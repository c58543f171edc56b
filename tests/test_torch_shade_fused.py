"""The wavefront's fused shading (ops/cuda/shade.py: csrc/shade.cu and its
adjoint csrc/shade_bwd.cu) on the CPU: the routing rule of
``ops/integrator.make_bounce_core`` (three routes), the bounce wired
through the wrappers (whose plain versions run on the CPU), the autograd
Function's gradients against the unrouted ``hit_attributes`` +
``shade_hit``, the card cases of ops/cuda/parity.py cut down, the
wrappers' checks, and the row layouts of the shading body that the kernels
share with K1-K4 (csrc/shade.cuh, csrc/adjoint.cuh). The kernels
themselves are held to hit_attributes + shade_hit on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 19).
"""

import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch.ops import integrator, shading
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from mini_opencl_raytracer_tpu_torch.ops.cuda import parity
from mini_opencl_raytracer_tpu_torch.ops.cuda import shade

torch.set_num_threads(1)
CPU = torch.device("cpu")
CSRC = Path(P.__file__).parent / "csrc"


@pytest.mark.parametrize("case, route", [
    ("cuda", "fused"), ("cpu", "plain"), ("grad", "adjoint"), ("shadow rays", "plain"),
    ("float64", "plain"), ("grad, 30 lights", "adjoint"), ("grad, 31 lights", "plain"),
    ("grad, shadow rays", "plain"), ("grad, float64", "plain"), ("grad, cpu", "plain"),
    ("31 lights", "fused")])
def test_routing_rule(case, route):
    """The kernel shades a bounce for rays on a CUDA device, in float32,
    without shadow rays: alone where no gradient is taken, as the autograd
    Function with the adjoint kernel where one is and the scene has at most
    30 lights (the adjoint's limit); anything else shades in PyTorch."""
    cfg = P.RenderConfig(shadow_rays="shadow rays" in case,
                         dtype="float64" if "float64" in case else "float32")
    o = SimpleNamespace(is_cuda="cpu" not in case)
    lights = 31 if "31 lights" in case else 30 if "30 lights" in case else 1
    assert pmk.MAX_LIGHTS == 30
    assert integrator.shading_route(cfg, o, grad="grad" in case, num_lights=lights) == route


@pytest.mark.parametrize("case, taken", [
    ("no_grad", False), ("nothing requires grad", False), ("scene leaf", True),
    ("carry tensor", True)])
def test_grad_taken(case, taken):
    """_remat's test: grad mode on, and a scene leaf or a carry tensor
    requires grad; on a card it picks the adjoint route over the fused
    one."""
    carry = (torch.zeros(2, 3, requires_grad=case == "carry tensor"), torch.ones(2))
    if case == "no_grad":
        with torch.no_grad():
            got = integrator._grad_taken(True, carry)
    else:
        got = integrator._grad_taken(case == "scene leaf", carry)
    assert got is taken
    route = integrator.shading_route(P.RenderConfig(), SimpleNamespace(is_cuda=True), got, 1)
    assert route == ("adjoint" if taken else "fused")


def _forced(monkeypatch):
    """Route as on a card (the rule without its device test) and record the
    bounce of each call of the two wrappers."""
    calls = {"fused": [], "adjoint": []}
    monkeypatch.setattr(integrator, "shading_route", lambda cfg, o, grad, n: (
        "plain" if cfg.shadow_rays or cfg.dtype != "float32" else
        "fused" if not grad else "adjoint" if n <= pmk.MAX_LIGHTS else "plain"))
    for route, name in (("fused", "shade_rows"), ("adjoint", "shade_grad")):
        real = getattr(shade, name)
        monkeypatch.setattr(shade, name, lambda *a, real=real, route=route, **k: (
            calls[route].append(a[8]) or real(*a, **k)))
    return calls


@pytest.mark.parametrize("case", ["cornell pallas", "cornell bvh", "bunny sorted"])
def test_routed_bounce_equals_plain(monkeypatch, case):
    """Every bounce routed through shade_rows (its plain version on the
    CPU, on the packed lights) gives the image of hit_attributes +
    shade_hit bit for bit; under a gradient every bounce goes through
    shade_grad instead, twice with remat (the forward and the recompute),
    whose forward is shade_rows."""
    if case == "bunny sorted":
        scene = P.bunny_scene(target_tris=4000, device=CPU)
        cfg = P.RenderConfig(width=32, height=16, bounces=3, direct_specular=True,
                             soft_edge_sigma=0.05)
    else:
        scene = parity.two_light_scene(CPU)
        cfg = P.RenderConfig(width=32, height=16, bounces=3, backend=case.split()[1],
                             specular_model="ggx", backface_cull=True)
    cam = P.Camera.default(device=CPU)
    plain = P.render_sample(scene, cam, cfg, frame=3)
    calls = _forced(monkeypatch)
    assert torch.equal(P.render_sample(scene, cam, cfg, frame=3), plain)
    assert calls == {"fused": list(range(cfg.bounces)), "adjoint": []}
    mats = dataclasses.replace(scene.materials,
                               diffuse=scene.materials.diffuse.detach().requires_grad_(True))
    small = P.RenderConfig(width=16, height=8, bounces=2, backend=cfg.backend)
    P.render_sample(dataclasses.replace(scene, materials=mats), cam, small).mean().backward()
    assert mats.diffuse.grad.abs().sum() > 0
    # The Function's forward is shade_rows.
    assert calls["fused"][:cfg.bounces] == list(range(cfg.bounces))
    assert sorted(calls["adjoint"]) == sorted(calls["fused"][cfg.bounces:]) == [0, 0, 1, 1]


def _grads(scene, cfg):
    loss, gs, gc = pgrad.loss_and_grads(scene, P.Camera.default(device=CPU), cfg,
                                        lambda im: im.mean())
    return loss, list(pgrad._leaves(gs)) + [("camera." + k, v) for k, v in pgrad._leaves(gc)]


@pytest.mark.parametrize("case", ["rows", "rows sorted", "no rows", "no rows sorted"])
@pytest.mark.parametrize("remat", [False, True])
def test_adjoint_route_grads_bitwise_plain(monkeypatch, case, remat):
    """The adjoint route on the CPU (the autograd Function with its plain
    versions: shade_plain forward, autograd of shade_plain backward) gives
    the loss and every gradient of the scene and the camera bit for bit as
    the unrouted hit_attributes + shade_hit: with K6's rows (the bunny) and
    without (Cornell on K5), the wavefront sorted and unsorted."""
    sort = case.endswith("sorted")
    if case.startswith("rows"):
        scene = P.bunny_scene(target_tris=4000, device=CPU)
        cfg = P.RenderConfig(width=24, height=16, bounces=3, direct_specular=True,
                             soft_edge_sigma=0.05, sort_rays=sort, remat=remat)
    else:
        scene = parity.two_light_scene(CPU)
        cfg = P.RenderConfig(width=24, height=16, bounces=3, backend="pallas",
                             specular_model="ggx", sort_rays=sort, remat=remat)
    loss, grads = _grads(scene, cfg)
    calls = _forced(monkeypatch)
    loss_r, grads_r = _grads(scene, cfg)
    assert sorted(calls["adjoint"]) == sorted(list(range(cfg.bounces)) * (2 if remat else 1))
    assert torch.equal(loss, loss_r)
    for (k, a), (_, b) in zip(grads, grads_r):
        assert torch.equal(a, b), k
    assert dict(grads_r)["materials.diffuse"].abs().sum() > 0
    assert dict(grads_r)["lights.position"].abs().sum() > 0


def test_cpu_bounces_shade_in_pytorch(monkeypatch):
    """On the CPU the integrator never calls the wrapper and counts no
    ray: the plain path's count is of rays on a CUDA device."""
    def refuse(*a, **k):
        raise AssertionError("shade_rows called on the CPU")

    monkeypatch.setattr(shade, "shade_rows", refuse)
    before = dict(build.RAYS), build.LAUNCHES["shade"]
    scene = P.bunny_scene(target_tris=4000, device=CPU)
    cfg = P.RenderConfig(width=16, height=16, bounces=2)
    with torch.no_grad():
        P.render_sample(scene, P.Camera.default(device=CPU), cfg)
    assert (build.RAYS, build.LAUNCHES["shade"]) == before


@pytest.mark.parametrize("name", list(parity.SHADE_CASES))
def test_shade_cases_are_what_they_say(name):
    """The card's cases, cut down, on the CPU: each holds what its name
    says (rows from K6 for the bunny and sponza, none from K5 and the
    LBVH walk; a bounce-1 carry with radiance and dead rays; the sorted
    one's live rays first and its dead ones parked; the flags), and the
    wrapper's plain version equals hit_attributes + shade_hit there."""
    kind, kw, bounce, sort = parity.SHADE_CASES[name]
    scene, cfg, closest, carry, b = parity.shade_case(name, CPU, small=True)
    fused, plain, hit = parity.shade_pair(scene, cfg, closest, carry, b)
    parity.check_shade(name, fused, plain)
    o, _, beta, radiance, alive, _ = carry
    assert b == bounce and (hit.rows is not None) == (kind in ("bunny", "sponza"))
    assert bool((alive & hit.hit).any()) and bool((alive & ~hit.hit).any())
    if bounce == 0:
        assert o.stride() == (0, 1) and bool(alive.all()) and not bool(radiance.any())
    else:
        assert bool(radiance.any()) and not bool(alive.all()) and not bool((beta == 1).all())
    if sort:
        n = int(alive.sum())
        assert bool(alive[:n].all()) and not bool(alive[n:].any())
        g = scene.geometry
        pts = torch.cat([g.v0, g.v1, g.v2])
        assert bool((o[n:] == integrator.park_point(pts.amin(0), pts.amax(0))).all())
    for field, value in kw.items():
        assert getattr(cfg, field) == value or field in ("width", "height")
    if kind == "lights":
        assert set(scene.lights.light_type.tolist()) == {0, 1, 2}


def test_shade_hit_is_the_mega_plain_versions():
    """The plain versions of K1 / K2 run ops/integrator.shade_hit itself,
    not another kernel: one call a bounce."""
    seen = []
    real = pmk.shade_hit
    assert real is integrator.shade_hit
    cfg = P.RenderConfig(width=16, height=8)
    table, tris, lv = pmk._tables(P.cornell_scene(device=CPU), cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device=CPU))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32)
    pmk.shade_hit = lambda *a, **k: seen.append(1) or real(*a, **k)
    try:
        out = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
        pmk.bounce_fwd_plain(table, tris, lv, out[0], out[1], out[2], out[3], out[7], 1, cfg)
    finally:
        pmk.shade_hit = real
    assert seen == [1, 1]


def _struct(text: str, name: str) -> dict:
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1)
    return {k: v for k, v in re.findall(r"(k\w+) = ([\w:]+)", body)}


def test_row_layouts_match_the_tables():
    """shade.cuh's TableRow is ops/shading.ShadingTable's layout and its
    MegaRow the mega table's (megakernel.py _N0.._NS, through
    megakernel.cuh's constants)."""
    text = (CSRC / "shade.cuh").read_text()
    consts = dict(re.findall(r"\b(k\w+) = (\d+)", (CSRC / "megakernel.cuh").read_text()))
    st = shading.ShadingTable
    table_row = {k: int(v) for k, v in _struct(text, "TableRow").items()}
    assert table_row == {"kCols": st.COLS, "kV0": st.V0, "kV1": st.V1, "kV2": st.V2,
                         "kN0": st.N0, "kN1": st.N1, "kN2": st.N2, "kKD": st.KD,
                         "kKS": st.KS, "kKE": st.KE, "kNS": st.NS}
    mega_row = {k: int(consts[v.lstrip(":")]) for k, v in _struct(text, "MegaRow").items()}
    assert mega_row == {"kCols": pmk._C_PAD, "kN0": pmk._N0, "kN1": pmk._N1, "kN2": pmk._N2,
                        "kKD": pmk._KD, "kKS": pmk._KS, "kKE": pmk._KE, "kNS": pmk._NS}


@pytest.mark.parametrize("case, error", [
    ("shadow rays", ValueError), ("float64", TypeError), ("grad", ValueError),
    ("int32 seeds", TypeError), ("strided columns", ValueError),
    ("rows unaligned", ValueError)])
def test_wrapper_refuses(case, error):
    """What the kernel does not take, the wrapper refuses, on the CPU as on
    the card."""
    scene, cfg, closest, carry, b = parity.shade_case("bunny 512x512 bounce 0", CPU, small=True)
    o, d, beta, radiance, alive, seeds = carry
    with torch.no_grad():
        hit = closest(o, d)
    table = shading.build_shading_table(scene.geometry, scene.materials).table
    lv = pmk.pack_lights(scene.lights)
    if case in ("shadow rays", "float64"):
        cfg = P.RenderConfig(shadow_rays=case == "shadow rays",
                             dtype="float64" if case == "float64" else "float32")
    elif case == "grad":
        beta = beta.clone().requires_grad_(True)
    elif case == "int32 seeds":
        seeds = seeds.to(torch.int32)
    elif case == "strided columns":
        d = torch.cat([d, d], dim=1)[:, ::2]
    else:
        raw = torch.zeros(hit.rows.numel() + 1)
        hit.rows = raw[1:].view(hit.rows.shape).copy_(hit.rows)
    with pytest.raises(error):
        shade.shade_rows(hit, table, o, d, beta, radiance, alive, seeds, b, lv, cfg)


@pytest.mark.parametrize("case, error", [
    ("shadow rays", ValueError), ("float64", TypeError), ("31 lights", ValueError),
    ("grad", ValueError), ("rows unaligned", ValueError), ("three cotangents", ValueError),
    ("float64 cotangent", ValueError)])
def test_adjoint_wrapper_refuses(case, error):
    """What the adjoint kernel does not take, its wrapper refuses, on the
    CPU as on the card."""
    scene, cfg, closest, carry, b = parity.shade_case("bunny 512x512 bounce 0", CPU, small=True)
    o, d, beta, _, alive, seeds = carry
    with torch.no_grad():
        hit = closest(o, d)
    rows = hit.rows.clone()
    lv = pmk.pack_lights(scene.lights)
    cot = [torch.ones_like(beta) for _ in range(4)]
    if case in ("shadow rays", "float64"):
        cfg = P.RenderConfig(shadow_rays=case == "shadow rays",
                             dtype="float64" if case == "float64" else "float32")
    elif case == "31 lights":
        lv = lv[[0] * 31]
    elif case == "grad":
        rows.requires_grad_(True)
    elif case == "rows unaligned":
        raw = torch.zeros(rows.numel() + 1)
        rows = raw[1:].view(rows.shape).copy_(rows)
    elif case == "three cotangents":
        cot = cot[:3]
    else:
        cot[3] = cot[3].double()
    with pytest.raises(error):
        shade.shade_adjoint(rows, o, d, beta, alive, hit.hit, seeds, lv, cot, b, cfg)
