"""Gradients of the port against the JAX package on the CPU.

* Per kernel: ``bounce0_bwd`` / ``bounce_bwd`` on CPU tensors (their plain
  versions) against JAX ``_run_bounce0_bwd`` / ``_run_bounce_bwd`` (Pallas
  in interpret mode), 32x32 rays in the four cases of
  tests/test_torch_megakernel.py, the same forward inputs and the same
  cotangents drawn with numpy. Rays whose next throughput is exactly zero
  get zero (o, d) cotangents (their next directions differ between XLA and
  torch by up to ~1e-3: see tests/test_torch_megakernel.py:_compare).
* The slice: ``grad.scene_grad`` / ``camera_grad`` on the port's mega path
  against JAX ``gradlib`` on mega (16x16, 2 bounces, four configurations),
  and the port's bruteforce against JAX bruteforce (24x24, 1 bounce).
* A finite-difference check, ``grad_float_leaves`` on integer leaves, and
  the tie rule of max / min under a gradient.

Tolerance: scale-normalised atol 1e-4 (|port - jax| / max|jax| <= 1e-4, as
tests/test_megakernel.py holds mega against bruteforce). It covers float32
sums taken in another order and the JAX scatter's 2-limb bf16 cotangent
(megakernel.py:665-672).

XLA's CPU code flushes denormals to zero and torch's does not, so where a
radiance underflows (pow(n.h, 92) of a grazing light) JAX has an exact 0
where the port has a denormal, and the final clamp's tie (half the
gradient at exactly 0) then falls on other pixels. This module runs the
port with ``torch.set_flush_denormal(True)`` to compare like with like.

Where the JAX gradient is not finite, the port's is and the entry is left
out of the comparison: JAX's d/dNs is NaN wherever sin(theta_h) =
sqrt(max(1 - cos^2, 0)) is exactly 0 (GGX on the Ns = 9999 boxes), and its
one-hot scatter matmul spreads the NaN over the whole Ns row; the port
gives that sqrt zero gradient at 0 (ops/brdf._sqrt0). The tests assert
that only the Ns row is affected.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import grad as jgrad
from mini_opencl_raytracer_tpu.ops import lights as jlights
from mini_opencl_raytracer_tpu.ops.linalg import cross as jcross
from mini_opencl_raytracer_tpu.ops.pallas import megakernel as jmk
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch.ops import lights as plights
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
from mini_opencl_raytracer_tpu_torch.ops import rng as trng
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from test_torch_megakernel import (BOUNCE, CASES, FRAME, H, R, W, _arrays,
                                   _flat_to_panels, _panels_to_flat,
                                   _two_lights)

torch.set_num_threads(1)

ATOL = 1e-4
CAM = J.Camera.default()


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    """Flush denormals like XLA's CPU code (module docstring)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _assert_close(got, ref, name, nonfinite_rows=None):
    """Scale-normalised comparison; ``nonfinite_rows`` names the rows of a
    [T_pad, 32] table gradient where JAX may be non-finite."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), f"{name}: port gradient not finite"
    fin = np.isfinite(ref)
    if not fin.all():
        assert nonfinite_rows is not None, f"{name}: JAX gradient not finite"
        cols = np.nonzero(~fin)[-1]
        assert set(cols.tolist()) <= set(nonfinite_rows), name
    scale = max(np.abs(ref[fin]).max(), 1e-6)
    np.testing.assert_allclose(got[fin] / scale, ref[fin] / scale, atol=ATOL,
                               err_msg=name)


def _cotangents(rs, next_beta):
    """Four [3, R] cotangents; zero (o, d) ones where next beta is 0."""
    cot = [rs.standard_normal((3, R)).astype(np.float32) for _ in range(4)]
    dead = np.abs(next_beta).max(axis=0) == 0
    cot[0][:, dead] = 0.0
    cot[1][:, dead] = 0.0
    return cot


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Forward and backward kernels of both packages on one case."""
    kw, two = CASES[request.param]
    js = J.cornell_scene(lights=_two_lights() if two else None)
    jcfg = J.RenderConfig(width=W, height=H, **kw)
    pcfg = P.RenderConfig(width=W, height=H, **kw)
    cam = J.Camera.default()
    tableT = jmk.build_mega_table(js.geometry, js.materials)
    lv = jmk.pack_lights(js.lights)
    mt = jmk.build_mt_table(js.geometry)
    camv = jnp.concatenate([cam.position, jcross(cam.front, cam.up), cam.up,
                            cam.front, jnp.zeros(4)]).astype(jnp.float32)[None]
    pid = np.random.default_rng(11).permutation(R).astype(np.uint32)
    pxy = jnp.stack([jmk._to_panels(jnp.asarray((pid % W).astype(np.float32)), R),
                     jmk._to_panels(jnp.asarray((pid // W).astype(np.float32)), R)])
    tile = np.ones((jmk._ROWS, jmk._LANES), np.uint32)
    rgcms = jnp.stack([jnp.asarray(tile * np.uint32(jmk._premixed_counter(0))),
                       jnp.asarray(tile * np.uint32(jmk._premixed_counter(1))),
                       jnp.asarray(tile * np.uint32(trng.premix(FRAME)))])
    out0 = jmk._run_bounce0_fwd(tableT, lv, mt, camv, pxy, rgcms,
                                jmk._bounce_cms(0), jcfg)
    j0 = [_panels_to_flat(a) for a in out0]
    rs = np.random.default_rng(21)
    cot0 = _cotangents(rs, j0[2])
    jd0 = jmk._run_bounce0_bwd(tableT, lv, camv, pxy, rgcms, jmk._bounce_cms(0),
                               out0[5], out0[6],
                               tuple(_flat_to_panels(c) for c in cot0), jcfg)

    beta_in = (j0[2] * rs.uniform(0.2, 1.0, size=(3, R))).astype(np.float32)
    alive_in = (j0[3] * (rs.uniform(size=R) > 0.2)).astype(np.float32)
    seeds_in = j0[7].astype(np.uint32)
    state = (_flat_to_panels(j0[0]), _flat_to_panels(j0[1], fills=(0.0, 0.0, 1.0)),
             _flat_to_panels(beta_in), _flat_to_panels(alive_in),
             jmk._to_panels(jnp.asarray(seeds_in), R))
    out1 = jmk._run_bounce_fwd(tableT, lv, mt, *state, jmk._bounce_cms(BOUNCE),
                               jcfg)
    cot1 = _cotangents(rs, _panels_to_flat(out1[2]))
    jd1 = jmk._run_bounce_bwd(tableT, lv, *state, out1[5], out1[6],
                              jmk._bounce_cms(BOUNCE), None,
                              tuple(_flat_to_panels(c) for c in cot1), jcfg)

    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    port = dict(table=pmk.build_mega_table(ps.geometry, ps.materials).T.contiguous(),
                tris=pmk.build_accel(ps.geometry), lv=pmk.pack_lights(ps.lights),
                camv=pmk.camera_vector(P.Camera.default(device="cpu")),
                pid=torch.from_numpy(pid.astype(np.int32)),
                o=torch.from_numpy(np.ascontiguousarray(j0[0])),
                d=torch.from_numpy(np.ascontiguousarray(j0[1])),
                beta=torch.from_numpy(beta_in), alive=torch.from_numpy(alive_in),
                seeds=torch.from_numpy(seeds_in.view(np.int32)))
    return dict(port=port, cfg=pcfg, jd0=[np.asarray(a) for a in jd0],
                jd1=[np.asarray(a) for a in jd1],
                cot0=tuple(torch.from_numpy(c) for c in cot0),
                cot1=tuple(torch.from_numpy(c) for c in cot1))


def test_bounce0_bwd_plain_matches_jax(case):
    p, cfg = case["port"], case["cfg"]
    fwd = pmk.bounce0_fwd(p["table"], p["tris"], p["lv"], p["camv"], p["pid"],
                          FRAME, cfg)
    before = dict(pmk.LAUNCHES)
    d_tab, d_lv, d_cam = pmk.bounce0_bwd(p["table"], p["lv"], p["camv"], p["pid"],
                                         FRAME, fwd[5], fwd[6], case["cot0"], cfg)
    assert pmk.LAUNCHES == before  # CPU tensors run the plain version
    jd = case["jd0"]
    _assert_close(d_tab, jd[0].T, "d_table", nonfinite_rows=[pmk._NS])
    _assert_close(d_lv, jd[1], "d_lights")
    _assert_close(d_cam, jd[2][0], "d_camv")
    assert np.abs(d_cam.numpy()).max() > 0 and np.abs(d_tab.numpy()).max() > 0


def test_bounce_bwd_plain_matches_jax(case):
    p, cfg = case["port"], case["cfg"]
    fwd = pmk.bounce_fwd(p["table"], p["tris"], p["lv"], p["o"], p["d"], p["beta"],
                         p["alive"], p["seeds"], BOUNCE, cfg)
    got = pmk.bounce_bwd(p["table"], p["lv"], p["o"], p["d"], p["beta"], p["alive"],
                         p["seeds"], fwd[5], fwd[6], case["cot1"], BOUNCE, cfg)
    jd = case["jd1"]
    for name, g, r in zip(("d_o", "d_d", "d_beta"), got[:3], jd[:3]):
        _assert_close(g, _panels_to_flat(r), name)
    _assert_close(got[3], jd[3].T, "d_table", nonfinite_rows=[pmk._NS])
    _assert_close(got[4], jd[4], "d_lights")
    # Rays that were not alive pass their cotangents through unchanged.
    dead = p["alive"].numpy() == 0
    for g, c in zip(got[:3], case["cot1"][:3]):
        np.testing.assert_array_equal(g.numpy()[:, dead], c.numpy()[:, dead])


# ---------------------------------------------------------------------------
# The slice: scene and camera gradients through render_sample.

SLICE = {
    "defaults": {},
    "shadow": dict(shadow_rays=True, direct_specular=True),
    "ggx": dict(specular_model="ggx"),
    "soft_edge": dict(soft_edge_sigma=0.05),
}


@pytest.fixture(scope="module")
def scenes():
    js = J.cornell_scene()
    return js, P.scene_from_numpy(_arrays(js), device="cpu")


def _leaf_dict(tree):
    return dict(pgrad._leaves(tree))


def _compare_trees(port_tree, jax_tree, nonfinite_leaves=()):
    jl = {".".join(str(getattr(k, "name", k)) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(jax_tree)}
    pl = _leaf_dict(port_tree)
    assert set(jl) == set(pl)
    for k, ref in jl.items():
        got = pl[k].numpy()
        assert got.dtype == ref.dtype, k
        if not np.issubdtype(ref.dtype, np.floating):
            assert not got.any(), k
            continue
        if k in nonfinite_leaves and not np.isfinite(ref).all():
            assert np.isfinite(got).all(), k
            continue
        _assert_close(got, ref, k)


@pytest.mark.parametrize("name", list(SLICE))
def test_scene_and_camera_grad_mega_match_jax(scenes, name):
    js, ps = scenes
    kw = dict(width=16, height=16, bounces=2, backend="mega", **SLICE[name])
    jcfg, pcfg = J.RenderConfig(**kw), P.RenderConfig(**kw)
    jloss = lambda img: jnp.mean(img)
    ploss = lambda img: img.mean()
    before = dict(pmk.LAUNCHES)
    g_p = pgrad.scene_grad(ps, P.Camera.default(device="cpu"), pcfg, ploss)
    c_p = pgrad.camera_grad(ps, P.Camera.default(device="cpu"), pcfg, ploss)
    assert pmk.LAUNCHES == before
    # The reference takes both in one trace: jgrad.scene_grad and
    # camera_grad are grad_float_leaves of this loss over either half.
    g_j, c_j = jgrad.grad_float_leaves(
        lambda sc: jgrad.render_loss(sc[0], sc[1], jcfg, jloss), (js, CAM))
    # JAX's roughness gradient is NaN under GGX (module docstring).
    _compare_trees(g_p, g_j, nonfinite_leaves=("materials.roughness",))
    _compare_trees(c_p, c_j)
    assert np.abs(g_p.materials.diffuse.numpy()).max() > 0


def test_scene_grad_bruteforce_matches_jax(scenes):
    """tests/test_grad.py's configuration: 24x24, 1 bounce, diffuse lobe."""
    js, ps = scenes
    kw = dict(width=24, height=24, bounces=1, backend="bruteforce",
              specular_prob=0.0)
    g_p = pgrad.scene_grad(ps, P.Camera.default(device="cpu"), P.RenderConfig(**kw),
                           lambda img: img.sum())
    g_j = jgrad.scene_grad(js, CAM, J.RenderConfig(**kw), lambda img: jnp.sum(img))
    _compare_trees(g_p, g_j)


def test_multibounce_kd_grad_fd(scenes):
    """Modelled on tests/test_megakernel.py:169: FD of the mega forward at
    16x16, 2 bounces, against the backward kernels' gradient."""
    _, ps = scenes
    cfg = P.RenderConfig(width=16, height=16, bounces=2)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    seeds = trng.pixel_seeds(pix, 0)
    o, d = generate_rays(P.Camera.default(device="cpu"), cfg, pix, seeds)
    base = ps.materials.diffuse

    def f(val):
        kd = base.clone()
        kd[0, 0] = val
        scene = dataclasses.replace(
            ps, materials=dataclasses.replace(ps.materials, diffuse=kd))
        return pmk.trace_paths_mega(scene, cfg, o, d, seeds).sum()

    ad, fd, ok = pgrad.fd_check(f, base[0, 0].clone(), eps=1e-2, rtol=5e-2,
                                atol=1e-3)
    assert ok, (float(ad), float(fd))
    assert float(ad) > 0.0


def test_grad_float_leaves_integer_leaves_zero(scenes):
    _, ps = scenes
    cfg = P.RenderConfig(width=8, height=8, bounces=1)
    g = pgrad.scene_grad(ps, P.Camera.default(device="cpu"), cfg, lambda img: img.mean())
    for leaf in (g.geometry.mat_idx, g.lights.light_type):
        assert leaf.dtype == torch.int32 and not leaf.any()
    assert isinstance(g, P.Scene)
    assert g.materials.diffuse.shape == ps.materials.diffuse.shape
    assert g.materials.diffuse.abs().sum() > 0


# ---------------------------------------------------------------------------
# Ties: max / min / clip pass half the gradient to each side, as in JAX.

def test_tie_gradients_match_jax():
    """d/d shininess of the direct specular at Ns = 1 exactly (the Cornell
    Light material), and d/d intensity through the final clamp where the
    radiance is exactly 0. With torch.clamp both were twice JAX's."""
    rs = np.random.default_rng(5)
    n = 64
    pos = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    normal = np.tile(np.float32([0, 0, 1]), (n, 1))
    wo = rs.normal(size=(n, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.5
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    ns = np.ones(n, np.float32)
    jl = J.Lights.default_point()
    pl = P.Lights.default_point(device="cpu")

    def jf(s):
        return jnp.sum(jlights.direct_light(jl, pos, normal, wo, s,
                                            direct_specular=True).specular_weight)

    g_j = np.asarray(jax.grad(jf)(jnp.asarray(ns)))
    s = torch.from_numpy(ns).requires_grad_()
    out = plights.direct_light(pl, torch.from_numpy(pos), torch.from_numpy(normal),
                               torch.from_numpy(wo), s, direct_specular=True)
    (g_p,) = torch.autograd.grad(out.specular_weight.sum(), s)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=1e-5, atol=1e-7)

    # Final clamp: no emission, black sky, no light -> radiance exactly 0.
    js = J.cornell_scene()
    js = js.replace(materials=js.materials.replace(
        emission=jnp.zeros_like(js.materials.emission)))
    js = js.replace(lights=js.lights.replace(intensity=jnp.zeros_like(js.lights.intensity)))
    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    kw = dict(width=8, height=8, bounces=1, sky_color=(0.0, 0.0, 0.0))
    for backend in ("bruteforce", "mega"):
        g_j = jgrad.scene_grad(js, CAM, J.RenderConfig(backend=backend, **kw),
                               lambda img: jnp.mean(img))
        g_p = pgrad.scene_grad(ps, P.Camera.default(device="cpu"),
                               P.RenderConfig(backend=backend, **kw),
                               lambda img: img.mean())
        ref = np.asarray(g_j.lights.intensity)
        assert ref[0] > 0, backend
        np.testing.assert_allclose(g_p.lights.intensity.numpy(), ref, rtol=1e-4,
                                   err_msg=backend)
