"""The backward's residual mode (``cfg.bwd_residuals``) of the port against
the JAX package's, on the CPU.

* Rows: ``bounce_fwd(save_resid=True)`` on CPU tensors (the plain version,
  ops/known.py) against JAX ``_run_bounce_fwd(save_resid=True)`` (Pallas in
  interpret mode), row by row on the live rays (alive with a winner, the
  JAX kernel's ``live``; the port's read back through its rank array), in
  the four cases of tests/test_torch_megakernel.py (Blinn; two lights with
  shadow rays and direct specular; GGX; soft edges), 32x32 rays.
  ``known.num_rows`` against ``_num_resid_rows``.
* The rank-indexed layout (``known.Resid``: a column per ray alive with a
  winner, at its rank in ray order) against the ray-indexed one it
  replaced (every ray's rows at its own index, rank = 0 .. R - 1): the
  same rows bitwise, the rank a prefix count, and the replay's gradients
  bitwise those of the ray-indexed rows, at bounces 1-2 of Cornell 32x32
  x 3 and of a triangle soup with shadow rays and direct specular.
* Per kernel: ``bounce_bwd(resid=rows)`` (the plain replay with the rows
  substituted) against JAX ``_run_bounce_bwd`` with its rows, in the same
  cases, and against the port's own recompute.
* The slice: ``loss_and_grads`` on mega at 16x16 x 2 bounces with
  ``bwd_residuals`` True against False, and against JAX's
  ``bwd_residuals=True`` gradients, in the three cases of
  tests/test_megakernel.py:135 (defaults, GGX, shadow rays).

Tolerances. Rows: |port - jax| <= 2e-5 + 1e-4 |jax| (the forward outputs'
tolerance of tests/test_torch_megakernel.py: the same float32 arithmetic
in another order, transcendentals from two libraries), except sin_h, which
both lobes compute as sqrt(1 - cos^2) by cancellation: XLA fuses the
multiply-add and torch does not, so where cos_h is within ~1e-3 of 1 (the
Ns = 9999 boxes) the two differ by up to ~1e-3 absolute; there the rows
are compared through sin_h^2 + cos_h^2 = 1 to 2e-5. Gradients: the
scale-normalised atol of tests/test_torch_grad.py (1e-4) against JAX, and
1e-5 between the port's two modes (tests/test_megakernel.py:135 holds
JAX's two modes at 1e-5): the closed-form derivatives of the known-value
nodes round differently from autograd's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import grad as jgrad
from mini_opencl_raytracer_tpu.ops.linalg import cross as jcross
from mini_opencl_raytracer_tpu.ops.pallas import megakernel as jmk
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch.ops import known
from mini_opencl_raytracer_tpu_torch.ops import rng as trng
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk, parity
from test_torch_grad import _assert_close, _compare_trees, _cotangents, flush_denormals  # noqa: F401
from test_torch_megakernel import (BOUNCE, CASES, FRAME, H, R, W, _arrays,
                                   _flat_to_panels, _panels_to_flat, _two_lights)

torch.set_num_threads(1)

ROW_ATOL, ROW_RTOL = 2e-5, 1e-4
MODES_ATOL = 1e-5


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both JAX kernels of one case with residual rows on; the port's
    inputs alongside (the setup of tests/test_torch_grad.py)."""
    kw, two = CASES[request.param]
    js = J.cornell_scene(lights=_two_lights() if two else None)
    jcfg = J.RenderConfig(width=W, height=H, bwd_residuals=True, **kw)
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
    rs = np.random.default_rng(31)
    beta_in = (j0[2] * rs.uniform(0.2, 1.0, size=(3, R))).astype(np.float32)
    alive_in = (j0[3] * (rs.uniform(size=R) > 0.2)).astype(np.float32)
    seeds_in = j0[7].astype(np.uint32)
    state = (_flat_to_panels(j0[0]), _flat_to_panels(j0[1], fills=(0.0, 0.0, 1.0)),
             _flat_to_panels(beta_in), _flat_to_panels(alive_in),
             jmk._to_panels(jnp.asarray(seeds_in), R))
    out1 = jmk._run_bounce_fwd(tableT, lv, mt, *state, jmk._bounce_cms(BOUNCE), jcfg,
                               save_resid=True)
    j1 = [_panels_to_flat(a) for a in out1]
    cot = _cotangents(rs, j1[2])
    jd = jmk._run_bounce_bwd(tableT, lv, *state, out1[5], out1[6],
                             jmk._bounce_cms(BOUNCE), out1[7],
                             tuple(_flat_to_panels(c) for c in cot), jcfg)
    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    port = dict(table=pmk.build_mega_table(ps.geometry, ps.materials).T.contiguous(),
                tris=pmk.build_accel(ps.geometry), lv=pmk.pack_lights(ps.lights),
                o=torch.from_numpy(np.ascontiguousarray(j0[0])),
                d=torch.from_numpy(np.ascontiguousarray(j0[1])),
                beta=torch.from_numpy(beta_in), alive=torch.from_numpy(alive_in),
                seeds=torch.from_numpy(seeds_in.view(np.int32)))
    return dict(port=port, cfg=pcfg, j1=j1, jd=[np.asarray(a) for a in jd],
                cot=tuple(torch.from_numpy(c) for c in cot), alive_in=alive_in,
                name=request.param)


def _fwd(case, save_resid):
    p = case["port"]
    return pmk.bounce_fwd(p["table"], p["tris"], p["lv"], p["o"], p["d"], p["beta"],
                          p["alive"], p["seeds"], BOUNCE, case["cfg"], save_resid=save_resid)


@pytest.mark.parametrize("kw,lights", [
    ({}, 1), ({"specular_model": "ggx"}, 1), ({"shadow_rays": True}, 1),
    ({"direct_specular": True}, 1), ({"direct_specular": True}, 2),
    ({"soft_edge_sigma": 0.05, "specular_model": "ggx"}, 30),
    ({"soft_edge_sigma": 0.05, "direct_specular": True, "shadow_rays": True}, 3)])
def test_resid_rows_count_matches_jax(kw, lights):
    n = known.num_rows(P.RenderConfig(**kw), lights)
    assert n == jmk._num_resid_rows(J.RenderConfig(**kw), lights)
    assert n == len(known.layout(P.RenderConfig(**kw), lights))
    if not kw and lights == 1:
        assert n == 17   # Cornell's main configuration


def test_resid_rows_plain_match_jax(case):
    """The plain rows of every live ray equal JAX's, row by row; recording
    them changes no output of the bounce."""
    out = _fwd(case, True)
    ref = _fwd(case, False)
    for a, b in zip(out[:7], ref):
        assert torch.equal(a, b)
    resid = out[7]
    j1 = case["j1"]
    jrows = j1[7]
    assert resid.rows.shape == jrows.shape == (
        known.num_rows(case["cfg"], case["port"]["lv"].shape[0]), R)
    live = (case["alive_in"] > 0) & (j1[5] >= 0)
    assert live.mean() > 0.3
    rank = resid.rank.numpy()
    assert np.array_equal(rank >= 0, live) and resid.count.item() == live.sum()
    rows = np.zeros_like(jrows)   # the port's rows back at the rays' own index
    rows[:, live] = resid.rows.numpy()[:, rank[live]]
    lay = known.layout(case["cfg"], case["port"]["lv"].shape[0])
    cos_h, sin_h = rows[lay["cos_h"]], rows[lay["sin_h"]]
    steep = live & (np.abs(1.0 - cos_h) < 1e-3)   # sin_h by cancellation (docstring)
    for name, k in lay.items():
        got, want = rows[k][live], jrows[k][live]
        if name == "sin_h":
            got, want = rows[k][live & ~steep], jrows[k][live & ~steep]
            np.testing.assert_allclose(jrows[k][steep] ** 2 + cos_h[steep] ** 2, 1.0,
                                       atol=2e-5, err_msg=name)
        np.testing.assert_allclose(got, want, atol=ROW_ATOL, rtol=ROW_RTOL, err_msg=name)
    pick = rows[lay["pick"]][live]
    assert set(np.unique(pick).tolist()) == {0.0, 1.0}


def test_bounce_bwd_resid_plain_matches_jax(case):
    """The plain replay on the rows against JAX's residual backward kernel,
    and against the port's recompute on the same inputs."""
    p, cfg = case["port"], case["cfg"]
    fwd = _fwd(case, True)
    args = (p["table"], p["lv"], p["o"], p["d"], p["beta"], p["alive"], p["seeds"],
            fwd[5], fwd[6], case["cot"], BOUNCE, cfg)
    before = {k: v for k, v in build.LAUNCHES.items() if k.startswith("bounce")}
    got = pmk.bounce_bwd(*args, resid=fwd[7])
    assert {k: build.LAUNCHES[k] for k in before} == before  # CPU tensors run the plain version
    rec = pmk.bounce_bwd(*args)
    jd = case["jd"]
    for i, name in enumerate(("d_o", "d_d", "d_beta")):
        _assert_close(got[i], _panels_to_flat(jd[i]), name)
        _assert_close(got[i], rec[i], name + " (recompute)")
    _assert_close(got[3], jd[3].T, "d_table", nonfinite_rows=[pmk._NS])
    _assert_close(got[4], jd[4], "d_lights")
    _assert_close(got[3], rec[3], "d_table (recompute)")
    _assert_close(got[4], rec[4], "d_lights (recompute)")
    # The replay reads no seed: other seeds give the same gradients.
    other = pmk.bounce_bwd(*args[:6], torch.zeros_like(p["seeds"]), *args[7:], resid=fwd[7])
    assert all(torch.equal(a, b) for a, b in zip(got, other))


def test_wrapper_checks_resid():
    scene, cfg = P.cornell_scene(device="cpu"), P.RenderConfig(width=8, height=8)
    table, tris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device="cpu"))
    pid = torch.arange(64, dtype=torch.int32)
    f0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 0, cfg)
    state = (f0[0], f0[1], f0[2], f0[3], f0[7])
    f1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg, save_resid=True)
    rows, rank, count = f1[7]
    assert rows.shape == (17, 64) and rows.dtype == torch.float32
    assert rank.shape == (64,) and rank.dtype == count.dtype == torch.int32
    assert count.shape == (1,)
    cot = (f0[0], f0[1], f0[2], f0[0])
    args = (table, lv, *state, f1[5], f1[6], cot, 1, cfg)
    with pytest.raises(ValueError):
        pmk.bounce_bwd(*args, resid=f1[7]._replace(rows=rows[:16].contiguous()))
    with pytest.raises(TypeError):
        pmk.bounce_bwd(*args, resid=f1[7]._replace(rows=rows.double()))
    with pytest.raises(TypeError):
        pmk.bounce_bwd(*args, resid=f1[7]._replace(rank=rank.long()))
    with pytest.raises(ValueError):
        pmk.bounce_bwd(*args, resid=f1[7]._replace(count=count.repeat(2)))


SLICE = {"defaults": {}, "ggx": {"specular_model": "ggx"}, "shadow": {"shadow_rays": True}}


@pytest.fixture(scope="module")
def scenes():
    js = J.cornell_scene()
    return js, P.scene_from_numpy(_arrays(js), device="cpu")


@pytest.mark.parametrize("name", list(SLICE))
def test_slice_grads_resid(scenes, name):
    js, ps = scenes
    kw = dict(width=16, height=16, bounces=2, backend="mega", **SLICE[name])
    cam = P.Camera.default(device="cpu")
    loss = lambda img: img.mean()
    _, gs_r, gc_r = pgrad.loss_and_grads(ps, cam, P.RenderConfig(bwd_residuals=True, **kw), loss)
    _, gs_c, gc_c = pgrad.loss_and_grads(ps, cam, P.RenderConfig(**kw), loss)
    for (k, a), (_, b) in zip(list(pgrad._leaves(gs_r)) + list(pgrad._leaves(gc_r)),
                              list(pgrad._leaves(gs_c)) + list(pgrad._leaves(gc_c))):
        if not a.is_floating_point():
            continue
        a64, b64 = a.double().numpy(), b.double().numpy()
        scale = max(np.abs(b64).max(), 1e-6)
        np.testing.assert_allclose(a64 / scale, b64 / scale, atol=MODES_ATOL, err_msg=k)
    jcfg = J.RenderConfig(bwd_residuals=True, **kw)
    g_j, c_j = jgrad.grad_float_leaves(
        lambda sc: jgrad.render_loss(sc[0], sc[1], jcfg, lambda img: jnp.mean(img)),
        (js, J.Camera.default()))
    _compare_trees(gs_r, g_j, nonfinite_leaves=("materials.roughness",))
    _compare_trees(gc_r, c_j)
    assert np.abs(gs_r.materials.diffuse.numpy()).max() > 0


# The rank-indexed layout against the ray-indexed one, on the CPU plain
# version: (scene, config) of each case, rendered at 32x32 x 3.
LAYOUT = {"cornell": (lambda: P.cornell_scene(device="cpu"), {}),
          "soup, shadow rays, direct specular": (
              lambda: parity.soup_scene("cpu", 512),
              {"shadow_rays": True, "direct_specular": True})}


@pytest.mark.parametrize("name", list(LAYOUT))
def test_rank_layout_replays_ray_layout(name, monkeypatch):
    """At bounces 1 and 2: the packed rows of the rays alive with a winner
    are bitwise their ray-indexed rows (every row), in the column of their
    rank, a prefix count in ray order; the columns past the count are
    zero; the replay through the ranks gives bitwise the gradients of the
    replay on the ray-indexed rows (rank = 0 .. R - 1, the layout before
    ranks), and both stay in the modes' gate of the recompute."""
    make, kw = LAYOUT[name]
    scene = make()
    cfg = P.RenderConfig(width=32, height=32, bounces=3, bwd_residuals=True, **kw)
    table, tris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device="cpu"))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32)
    f0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, FRAME, cfg)
    state, seeds = f0[:4], f0[7]
    by_ray = {}
    pack = known.Known.packed

    def spy(kn, live):   # the ray-indexed rows the packed ones come from
        by_ray["rows"] = kn.stacked()
        return pack(kn, live)

    monkeypatch.setattr(known.Known, "packed", spy)
    gen = np.random.default_rng(5)
    for b in (1, 2):
        out = pmk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg, save_resid=True)
        resid, rows = out[7], by_ray["rows"]
        live = (state[3] > 0) & (out[5] >= 0)
        n = int(live.sum())
        assert 0 < n < live.numel()
        assert torch.equal(resid.rank[live], torch.arange(n, dtype=torch.int32))
        assert bool((resid.rank[~live] == -1).all()) and resid.count.item() == n
        assert torch.equal(resid.rows[:, resid.rank[live].long()], rows[:, live])
        assert not resid.rows[:, n:].any()
        R = live.numel()
        every = known.Resid(rows, torch.arange(R, dtype=torch.int32),
                            torch.full((1,), R, dtype=torch.int32))
        cot = tuple(torch.from_numpy(gen.normal(size=(3, R)).astype(np.float32))
                    for _ in range(4))
        args = (table, lv, *state, seeds, out[5], out[6], cot, b, cfg)
        got = pmk.bounce_bwd(*args, resid=resid)
        ref = pmk.bounce_bwd(*args, resid=every)
        rec = pmk.bounce_bwd(*args)
        for g, r, c, what in zip(got, ref, rec, parity.BOUNCE_GRADS):
            assert torch.equal(g, r), what
            assert bool(torch.isfinite(g).all()), what
            scale = max(c.abs().max().item(), 1e-6)
            np.testing.assert_allclose(g.numpy() / scale, c.numpy() / scale, atol=MODES_ATOL,
                                       err_msg=what)
        state = out[:4]
