"""The panel intersector (K5's plain version, taken by the wrappers for
CPU tensors) and the wavefront ``pallas`` render of a small scene,
against the JAX package (Pallas in interpret mode).

Tolerances: t to 1e-5 relative, as tests/test_pallas.py (the same
float32 Möller–Trumbore, but XLA rounds some products differently: 7e-6
at a hit 0.01 away), and winners equal, except on
knife-edge ties, where two coplanar triangles (the Cornell boxes'
bottoms on the floor) reach the same t to within 1e-6 and rounding picks
either; at most 0.1% of the rays. Renders atol 2e-5, rtol 1e-4, as
tests/test_torch_render.py (the same float32 math in another operation
order, with transcendentals from other libraries).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu.ops.pallas import panel as jpanel
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import panel as ppanel

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _arrays(jscene):
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


@pytest.fixture(scope="module")
def scenes():
    js = J.cornell_scene()
    return js, P.scene_from_numpy(_arrays(js), device="cpu")


def _tri_t(geo, idx, o, d):
    """float64 Möller–Trumbore t of one ray against triangle ``idx``."""
    v0 = geo.v0[idx].double().numpy()
    e1, e2 = geo.v1[idx].double().numpy() - v0, geo.v2[idx].double().numpy() - v0
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    q = np.cross(o - v0, e1)
    return np.dot(e2, q) / det


def assert_same_winners(geo, got_idx, ref_idx, hit, o, d, rtol=1e-6):
    """Winners equal, except on ties: both winners at the same t."""
    bad = np.nonzero(hit & (got_idx != ref_idx))[0]
    assert len(bad) <= max(1, len(hit) // 1000), bad
    for r in bad:
        np.testing.assert_allclose(_tri_t(geo, got_idx[r], o[r], d[r]),
                                   _tri_t(geo, ref_idx[r], o[r], d[r]), rtol=rtol,
                                   err_msg=f"ray {r}: winners differ off a tie")


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([-7, -20, 1], [7, 19, 16], size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_pack_triangles_matches_jax(scenes):
    js, ps = scenes
    ref = np.asarray(jpanel.pack_triangles(js.geometry))
    got = ppanel.pack_triangles(ps.geometry).numpy()
    assert got.shape == (40, 9)
    np.testing.assert_array_equal(got, ref[:, :9])


@pytest.mark.parametrize("n,seed,cull", [(2048, 0, False), (100, 5, False),
                                         (1024, 3, True)])
def test_panel_closest_matches_jax(scenes, n, seed, cull):
    """Closest hits of random rays through the room (n = 100: a ragged
    count, not a multiple of any tile): hit and winner equal, t to 1e-5."""
    js, ps = scenes
    o, d = _random_rays(n, seed)
    tri_j = jpanel.pack_triangles(js.geometry)
    ref = jpanel.intersect_panel(jnp.asarray(o), jnp.asarray(d), js.geometry, tri_j,
                                 t_max=1e5, backface_cull=cull)
    before = {k: build.LAUNCHES[k] for k in ("panel_closest", "panel_any")}
    got = ppanel.intersect_panel(torch.from_numpy(o), torch.from_numpy(d), ps.geometry,
                                 ppanel.pack_triangles(ps.geometry), t_max=1e5,
                                 backface_cull=cull)
    assert {k: build.LAUNCHES[k] for k in before} == before  # the CPU takes the plain version
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    assert_same_winners(ps.geometry, got.tri_idx.numpy(), np.asarray(ref.tri_idx),
                        got.hit.numpy(), o, d)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    assert got.hit.float().mean() > 0.3


def test_panel_occlusion_matches_jax(scenes):
    js, ps = scenes
    o, d = _random_rays(1024, seed=2)
    limit = np.full((1024,), 6.0, np.float32)
    limit[::7] = np.inf                        # whole-ray queries
    tri_j = jpanel.pack_triangles(js.geometry)
    ref = jpanel.occluded_panel(jnp.asarray(o), jnp.asarray(d), jnp.asarray(limit),
                                js.geometry, tri_j)
    got = ppanel.occluded_panel(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(limit), ps.geometry,
                                ppanel.pack_triangles(ps.geometry))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.float().mean() < 0.95


def test_panel_plain_agrees_with_brute(scenes):
    """run_panel_plain against the all-pairs oracle (intersect_brute) with
    a per-ray t_init: same winners, same t (the oracle recomputes t on
    the winner by the same arithmetic)."""
    _, ps = scenes
    o, d = (torch.from_numpy(a) for a in _random_rays(512, seed=8))
    tris = ppanel.pack_triangles(ps.geometry)
    t_init = torch.full((512,), 1e5)
    t, idx = ppanel.run_panel_plain(tris, o, d, t_init, False)
    brute = P.intersect_brute(o, d, ps.geometry, t_max=1e5)
    np.testing.assert_array_equal((idx >= 0).numpy(), brute.hit.numpy())
    hit = brute.hit
    np.testing.assert_array_equal(idx[hit].numpy(), brute.tri_idx[hit].numpy())
    np.testing.assert_array_equal(t[hit].numpy(), brute.t[hit].numpy())
    # A t_init below the hit turns it into a miss that reports t_init.
    t2, idx2 = ppanel.run_panel_plain(tris, o, d, t * 0.5, False)
    assert (idx2[hit] == -1).all()
    np.testing.assert_array_equal(t2[hit].numpy(), (t * 0.5)[hit].numpy())


def test_wrappers_check_inputs(scenes):
    _, ps = scenes
    tris = ppanel.pack_triangles(ps.geometry)
    o = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        ppanel.panel_closest(tris, o.double(), o, torch.zeros(4))
    with pytest.raises(ValueError):
        ppanel.panel_closest(tris, o, o, torch.zeros(5))
    with pytest.raises(ValueError):
        ppanel.panel_closest(torch.zeros((2049, 9)), o, o, torch.zeros(4))


@pytest.mark.parametrize("kw", [{}, dict(shadow_rays=True, direct_specular=True)])
def test_pallas_render_matches_jax(scenes, kw):
    """render_sample with backend="pallas" on Cornell (36 triangles: the
    panel serves it), 32x32 x 2 bounces, against JAX pallas."""
    js, ps = scenes
    cfg = dict(width=32, height=32, bounces=2, backend="pallas", **kw)
    ref = np.asarray(J.render_sample(js, J.Camera.default(), J.RenderConfig(**cfg),
                                     frame=2))
    got = P.render_sample(ps, P.Camera.default(device="cpu"), P.RenderConfig(**cfg),
                          frame=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_pallas_matches_mega_on_cpu(scenes):
    """The wavefront integrator on the panel and the mega path's plain
    versions run the same arithmetic on the same RNG draws."""
    _, ps = scenes
    cam = P.Camera.default(device="cpu")
    kw = dict(width=24, height=16, bounces=3, shadow_rays=True)
    pal = P.render_sample(ps, cam, P.RenderConfig(backend="pallas", **kw), frame=1)
    mega = P.render_sample(ps, cam, P.RenderConfig(backend="mega", **kw), frame=1)
    np.testing.assert_allclose(pal.numpy(), mega.numpy(), atol=ATOL, rtol=RTOL)
