"""The per-warp ray-bundle cull of the panel and first-bounce kernels
(csrc/bundle.cuh) through its model, ops/cuda/bundle_cull.py, on the CPU;
and the cluster walk (K6) at grazing incidence.

The cull may keep too much, never too little, so the model's (t, idx)
must equal the plain version's (run_panel_plain) bit for bit, on the
Cornell wavefront's rays and on adversarial sets (ops/cuda/parity
.cull_ray_sets). Against the JAX package (Pallas in interpret mode) the
tolerances of tests/test_torch_panel.py hold: t to 1e-5 relative, winners
equal except on knife-edge ties.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu.ops.pallas import panel as jpanel
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops import rng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
from mini_opencl_raytracer_tpu_torch.ops.cuda import bundle_cull as bc
from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as pcl
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from mini_opencl_raytracer_tpu_torch.ops.cuda import panel as ppanel
from mini_opencl_raytracer_tpu_torch.ops.cuda import parity
from mini_opencl_raytracer_tpu_torch.ops.cuda.clustered_walk import walk
from mini_opencl_raytracer_tpu_torch.ops.intersect import ray_triangle_edges
from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids

from test_torch_panel import _arrays, assert_same_winners

torch.set_num_threads(1)

ADVERSARIAL = ("vertices_edges", "coplanar", "grazing", "signed_zeros", "open_limits",
               "padding", "soup2048")
WAVEFRONT = ("primary", "bounce1", "bounce1_sorted", "shadow")


@pytest.fixture(scope="module")
def ray_sets():
    """name -> (records [T_pad, 9], o, d, limit): Cornell's 64x64 wavefront
    rays in tile order (primary, bounce-1 in pixel order and sorted, shadow
    rays toward light 0) and the adversarial sets."""
    cornell = P.cornell_scene(device="cpu")
    cam = P.Camera.default(device="cpu")
    cfg = P.RenderConfig(width=64, height=64)
    rays = parity.wavefront_rays(cornell, cam, cfg,
                                 *ppanel.make_intersectors(cornell.geometry, cfg))
    tris = ppanel.pack_triangles(cornell.geometry)
    out = {}
    for name in WAVEFRONT:
        r = rays[name]
        o, d = r[0], r[1]
        limit = r[2] if name == "shadow" else torch.full((o.shape[0],), cfg.t_max)
        out[name] = (tris, o, d, limit)
    for name, (geo, o, d, limit) in parity.cull_ray_sets("cpu").items():
        out[name] = (ppanel.pack_triangles(geo), o, d, limit)
    return out


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("name", WAVEFRONT + ADVERSARIAL)
def test_cull_matches_plain(ray_sets, name, mode, cull):
    """Closest mode: (t, idx) bitwise equal to run_panel_plain's. Any mode:
    the same rays blocked, and the first kept record that blocks is one
    the exact test accepts below the limit."""
    tris, o, d, limit = ray_sets[name]
    p_t, p_idx = ppanel.run_panel_plain(tris, o, d, limit, cull)
    t, idx, tests = bc.cull_hits(tris, o, d, limit, cull, any_hit=(mode == "any"))
    if mode == "closest":
        assert torch.equal(t, p_t) and torch.equal(idx, p_idx)
    else:
        assert torch.equal(idx >= 0, p_idx >= 0)
        hit = idx >= 0
        t_k, _, _, ok = ray_triangle_edges(o[hit], d[hit], tris[idx[hit].long(), 0:3],
                                           tris[idx[hit].long(), 3:6],
                                           tris[idx[hit].long(), 6:9], cull)
        assert bool(ok.all()) and torch.equal(t_k, t[hit]) and bool((t[hit] < limit[hit]).all())
    assert int(tests.max()) <= tris.shape[0] and bool((p_idx >= 0).any())


@pytest.mark.parametrize("name", WAVEFRONT + ADVERSARIAL)
def test_cull_keeps_every_accepted_pair(ray_sets, name):
    """Stronger than equal results: every (ray, record) pair that the exact
    test accepts below the ray's limit, with or without backface culling,
    is kept for the ray's warp."""
    tris, o, d, limit = ray_sets[name]
    kept, _ = bc.candidates(tris, o, d, limit, torch.ones(o.shape[0], dtype=torch.bool))
    mine = kept[torch.arange(o.shape[0]) // bc.WARP]
    for cull in (False, True):
        t, _, _, ok = ray_triangle_edges(o[:, None], d[:, None], tris[None, :, 0:3],
                                         tris[None, :, 3:6], tris[None, :, 6:9], cull)
        ok &= t < limit[:, None]
        assert not bool((ok & ~mine).any())


def test_counts_on_main_path_primary_rays():
    """On primary rays of the 1080p main path (a window of 4096 in
    render_sample's tile order, through the box and beside it), a ray
    runs fewer than 4 M-T tests, where the dense loop runs all 40 records."""
    cfg = P.RenderConfig(width=1920, height=1080)
    pid = _swizzled_ids(cfg, torch.device("cpu"))[1_000_000:1_004_096]
    o, d = generate_rays(P.Camera.default(device="cpu"), cfg, pid, rng.pixel_seeds(pid, 0))
    o, d = o.contiguous(), d.contiguous()
    tris = ppanel.pack_triangles(P.cornell_scene(device="cpu").geometry)
    limit = torch.full((o.shape[0],), cfg.t_max)
    t, idx, tests = bc.cull_hits(tris, o, d, limit, False)
    p_t, p_idx = ppanel.run_panel_plain(tris, o, d, limit, False)
    assert torch.equal(t, p_t) and torch.equal(idx, p_idx)
    assert 0.2 < (idx >= 0).float().mean() < 0.9
    assert tris.shape[0] == 40 and tests.float().mean() < 4.0


def test_bundles_dense_and_empty():
    """A warp goes dense when its directions straddle 0 on two axes or a
    live ray is not finite, and tests nothing when it has no live ray;
    dense warps test every record, in ascending order."""
    tris = ppanel.pack_triangles(P.cornell_scene(device="cpu").geometry)
    gen = np.random.default_rng(1)
    o = torch.tensor(gen.uniform([-7, 1, 1], [7, 19, 16], (128, 3)), dtype=torch.float32)
    d = torch.tensor(gen.normal(size=(128, 3)), dtype=torch.float32)
    d[32:64] = torch.tensor([0.1, 1.0, 0.2])          # one direction: culled
    o[70, 1] = float("nan")                            # warp 2 has a NaN origin
    live = torch.ones((128,), dtype=torch.bool)
    live[96:] = False                                  # warp 3 has no live ray
    limit = torch.full((128,), 1e5)
    *_, dense, empty = bc.bundles(o, d, limit, live)
    assert dense.tolist() == [True, False, True, False]
    assert empty.tolist() == [False, False, False, True]
    t, idx, tests = bc.cull_hits(tris, o, d, limit, False, live=live)
    assert (tests[:32] == 40).all() and (tests[96:] == 0).all() and (idx[96:] == -1).all()
    assert int(tests[32:64].max()) < 40


def test_cull_hits_matches_jax():
    """The slice's intersection with the cull against the JAX package's
    panel (Pallas, interpret mode) on the same seeded rays through the
    room and the camera's 32x32 rays."""
    js = J.cornell_scene()
    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    gen = np.random.default_rng(7)
    cfg = P.RenderConfig(width=32, height=32)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32)
    o_c, d_c = generate_rays(P.Camera.default(device="cpu"), cfg, pid, rng.pixel_seeds(pid, 0))
    o_r = gen.uniform([-7, -20, 1], [7, 19, 16], (1024, 3)).astype(np.float32)
    d_r = gen.normal(size=(1024, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = np.concatenate([o_c.numpy(), o_r]).astype(np.float32)
    d = np.concatenate([d_c.numpy(), d_r]).astype(np.float32)
    ref = jpanel.intersect_panel(jnp.asarray(o), jnp.asarray(d), js.geometry,
                                 jpanel.pack_triangles(js.geometry), t_max=1e5)
    limit = torch.full((o.shape[0],), 1e5)
    t, idx, _ = bc.cull_hits(ppanel.pack_triangles(ps.geometry), torch.from_numpy(o),
                             torch.from_numpy(d), limit, False)
    hit = (idx >= 0).numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    assert_same_winners(ps.geometry, idx.numpy(), np.asarray(ref.tri_idx), hit, o, d)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)


def test_stats_are_counted_by_the_kernels_only():
    """stats= asks the kernels for their counts; on the CPU it raises."""
    scene = P.cornell_scene(device="cpu")
    tris = ppanel.pack_triangles(scene.geometry)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="stats"):
        ppanel.panel_closest(tris, o, o, torch.ones(4), stats=torch.zeros(4, dtype=torch.int32))
    cfg = P.RenderConfig(width=4, height=1)
    table, mtris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device="cpu"))
    with pytest.raises(ValueError, match="stats"):
        pmk.bounce0_fwd(table, mtris, lv, camv, torch.arange(4, dtype=torch.int32), 0, cfg,
                        stats=torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("cos", [1e-2, 1e-3, 1e-4])
@pytest.mark.parametrize("layout", ["sah", "morton"])
def test_walk_matches_plain_at_grazing(layout, cos):
    """K6 at grazing incidence: near-tie rays (aimed at points of edges
    shared by two triangles, often in two clusters, whose t differ by a few
    ulps) meet a bumpy surface at cos down to 1e-4. The model of the
    kernel's walk gives the plain version's (t, slot) on every ray."""
    geo, pts, tris, nrm = parity.grazing_surface()
    cg = pcl.build_accel(geo) if layout == "sah" else pcl.build_clusters(geo)
    o, d = parity.grazing_rays(pts, tris, nrm, cos)
    t_init = torch.full((o.shape[0],), 1e5)
    p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, t_init, False)
    w_t, w_slot, _ = walk(cg, o, d, t_init)
    assert (p_slot >= 0).float().mean() > 0.8
    assert torch.equal(w_slot, p_slot) and torch.equal(w_t, p_t)


@pytest.mark.parametrize("cos", [1e-3, 1e-4])
def test_walk_finds_the_grazed_triangle_behind_a_decoy(cos):
    """K6 at grazing incidence against a decoy (parity.grazing_decoys):
    F's Möller–Trumbore t lies more than 0.05% of t below the decoy's, and
    the entry of F's box more than 0.1% beyond it, so a cull by the best t
    with a slack of 1e-4 of t would drop F's cluster after the decoy's hit.
    The model of the kernel's walk returns the plain version's (t, slot),
    F, closest and any-hit, in every scene."""
    cases = parity.grazing_decoys("cpu", cos)
    assert len(cases) >= (1 if cos == 1e-3 else 8)
    for cg, o, d, t_f, t_dec, entry in cases:
        assert 1.0005 * t_f < t_dec and entry > 1.001 * t_dec
        t_init = torch.full((1,), 1e5)
        p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, t_init, False)
        w_t, w_slot, stats = walk(cg, o, d, t_init)
        assert p_slot.item() == pcl.CLUSTER and p_t.item() == t_f
        assert torch.equal(w_slot, p_slot) and torch.equal(w_t, p_t)
        assert stats[0, 1].item() == 2
        _, a_slot, _ = walk(cg, o, d, t_init, any_hit=True)
        assert a_slot.item() >= 0
