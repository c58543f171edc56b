"""The CUDA kernels (the bounce kernels forward and backward, the panel
and cluster-traversal intersectors) against their plain versions on a
GPU.

Marked ``cuda``; skips without a CUDA device (the kernels have no CPU
mode). The unmarked tests check, on the CPU, that the card cases below
exercise what they are meant to, and the backward wrappers' launch plan.
This file imports neither JAX nor the JAX
package, so it runs on a machine without JAX; tests/conftest.py imports
JAX, hence:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Gate: ops/cuda/parity.py, the one chip_smoke.py applies (seeds bit-exact,
winners equal on >= 99.99% of rays, every float output with mean |diff|
<= 1e-4 and frac(|diff| > 1e-3) <= 1e-4, any-hit occlusion equal). At
128x128 the tail bound lets 4 of the 49152 entries of a [3, R] output
differ, and the winner bound 1 of the 16384 rays.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import native as pnative
from mini_opencl_raytracer_tpu_torch.ops import integrator, rng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays, rays_from_basis
from mini_opencl_raytracer_tpu_torch.ops.cuda import bundle_cull as bc
from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as pcl
from mini_opencl_raytracer_tpu_torch.ops.cuda.clustered_walk import walk
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from mini_opencl_raytracer_tpu_torch.ops.cuda import panel as ppanel
from mini_opencl_raytracer_tpu_torch.ops.cuda import parity
from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {},
    dict(shadow_rays=True, direct_specular=True, specular_model="ggx"),
    dict(soft_edge_sigma=0.05, backface_cull=True),
])
def test_kernels_match_plain_on_card(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = P.RenderConfig(width=128, height=128, **kw)
    table, tris, lv = pmk._tables(P.cornell_scene(device=dev), cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device=dev))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    n0 = dict(pmk.LAUNCHES)
    k0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 1, cfg)
    p0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
    state = (k0[0], k0[1], k0[2], k0[3], k0[7])
    k1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    p1 = pmk.bounce_fwd_plain(table, tris, lv, *state, 1, cfg)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES == dict(n0, bounce0_fwd=n0["bounce0_fwd"] + 1,
                                bounce_fwd=n0["bounce_fwd"] + 1)
    parity.check_bounce("bounce0_fwd", k0, p0)
    parity.check_bounce("bounce_fwd", k1, p1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {},
    dict(shadow_rays=True, direct_specular=True, specular_model="ggx"),
    dict(soft_edge_sigma=0.05, backface_cull=True),
])
def test_backward_kernels_match_plain_on_card(kw):
    """bounce0_bwd and bounce_bwd against their plain versions at 128x128,
    under parity.check_grads (per-ray mean and tail bounds scaled by the
    largest plain value; reduced outputs within 2e-3 of the largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = P.RenderConfig(width=128, height=128, **kw)
    table, tris, lv = pmk._tables(P.cornell_scene(device=dev), cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device=dev))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    f0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 1, cfg)
    cot0 = parity.cotangents(f0[2], gen)
    n0 = dict(pmk.LAUNCHES)
    k0 = pmk.bounce0_bwd(table, lv, camv, pid, 1, f0[5], f0[6], cot0, cfg)
    p0 = pmk.bounce0_bwd_plain(table, lv, camv, pid, 1, f0[5], f0[6], cot0, cfg)
    state = (f0[0], f0[1], f0[2], f0[3], f0[7])
    f1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    cot1 = parity.cotangents(f1[2], gen)
    n1 = dict(pmk.LAUNCHES)
    k1 = pmk.bounce_bwd(table, lv, *state[:4], f0[7], f1[5], f1[6], cot1, 1, cfg)
    p1 = pmk.bounce_bwd_plain(table, lv, *state[:4], f0[7], f1[5], f1[6], cot1, 1, cfg)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES["bounce0_bwd"] == n0["bounce0_bwd"] + 1
    assert pmk.LAUNCHES["bounce_bwd"] == n1["bounce_bwd"] + 1
    parity.check_grads("bounce0_bwd", k0, p0, parity.BOUNCE0_GRADS)
    parity.check_grads("bounce_bwd", k1, p1, parity.BOUNCE_GRADS)


# The backward kernels' reduction cases: (scene, cfg, pixel ids, bounce
# whose state is killed). 16:9 like the main path, so many primary rays see
# the sky.
_W, _H = 128, 72
REDUCTION_CASES = ("shuffled", "soup2048", "soup512", "dead", "lights30")


def _reduction_case(name, dev):
    cfg = P.RenderConfig(width=_W, height=_H)
    ids = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    if name == "shuffled":
        return P.cornell_scene(device=dev), cfg, parity.shuffled_ids(cfg.num_pixels, 11, dev)
    if name.startswith("soup"):
        return parity.soup_scene(dev, n=int(name[4:])), cfg, ids
    if name == "lights30":
        return parity.many_light_scene(dev), dataclasses.replace(cfg, shadow_rays=True), ids
    return P.cornell_scene(device=dev), cfg, ids   # dead: bounce 1 with no ray alive


def _bwd_inputs(name, dev):
    """Forward state, winners and seeded cotangents of a reduction case:
    (args of bounce0_bwd, args of bounce_bwd at bounce 1)."""
    scene, cfg, pid = _reduction_case(name, dev)
    table, tris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device=dev))
    f0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    args0 = (table, lv, camv, pid, 1, f0[5], f0[6], parity.cotangents(f0[2], gen), cfg)
    f1 = pmk.bounce_fwd_plain(table, tris, lv, f0[0], f0[1], f0[2], f0[3], f0[7], 1, cfg)
    alive, winner = f0[3], f1[5]
    if name == "dead":
        alive, winner = torch.zeros_like(alive), torch.full_like(winner, -1)
    args1 = (table, lv, f0[0], f0[1], f0[2], alive, f0[7], winner, f1[6],
             parity.cotangents(f1[2], gen), 1, cfg)
    return args0, args1


@pytest.mark.parametrize("T_pad", [8, 40, 2048])
@pytest.mark.parametrize("R", [1, 255, 2_073_600])
def test_bwd_plan(T_pad, R):
    """The backward wrappers' launch plan on a 132-SM card: a persistent
    grid of at most two blocks per SM and no more than one per tile of 256
    rays; partial rows of T_pad * 32 + L * 16 (+ 16 camera) floats; the
    table partial in shared memory up to T_pad 512. The scratch does not
    grow with R past the grid."""
    for first in (True, False):
        plan = pmk.bwd_plan(R, T_pad, 30, 132, first)
        assert plan.grid == min(-(-R // 256), 264) >= 1
        assert plan.part_cols == T_pad * 32 + 30 * 16 + (16 if first else 0)
        assert plan.smem_table == (T_pad <= 512)
        assert plan.grid * plan.part_cols * 4 <= 264 * (2048 * 32 + 30 * 16 + 16) * 4
    assert pmk.bwd_plan(R, 8, 1, 132, False).grid == plan.grid


def test_shuffled_ids_scatter_winners():
    """The shuffled case is incoherent: at bounce 1 every 32-ray group has
    at least 2 distinct live winners and 6.71 on average (measured on the
    plain path), where the tile order that render_sample passes gives 3.34
    on average and none in most groups (their rays see the sky)."""
    args0, args1 = _bwd_inputs("shuffled", "cpu")
    scene, cfg, _ = _reduction_case("shuffled", "cpu")
    table, tris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device="cpu"))

    def distinct(pid):
        f0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
        f1 = pmk.bounce_fwd_plain(table, tris, lv, *f0[:4], f0[7], 1, cfg)
        return torch.tensor([len(set(g[g >= 0].tolist())) for g in f1[5].reshape(-1, 32)])

    shuffled = distinct(args0[3])
    tiled = distinct(_swizzled_ids(cfg, "cpu"))
    assert shuffled.min().item() >= 2 and shuffled.float().mean().item() >= 6.5
    assert tiled.float().mean().item() < 4.0 and tiled.float().median().item() == 0


def test_reduction_cases_hit_their_branches():
    """Each table branch of the backward kernels has a card case: the
    2048-triangle soup (the mega path's limit) keeps its table partial in
    global memory, the 512-triangle soup in shared memory at the branch's
    limit, Cornell (T_pad 40) in shared memory; the dead case has no ray
    alive."""
    want = {"soup2048": (2048, False), "soup512": (512, True), "shuffled": (40, True)}
    for name, (T_pad, smem) in want.items():
        args0, _ = _bwd_inputs(name, "cpu")
        assert args0[0].shape[0] == T_pad
        assert pmk.bwd_plan(args0[3].shape[0], T_pad, 1, 132, True).smem_table == smem
    _, args1 = _bwd_inputs("dead", "cpu")
    assert not (args1[5] > 0).any() and (args1[7] < 0).all()


def test_many_lights_case_is_live():
    """The 30-light case (the mega path's limit) with shadow rays: all three
    light types, and at bounce 0 each light is blocked for some live rays
    and seen by others, so the kernels' light loop and occlusion replay run
    on every light."""
    args0, _ = _bwd_inputs("lights30", "cpu")
    table, lv, _, _, _, winner, occ = args0[:7]
    assert lv.shape[0] == 30 and set(lv[:, 6].round().int().tolist()) == {0, 1, 2}
    live = winner >= 0
    bits = torch.stack([(occ[live] >> li) & 1 for li in range(30)])
    assert bool((bits.amax(1) == 1).all()) and bool((bits.amin(1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", REDUCTION_CASES)
def test_backward_reduction_cases_on_card(name, monkeypatch):
    """bounce0_bwd and bounce_bwd on the reduction cases against their
    plain versions under parity.check_grads, bitwise equal to a second run,
    and, where the table partial fits shared memory, bitwise equal to the
    global-memory branch (same order of sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args0, args1 = _bwd_inputs(name, torch.device("cuda"))
    for kernel, plain, args, names in ((pmk.bounce0_bwd, pmk.bounce0_bwd_plain, args0,
                                        parity.BOUNCE0_GRADS),
                                       (pmk.bounce_bwd, pmk.bounce_bwd_plain, args1,
                                        parity.BOUNCE_GRADS)):
        k, k2, p = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        parity.check_grads(f"{kernel.__name__}, {name}", k, p, names)
        assert all(torch.equal(a, b) for a, b in zip(k, k2))
        if args[0].shape[0] <= pmk._SMEM_ROWS:
            monkeypatch.setattr(pmk, "_SMEM_ROWS", 0)
            k3 = kernel(*args)
            monkeypatch.undo()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(k, k3))


def _camera_and_room_rays(dev, n=16384, seed=0):
    """Camera rays at 128x128 and seeded rays from points in the room."""
    cfg = P.RenderConfig(width=128, height=128)
    ids = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    o, d = generate_rays(P.Camera.default(device=dev), cfg, ids, rng.pixel_seeds(ids, 1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([-7.0, 1.0, 1.0], device=dev)
    hi = torch.tensor([7.0, 19.0, 16.0], device=dev)
    o2 = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    d2 = torch.randn((n, 3), generator=gen, device=dev)
    d2 = d2 / torch.linalg.norm(d2, dim=1, keepdim=True)
    return ((o.contiguous(), d.contiguous()), (o2, d2))


@pytest.mark.cuda
@pytest.mark.parametrize("cull", [False, True])
def test_panel_kernel_matches_plain_on_card(cull):
    """panel_closest / panel_any (K5) on Cornell against run_panel_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    tris = ppanel.pack_triangles(P.cornell_scene(device=dev).geometry)
    for o, d in _camera_and_room_rays(dev):
        R = o.shape[0]
        t_init = torch.full((R,), 1e5, device=dev)
        n0 = dict(ppanel.LAUNCHES)
        k = ppanel.panel_closest(tris, o, d, t_init, cull)
        p = ppanel.run_panel_plain(tris, o, d, t_init, cull)
        limit = torch.full((R,), 6.0, device=dev)
        k_any = ppanel.panel_any(tris, o, d, limit, cull)
        p_any = ppanel.run_panel_plain(tris, o, d, limit, cull)[1] >= 0
        torch.cuda.synchronize()
        assert ppanel.LAUNCHES == {"panel_closest": n0["panel_closest"] + 1,
                                   "panel_any": n0["panel_any"] + 1}
        parity.check_hits("panel_closest", k, p)
        parity.check_any("panel_any", k_any, p_any)


def _ragged_soup(dev, n=20_000, seed=5):
    """A seeded soup of ``n`` triangles spread through the room: at 20,000
    triangles 157 Morton clusters in 3 supers, or some 230 SAH leaves in
    4, cluster counts that are no power of the tree's arity."""
    r = np.random.default_rng(seed)
    base = r.uniform([-8, 0, 0], [8, 20, 17], size=(n, 3)).astype(np.float32)
    v1 = base + r.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    v2 = base + r.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    z3 = torch.zeros((n, 3), device=dev)
    z2 = torch.zeros((n, 2), device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    return P.Geometry(v0=t(base), v1=t(v1), v2=t(v2), n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2,
                      uv2=z2, mat_idx=torch.zeros((n,), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("layout", ["sah", "morton"])
def test_ragged_soup_is_ragged(layout):
    """The card case below spans several supers, and its real cluster
    count is no power of the tree's arity: the tree has empty padding."""
    if layout == "sah" and not pnative.available():
        pytest.skip("no C++ compiler: the native SAH library is unavailable")
    build = pcl.build_accel if layout == "sah" else pcl.build_clusters
    cg = build(_ragged_soup(torch.device("cpu")))
    real = int((cg.cl_count > 0).sum())
    assert cg.num_supers >= 3
    assert pcl.ARITY ** round(np.log(real) / np.log(pcl.ARITY)) != real
    assert bool((cg.tree[:, 0] >= 1e38).any())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sah", "morton"])
def test_clustered_kernel_matches_plain_on_card(layout):
    """clustered_closest (rows included) / clustered_any (K6) against
    run_clustered_plain, bitwise, on the bunny scene at 4000 triangles and
    on the ragged soup (several supers); the per-ray counts [R, 3] in both
    modes equal those of the model of the walk; and the same rays sorted
    by the wavefront's coherence key or shuffled give bitwise the same
    per-ray outputs and counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    build = pcl.build_accel if layout == "sah" else pcl.build_clusters
    bunny = P.bunny_scene(target_tris=4000, device=dev)
    for geo, mats in ((bunny.geometry, bunny.materials), (_ragged_soup(dev), None)):
        cg = build(geo, materials=mats)
        pts = torch.cat([geo.v0, geo.v1, geo.v2])
        blocked = []
        for o, d in _camera_and_room_rays(dev):
            R = o.shape[0]
            t_init = torch.full((R,), 1e5, device=dev)
            limit = torch.full((R,), 6.0, device=dev)
            st, st_any = (torch.zeros((R, 3), dtype=torch.int32, device=dev) for _ in range(2))
            n0 = dict(pcl.LAUNCHES)
            k = pcl.clustered_closest(cg, o, d, t_init, stats=st)
            k_any = pcl.clustered_any(cg, o, d, limit, stats=st_any)
            torch.cuda.synchronize()
            assert pcl.LAUNCHES == {"clustered_closest": n0["clustered_closest"] + 1,
                                    "clustered_any": n0["clustered_any"] + 1}
            p = pcl.run_clustered_plain(cg, o, d, t_init, False, with_rows=mats is not None)
            p_any = pcl.run_clustered_plain(cg, o, d, limit, False)[1] >= 0
            parity.check_hits("clustered_closest", k, p)
            assert all(torch.equal(a, b) for a, b in zip(k, p) if a is not None)
            assert (k[2] is None) == (mats is None)
            assert torch.equal(k_any, p_any)
            blocked.append(k_any.float().mean().item())
            assert torch.equal(st, walk(cg, o, d, t_init)[2])
            assert torch.equal(st_any, walk(cg, o, d, limit, any_hit=True)[2])
            keys = integrator._ray_sort_keys(o, d, pts.amin(0), pts.amax(0))
            gen = torch.Generator(device=dev).manual_seed(3)
            for perm in (torch.sort(keys, stable=True).indices,
                         torch.randperm(R, generator=gen, device=dev)):
                st_p = torch.zeros_like(st)
                kp = pcl.clustered_closest(cg, o[perm].contiguous(), d[perm].contiguous(),
                                           t_init, stats=st_p)
                assert all(torch.equal(a, b[perm]) for a, b in zip(kp, k) if a is not None)
                assert torch.equal(st_p, st[perm])
        assert 0.0 < max(blocked) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sah", "morton"])
def test_clustered_kernel_keeps_out_of_the_leaf_padding_on_card(layout):
    """K6 at a limit of inf and of 3e38 on a soup whose tree pads its leaf
    level (2 or 3 supers of 4**4 leaf slots), on rays in the positive
    octant, half along (1, 1, 1), where a far-point box passes the slab
    test: bitwise run_clustered_plain's (t, slot) and any-hit, and the
    counts of the model of the walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    build = pcl.build_accel if layout == "sah" else pcl.build_clusters
    cg = build(_ragged_soup(dev, n=15_000))
    assert pcl.ARITY ** cg.depth > cg.cl_count.shape[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    n = 8192
    lo = torch.tensor([-7.0, -20.0, 1.0], device=dev)
    hi = torch.tensor([7.0, 19.0, 16.0], device=dev)
    o = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    d = 0.1 + 0.9 * torch.rand((n, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    d[: n // 2] = 1.0
    for limit in (float("inf"), 3.0e38):
        ti = torch.full((n,), limit, device=dev)
        st = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        k_t, k_slot, _ = pcl.clustered_closest(cg, o, d, ti, stats=st)
        k_any = pcl.clustered_any(cg, o, d, ti)
        p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, ti, False)
        assert torch.equal(k_t, p_t) and torch.equal(k_slot, p_slot)
        assert torch.equal(k_any, p_slot >= 0)
        assert torch.equal(st, walk(cg, o, d, ti)[2])
        assert 0.0 < (p_slot >= 0).float().mean().item() < 1.0


@pytest.mark.cuda
def test_sorted_wavefront_bitwise_on_card():
    """The sorted and unsorted wavefronts give bitwise equal pixels on the
    card, through the cluster-traversal kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene = P.bunny_scene(target_tris=4000, device=dev)
    cam = P.Camera.default(device=dev)
    kw = dict(width=64, height=64, bounces=4, shadow_rays=True)
    accel = P.build_accel(scene, P.RenderConfig(**kw))
    n0 = pcl.LAUNCHES["clustered_closest"]
    imgs = [P.render_sample(scene, cam, P.RenderConfig(sort_rays=s, **kw), accel=accel)
            for s in (True, False)]
    assert pcl.LAUNCHES["clustered_closest"] == n0 + 8
    assert torch.equal(imgs[0], imgs[1])


# A ray starting 2.3e-4 before a tilted triangle F, next to the corner
# that bounds F's box (float32 values): Moller-Trumbore puts the hit about
# 1.2% of t below the slab entry of F's box.
_F = ((2.98009991645813, -9.715656280517578, -4.385581016540527),
      (6.7950758934021, -7.85994815826416, -7.030585289001465),
      (-0.21197199821472168, -10.590027809143066, -7.030278205871582))
_O = (6.792333126068115, -7.860908508300781, -7.03060245513916)
_D = (-0.68116694688797, -0.7285225987434387, 0.07257002592086792)
_T_DECOY = 0.000235


def short_range_case():
    """(geometry, accel, o, d) on the CPU: F is triangle 0, alone in
    cluster 1; triangle 1 is a small decoy facing the ray at t = 2.35e-4,
    between F's hit and F's box entry, alone in cluster 0, which the
    kernel visits first. The closest hit is F; a cull bound of best t x
    (1 + 1e-4) alone would drop F's cluster after the decoy's hit."""
    o, d = torch.tensor([_O]), torch.tensor([_D])
    a = torch.linalg.cross(d[0], torch.tensor([0.0, 0.0, 1.0]))
    a = a / torch.linalg.norm(a)
    b = torch.linalg.cross(d[0], a)
    c = o[0] + _T_DECOY * d[0]
    corners = [torch.stack([torch.tensor(v), w]) for v, w in
               zip(_F, (c + 1e-3 * a, c + 1e-3 * b, c - 1e-3 * (a + b)))]
    zeros3, zeros2 = torch.zeros((2, 3)), torch.zeros((2, 2))
    geo = P.Geometry(v0=corners[0], v1=corners[1], v2=corners[2], n0=zeros3, n1=zeros3,
                     n2=zeros3, uv0=zeros2, uv1=zeros2, uv2=zeros2,
                     mat_idx=torch.zeros((2,), dtype=torch.int32))
    leaves = (np.array([1, 0], np.int32), np.array([0, 1], np.int32),
              np.array([1, 1], np.int32))
    return geo, pcl.build_clusters(geo, leaf_info=leaves), o, d


def test_short_range_case_hits_below_its_box_entry():
    """The plain version and the oracle pick F, and the case is live: the
    decoy's t lies between F's M-T t and F's box entry / (1 + 1e-4)."""
    geo, cg, o, d = short_range_case()
    h = pcl.intersect_clustered(o, d, cg, t_max=1e5)
    brute = P.intersect_brute(o, d, geo, t_max=1e5)
    assert h.tri_idx.item() == brute.tri_idx.item() == 0
    assert h.t.item() == brute.t.item()
    t_decoy = P.intersect_brute(o, d, dataclasses.replace(
        geo, **{k: getattr(geo, k)[1:] for k in ("v0", "v1", "v2", "n0", "n1", "n2",
                                                  "uv0", "uv1", "uv2", "mat_idx")}),
        t_max=1e5).t.item()
    box = cg.cl_aabb[1]
    inv = 1.0 / d[0]
    t1, t2 = (box[0:3] - o[0]) * inv, (box[3:6] - o[0]) * inv
    entry = torch.minimum(t1, t2).max().clamp(min=0.0).item()
    assert h.t.item() < t_decoy < entry / (1.0 + 1e-4)


def test_walk_short_range_case():
    """The model of the kernel's walk finds F, as the plain version does:
    it visits the decoy's cluster first, then F's cluster, whose entry
    lies beyond the decoy's t."""
    _, cg, o, d = short_range_case()
    t_init = torch.full((1,), 1e5)
    t, slot, stats = walk(cg, o, d, t_init)
    p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, t_init, False)
    assert slot.item() == p_slot.item() == pcl.CLUSTER and t.item() == p_t.item()
    assert stats[0, 1].item() == 2


@pytest.mark.cuda
def test_clustered_short_range_hit_on_card():
    """K6 finds F, as its plain version does, though M-T puts F's hit
    below its box's entry by 1.2% of t."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _, cg, o, d = short_range_case()
    cg = pcl.ClusteredGeometry(**{f.name: (v.to(dev) if torch.is_tensor(v) else v)
                                  for f in dataclasses.fields(cg)
                                  for v in [getattr(cg, f.name)]})
    o, d = o.to(dev), d.to(dev)
    t_init = torch.full((1,), 1e5, device=dev)
    k_t, k_slot, _ = pcl.clustered_closest(cg, o, d, t_init)
    p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, t_init, False)
    torch.cuda.synchronize()
    assert p_slot.item() == pcl.CLUSTER            # F, the first slot of cluster 1
    assert k_slot.item() == p_slot.item() and k_t.item() == p_t.item()


CULL_SETS = ("vertices_edges", "coplanar", "grazing", "signed_zeros", "open_limits",
             "padding", "soup2048")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CULL_SETS)
def test_panel_cull_on_card(name):
    """K5 on the adversarial sets of its per-warp cull: (t, idx) bitwise
    equal to run_panel_plain's (closest mode), and t, idx and each ray's
    M-T count equal to the model of the cull (ops/cuda/bundle_cull.py) in
    closest and any mode, with and without backface culling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    geo, o, d, limit = parity.cull_ray_sets(dev)[name]
    tris = ppanel.pack_triangles(geo)
    R = o.shape[0]
    for cull in (False, True):
        st, sa = (torch.zeros((R,), dtype=torch.int32, device=dev) for _ in range(2))
        k = ppanel.panel_closest(tris, o, d, limit, cull, stats=st)
        ka = ppanel._run("panel_any", True, tris, o, d, limit, cull, sa)
        p = ppanel.run_panel_plain(tris, o, d, limit, cull)
        m = bc.cull_hits(tris, o, d, limit, cull)
        ma = bc.cull_hits(tris, o, d, limit, cull, any_hit=True)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert torch.equal(k[0], m[0]) and torch.equal(k[1], m[1]) and torch.equal(st, m[2])
        assert torch.equal(ka[0], ma[0]) and torch.equal(ka[1], ma[1]) and torch.equal(sa, ma[2])
        assert torch.equal(ka[1] >= 0, p[1] >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(3))
def test_bounce0_cull_on_card(case):
    """K1's cull on a 2048-triangle soup and under a camera grazing the
    floor (with backface culling and shadow rays in the last case), at
    128x128: every output bitwise equal to the plain version's, and
    without shadow rays each ray's M-T count equal to the model's on the
    plain version's camera rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    label, scene, cam, cfg = parity.k1_cull_cases(dev)[case]
    cfg = dataclasses.replace(cfg, width=128, height=128)
    table, tris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(cam)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    st = torch.zeros((cfg.num_pixels,), dtype=torch.int32, device=dev)
    k0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 2, cfg, stats=st)
    p0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 2, cfg)
    torch.cuda.synchronize()
    parity.check_bounce(f"bounce0_fwd, {label}", k0, p0)
    assert all(torch.equal(a, b) for a, b in zip(k0, p0)), label
    if not cfg.shadow_rays:
        seeds = rng.pixel_seeds(pid, 2)
        o, d = rays_from_basis(camv[0:3], camv[3:6], camv[6:9], camv[9:12], cfg, pid, seeds)
        limit = torch.full((cfg.num_pixels,), min(cfg.t_max, 3.0e38), device=dev)
        model = bc.cull_hits(tris, o.contiguous(), d.contiguous(), limit, cfg.backface_cull)[2]
        assert torch.equal(model, st), label
    assert 0 < st.float().mean() < tris.shape[0] + (2 * tris.shape[0] if cfg.shadow_rays else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sah", "morton"])
def test_clustered_grazing_on_card(layout):
    """K6 on near-tie rays grazing a bumpy surface at cos 1e-2 ... 1e-4
    (tests/test_torch_bundle_cull.py holds its walk's model to the plain
    version on the same rays): (t, slot) equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    geo, pts, tris, nrm = parity.grazing_surface()
    cg = pcl.build_accel(geo) if layout == "sah" else pcl.build_clusters(geo)
    cg = pcl.ClusteredGeometry(**{f.name: (v.to(dev) if torch.is_tensor(v) else v)
                                  for f in dataclasses.fields(cg)
                                  for v in [getattr(cg, f.name)]})
    for cos in (1e-2, 1e-3, 1e-4):
        o, d = (a.to(dev) for a in parity.grazing_rays(pts, tris, nrm, cos))
        t_init = torch.full((o.shape[0],), 1e5, device=dev)
        k_t, k_slot, _ = pcl.clustered_closest(cg, o, d, t_init)
        p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, t_init, False)
        torch.cuda.synchronize()
        assert torch.equal(k_slot, p_slot) and torch.equal(k_t, p_t), cos


@pytest.mark.cuda
@pytest.mark.parametrize("cos", [1e-3, 1e-4])
def test_clustered_grazing_decoy_on_card(cos):
    """K6 on the decoy scenes of parity.grazing_decoys (the CPU test
    tests/test_torch_bundle_cull.py::test_walk_finds_the_grazed_triangle_behind_a_decoy
    holds the walk's model on them): (t, slot) and the any-hit equal to
    the plain version's, F in every scene, both clusters visited."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cases = parity.grazing_decoys(dev, cos)
    assert cases
    for cg, o, d, t_f, _, _ in cases:
        t_init = torch.full((1,), 1e5, device=dev)
        stats = torch.zeros((1, 3), dtype=torch.int32, device=dev)
        k_t, k_slot, _ = pcl.clustered_closest(cg, o, d, t_init, stats=stats)
        k_any = pcl.clustered_any(cg, o, d, t_init)
        p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, t_init, False)
        torch.cuda.synchronize()
        assert p_slot.item() == pcl.CLUSTER and p_t.item() == t_f
        assert torch.equal(k_slot, p_slot) and torch.equal(k_t, p_t)
        assert bool(k_any.item()) and stats[0, 1].item() == 2
