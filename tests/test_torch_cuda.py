"""The CUDA kernels (the bounce kernels forward and backward, the panel
and cluster-traversal intersectors, the LBVH walk, the material gather's
backward, the wavefront's fused shading and its adjoint, the wavefront's
raygen) against their plain versions on a GPU, and the compiled programs (jit.py) against eager,
the parallel entry points included on an NCCL group of one process.

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
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch import native as pnative
from mini_opencl_raytracer_tpu_torch.ops import integrator, known, rng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays, rays_from_basis
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import bundle_cull as bc
from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as pcl
from mini_opencl_raytracer_tpu_torch.ops.cuda.clustered_walk import walk
from mini_opencl_raytracer_tpu_torch.ops.cuda import material_rows as pmr
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from mini_opencl_raytracer_tpu_torch.ops.cuda import panel as ppanel
from mini_opencl_raytracer_tpu_torch.ops.cuda import parity
from mini_opencl_raytracer_tpu_torch.ops.cuda import shade as pshade
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
    n0 = {k: v for k, v in build.LAUNCHES.items() if k.startswith("bounce")}
    k0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 1, cfg)
    p0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
    state = (k0[0], k0[1], k0[2], k0[3], k0[7])
    k1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    p1 = pmk.bounce_fwd_plain(table, tris, lv, *state, 1, cfg)
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] for k in n0} == dict(
        n0, bounce0_fwd=n0["bounce0_fwd"] + 1, bounce_fwd=n0["bounce_fwd"] + 1)
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
    n0 = dict(build.LAUNCHES)
    k0 = pmk.bounce0_bwd(table, lv, camv, pid, 1, f0[5], f0[6], cot0, cfg)
    p0 = pmk.bounce0_bwd_plain(table, lv, camv, pid, 1, f0[5], f0[6], cot0, cfg)
    state = (f0[0], f0[1], f0[2], f0[3], f0[7])
    f1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    cot1 = parity.cotangents(f1[2], gen)
    n1 = dict(build.LAUNCHES)
    k1 = pmk.bounce_bwd(table, lv, *state[:4], f0[7], f1[5], f1[6], cot1, 1, cfg)
    p1 = pmk.bounce_bwd_plain(table, lv, *state[:4], f0[7], f1[5], f1[6], cot1, 1, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bounce0_bwd"] == n0["bounce0_bwd"] + 1
    assert build.LAUNCHES["bounce_bwd"] == n1["bounce_bwd"] + 1
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


@pytest.mark.parametrize("R", [1, 255, 257, 2_073_600])
def test_k2_lane_model(R):
    """chip_smoke.lane_use, the model of how K2 fills its warps (tiles of
    128 rays; a tile packs its live rays into ceil(live / 32) warps where
    that is fewer than the warps holding them), on every ray dead, every
    ray alive and a seeded 10% alive: at R <= 257 its counts equal a count
    ray by ray; at any R packing runs no more warps than one thread a ray,
    at least ceil(live / 32), and fills them at least as well."""
    import chip_smoke
    tile, warps = chip_smoke.K2_TILE, -(-R // 32)
    gen = torch.Generator().manual_seed(R)
    for alive in (torch.zeros(R), torch.ones(R), (torch.rand(R, generator=gen) < 0.1).float()):
        u = chip_smoke.lane_use(torch, alive, tile)
        n = int(alive.sum().item())
        if R <= 257:
            before = now = 0
            for t0 in range(0, R, tile):
                tl = alive[t0:t0 + tile].tolist()
                hold = sum(any(tl[w:w + 32]) for w in range(0, len(tl), 32))
                before, now = before + hold, now + min(hold, -(-int(sum(tl)) // 32))
            assert (u["warps_before"], u["warps_now"]) == (before / warps, now / warps)
        assert u["live"] == n / R
        assert -(-n // 32) <= round(u["warps_now"] * warps) <= round(u["warps_before"] * warps)
        assert u["use_now"] >= u["use_before"]
        if n == R:
            assert u["warps_now"] == u["warps_before"] == 1.0


@pytest.mark.parametrize("name", parity.K2_CASES)
def test_k2_cases_are_what_they_say(name):
    """The edge cases that the card holds K2 to (below, and chip_smoke.py
    phase 3), built on the CPU at 64x36: which rays are alive, how many,
    the options, and a state the bounce can run."""
    scene, cfg, state, b = parity.k2_case(name, "cpu", 64, 36)
    o, d, beta, alive, seeds = state
    R = alive.numel()
    assert b == 1 and o.shape == d.shape == beta.shape == (3, R) and seeds.shape == (R,)
    assert all(x.is_contiguous() for x in state)
    frac = alive.mean().item()
    want = {"every ray dead": (0.0, 0.0), "every ray alive": (1.0, 1.0),
            "10% alive": (0.05, 0.15), "R=1": (1.0, 1.0)}.get(name, (0.1, 0.6))
    assert want[0] <= frac <= want[1], frac
    if name.startswith("R="):
        assert R == int(name[2:]) and alive[0] == 1.0
    else:
        assert R == 64 * 36
    assert cfg.shadow_rays == (name == "30 lights + shadow rays")
    assert scene.lights.count == (30 if cfg.shadow_rays else 1)
    assert cfg.backface_cull == (cfg.soft_edge_sigma > 0) == (name == "backface_cull + soft_edge")
    table, tris, lv = pmk._tables(scene, cfg, None)
    out = pmk.bounce_fwd(table, tris, lv, *state, b, cfg)
    assert ((out[5] >= 0) <= (alive > 0)).all() and torch.isfinite(out[4]).all()


def test_k2_ray_set_cases_are_live():
    """K2 on the adversarial rays of parity.cull_ray_sets (below, and
    chip_smoke.py phase 3), on the CPU: each set with and without backface
    culling, every ray alive at the limit 3e38, and most rays hitting."""
    cases = parity.k2_ray_set_cases("cpu")
    assert len(cases) == 2 * len(parity.cull_ray_sets("cpu"))
    for label, scene, cfg, state, b in cases:
        assert cfg.t_max == 3.0e38 and cfg.backface_cull == label.endswith("backface_cull")
        assert bool((state[3] == 1.0).all()) and b == 1
        table, tris, lv = pmk._tables(scene, cfg, None)
        out = pmk.bounce_fwd(table, tris, lv, *state, b, cfg)
        assert (out[5] >= 0).float().mean() > 0.75, label


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
        n0 = {k: build.LAUNCHES[k] for k in ("panel_closest", "panel_any")}
        k = ppanel.panel_closest(tris, o, d, t_init, cull)
        p = ppanel.run_panel_plain(tris, o, d, t_init, cull)
        limit = torch.full((R,), 6.0, device=dev)
        k_any = ppanel.panel_any(tris, o, d, limit, cull)
        p_any = ppanel.run_panel_plain(tris, o, d, limit, cull)[1] >= 0
        torch.cuda.synchronize()
        assert {k: build.LAUNCHES[k] for k in n0} == {"panel_closest": n0["panel_closest"] + 1,
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
    make_accel = pcl.build_accel if layout == "sah" else pcl.build_clusters
    bunny = P.bunny_scene(target_tris=4000, device=dev)
    for geo, mats in ((bunny.geometry, bunny.materials), (_ragged_soup(dev), None)):
        cg = make_accel(geo, materials=mats)
        pts = torch.cat([geo.v0, geo.v1, geo.v2])
        blocked = []
        for o, d in _camera_and_room_rays(dev):
            R = o.shape[0]
            t_init = torch.full((R,), 1e5, device=dev)
            limit = torch.full((R,), 6.0, device=dev)
            st, st_any = (torch.zeros((R, 3), dtype=torch.int32, device=dev) for _ in range(2))
            n0 = {k: build.LAUNCHES[k] for k in ("clustered_closest", "clustered_any")}
            k = pcl.clustered_closest(cg, o, d, t_init, stats=st)
            k_any = pcl.clustered_any(cg, o, d, limit, stats=st_any)
            torch.cuda.synchronize()
            assert {k: build.LAUNCHES[k] for k in n0} == {
                "clustered_closest": n0["clustered_closest"] + 1,
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
    n0 = build.LAUNCHES["clustered_closest"]
    imgs = [P.render_sample(scene, cam, P.RenderConfig(sort_rays=s, **kw), accel=accel)
            for s in (True, False)]
    assert build.LAUNCHES["clustered_closest"] == n0 + 8
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
@pytest.mark.parametrize("name", parity.K2_CASES + ("R=2073600", "ray sets"))
def test_bounce_fwd_edge_cases_on_card(name):
    """K2 on its edge cases (parity.K2_CASES at 128x72; the main path's
    1920x1080 bounce-1 state with render_sample's tile-ordered ids; the
    adversarial rays of parity.k2_ray_set_cases): every output bitwise
    equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    if name == "ray sets":
        cases = parity.k2_ray_set_cases(dev)
    elif name == "R=2073600":
        scene, cfg = P.cornell_scene(device=dev), P.RenderConfig(width=1920, height=1080)
        table, tris, lv = pmk._tables(scene, cfg, None)
        camv = pmk.camera_vector(P.Camera.default(device=dev))
        f0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, _swizzled_ids(cfg, dev), 0, cfg)
        cases = [(name, scene, cfg, (f0[0], f0[1], f0[2], f0[3], f0[7]), 1)]
    else:
        cases = [(name,) + parity.k2_case(name, dev)]
    for label, scene, cfg, state, b in cases:
        table, tris, lv = pmk._tables(scene, cfg, None)
        n0 = build.LAUNCHES["bounce_fwd"]
        k = pmk.bounce_fwd(table, tris, lv, *state, b, cfg)
        p = pmk.bounce_fwd_plain(table, tris, lv, *state, b, cfg)
        torch.cuda.synchronize()
        assert build.LAUNCHES["bounce_fwd"] == n0 + 1
        assert parity.check_bitwise(f"bounce_fwd, {label}", k, p) == 0.0


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


@pytest.mark.cuda
def test_cli_render_on_card(tmp_path):
    """The CLI on the card at 128x128 x 9: render 2 frames with a
    checkpoint through K1/K2, resume 2 more; the resumed image bitwise
    equal to a 4-frame render in process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import cli
    dev = torch.device("cuda")
    ck, out = str(tmp_path / "st.npz"), str(tmp_path / "img.npy")
    args = ["render", "--width", "128", "--height", "128", "--bounces", "9",
            "--device", "cuda"]
    n0 = dict(build.LAUNCHES)
    assert cli.main(args + ["--frames", "2", "--checkpoint", ck, "--out", out]) == 0
    assert build.LAUNCHES["bounce0_fwd"] - n0["bounce0_fwd"] == 2
    assert build.LAUNCHES["bounce_fwd"] - n0["bounce_fwd"] == 16
    assert cli.main(args + ["--frames", "2", "--resume", ck, "--out", out]) == 0
    cam = P.Camera.from_angles([0.0, -25.0, 8.5], 1.571, 1.571, device=dev)
    cfg = P.RenderConfig(width=128, height=128, bounces=9)
    with torch.no_grad():
        ref = P.render(P.cornell_scene(device=dev), cam, cfg, frames=4)
    assert torch.equal(torch.from_numpy(np.load(out)), ref.cpu())


@pytest.mark.cuda
def test_intersect_bvh_on_card():
    """The LBVH walk (plain PyTorch) on the card against the brute-force
    oracle: Cornell 128x128 primary rays and seeded random rays, winners
    and hits equal, any-hit equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = P.cornell_scene(device=dev)
    cfg = P.RenderConfig(width=128, height=128)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    o, d = generate_rays(P.Camera.default(device=dev), cfg, pid, rng.pixel_seeds(pid, 0))
    g = torch.Generator().manual_seed(3)
    o2 = (torch.rand((4096, 3), generator=g) * torch.tensor([14.0, 39.0, 15.0])
          + torch.tensor([-7.0, -20.0, 1.0])).to(dev)
    d2 = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=1).to(dev)
    bvh = P.build_bvh(scene.geometry)
    assert bvh.pv0.device.type == "cuda"
    for oo, dd in ((o, d), (o2, d2)):
        ref = P.intersect_brute(oo, dd, scene.geometry, t_max=1e5)
        got = P.intersect_bvh(oo, dd, bvh, t_max=1e5)
        assert torch.equal(got.hit, ref.hit)
        assert (got.tri_idx == ref.tri_idx)[ref.hit].float().mean().item() > 0.9999
        torch.testing.assert_close(got.t[ref.hit], ref.t[ref.hit], rtol=1e-5, atol=0)
        limit = torch.full((oo.shape[0],), 8.0, device=dev)
        assert torch.equal(P.occluded_bvh(oo, dd, limit, bvh),
                           P.occluded_brute(oo, dd, limit, scene.geometry))


# Compiled programs (jit.py) on the card.

def _update(scene, what: str):
    """``scene`` with new values of one kind: the diffuse albedos, or one
    vertex of triangle 5 moved (its accel must be rebuilt)."""
    if what == "diffuse":
        m = scene.materials
        return dataclasses.replace(scene, materials=dataclasses.replace(
            m, diffuse=m.diffuse * 0.7 + 0.1))
    g = scene.geometry
    v0 = g.v0.clone()
    v0[5] += 0.05
    return dataclasses.replace(scene, geometry=dataclasses.replace(g, v0=v0))


def _compiled_case(name: str, dev):
    """(scene, accel builder, compiled call, eager call) of a path: each
    call takes (scene, camera, accel, frame)."""
    from mini_opencl_raytracer_tpu_torch import grad, jit
    loss = lambda img: img.mean()
    if name == "render":
        cfg = P.RenderConfig(width=256, height=256, bounces=9)
        return (P.cornell_scene(device=dev), lambda s: P.build_accel(s, cfg),
                lambda s, c, a, f: P.render(s, c, cfg, frames=2, accel=a),
                lambda s, c, a, f: P.to_image(P.render_radiance(s, c, cfg, frames=2, accel=a),
                                              cfg.gamma))
    if name == "step":
        cfg = P.RenderConfig(width=256, height=256, bounces=9)
        step = lambda s, c, a, f: grad.loss_and_grads(s, c, cfg, loss, accel=a)
        return (P.cornell_scene(device=dev), lambda s: P.build_accel(s, cfg), jit.jit(step),
                step)
    cfg = (P.RenderConfig(width=128, height=128, bounces=2) if name == "large scene frame"
           else P.RenderConfig(width=128, height=128, bounces=9, backend="pallas"))
    scene = (P.bunny_scene(target_tris=4000, device=dev) if name == "large scene frame"
             else P.cornell_scene(device=dev))
    sample = lambda s, c, a, f: P.render_sample(s, c, cfg, frame=f, accel=a)
    return scene, lambda s: P.build_accel(s, cfg), jit.jit(sample), sample


def _counts():
    return dict(build.LAUNCHES)


def _since(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["render", "step", "large scene frame", "path B frame"])
def test_compiled_equals_eager_on_card(name):
    """A compiled call is bitwise the eager call on the same inputs: its
    first call, replays at other frames, a replay after the diffuse
    albedos change and one after a vertex moves with the accel rebuilt;
    N replays launch N times the kernels of one eager call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    dev = torch.device("cuda")
    scene, accel_of, compiled, eager = _compiled_case(name, dev)
    cam = P.Camera.default(device=dev)
    frame = lambda f: torch.full((), f, dtype=torch.int64, device=dev)

    def same(a, b):
        la, da = jit.flatten(a)
        lb, db = jit.flatten(b)
        return da == db and all(torch.equal(x, y) for x, y in zip(la, lb))

    accel = accel_of(scene)
    with torch.no_grad() if name != "step" else torch.enable_grad():
        for f in (3, 4, 2**32 - 1):
            got = compiled(scene, cam, accel, frame(f))
            assert same(got, eager(scene, cam, accel, frame(f))), f"frame {f}"
        before = _counts()
        eager(scene, cam, accel, frame(1))
        one = _since(before)
        before = _counts()
        for f in range(3):
            compiled(scene, cam, accel, frame(f))
        assert one and _since(before) == {k: 3 * v for k, v in one.items()}
        for what in ("diffuse", "vertex"):
            scene = _update(scene, what)
            accel = accel_of(scene)
            for f in (5, 6):
                assert same(compiled(scene, cam, accel, frame(f)),
                            eager(scene, cam, accel, frame(f))), f"{what}, frame {f}"


@pytest.mark.cuda
def test_k6_rays_counted_per_launch_on_card():
    """K6's ray counts (build.RAYS, by kind) on a compiled render of a
    large scene with shadow rays and two lights: an eager call and each
    replay add, per kind, the rays of every launch (R = W x H x spp, one
    closest-hit launch a bounce and frame, one any-hit launch a light,
    bounce and frame), and the light loop's shadow-ray slots
    (``wave_shadow``: R x L x bounces x frames); jit.COUNTS gets the
    replays' rays alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    dev = torch.device("cuda")
    cfg = P.RenderConfig(width=96, height=64, bounces=2, shadow_rays=True)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    lights = P.Lights(position=t([[0.0, -10.0, 16.0], [4.0, 2.0, 14.0]]),
                      direction=t([[-0.5, 0.4, -0.1], [0.0, 0.5, -1.0]]),
                      light_type=torch.tensor([P.LIGHT_POINT] * 2, dtype=torch.int32,
                                              device=dev),
                      intensity=t([16.0, 8.0]), attenuation=t([0.8, 0.8]),
                      cos_cutoff=t([0.9, 0.9]))
    scene = P.bunny_scene(target_tris=4000, lights=lights, device=dev)
    cam, accel = P.Camera.default(device=dev), P.build_accel(scene, cfg)
    R, L, frames = cfg.width * cfg.height * cfg.spp, 2, 2
    call = lambda: P.render(scene, cam, cfg, frames=frames, accel=accel)
    k6 = ("clustered_closest", "clustered_any")
    kinds = k6 + ("wave_shadow",)
    counted = tuple(k + "_rays" for k in kinds) + ("replays",)
    snap = lambda: ({k: build.LAUNCHES[k] for k in k6}, {k: build.RAYS[k] for k in kinds},
                    dict(jit.COUNTS))

    def since(before):
        return ({k: build.LAUNCHES[k] - v for k, v in before[0].items()},
                {k: build.RAYS[k] - v for k, v in before[1].items()},
                {k: jit.COUNTS[k] - before[2][k] for k in counted})

    n = cfg.bounces * frames
    launches = {"clustered_closest": n, "clustered_any": L * n}
    rays = {"clustered_closest": R * n, "clustered_any": R * L * n, "wave_shadow": R * L * n}
    with torch.no_grad():
        with jit.disable_jit():
            before = snap()
            call()
            assert since(before) == (launches, rays, dict.fromkeys(counted, 0))
        call()                  # the key's warm-up (eager) and capture
        before = snap()
        for _ in range(3):
            call()
        assert since(before) == ({k: 3 * v for k, v in launches.items()},
                                 {k: 3 * v for k, v in rays.items()},
                                 {**{k + "_rays": 3 * v for k, v in rays.items()},
                                  "replays": 3})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["step", "large scene frame"])
def test_eager_path_makes_no_host_sync_on_card(name):
    """The eager mega step and a large-scene (K6) frame, after one warm-up
    call, run under torch.cuda.set_sync_debug_mode("error"): no host read
    and no blocking copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene, accel_of, _, eager = _compiled_case(name, dev)
    cam = P.Camera.default(device=dev)
    accel = accel_of(scene)
    f = torch.full((), 9, dtype=torch.int64, device=dev)
    eager(scene, cam, accel, f)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eager(scene, cam, accel, f)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out is not None


# The LBVH walk kernel (csrc/bvh.cu).

@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "quad soup"])
def test_bvh_kernel_matches_plain_on_card(scene):
    """The walk kernel's (t, slot) bit for bit the plain walk's, with and
    without backface culling, on the primary, bounce-1 and shadow rays of
    a 128x128 render and on rays at shared edges (the first-slot tie
    rule), on Cornell and on a seeded soup of 4096 triangles (2048
    quads); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from mini_opencl_raytracer_tpu_torch.ops import bvh as pbvh
    from mini_opencl_raytracer_tpu_torch.ops.cuda import bvh as pbk
    dev = torch.device("cuda")
    sc = P.cornell_scene(device=dev) if scene == "cornell" else parity.quad_soup_scene(dev)
    cfg = P.RenderConfig(width=128, height=128, bounces=2, backend="bruteforce")
    b = P.build_bvh(sc.geometry)
    rays = parity.wavefront_rays(sc, P.Camera.default(device=dev), cfg,
                                 *P.make_intersectors(sc, cfg))
    full = lambda o: torch.full((o.shape[0],), cfg.t_max, device=dev)
    sets = [(o, d, full(o)) for o, d in (rays["primary"], rays["bounce1"],
                                         parity.shared_edge_rays(sc.geometry))]
    for o, d, t_init in sets + [rays["shadow"]]:
        for cull in (False, True):
            n0 = build.LAUNCHES["bvh_walk"]
            got = pbk.walk(o, d, t_init, b, cull)
            ref = pbvh.walk_plain(o, d, t_init, b, cull)
            torch.cuda.synchronize()
            assert build.LAUNCHES["bvh_walk"] == n0 + 1
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            assert (got[0] < t_init).any()


# The parallel entry points, compiled, on an NCCL group of one process.

@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["render_sample_dp", "train_step_dp"])
def test_compiled_parallel_equals_eager_on_card(entry):
    """At NCCL world 1 the compiled entry point (a replayed graph) is bit
    for bit the eager call (jit.disable_jit) at tensor frames, at an int
    frame and after a material update; 3 replays launch the kernels and
    hand the collectives the bytes of 3 eager calls; a capture that fails
    under NCCL raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch.distributed as dist
    from mini_opencl_raytracer_tpu_torch import jit
    from mini_opencl_raytracer_tpu_torch.parallel import comm, mesh as pmesh, shard
    dev = torch.device("cuda")
    mesh = pmesh.single_device_mesh(device_type="cuda")
    cam = P.Camera.default(device=dev)
    cfg = P.RenderConfig(width=128, height=128, bounces=9)
    call = {"render_sample_dp": lambda s, f: shard.render_sample_dp(s, cam, cfg, mesh, f),
            "train_step_dp": lambda s, f: shard.train_step_dp(s, cam, cfg, mesh, f,
                                                              grad_buckets=4)}[entry]

    def same(a, b):
        la, da = jit.flatten(a)
        lb, db = jit.flatten(b)
        return da == db and all(torch.equal(x, y) for x, y in zip(la, lb))

    def eager(s, f):
        with jit.disable_jit():
            return call(s, f)

    counts = lambda: dict(_counts(), **{"bytes " + k: v for k, v in comm.BYTES.items()})
    frame = lambda f: torch.full((), f, dtype=torch.int64, device=dev)
    scene = P.cornell_scene(device=dev)
    try:
        with torch.no_grad() if entry == "render_sample_dp" else torch.enable_grad():
            for f in (frame(3), frame(4), 7, frame(2**32 - 1)):
                assert same(call(scene, f), eager(scene, f)), f"frame {f}"
            before = counts()
            eager(scene, frame(1))
            one = {k: v - before[k] for k, v in counts().items() if v != before[k]}
            before = counts()
            for f in range(3):
                call(scene, frame(f))
            three = {k: v - before[k] for k, v in counts().items() if v != before[k]}
            assert one and three == {k: 3 * v for k, v in one.items()}
            scene = _update(scene, "diffuse")
            assert same(call(scene, frame(5)), eager(scene, frame(5)))

        @jit.jit(static_argnames=("mesh",))
        def syncs(x, mesh):
            return comm.psum(x, comm.Axis(mesh, "dp")) * x.sum().item()

        with pytest.raises(RuntimeError, match="capturing"):
            syncs(torch.ones(4, device=dev), mesh)   # the eager call, then its capture
    finally:
        shard.render_sample_dp.clear()
        shard._train_step_dp.clear()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The backward's two modes: the residual variants of K2 / K4
# (cfg.bwd_residuals) and remat.

@pytest.mark.parametrize("option", list(parity.RESID_OPTIONS))
def test_resid_options_have_their_rows(option):
    """Each residual option's row count on Cornell (one light) is the
    layout's, every K2 case keeps live rays in that option, and the
    all-ranked case ranks every ray (CPU)."""
    kw, n = parity.RESID_OPTIONS[option]
    assert known.num_rows(P.RenderConfig(**kw), 1) == n
    for name in ("10% alive", parity.ALL_RANKED):
        scene, cfg, state, b = parity.resid_case(name, option, "cpu", 64, 36)
        assert cfg.bwd_residuals and all(getattr(cfg, k) == v for k, v in kw.items())
        table, tris, lv = pmk._tables(scene, cfg, None)
        out = pmk.bounce_fwd(table, tris, lv, *state, b, cfg, save_resid=True)
        R = state[3].shape[0]
        assert out[7].rows.shape == (n, R)
        live = parity.live_rays(state[3], out[5])
        assert live.sum() > 0 and out[7].count.item() == live.sum()
        if name == parity.ALL_RANKED:
            assert torch.equal(out[7].rank, torch.arange(R, dtype=torch.int32))


# The rows K2 writes and K4 reads on Cornell's one light, per residual
# option: (every live ray's, a diffuse ray's, a specular ray's, a ray's
# whose path goes on).
ROWS_READ = {"blinn": (2, 3, 7, 1), "ggx": (2, 3, 6, 1), "shadow rays": (2, 3, 7, 1),
             "direct specular": (2, 3, 7, 3), "soft edge": (3, 3, 7, 1)}


@pytest.mark.parametrize("option", list(parity.RESID_OPTIONS))
def test_resid_rows_compared_are_those_read(option):
    """megakernel.rows_read names distinct rows of the layout, as many as
    K4 reads in each option, and parity.check_resid_rows holds exactly
    those, read back through the rank array: the unread rows, the other
    lobe's rows, the lights' rows of paths that end and the columns past
    the count may hold anything, while a changed read row of a ray of its
    class, or a changed rank, fails the gate (CPU, the plain rows)."""
    scene, cfg, state, b = parity.resid_case("10% alive", option, "cpu", 64, 36)
    table, tris, lv = pmk._tables(scene, cfg, None)
    out = pmk.bounce_fwd(table, tris, lv, *state, b, cfg, save_resid=True)
    resid, alive_next = out[7], out[3]
    rows, rank, count = resid
    read = pmk.rows_read(cfg, 1)
    assert tuple(len(read[k]) for k in ("all", "diffuse", "specular", "lights")) == \
        ROWS_READ[option]
    flat = sum(read.values(), [])
    assert len(set(flat)) == len(flat) and max(flat) < rows.shape[0]
    live = rank >= 0
    n = int(count.item())
    col = rank[live].long()   # the live rays' columns, in ray order
    spec = rows[known.layout(cfg, 1)["pick"], col] > 0.5
    on = alive_next[live] > 0
    assert spec.any() and (~spec).any() and on.any()
    junk = rows.clone()
    junk[[r for r in range(rows.shape[0]) if r not in flat]] = float("nan")
    for part, rays in (("diffuse", spec), ("specular", ~spec), ("lights", ~on)):
        for r in read[part]:
            junk[r, col[rays]] = float("nan")
    junk[:, n:] = float("nan")
    assert parity.check_resid_rows(option, resid._replace(rows=junk), resid, alive_next, cfg,
                                   1)["bitwise"]
    for part, rays in (("all", slice(None)), ("diffuse", ~spec), ("specular", spec),
                       ("lights", on)):
        bad = rows.clone()
        bad[read[part][-1], col[rays][0]] += 1.0
        with pytest.raises(AssertionError):
            parity.check_resid_rows(option, resid._replace(rows=bad), resid, alive_next, cfg, 1)
    moved = rank.clone()
    moved[live.nonzero()[:2, 0]] = moved[live.nonzero()[:2, 0]].flip(0)
    with pytest.raises(AssertionError):
        parity.check_resid_rows(option, resid._replace(rank=moved), resid, alive_next, cfg, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("option", list(parity.RESID_OPTIONS))
def test_resid_kernels_match_plain_on_card(option):
    """K2 with rows: its outputs bitwise its twin's without rows and its
    plain version's, its ranks 0 .. count - 1 on the rays the plain
    version ranks, the rows K4 reads, read back through each one's ranks,
    bitwise the plain version's. K4 with rows: bitwise K4 without (in the gradient
    gate with direct specular), in the gradient gate of its plain version
    (the replay on the plain rows). On parity.RESID_CASES' states (K2_CASES
    and one where every ray is ranked); launches counted under the
    variants' names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for name in parity.RESID_CASES:
        scene, cfg, state, b = parity.resid_case(name, option, dev)
        table, tris, lv = pmk._tables(scene, cfg, None)
        n0 = dict(build.LAUNCHES)
        kr = pmk.bounce_fwd(table, tris, lv, *state, b, cfg, save_resid=True)
        kc = pmk.bounce_fwd(table, tris, lv, *state, b, cfg)
        pl = pmk.bounce_fwd_plain(table, tris, lv, *state, b, cfg, save_resid=True)
        torch.cuda.synchronize()
        assert build.LAUNCHES["bounce_fwd_resid"] == n0["bounce_fwd_resid"] + 1
        assert build.LAUNCHES["bounce_fwd"] == n0["bounce_fwd"] + 1
        assert all(torch.equal(x, y) for x, y in zip(kr[:7], kc)), name
        parity.check_bitwise(name, kr[:7], pl[:7])
        rows = parity.check_resid_rows(name, kr[7], pl[7], kr[3], cfg, lv.shape[0])
        assert rows["bitwise"], name
        cot = parity.cotangents(kc[2], gen)
        args = (table, lv, *state, kc[5], kc[6], cot, b, cfg)
        g_r = pmk.bounce_bwd(*args, resid=kr[7])
        assert build.LAUNCHES["bounce_bwd_resid"] == n0["bounce_bwd_resid"] + 1
        parity.check_resid_bwd(name, g_r, pmk.bounce_bwd(*args), cfg)
        parity.check_grads(name, g_r, pmk.bounce_bwd_plain(*args, resid=pl[7]),
                           parity.BOUNCE_GRADS)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "large scene"])
def test_remat_bitwise_on_card(backend):
    """remat on and off: the loss and every gradient bitwise equal (under
    torch.use_deterministic_algorithms: index_add_ otherwise sums with
    atomics), the K5 / K6 launches of the recompute on top of the
    forward's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cam = P.Camera.default(device=dev)
    if backend == "pallas":
        scene = P.cornell_scene(device=dev)
        cfg = P.RenderConfig(width=128, height=128, bounces=3, backend="pallas")
    else:
        scene = P.bunny_scene(target_tris=20000, device=dev)
        cfg = P.RenderConfig(width=128, height=128, bounces=3)
    accel = P.build_accel(scene, cfg)
    out, n = {}, {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        names = ("panel_closest", "panel_any", "clustered_closest", "clustered_any")
        n0 = {k: build.LAUNCHES[k] for k in names}
        torch.use_deterministic_algorithms(True)
        try:
            out[remat] = pgrad.loss_and_grads(scene, cam, c, lambda im: im.mean(), accel=accel)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        n[remat] = {k: build.LAUNCHES[k] - v for k, v in n0.items() if build.LAUNCHES[k] != v}
    key = "panel_closest" if backend == "pallas" else "clustered_closest"
    assert n[False] == {key: cfg.bounces} and n[True] == {key: 2 * cfg.bounces}
    assert torch.equal(out[False][0], out[True][0])
    for part in (1, 2):
        for (k, a), (_, b) in zip(pgrad._leaves(out[False][part]),
                                  pgrad._leaves(out[True][part])):
            assert torch.equal(a, b), k


# The material gather's backward (csrc/material_rows.cu).

MATERIAL_ROWS_CASES = ("bunny", "bunny float64", "M=1", "M=6", "M=2048", "M=2049",
                       "M=5000 float64", "T=36", "T=1037", "T=1037 transposed",
                       "T=300000 contiguous")


def _material_rows_case(name: str, dev):
    """(mat_idx [T] int64, M, layout of the cotangent, dtype): "table"
    reads columns 24-33 of a [T, 34] gradient (the wavefront's),
    "transposed" rows 24-33 of a [32, T_pad] one (the mega path's). M =
    2048 fills one slice of the kernel's materials (kSliceMats), 2049 and
    5000 take two and three."""
    gen = torch.Generator().manual_seed(len(name))
    words = name.split()
    dtype = torch.float64 if words[-1] == "float64" else torch.float32
    layout = words[-1] if words[-1] in ("transposed", "contiguous") else "table"
    if words[0] == "bunny":   # the bunny-512-b2 configuration's: 69,702 of 69,732 on one
        return P.bunny_scene(device=dev).geometry.mat_idx.to(torch.int64), 6, layout, dtype
    if name == "T=36":
        return (P.cornell_scene(device=dev).geometry.mat_idx.to(torch.int64), 6, layout,
                dtype)
    M = int(words[0][2:]) if words[0][:2] == "M=" else 6
    T = int(words[0][2:]) if words[0][:2] == "T=" else (50_000 if M <= 6 else 200_000)
    return torch.randint(0, M, (T,), generator=gen).to(dev), M, layout, dtype


def _material_cot(values: torch.Tensor, layout: str) -> torch.Tensor:
    """values [T, 10] as a view of the layout autograd hands over."""
    T = values.shape[0]
    if layout == "contiguous":
        return values.contiguous()
    if layout == "table":
        base = torch.zeros((T, 34), dtype=values.dtype, device=values.device)
        base[:, 24:] = values
        return base[:, 24:]
    base = torch.zeros((32, T + 40), dtype=values.dtype, device=values.device)
    base[16:26, :T] = values.T
    return base[16:26, :T].T


@pytest.mark.cuda
@pytest.mark.parametrize("name", MATERIAL_ROWS_CASES)
def test_material_rows_kernel_on_card(name):
    """The reduction against a float64 index_add_: exactly equal on
    integer-valued cotangents (every partial sum is exact in float32), and
    within 1e-6 of the sum of |cotangent| by material on normal ones; one
    material_rows_bwd launch a call, whatever M and the dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    mi, M, layout, dtype = _material_rows_case(name, dev)
    T = mi.shape[0]
    gen = torch.Generator(device=dev).manual_seed(T + M)
    n0 = build.LAUNCHES["material_rows_bwd"]
    for kind in ("integers", "normal"):
        values = torch.randn((T, 10), generator=gen, device=dev, dtype=dtype)
        if kind == "integers":
            values = torch.round(values * 4).clamp(-8, 8)
        got = pmr.reduce_by_material(_material_cot(values, layout), mi, M)
        ref = torch.zeros((M, 10), dtype=torch.float64, device=dev).index_add_(
            0, mi, values.double())
        assert got.shape == (M, 10) and got.dtype == dtype
        if kind == "integers":
            assert torch.equal(got.double(), ref)
        else:
            scale = torch.zeros_like(ref).index_add_(0, mi, values.double().abs())
            assert ((got.double() - ref).abs() <= 1e-6 * scale).all()
    torch.cuda.synchronize()
    assert build.LAUNCHES["material_rows_bwd"] == n0 + 2


@pytest.mark.cuda
def test_material_rows_kernel_is_deterministic_on_card():
    """Two calls on the bunny's indices give the same bits, and so do two
    calls over three slices of materials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for name in ("bunny", "M=5000 float64"):
        mi, M, layout, dtype = _material_rows_case(name, dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        cot = _material_cot(torch.randn((mi.shape[0], 10), generator=gen, device=dev,
                                        dtype=dtype), layout)
        a = pmr.reduce_by_material(cot, mi, M)
        b = pmr.reduce_by_material(cot, mi, M)
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("builder", ["shading table", "mega table"])
def test_material_rows_backward_replays_bitwise_on_card(builder):
    """The leaves' gradients through a table builder: a captured graph's
    replays equal the eager call bit for bit, one material_rows_bwd a
    call, replays included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    from mini_opencl_raytracer_tpu_torch.ops import shading
    dev = torch.device("cuda")
    scene = P.bunny_scene(device=dev) if builder == "shading table" else P.cornell_scene(device=dev)
    names = ("diffuse", "specular", "emission", "roughness")

    def grads(materials, geometry, cot):
        leaves = {k: getattr(materials, k).detach().requires_grad_(True) for k in names}
        mats = dataclasses.replace(materials, **leaves)
        table = (shading.build_shading_table(geometry, mats).table if builder == "shading table"
                 else pmk.build_mega_table(geometry, mats))
        return torch.autograd.grad(table, [leaves[k] for k in names], cot)

    shape = ((scene.num_triangles, 34) if builder == "shading table"
             else tuple(pmk.build_mega_table(scene.geometry, scene.materials).shape))
    gen = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
    compiled = jit.jit(grads)
    with jit.disable_jit():
        eager = [grads(scene.materials, scene.geometry, c) for c in cots]
    n0 = build.LAUNCHES["material_rows_bwd"]
    got = [compiled(scene.materials, scene.geometry, c) for c in cots + cots[:1]]
    torch.cuda.synchronize()
    assert build.LAUNCHES["material_rows_bwd"] - n0 == len(got)
    for g, e in zip(got, eager + eager[:1]):
        assert all(torch.equal(x, y) for x, y in zip(g, e))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(parity.SHADE_CASES))
def test_fused_shading_bitwise_on_card(name):
    """The wavefront's fused shading (csrc/shade.cu) against
    hit_attributes + shade_hit on the same closest hit: every output
    bitwise (parity.check_shade), one launch, on the cases of
    parity.SHADE_CASES: the bunny at 512x512 at bounce 0 and at a sorted,
    parked bounce 1 with a radiance carry, sponza at 384x216 (rows from
    K6), Cornell on K5 and on the LBVH walk (no rows), each flag, 30
    lights of the three types; and on Cornell the state with its rows 12
    floats apart, as the pipeline stages hand it over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    scene, cfg, closest, carry, bounce = parity.shade_case(name, torch.device("cuda"))
    n0 = build.LAUNCHES["shade"]
    fused, plain, hit = parity.shade_pair(scene, cfg, closest, carry, bounce)
    torch.cuda.synchronize()
    assert build.LAUNCHES["shade"] == n0 + 1
    assert (hit.rows is not None) == (parity.SHADE_CASES[name][0] in ("bunny", "sponza"))
    parity.check_shade(name, fused, plain)
    if name == "cornell pallas":  # the pipeline stages' state: rows 12 floats apart
        packed = torch.cat(carry[:4], dim=1)
        strided = tuple(packed[:, 3 * k:3 * k + 3] for k in range(4)) + carry[4:]
        again, _, _ = parity.shade_pair(scene, cfg, closest, strided, bounce)
        parity.check_shade(name + ", strided", again, fused)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["large scene", "pallas"])
def test_fused_render_equals_plain_on_card(backend, monkeypatch):
    """A render whose bounces shade in the kernel equals, bit for bit, the
    render with every bounce shaded by hit_attributes + shade_hit (the
    rule turned off), compiled and eager; a training step under grad
    shades in the kernel and differentiates in the adjoint kernel (remat:
    two forward launches a bounce, one adjoint launch), none in PyTorch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    dev = torch.device("cuda")
    if backend == "pallas":
        scene = P.cornell_scene(device=dev)
        cfg = P.RenderConfig(width=256, height=144, bounces=4, backend="pallas",
                             soft_edge_sigma=0.05, direct_specular=True)
    else:
        scene = P.bunny_scene(device=dev)
        cfg = P.RenderConfig(width=256, height=256, bounces=3)
    cam, accel = P.Camera.default(device=dev), P.build_accel(scene, cfg)
    call = lambda: P.render(scene, cam, cfg, frames=2, accel=accel)
    with torch.no_grad():
        n0 = build.LAUNCHES["shade"]
        with jit.disable_jit():
            eager = call()
        compiled = [call() for _ in range(3)]
        torch.cuda.synchronize()
        # The eager call, the compiled warm-up and two replays.
        assert build.LAUNCHES["shade"] - n0 == 4 * 2 * cfg.bounces
        monkeypatch.setattr(integrator, "shading_route", lambda cfg, o, grad, n: "plain")
        with jit.disable_jit():
            plain = call()
    for img in [eager] + compiled:
        assert torch.equal(img, plain)
    monkeypatch.undo()
    n0, rays = dict(build.LAUNCHES), dict(build.RAYS)
    small = dataclasses.replace(cfg, width=64, height=64)
    pgrad.loss_and_grads(scene, cam, small, lambda im: im.mean(), accel=accel)
    torch.cuda.synchronize()
    R = small.width * small.height * small.spp
    assert {k: build.LAUNCHES[k] - n0[k] for k in ("shade", "shade_adjoint")} == {
        "shade": 2 * cfg.bounces, "shade_adjoint": cfg.bounces}
    assert {k: build.RAYS[k] - rays[k] for k in ("shade_fused", "shade_adjoint",
                                                  "shade_plain")} == {
        "shade_fused": 2 * cfg.bounces * R, "shade_adjoint": cfg.bounces * R, "shade_plain": 0}


@pytest.mark.cuda
def test_fused_shading_rays_counted_on_card():
    """A replayed render adds R fused rays a bounce and frame to
    jit.COUNTS["shade_fused_rays"] (and to build.RAYS), none to
    ``shade_plain_rays``; with shadow rays every bounce shades in PyTorch
    and the count moves to ``shade_plain_rays``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    dev = torch.device("cuda")
    scene = P.bunny_scene(target_tris=4000, device=dev)
    cam, frames = P.Camera.default(device=dev), 2
    for shadow_rays, kind in ((False, "shade_fused"), (True, "shade_plain")):
        cfg = P.RenderConfig(width=96, height=64, bounces=2, shadow_rays=shadow_rays)
        accel = P.build_accel(scene, cfg)
        R = cfg.width * cfg.height * cfg.spp
        call = lambda: P.render(scene, cam, cfg, frames=frames, accel=accel)
        with torch.no_grad():
            call()              # the key's warm-up (eager) and capture
            before = dict(build.RAYS), dict(jit.COUNTS)
            for _ in range(3):
                call()
        rays = 3 * R * cfg.bounces * frames
        assert {k: build.RAYS[k] - before[0][k] for k in ("shade_fused", "shade_plain")} == (
            {"shade_fused": 0, "shade_plain": 0} | {kind: rays})
        assert {k: jit.COUNTS[k] - before[1][k] for k in ("shade_fused_rays",
                                                          "shade_plain_rays")} == (
            {"shade_fused_rays": 0, "shade_plain_rays": 0} | {kind + "_rays": rays})


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(parity.SHADE_CASES))
def test_shade_adjoint_matches_plain_on_card(name):
    """The wavefront shading's adjoint (csrc/shade_bwd.cu) against autograd
    of shade_plain, its plain version, on the cases of parity.SHADE_CASES
    (the bunny and sponza with K6's rows, Cornell without, each flag, 30
    lights of three types) under K4's gates (parity.check_grads: d o, d d,
    d beta and the rows' gradient by the scaled forward gate, the light
    gradient within 2e-3 of its largest); a second call bitwise the first;
    one launch and R rays counted a call. On Cornell also the state with
    its rows 12 floats apart, as the pipeline stages hand it over, and a
    radiance cotangent broadcast along the rays, each bitwise the dense
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scene, cfg, closest, carry, bounce = parity.shade_case(name, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    args = parity.adjoint_inputs(scene, cfg, closest, carry, gen)
    R = carry[4].shape[0]
    n0, r0 = build.LAUNCHES["shade_adjoint"], build.RAYS["shade_adjoint"]
    got = [pshade.shade_adjoint(*args, bounce, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert (build.LAUNCHES["shade_adjoint"] - n0, build.RAYS["shade_adjoint"] - r0) == (2, 2 * R)
    parity.check_grads(name, got[0], pshade.shade_adjoint_plain(*args, bounce, cfg),
                       parity.SHADE_GRADS)
    for n, a, b in zip(parity.SHADE_GRADS, *got):
        assert torch.equal(a, b), f"{n} differs between two calls"
    if name == "cornell pallas":
        rows, o, d, beta, alive, hit, seeds, lv, cot = args
        packed = torch.cat([o.expand(R, 3), d, beta, beta], dim=1)
        strided = tuple(packed[:, 3 * k:3 * k + 3] for k in range(3))
        again = pshade.shade_adjoint(rows, *strided, alive, hit, seeds, lv, cot, bounce, cfg)
        broad = cot[3][:1].expand(R, 3)
        dense = cot[:3] + (broad.contiguous(),)
        want = pshade.shade_adjoint(*args[:8], dense, bounce, cfg)
        seen = pshade.shade_adjoint(*args[:8], cot[:3] + (broad,), bounce, cfg)
        for n, a, b, c, e in zip(parity.SHADE_GRADS, got[0], again, want, seen):
            assert torch.equal(a, b), f"{n}, strided state"
            assert torch.equal(c, e), f"{n}, broadcast cotangent"


@pytest.mark.cuda
def test_adjoint_step_on_card(monkeypatch):
    """A compiled training step of a bunny-scale scene (69,732 triangles,
    256x256 x 2 bounces: K6, sorted, remat) shades through the adjoint
    route: each replay adds 2 bounces x 2 (forward and recompute) x R fused
    rays, 2 x R adjoint rays and no ray shaded in PyTorch to jit.COUNTS;
    its loss and every gradient are within the gradient gate of the same
    step shaded in PyTorch (the route turned off); and, eager under
    torch.use_deterministic_algorithms (the table's index_add_ otherwise
    sums with atomics), remat on and off give the loss and every gradient
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    dev = torch.device("cuda")
    scene, cam = P.bunny_scene(device=dev), P.Camera.default(device=dev)
    cfg = P.RenderConfig(width=256, height=256, bounces=2)
    accel = P.build_accel(scene, cfg)
    R = cfg.width * cfg.height * cfg.spp
    loss = lambda im: ((im - 0.25) ** 2).mean()
    step = jit.jit(lambda s, c, a: pgrad.loss_and_grads(s, c, cfg, loss, accel=a))
    step(scene, cam, accel)           # the key's warm-up (eager) and capture
    keys = ("shade_fused_rays", "shade_adjoint_rays", "shade_plain_rays", "replays")
    before = {k: jit.COUNTS[k] for k in keys}
    for _ in range(2):
        got = step(scene, cam, accel)
    torch.cuda.synchronize()
    assert {k: jit.COUNTS[k] - v for k, v in before.items()} == {
        "shade_fused_rays": 2 * 4 * R, "shade_adjoint_rays": 2 * 2 * R,
        "shade_plain_rays": 0, "replays": 2}
    monkeypatch.setattr(integrator, "shading_route", lambda cfg, o, grad, n: "plain")
    with jit.disable_jit():
        ref = pgrad.loss_and_grads(scene, cam, cfg, loss, accel=accel)
    monkeypatch.undo()
    parity.check_grad_sum("loss", got[0], ref[0])
    for part in (1, 2):
        for (k, a), (_, b) in zip(pgrad._leaves(got[part]), pgrad._leaves(ref[part])):
            if a.is_floating_point():
                parity.check_grad_sum(k, a, b)
    out = {}
    for remat in (False, True):
        torch.use_deterministic_algorithms(True)
        try:
            with jit.disable_jit():
                out[remat] = pgrad.loss_and_grads(scene, cam, dataclasses.replace(
                    cfg, remat=remat), loss, accel=accel)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    assert torch.equal(out[False][0], out[True][0])
    for part in (1, 2):
        for (k, a), (_, b) in zip(pgrad._leaves(out[False][part]),
                                  pgrad._leaves(out[True][part])):
            assert torch.equal(a, b), k


@pytest.mark.cuda
def test_pipeline_adjoint_grads_on_card(monkeypatch):
    """The pipeline's stages (parallel/pipeline.py, make_bounce_step: the
    state handed over with its rows 12 floats apart) differentiate their
    bounces through the adjoint route: an eager gradient of
    render_sample_pp on an NCCL group of one process (Cornell 128x128 x 2,
    2 microbatches) shades no ray in PyTorch, and its every leaf is within
    the gradient gate of the same call shaded in PyTorch (the route turned
    off); under torch.use_deterministic_algorithms remat on and off give
    every leaf bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch.distributed as dist
    from mini_opencl_raytracer_tpu_torch import jit
    from mini_opencl_raytracer_tpu_torch.parallel import mesh as pmesh, pipeline
    dev = torch.device("cuda")
    mesh = pmesh.single_device_mesh(device_type="cuda")
    scene, cam = P.cornell_scene(device=dev), P.Camera.default(device=dev)
    cfg = P.RenderConfig(width=128, height=128, bounces=2)
    R = cfg.width * cfg.height

    def grads(c):
        with jit.disable_jit():
            return pgrad.grad_float_leaves(lambda sc: pipeline.render_sample_pp(
                sc, cam, c, mesh, 0, pp_axis="dp", n_micro=2).mean(), scene)

    try:
        before = dict(build.RAYS)
        got = grads(cfg)
        torch.cuda.synchronize()
        moved = {k: build.RAYS[k] - before[k]
                 for k in ("shade_fused", "shade_adjoint", "shade_plain")}
        assert moved == {"shade_fused": 2 * 2 * R, "shade_adjoint": 2 * R, "shade_plain": 0}
        monkeypatch.setattr(integrator, "shading_route", lambda cfg, o, grad, n: "plain")
        ref = grads(cfg)
        monkeypatch.undo()
        for (k, a), (_, b) in zip(pgrad._leaves(got), pgrad._leaves(ref)):
            if a.is_floating_point():
                parity.check_grad_sum(k, a, b)
        out = {}
        for remat in (False, True):
            torch.use_deterministic_algorithms(True)
            try:
                out[remat] = grads(dataclasses.replace(cfg, remat=remat))
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        for (k, a), (_, b) in zip(pgrad._leaves(out[False]), pgrad._leaves(out[True])):
            assert torch.equal(a, b), k
    finally:
        pipeline.render_sample_pp.clear()
        dist.destroy_process_group()


# The wavefront raygen's card cases: (width, height, ids): sponza 4K and
# config 3 in tile order, a scanline slice whose R is not a multiple of the
# kernel's 256-thread block, shuffled ids, and no rays.
RAYGEN_CASES = {"sponza 3840x2160": (3840, 2160, "swizzled"),
                "bunny 512x512": (512, 512, "swizzled"),
                "R=1000 scanline": (64, 48, 1000), "shuffled 96x64": (96, 64, "shuffled"),
                "R=0": (64, 48, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["int", "tensor"])
@pytest.mark.parametrize("name", list(RAYGEN_CASES))
def test_raygen_matches_plain_on_card(name, frame):
    """The wavefront's raygen kernel (csrc/raygen.cu) against its plain
    version on the same device: seeds, origins and directions bit for bit,
    d and the seeds dense, o the camera's position expanded; one launch and
    R rays counted (none for R = 0); a second call bitwise the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch.ops.cuda import raygen
    dev = torch.device("cuda")
    w, h, ids = RAYGEN_CASES[name]
    cfg = P.RenderConfig(width=w, height=h)
    if ids == "swizzled":
        pid = _swizzled_ids(cfg, dev)
    elif ids == "shuffled":
        gen = torch.Generator().manual_seed(5)
        pid = torch.randperm(cfg.num_pixels, generator=gen).to(torch.int32).to(dev)
    else:
        pid = torch.arange(7, 7 + ids, dtype=torch.int32, device=dev)
    cam = P.Camera.from_angles((0.5, -20.0, 7.0), pitch=1.4, yaw=1.7, device=dev)
    fr = torch.full((), 2**32 - 3, dtype=torch.int64, device=dev) if frame == "tensor" else 9
    R = pid.shape[0]
    n0, r0 = build.LAUNCHES["raygen"], build.RAYS["raygen_fused"]
    got = raygen.raygen_fused(cam, cfg, pid, fr)
    again = raygen.raygen_fused(cam, cfg, pid, fr)
    want = raygen.raygen_plain(cam, cfg, pid, fr)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["raygen"] - n0, build.RAYS["raygen_fused"] - r0) == (
        (2, 2 * R) if R else (0, 0))
    assert got[0].stride() == (0, 1) and got[1].is_contiguous() and got[2].is_contiguous()
    for label, a, b, c in zip(("o", "d", "seeds"), got, want, again):
        assert a.shape == b.shape and a.dtype == b.dtype, label
        assert torch.equal(a, b) and torch.equal(a, c), label


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bunny", "shadow rays"])
def test_raygen_render_equals_plain_on_card(case, monkeypatch):
    """``render(frames=4)`` of a wavefront scene with its rays from the
    kernel is, bit for bit, the render with the plain route (the parent's
    raygen: the rule turned off), compiled and eager; four launches a call,
    and a replay adds 4 R to ``raygen_fused_rays`` and none to
    ``raygen_plain_rays``. A training step takes the camera's gradient and
    generates its rays in PyTorch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from mini_opencl_raytracer_tpu_torch import jit
    from mini_opencl_raytracer_tpu_torch.ops.cuda import raygen
    dev = torch.device("cuda")
    scene = P.bunny_scene(target_tris=4000, device=dev)
    cfg = P.RenderConfig(width=128, height=96, bounces=2, shadow_rays=case == "shadow rays")
    cam, accel, R = P.Camera.default(device=dev), P.build_accel(scene, cfg), cfg.num_pixels
    call = lambda: P.render(scene, cam, cfg, frames=4, accel=accel)
    with torch.no_grad():
        n0 = build.LAUNCHES["raygen"]
        with jit.disable_jit():
            eager = call()
        compiled = [call() for _ in range(2)]
        before = dict(jit.COUNTS)
        compiled.append(call())
        torch.cuda.synchronize()
        # The eager call, the compiled warm-up and two replays.
        assert build.LAUNCHES["raygen"] - n0 == 4 * 4
        assert {k: jit.COUNTS[k] - before[k] for k in ("raygen_fused_rays",
                                                       "raygen_plain_rays")} == {
            "raygen_fused_rays": 4 * R, "raygen_plain_rays": 0}
        monkeypatch.setattr(raygen, "raygen_route", lambda camera, cfg, ids: "plain")
        with jit.disable_jit():
            plain = call()
    for img in [eager] + compiled:
        assert torch.equal(img, plain)
    monkeypatch.undo()
    rays = dict(build.RAYS)
    pgrad.loss_and_grads(scene, cam, cfg, lambda im: im.mean(), accel=accel)
    torch.cuda.synchronize()
    assert {k: build.RAYS[k] - rays[k] for k in ("raygen_fused", "raygen_plain")} == {
        "raygen_fused": 0, "raygen_plain": R}
