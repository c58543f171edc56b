"""The cluster-traversal intersector (K6's plain version, taken by the
wrappers for CPU tensors), the sorted wavefront and the ``pallas`` render
and gradient of large scenes, against the JAX package (Pallas in
interpret mode) and the all-pairs oracle.

Tolerances: hits and winners equal; t to rtol 1e-5, atol 5e-4 against
JAX's clustered kernel (tests/test_pallas.py:122: its bf16 limb-packed
M-T has an absolute t error) and exactly equal to the oracle (the same
arithmetic); renders atol 2e-5, rtol 1e-4 (tests/test_torch_render.py);
the diffuse gradient atol 1e-4 of its largest value
(tests/test_pallas.py:203-204).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import native as jnative
from mini_opencl_raytracer_tpu.models.procedural import bunny_scene as jbunny
from mini_opencl_raytracer_tpu.ops.pallas import clustered as jcl
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch import native as pnative
from mini_opencl_raytracer_tpu_torch.ops import rng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as pcl
from mini_opencl_raytracer_tpu_torch.ops.cuda.clustered_walk import _slab_rows, _Walk, walk
from mini_opencl_raytracer_tpu_torch.ops.shading import build_shading_table, take_rows

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
CPU = "cpu"


def _arrays(jscene):
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def _soup(n, seed):
    r = np.random.default_rng(seed)
    base = r.uniform([-8, 0, 0], [8, 20, 17], size=(n, 3)).astype(np.float32)
    v1 = base + r.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    v2 = base + r.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    z3, z2 = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32)
    arrays = dict(v0=base, v1=v1, v2=v2, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                  mat_idx=np.zeros((n,), np.int32))
    jg = J.Geometry(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pg = P.Geometry(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    return jg, pg


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([-7, -20, 1], [7, 19, 16], size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def bunny():
    js = jbunny(target_tris=4000)
    return js, P.scene_from_numpy(_arrays(js), device=CPU)


@pytest.mark.parametrize("layout", ["morton", "sah"])
def test_clustered_matches_jax_and_oracle(layout):
    """A 3000-triangle soup (24 clusters), in both slot layouts: the
    port's layout tables equal JAX's, and its closest hits equal the
    oracle's and JAX's clustered kernel's."""
    if layout == "sah" and not (pnative.available() and jnative.available()):
        pytest.skip("no C++ compiler: the native SAH library is unavailable")
    jg, pg = _soup(3000, seed=9)
    if layout == "sah":
        jcg, pcg = jcl.build_accel(jg), pcl.build_accel(pg)
    else:
        jcg, pcg = jcl.build_clusters(jg), pcl.build_clusters(pg)
    assert pcg.layout == layout and pcg.num_supers == 1
    np.testing.assert_array_equal(pcg.slot_to_tri.numpy(), np.asarray(jcg.slot_to_tri))
    np.testing.assert_array_equal(pcg.cl_aabb.numpy(), np.asarray(jcg.cl_aabb))
    np.testing.assert_array_equal(pcg.sup_aabb.numpy(), np.asarray(jcg.sup_aabb))
    o, d = _random_rays(512, seed=12)
    ref = jcl.intersect_clustered(jnp.asarray(o), jnp.asarray(d), jcg, t_max=1e5)
    before = {k: build.LAUNCHES[k] for k in ("clustered_closest", "clustered_any")}
    got = pcl.intersect_clustered(torch.from_numpy(o), torch.from_numpy(d), pcg, t_max=1e5)
    assert {k: build.LAUNCHES[k] for k in before} == before  # the CPU takes the plain version
    brute = P.intersect_brute(torch.from_numpy(o), torch.from_numpy(d), pg, t_max=1e5,
                              ray_chunk=256)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(hit, brute.hit.numpy())
    assert hit.mean() > 0.3
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5, atol=5e-4)
    np.testing.assert_array_equal(got.t.numpy()[hit], brute.t.numpy()[hit])
    np.testing.assert_array_equal(got.tri_idx.numpy()[hit], np.asarray(ref.tri_idx)[hit])
    np.testing.assert_array_equal(got.tri_idx.numpy()[hit], brute.tri_idx.numpy()[hit])
    assert got.rows is None                  # built without materials


def test_clustered_several_supers_match_oracle():
    """20,000 triangles fill three supers: closest hits and occlusion of
    the plain version equal the oracle's."""
    _, pg = _soup(20_000, seed=5)
    cg = pcl.build_clusters(pg)
    assert cg.num_supers == 3 and cg.sup_aabb.shape == (8, 8)
    o, d = (torch.from_numpy(a) for a in _random_rays(256, seed=6))
    got = pcl.intersect_clustered(o, d, cg, t_max=1e5)
    brute = P.intersect_brute(o, d, pg, t_max=1e5, ray_chunk=64)
    np.testing.assert_array_equal(got.hit.numpy(), brute.hit.numpy())
    np.testing.assert_array_equal(got.t.numpy(), brute.t.numpy())
    np.testing.assert_array_equal(got.tri_idx.numpy(), brute.tri_idx.numpy())
    limit = torch.full((256,), 3.0)
    np.testing.assert_array_equal(
        pcl.occluded_clustered(o, d, limit, cg).numpy(),
        P.occluded_brute(o, d, limit, pg, ray_chunk=64).numpy())


def test_clustered_occlusion():
    jg, pg = _soup(3000, seed=7)
    jcg, pcg = jcl.build_clusters(jg), pcl.build_clusters(pg)
    o, d = _random_rays(256, seed=13)
    limit = np.full((256,), 8.0, np.float32)
    limit[::5] = np.inf
    ref = jcl.occluded_clustered(jnp.asarray(o), jnp.asarray(d), jnp.asarray(limit), jcg)
    got = pcl.occluded_clustered(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(limit), pcg)
    brute = P.occluded_brute(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(limit), pg, ray_chunk=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), brute.numpy())
    assert 0.1 < got.float().mean() < 0.9


def test_tie_goes_to_lowest_triangle_id():
    """Triangle 250 is a copy of triangle 40, laid out in cluster 0 and 40
    in cluster 2, so the traversal meets 250 first at the same t: the
    lower original id (40, the oracle's winner) takes the tie."""
    cg, o, d, pg = _tie_case()
    assert cg.slot_to_tri[0].item() == 250 and cg.slot_to_tri[256 + 43].item() == 40
    h = pcl.intersect_clustered(o, d, cg, t_max=1e5)
    brute = P.intersect_brute(o, d, pg, t_max=1e5)
    assert brute.tri_idx.item() == 40 and h.tri_idx.item() == 40
    assert h.t.item() == brute.t.item()


def test_winner_rows_match_take_rows(bunny):
    """Hit.rows equal take_rows(shading table, tri_idx) on hits and zeros
    on misses; the same winners as JAX's clustered kernel."""
    js, ps = bunny
    cfg = P.RenderConfig(width=32, height=32)
    ids = torch.arange(cfg.num_pixels, dtype=torch.int32)
    seeds = rng.pixel_seeds(ids, 0)
    o, d = generate_rays(P.Camera.default(device=CPU), cfg, ids, seeds)
    cg = pcl.build_accel(ps.geometry, materials=ps.materials)
    h = pcl.intersect_clustered(o, d, cg, cfg.t_max)
    assert h.rows is not None and h.rows.shape == (1024, 34)
    st = build_shading_table(ps.geometry, ps.materials)
    want = take_rows(st.table, h.tri_idx)
    hit = h.hit
    assert 0.3 < hit.float().mean() < 1.0
    np.testing.assert_array_equal(h.rows[hit].numpy(), want[hit].numpy())
    assert (h.rows[~hit] == 0).all()
    jcg = jcl.build_accel(js.geometry, materials=js.materials)
    ref = jcl.intersect_clustered(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jcg,
                                  cfg.t_max)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(h.tri_idx.numpy(), np.asarray(ref.tri_idx))


def test_prebuilt_accel_tracks_material_updates(bunny):
    """A prebuilt accel keeps responding to live material updates
    (make_intersectors refreshes the attrs' material columns through
    slot_mat): the image with the stale accel equals the one with a fresh
    accel, and differs from the image before the update."""
    _, scene = bunny
    cam = P.Camera.default(device=CPU)
    cfg = P.RenderConfig(width=16, height=16, bounces=2, backend="pallas")
    accel = P.build_accel(scene, cfg)
    assert isinstance(accel, pcl.ClusteredGeometry) and accel.attrs is not None
    s2 = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, diffuse=scene.materials.diffuse * 0.25))
    want = P.render_sample(s2, cam, cfg)
    got = P.render_sample(s2, cam, cfg, accel=accel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    base = P.render_sample(scene, cam, cfg, accel=accel)
    assert (base - want).abs().max() > 1e-3


def test_sorted_wavefront_matches_unsorted(bunny):
    """cfg.sort_rays permutes the wavefront between bounces and restores
    pixel order at the end: per-pixel values are identical."""
    _, scene = bunny
    cam = P.Camera.default(device=CPU)
    kw = dict(width=16, height=16, bounces=3, shadow_rays=True)
    accel = P.build_accel(scene, P.RenderConfig(**kw))
    imgs = [P.render_sample(scene, cam, P.RenderConfig(sort_rays=s, **kw), frame=1,
                            accel=accel) for s in (True, False)]
    assert imgs[0].abs().sum() > 0
    np.testing.assert_array_equal(imgs[0].numpy(), imgs[1].numpy())


@pytest.mark.parametrize("layout", ["morton", "sah"])
def test_cluster_counts_cover_the_real_slots(layout):
    """cl_count holds each cluster's real slots, and they come first in
    the cluster, so the kernel's loop over them skips only padding; a
    leaf larger than a cluster is refused."""
    if layout == "sah" and not pnative.available():
        pytest.skip("no C++ compiler: the native SAH library is unavailable")
    _, pg = _soup(3000, seed=9)
    cg = (pcl.build_accel if layout == "sah" else pcl.build_clusters)(pg)
    real = (cg.tris.reshape(-1, pcl.CLUSTER, 9) != 0).any(dim=2)
    count = cg.cl_count.to(torch.int64)
    assert int(count.sum()) == 3000 and int(count.max()) <= pcl.CLUSTER
    prefix = torch.arange(pcl.CLUSTER)[None, :] < count[:, None]
    assert torch.equal(real, prefix)
    if layout == "sah":
        assert int((count > 0).sum()) > 3000 // pcl.CLUSTER   # SAH leaves are not full
    with pytest.raises(ValueError, match="does not fit"):
        pcl.build_clusters(pg, leaf_info=(np.arange(3000, dtype=np.int32),
                                          np.array([0], np.int32),
                                          np.array([3000], np.int32)))


def _ragged(layout, n=20_000):
    """n triangles: at 20,000, 157 Morton clusters in 3 supers or some 230
    SAH leaves in 4, cluster counts that are no power of the tree's arity."""
    if layout == "sah" and not pnative.available():
        pytest.skip("no C++ compiler: the native SAH library is unavailable")
    _, pg = _soup(n, seed=5)
    return (pcl.build_accel if layout == "sah" else pcl.build_clusters)(pg)


@pytest.mark.parametrize("layout", ["morton", "sah"])
def test_tree_boxes_contain_their_children(layout):
    """Every inner node's box contains each non-empty child's box bitwise
    (lo <= and hi >= as floats, children inner nodes or clusters); the
    supers are the tree's level of S_pad nodes."""
    cg = _ragged(layout)
    n_inner, A = cg.tree.shape[0], pcl.ARITY
    kids = torch.arange(n_inner)[:, None] * A + 1 + torch.arange(A)
    rows = torch.cat([cg.tree, cg.cl_aabb])
    child = rows[kids.clamp(max=rows.shape[0] - 1)]
    inside = kids < rows.shape[0]
    real = inside & (child[..., 0] < 1e38)
    assert bool(real.any(dim=1)[cg.tree[:, 0] < 1e38].all())
    lo_ok = cg.tree[:, None, 0:3] <= child[..., 0:3]
    hi_ok = cg.tree[:, None, 3:6] >= child[..., 3:6]
    assert bool((lo_ok & hi_ok).all(dim=2)[real].all())
    S, per_super = cg.num_supers, round(np.log(pcl.SUPER) / np.log(A))
    start = (A ** (cg.depth - per_super) - 1) // (A - 1)
    assert torch.equal(cg.tree[start:start + S], cg.sup_aabb[:S])


@pytest.mark.parametrize("layout", ["morton", "sah"])
def test_every_cluster_sits_under_one_leaf_slot(layout):
    """Leaf slot j of the tree (heap index n_inner + j) is cluster j: each
    real cluster has one slot, and the slots past C_pad are padding. A node
    is a far-point box exactly when no real cluster lies below it."""
    cg = _ragged(layout)
    A, depth = pcl.ARITY, cg.depth
    C_pad = cg.num_slots // pcl.CLUSTER
    below = torch.zeros(A ** depth, dtype=torch.bool)
    below[:C_pad] = cg.cl_count > 0
    assert int(below.sum()) == int((cg.cl_count > 0).sum()) and A ** depth >= C_pad
    far = []
    while below.numel() > 1:
        below = below.reshape(-1, A).any(dim=1)
        far.append(~below)
    far = torch.cat(far[::-1])
    assert far.numel() == cg.tree.shape[0] and bool(far.any())
    assert torch.equal(far, (cg.tree[:, :6] == 3.0e38).all(dim=1))


def _walk_cases():
    """(name, builder of (accel, o, d)): the ragged soups with seeded rays
    and the tie case."""
    yield from ((f"ragged {layout}", lambda layout=layout: (
        _ragged(layout), *(torch.from_numpy(a) for a in _random_rays(192, seed=6))))
        for layout in ("morton", "sah"))
    yield "tie", lambda: _tie_case()[:3]


def _tie_case():
    """Triangle 250 is a copy of triangle 40, laid out in cluster 0 and 40
    in cluster 2 (accel, o, d, geometry)."""
    _, pg = _soup(300, seed=3)
    for k in ("v0", "v1", "v2"):
        getattr(pg, k)[250] = getattr(pg, k)[40]
    rest = np.setdiff1d(np.arange(300), [40, 250])
    order = np.concatenate([[250], rest, [40]]).astype(np.int32)
    leaf_info = (order, np.array([0, 128, 256], np.int32),
                 np.array([128, 128, 44], np.int32))
    cg = pcl.build_clusters(pg, leaf_info=leaf_info)
    v0, v1, v2 = pg.v0[40], pg.v1[40], pg.v2[40]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.linalg.norm(n)
    o = ((v0 + v1 + v2) / 3.0 + 0.05 * n)[None]
    return cg, o, -n[None], pg


class _FlatWalk(_Walk):
    """The walk of the flat scan that the tree replaced: supers front to
    back by (entry, index), every super box slab-tested at each step, then
    the SUPER cluster boxes of the super in order."""

    def run(self) -> None:
        cg = self.cg
        R = self.o.shape[0]
        S = cg.num_supers
        sup = cg.sup_aabb[:S]
        last_e = torch.full((R,), -1.0)
        last_s = torch.full((R,), -1, dtype=torch.int64)
        active = torch.ones((R,), dtype=torch.bool)
        sidx = torch.arange(S)
        while True:
            r = active.nonzero()[:, 0]
            if not r.numel():
                return
            e, h = _slab_rows(sup[None].expand(r.numel(), S, 8), self.o[r], self.inv[r],
                              self.bound(r))
            self.stats[r, 2] += S
            after = (e > last_e[r, None]) | ((e == last_e[r, None]) & (sidx > last_s[r, None]))
            cand = h & after
            ns = torch.where(cand, e, torch.full_like(e, float("inf"))).argmin(dim=1)
            has = cand.any(dim=1)
            active[r[~has]] = False
            r, ns, e = r[has], ns[has], e[has]
            last_e[r] = e.gather(1, ns[:, None])[:, 0]
            last_s[r] = ns
            for c in range(pcl.SUPER):
                keep = ~self.found[r]
                r, ns = r[keep], ns[keep]
                j = ns * pcl.SUPER + c
                _, h = _slab_rows(cg.cl_aabb[j][:, None], self.o[r], self.inv[r],
                                  self.bound(r))
                self.stats[r, 2] += 1
                if bool(h.any()):
                    self.visit(r[h[:, 0]], j[h[:, 0]])
            active &= ~self.found


def _flat_walk(cg, o, d, t_init, any_hit=False):
    w = _FlatWalk(cg, o, d, t_init, False, any_hit)
    w.run()
    return w.best, w.slot.to(torch.int32), w.stats.to(torch.int32)


@pytest.mark.parametrize("case", [name for name, _ in _walk_cases()])
def test_walk_matches_plain(case):
    """The model of the kernel's walk (stack order as in csrc/clustered.cu,
    no cull by the best t) and the flat walk it replaced return
    run_clustered_plain's (t, slot) exactly, closest and any-hit, at an
    open and at a short limit; the tree tests fewer boxes."""
    cg, o, d = dict(_walk_cases())[case]()
    for limit in (1e5, 4.0):
        ti = torch.full((o.shape[0],), limit)
        p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, ti, False)
        boxes = {}
        for order, run in (("tree", walk), ("flat", _flat_walk)):
            t, slot, stats = run(cg, o, d, ti)
            assert torch.equal(t, p_t) and torch.equal(slot, p_slot), order
            _, a_slot, a_stats = run(cg, o, d, ti, any_hit=True)
            assert torch.equal(a_slot >= 0, p_slot >= 0), order
            assert bool((a_stats <= stats).all()), order
            boxes[order] = stats[:, 2].sum().item()
        if case != "tie":
            assert 0.3 < (p_slot >= 0).float().mean() < 1.0
            assert boxes["tree"] < 0.6 * boxes["flat"]
    if case == "tie":
        assert cg.slot_to_tri[p_slot[0].long()].item() == 40


def _diagonal_rays(n, seed):
    """Seeded rays through the room, half with the direction (1, 1, 1)
    (not normalised), half in the positive octant with every component
    below 0.88."""
    r = np.random.default_rng(seed)
    o = r.uniform([-7, -20, 1], [7, 19, 16], size=(n, 3)).astype(np.float32)
    d = r.uniform(0.1, 1.0, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n // 2] = 1.0
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("layout", ["morton", "sah"])
def test_walk_keeps_out_of_the_leaf_padding_at_an_open_limit(layout):
    """At a limit of inf or 3e38 a far-point box passes the slab test of a
    ray along (1, 1, 1), so the walk enters the inner nodes above the leaf
    padding; it tests no child past the last real leaf row (the model
    indexes the leaf rows unclamped and would raise) and returns
    run_clustered_plain's (t, slot) exactly, closest and any-hit."""
    cg = _ragged(layout, n=15_000)      # 2 or 3 supers: 128 or 192 of 256 leaf slots
    assert pcl.ARITY ** cg.depth > cg.cl_count.shape[0]
    o, d = _diagonal_rays(128, seed=7)
    far = torch.full((1, 1, 8), 3.0e38)
    for limit in (float("inf"), 3.0e38):
        ti = torch.full((o.shape[0],), limit)
        _, through = _slab_rows(far.expand(o.shape[0], 1, 8), o, pcl.inverse(d), ti)
        assert bool(through[: o.shape[0] // 2].all())
        p_t, p_slot, _ = pcl.run_clustered_plain(cg, o, d, ti, False)
        t, slot, stats = walk(cg, o, d, ti)
        assert torch.equal(t, p_t) and torch.equal(slot, p_slot)
        _, a_slot, _ = walk(cg, o, d, ti, any_hit=True)
        assert torch.equal(a_slot >= 0, p_slot >= 0)
        assert 0.0 < (p_slot >= 0).float().mean() < 1.0


def test_bunny_render_matches_jax(bunny):
    """render_sample of bunny(4000) (backend auto -> pallas -> clustered,
    sorted wavefront), 16x16 x 2 bounces, against JAX."""
    js, ps = bunny
    kw = dict(width=16, height=16, bounces=2)
    assert P.resolve_backend(ps, P.RenderConfig(**kw)) == "pallas"
    ref = np.asarray(J.render_sample(js, J.Camera.default(), J.RenderConfig(**kw),
                                     frame=1))
    got = P.render_sample(ps, P.Camera.default(device=CPU), P.RenderConfig(**kw),
                          frame=1)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_diffuse_gradient_matches_jax(bunny):
    """d mean(render_sample) / d diffuse through the wavefront: the rows'
    scatter-add (_PrecomputedRows) against JAX pallas's custom VJP."""
    js, ps = bunny
    kw = dict(width=16, height=16, bounces=2, backend="pallas")

    def jloss(kd):
        s = js.replace(materials=js.materials.replace(diffuse=kd))
        return jnp.mean(J.render_sample(s, J.Camera.default(), J.RenderConfig(**kw)))

    g_ref = np.asarray(jax.grad(jloss)(js.materials.diffuse))
    g = pgrad.scene_grad(ps, P.Camera.default(device=CPU), P.RenderConfig(**kw),
                          lambda img: img.mean()).materials.diffuse.numpy()
    scale = max(np.abs(g_ref).max(), 1e-6)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g / scale, g_ref / scale, atol=1e-4)
