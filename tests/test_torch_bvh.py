"""The port's LBVH (``ops/bvh.py``) and the ``bvh`` backend against the
JAX package's on the CPU.

The six cases of tests/test_bvh.py run on the port (invariants, winners
against the brute-force oracle). Then, on the same inputs as JAX: the
build bitwise (``slot_to_tri``, ``node_lo``, ``node_hi``, ``pv*``) on
Cornell and on a seeded soup of 1000 triangles; ``intersect_bvh`` /
``occluded_bvh`` on 256 seeded rays with ``tri_idx`` and ``hit`` equal and
t within 1e-6 relative (the same float32 Möller–Trumbore, summed in
another order); and ``render(backend="bvh")`` at 16x16 x 2 against JAX's
bvh render within atol 2e-5, rtol 1e-4 (tests/test_torch_render.py's
tolerance: the same shading in another operation order), through the
compiled ``render``.
The walk's tie rule on rays at shared edges (Cornell, a soup of quads):
its t is the dense minimum bitwise, and a tie within one leaf goes to the
first slot; the kernel's wrapper on the CPU is the plain walk. The
kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu.ops import bvh as jbvh
from mini_opencl_raytracer_tpu_torch.config import BVHConfig
from mini_opencl_raytracer_tpu_torch.ops import bvh as pbvh
from mini_opencl_raytracer_tpu_torch.ops.cuda import bvh as bvh_kernel
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import parity
from mini_opencl_raytracer_tpu_torch.ops.intersect import ray_triangle

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell_p():
    return P.cornell_scene(device="cpu")


@pytest.fixture(scope="module")
def cornell_bvh(cornell_p):
    return pbvh.build_bvh(cornell_p.geometry, BVHConfig(leaf_size=8))


def _soup(n, seed):
    r = np.random.default_rng(seed)
    base = r.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    e1 = r.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    e2 = r.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    return base, base + e1, base + e2


def _geometries(v0, v1, v2):
    """(JAX Geometry, port Geometry) of the same corners."""
    n = v0.shape[0]
    z3, z2 = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32)
    zi = np.zeros((n,), np.int32)
    arrs = dict(v0=v0, v1=v1, v2=v2, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                mat_idx=zi)
    return (J.Geometry(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            P.Geometry(**{k: torch.from_numpy(v.copy()) for k, v in arrs.items()}))


def _random_rays(n, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform([-7, -20, 1], [7, 19, 16], size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_leaf_partition_covers_all(cornell_p, cornell_bvh):
    """Every triangle sits in exactly one real leaf slot."""
    real = cornell_bvh.slot_to_tri[cornell_bvh.pv0[:, 0] < 1e29].tolist()
    assert sorted(real) == list(range(cornell_p.num_triangles))


def test_parent_bounds_contain_children(cornell_bvh):
    lo, hi = cornell_bvh.node_lo.numpy(), cornell_bvh.node_hi.numpy()
    for i in range(cornell_bvh.num_leaves - 1):
        for c in (2 * i + 1, 2 * i + 2):
            if (lo[c] > hi[c]).any():      # an empty box is contained
                continue
            assert (lo[i] <= lo[c] + 1e-4).all()
            assert (hi[i] >= hi[c] - 1e-4).all()


def test_leaf_bounds_contain_triangles(cornell_bvh):
    L, leaf = cornell_bvh.num_leaves, cornell_bvh.leaf_size
    lo, hi = cornell_bvh.node_lo.numpy()[L - 1:], cornell_bvh.node_hi.numpy()[L - 1:]
    pv = [cornell_bvh.pv0.numpy(), cornell_bvh.pv1.numpy(), cornell_bvh.pv2.numpy()]
    for j in range(L):
        for s in range(j * leaf, (j + 1) * leaf):
            if pv[0][s, 0] > 1e29:
                continue
            for corner in pv:
                assert (corner[s] >= lo[j] - 1e-4).all()
                assert (corner[s] <= hi[j] + 1e-4).all()


def test_bvh_matches_bruteforce(cornell_p, cornell_bvh):
    """Same hit mask, t and triangle as the all-pairs oracle (ids may
    differ only where coincident triangles tie)."""
    o, d = (torch.from_numpy(a) for a in _random_rays(512))
    brute = P.intersect_brute(o, d, cornell_p.geometry, t_max=1e5)
    hit = P.intersect_bvh(o, d, cornell_bvh, t_max=1e5)
    np.testing.assert_array_equal(brute.hit.numpy(), hit.hit.numpy())
    m = brute.hit
    np.testing.assert_allclose(brute.t[m].numpy(), hit.t[m].numpy(), rtol=1e-5)
    assert (brute.tri_idx[m] == hit.tri_idx[m]).float().mean() > 0.99
    # A miss: t = t_max, tri_idx = 0.
    assert (hit.t[~m] == 1e5).all() and (hit.tri_idx[~m] == 0).all()


def test_bvh_occlusion_matches(cornell_p, cornell_bvh):
    o, d = (torch.from_numpy(a) for a in _random_rays(256, seed=1))
    limit = torch.full((256,), 8.0)
    brute = P.occluded_brute(o, d, limit, cornell_p.geometry)
    np.testing.assert_array_equal(brute.numpy(),
                                  P.occluded_bvh(o, d, limit, cornell_bvh).numpy())
    # A non-finite limit is the open ray.
    inf = torch.full((256,), float("inf"))
    np.testing.assert_array_equal(P.occluded_brute(o, d, inf, cornell_p.geometry).numpy(),
                                  P.occluded_bvh(o, d, inf, cornell_bvh).numpy())


def test_bigger_scene_random_soup():
    """A random soup (unstructured, shared Morton cells) traverses right."""
    _, geo = _geometries(*_soup(500, 7))
    bvh = pbvh.build_bvh(geo, BVHConfig(leaf_size=4))
    o, d = (torch.from_numpy(a) for a in _random_rays(256, seed=3))
    brute = P.intersect_brute(o, d, geo, t_max=1e5)
    hit = P.intersect_bvh(o, d, bvh, t_max=1e5)
    np.testing.assert_array_equal(brute.hit.numpy(), hit.hit.numpy())
    m = brute.hit
    np.testing.assert_allclose(brute.t[m].numpy(), hit.t[m].numpy(), rtol=1e-4)


# The port against the JAX package on the same inputs.

_CASES = {"cornell": 8, "soup1000": 8, "soup1000_leaf4": 4, "soup600": 8}


@pytest.fixture(scope="module")
def jax_vs_port():
    """Per case: (JAX BVH, port BVH, JAX results on the seeded rays); the
    JAX traversals run once per module."""
    jg = J.cornell_geometry()
    corners = {"cornell": tuple(np.asarray(a) for a in (jg.v0, jg.v1, jg.v2)),
               "soup1000": _soup(1000, 11)}
    corners["soup1000_leaf4"] = corners["soup1000"]
    corners["soup600"] = _soup(600, 12)     # 75 leaves of 128: padding subtrees
    o, d = _random_rays(256, seed=5)
    limit = np.random.default_rng(6).uniform(1.0, 30.0, size=256).astype(np.float32)
    limit[::7] = np.inf
    out = {}
    for case, leaf in _CASES.items():
        jgeo, pgeo = _geometries(*corners[case])
        jb = jbvh.build_bvh(jgeo, J.BVHConfig(leaf_size=leaf))
        pb = pbvh.build_bvh(pgeo, BVHConfig(leaf_size=leaf))
        jh = J.intersect_bvh(jnp.asarray(o), jnp.asarray(d), jb, t_max=1e5)
        jocc = J.occluded_bvh(jnp.asarray(o), jnp.asarray(d), jnp.asarray(limit), jb)
        out[case] = (jb, pb, {"t": np.asarray(jh.t), "tri_idx": np.asarray(jh.tri_idx),
                              "hit": np.asarray(jh.hit), "occ": np.asarray(jocc)})
    return out, (o, d, limit)


@pytest.mark.parametrize("case", list(_CASES))
def test_build_bvh_matches_jax_bitwise(jax_vs_port, case):
    jb, pb, _ = jax_vs_port[0][case]
    assert (pb.leaf_size, pb.num_leaves, pb.depth, pb.num_nodes) == (
        jb.leaf_size, jb.num_leaves, jb.depth, jb.num_nodes)
    for name in ("slot_to_tri", "node_lo", "node_hi", "pv0", "pv1", "pv2"):
        got, ref = getattr(pb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("case", list(_CASES))
def test_traversal_matches_jax(jax_vs_port, case):
    (_, pb, ref), (o, d, limit) = jax_vs_port[0][case], jax_vs_port[1]
    to = lambda a: torch.from_numpy(a)
    hit = P.intersect_bvh(to(o), to(d), pb, t_max=1e5)
    np.testing.assert_array_equal(hit.hit.numpy(), ref["hit"])
    np.testing.assert_array_equal(hit.tri_idx.numpy(), ref["tri_idx"])
    np.testing.assert_allclose(hit.t.numpy(), ref["t"], rtol=1e-6, atol=0)
    assert ref["hit"].any() and not ref["hit"].all()
    occ = P.occluded_bvh(to(o), to(d), to(limit), pb)
    np.testing.assert_array_equal(occ.numpy(), ref["occ"])


def test_padding_subtrees_are_not_entered():
    """An inverted box (a subtree of padding only) misses the slab test,
    whatever the ray; a real box is entered as before."""
    o = torch.tensor([[0.0, -25.0, 8.5], [1e3, 1e3, 1e3]])
    inv = 1.0 / torch.tensor([[0.1, 1.0, -0.2], [1.0, 1.0, 1.0]])
    best = torch.full((2,), 1e5)
    empty = (torch.full((2, 3), pbvh._BIG), torch.full((2, 3), -pbvh._BIG))
    assert not pbvh._slab_test(*empty, o, inv, best)[0].any()
    room = (torch.tensor([[-8.0, 0.0, 0.0]] * 2), torch.tensor([[8.0, 20.0, 17.0]] * 2))
    assert pbvh._slab_test(*room, o, inv, best)[0].tolist() == [True, False]


def test_render_bvh_matches_jax(cornell_p):
    cam = P.Camera.default(device="cpu")
    kw = dict(width=16, height=16, bounces=2, backend="bvh", shadow_rays=True)
    ref = np.asarray(J.render(J.cornell_scene(), J.Camera.default(), J.RenderConfig(**kw),
                              frames=1))
    cfg = P.RenderConfig(**kw)
    accel = P.build_accel(cornell_p, cfg)
    assert isinstance(accel, P.BVH)
    got = P.render(cornell_p, cam, cfg, frames=1, accel=accel)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)
    # Without a prebuilt accel the backend builds its own: the same image.
    assert torch.equal(P.render(cornell_p, cam, cfg, frames=1), got)


def test_compiled_bvh_render_matches_jax(cornell_p):
    """render(), the compiled program, on the bvh backend: its image over
    two frames is JAX's jitted render's."""
    kw = dict(width=16, height=16, bounces=2, backend="bvh")
    ref = np.asarray(J.render(J.cornell_scene(), J.Camera.default(), J.RenderConfig(**kw),
                              frames=2))
    got = P.render(cornell_p, P.Camera.default(device="cpu"), P.RenderConfig(**kw), frames=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("scene", ["cornell", "quad soup"])
def test_walk_ties_go_to_the_first_slot_of_a_leaf(scene):
    """On rays at shared edges, the walk's t is the dense minimum over all
    slots bitwise, and where the slots at that minimum lie in one leaf the
    walk returns the first of them (the kernel must do the same)."""
    sc = (P.cornell_scene(device="cpu") if scene == "cornell"
          else parity.quad_soup_scene("cpu"))
    o, d = parity.shared_edge_rays(sc.geometry, 2048)
    b = pbvh.build_bvh(sc.geometry)
    t_walk, slot = pbvh.walk_plain(o, d, torch.full((o.shape[0],), 1e5), b, False)
    t, _, _, valid = ray_triangle(o[:, None], d[:, None], b.pv0[None], b.pv1[None],
                                  b.pv2[None])
    t = torch.where(valid & (t < 1e5), t, torch.full_like(t, float("inf")))
    t_min = t.min(dim=1).values
    hit = torch.isfinite(t_min)
    assert hit.float().mean() > 0.9 and torch.equal(t_walk[hit], t_min[hit])
    tied = (t == t_min[:, None]) & hit[:, None]
    leaves = torch.where(tied, torch.arange(t.shape[1]) // b.leaf_size, -1)
    one_leaf = (tied.sum(1) >= 2) & (leaves.amax(1) == torch.where(
        tied, leaves, torch.full_like(leaves, 1 << 30)).amin(1))
    assert one_leaf.sum() >= 3
    first = tied.to(torch.int8).argmax(dim=1)
    assert torch.equal(slot[one_leaf], first[one_leaf])


def test_walk_on_the_cpu_is_the_plain_walk(cornell_p, cornell_bvh):
    """The kernel's wrapper runs the plain walk on CPU tensors, launching
    nothing; the plain walk counts leaf_size M-T tests a leaf entered."""
    o, d = (torch.from_numpy(a) for a in _random_rays(256))
    t_init = torch.full((256,), 1e5)
    n0 = build.LAUNCHES["bvh_walk"]
    got = bvh_kernel.walk(o, d, t_init, cornell_bvh)
    stats = torch.zeros(256, dtype=torch.int64)
    ref = pbvh.walk_plain(o, d, t_init, cornell_bvh, False, stats=stats)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert build.LAUNCHES["bvh_walk"] == n0
    assert (stats % cornell_bvh.leaf_size == 0).all() and (stats[got[0] < 1e5] > 0).all()
