"""Morton codes and the LBVH ``bvh`` backend (the JAX package's
``ops/bvh.py``).

Morton codes order the triangles of the clustered kernel's Morton layout
(ops/cuda/clustered.build_clusters), the rays of the sorted wavefront
(ops/integrator._ray_sort_keys) and the LBVH's leaves. Codes are int64
holding the uint32 value: torch on the CPU has no ``>>`` or ``*`` on
uint32, so every step is masked to 32 bits.

LBVH build: triangles sorted (stably) along the 30-bit Morton curve of
their quantized centroids, grouped into fixed-size leaves, and a complete
binary tree of boxes built bottom-up over the leaves, in heap layout
(node ``i`` has children ``2i+1`` / ``2i+2``, leaves on the last level).
The build gives the JAX package's ``slot_to_tri`` and boxes bitwise.

Traversal: the reference's per-ray stack walk (Intersect,
kernel_bvh.cl:171-219; JAX ``_intersect_one``): every ray pops one node
at a time from its own stack of ``depth + 2`` entries, tests the node's
box against its best t, tests a leaf's triangles (strict ``t < best``,
the first index on ties) and pushes an inner node's children near-first
by entry distance (``tn0 <= tn1``). Each ray makes the JAX walk's
decisions in the same order on every node that holds a triangle; subtrees
of padding only are not entered (``_slab_test``), so results, ties
included, are the JAX walk's. On a CUDA device the walk is a kernel
(``csrc/bvh.cu`` through ``ops/cuda/bvh.walk``, one thread a ray), so
``render`` captures the backend like the others (jit.py); its plain
version, ``walk_plain``, runs it vectorised over the live rays, a host
loop of one node per ray a step. The JAX traversal is jnp code (a vmapped
``lax.while_loop``), not a Pallas kernel: this is a reference path, not
the fast one (large scenes belong to the cluster-traversal kernel).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import BVHConfig
from ..models.scene import Geometry
from .cuda import bvh as bvh_kernel
from .intersect import Hit, ray_triangle

_U32 = 0xFFFFFFFF
# Padding value of the triangle slots past the last triangle.
_BIG = 1e30


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value with two zero bits between
    them (standard Morton bit-dilation), in uint32 arithmetic."""
    v = v.to(torch.int64) & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(points01: torch.Tensor) -> torch.Tensor:
    """[N, 3] points in [0,1] -> 30-bit Morton codes (int64)."""
    q = torch.clamp(points01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (expand_bits_10(q[:, 0]) * 4
            + expand_bits_10(q[:, 1]) * 2
            + expand_bits_10(q[:, 2]))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class BVH:
    """Segment-tree LBVH over Morton-sorted triangles.

    ``2 * num_leaves - 1`` nodes in heap order, root at 0; leaf ``j`` is
    node ``num_leaves - 1 + j`` and covers triangle slots ``[j*leaf_size,
    (j+1)*leaf_size)`` of the padded, Morton-ordered corners. Padding
    slots hold corners at 1e30 that never win, and a leaf of padding only
    has the box (+1e30, -1e30) that every slab test rejects.
    """

    node_lo: torch.Tensor      # [2L-1, 3]
    node_hi: torch.Tensor      # [2L-1, 3]
    pv0: torch.Tensor          # [L*leaf, 3] Morton-ordered, padded corners
    pv1: torch.Tensor          # [L*leaf, 3]
    pv2: torch.Tensor          # [L*leaf, 3]
    slot_to_tri: torch.Tensor  # [L*leaf] int32 original triangle index
    leaf_size: int
    num_leaves: int

    @property
    def depth(self) -> int:
        """Tree depth (root = level 0)."""
        return self.num_leaves.bit_length() - 1

    @property
    def num_nodes(self) -> int:
        return 2 * self.num_leaves - 1


@torch.no_grad()
def build_bvh(geometry: Geometry, cfg: BVHConfig = BVHConfig()) -> BVH:
    """Build the LBVH on the geometry's device (sorts, reshapes and
    reductions; no gradient)."""
    v0, v1, v2 = geometry.v0.detach(), geometry.v1.detach(), geometry.v2.detach()
    T = v0.shape[0]
    leaf = cfg.leaf_size

    # Morton order of the quantized centroids over their bounds (replaces
    # the SAH split search, CLBVHnode.cpp:76-134). Stable, as
    # jax.lax.sort_key_val: coplanar quads give equal codes.
    cent = (v0 + v1 + v2) / 3.0
    lo, hi = torch.amin(cent, dim=0), torch.amax(cent, dim=0)
    codes = morton3d((cent - lo) / torch.clamp(hi - lo, min=1e-12))
    order = torch.sort(codes, stable=True).indices

    L = _next_pow2(max((T + leaf - 1) // leaf, 1))
    S = L * leaf
    slot_to_tri = torch.cat([order, order.new_zeros(S - T)]).to(torch.int32)

    def padded(a):
        return torch.cat([a[order], a.new_full((S - T, 3), _BIG)])

    pv0, pv1, pv2 = padded(v0), padded(v1), padded(v2)

    # Leaf boxes; padding slots become an empty box.
    pad_mask = (torch.arange(S, device=v0.device) >= T).reshape(L, leaf, 1)
    tri_lo = torch.minimum(torch.minimum(pv0, pv1), pv2).reshape(L, leaf, 3)
    tri_hi = torch.maximum(torch.maximum(pv0, pv1), pv2).reshape(L, leaf, 3)
    tri_lo = torch.where(pad_mask, torch.full_like(tri_lo, _BIG), tri_lo)
    tri_hi = torch.where(pad_mask, torch.full_like(tri_hi, -_BIG), tri_hi)
    levels_lo, levels_hi = [tri_lo.amin(dim=1)], [tri_hi.amax(dim=1)]
    # Bottom-up union sweep: level k has 2^k nodes.
    while levels_lo[-1].shape[0] > 1:
        cur_lo, cur_hi = levels_lo[-1], levels_hi[-1]
        levels_lo.append(torch.minimum(cur_lo[0::2], cur_lo[1::2]))
        levels_hi.append(torch.maximum(cur_hi[0::2], cur_hi[1::2]))
    return BVH(node_lo=torch.cat(levels_lo[::-1]), node_hi=torch.cat(levels_hi[::-1]),
               pv0=pv0, pv1=pv1, pv2=pv2, slot_to_tri=slot_to_tri,
               leaf_size=leaf, num_leaves=L)


def _slab_test(lo, hi, o, inv_d, t_best):
    """Ray-box slab test against the current best t (RayBounds,
    kernel_bvh.cl:156-169): (hit, entry t before clamping at 0).

    An inverted box (a subtree of padding slots, lo = +1e30 > hi = -1e30)
    is a miss. The min/max slab form alone passes it (its slabs run from
    -inf to +inf), and the JAX walk does enter every padding subtree: on
    the 69,732-triangle bunny (16,384 leaves, 7,667 of them padding) that
    is ~15,400 nodes a ray, against ~100 here. Padding never wins and
    entering it moves no other node on the stack, so every result is the
    JAX walk's."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = torch.minimum(tmax, t_best) >= torch.clamp(tmin, min=0.0)
    return hit & (lo <= hi).all(dim=-1), tmin


@torch.no_grad()
def walk_plain(o, d, t_init, bvh: BVH, backface_cull: bool, stats=None):
    """Closest hit below ``t_init`` of every ray: (best t [R], best slot
    [R] int64, 0 where nothing is below t_init). The plain version of the
    walk kernel (ops/cuda/bvh.py). ``stats`` (int64 [R]) gains each ray's
    count of Moller-Trumbore tests, leaf_size a leaf entered."""
    R, dev = o.shape[0], o.device
    L, leaf = bvh.num_leaves, bvh.leaf_size
    inv_d = 1.0 / torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))
    stack = torch.zeros((R, bvh.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)
    best_t = t_init.clone()
    best_slot = torch.zeros((R,), dtype=torch.int64, device=dev)
    lanes = torch.arange(leaf, device=dev)
    while True:
        r = (sp > 0).nonzero()[:, 0]
        if r.numel() == 0:
            return best_t, best_slot
        top = sp[r] - 1
        node = stack[r, top]
        in_box, _ = _slab_test(bvh.node_lo[node], bvh.node_hi[node], o[r], inv_d[r],
                               best_t[r])
        is_leaf = node >= L - 1

        # A leaf: its triangle block densely, strict t < best, first index
        # on ties.
        m = in_box & is_leaf
        rl = r[m]
        if stats is not None:
            stats[rl] += leaf
        if rl.numel():
            base = (node[m] - (L - 1)) * leaf
            rows = base[:, None] + lanes
            t, _, _, valid = ray_triangle(o[rl][:, None], d[rl][:, None], bvh.pv0[rows],
                                          bvh.pv1[rows], bvh.pv2[rows], backface_cull)
            cur = best_t[rl]
            t = torch.where(valid & (t < cur[:, None]), t, torch.full_like(t, float("inf")))
            tk, k = t.min(dim=1)
            better = tk < cur
            best_t[rl] = torch.where(better, tk, cur)
            best_slot[rl] = torch.where(better, base + k, best_slot[rl])

        # An inner node: push both children, the nearer entry on top.
        m = in_box & ~is_leaf
        ri = r[m]
        if ri.numel():
            c0 = 2 * node[m] + 1
            c1 = c0 + 1
            oi, ii, bi = o[ri], inv_d[ri], best_t[ri]
            _, tn0 = _slab_test(bvh.node_lo[c0], bvh.node_hi[c0], oi, ii, bi)
            _, tn1 = _slab_test(bvh.node_lo[c1], bvh.node_hi[c1], oi, ii, bi)
            near = tn0 <= tn1
            at = top[m]
            stack[ri, at] = torch.where(near, c1, c0)
            stack[ri, at + 1] = torch.where(near, c0, c1)
            top[m] = at + 2
        sp[r] = top


@torch.no_grad()
def _walk(o, d, t_init, bvh: BVH, backface_cull: bool):
    """``walk_plain``'s result: the kernel on CUDA, the plain walk on the
    CPU (ops/cuda/bvh.walk)."""
    return bvh_kernel.walk(o.contiguous(), d.contiguous(), t_init.contiguous(), bvh,
                           backface_cull)


def intersect_bvh(o: torch.Tensor, d: torch.Tensor, bvh: BVH, t_max: float = 1e5,
                  backface_cull: bool = False) -> Hit:
    """Closest hit through the LBVH -> Hit with *original* triangle
    indices (through ``slot_to_tri``); a miss gives t = t_max and
    tri_idx = 0."""
    t_init = torch.full((o.shape[0],), t_max, dtype=o.dtype, device=o.device)
    best_t, best_slot = _walk(o.detach(), d.detach(), t_init, bvh, backface_cull)
    hit = best_t < t_init
    tri = bvh.slot_to_tri.to(torch.int64)[best_slot]
    return Hit(t=torch.where(hit, best_t, t_init),
               tri_idx=torch.where(hit, tri, torch.zeros_like(tri)), hit=hit)


def occluded_bvh(o: torch.Tensor, d: torch.Tensor, t_limit: torch.Tensor, bvh: BVH,
                 backface_cull: bool = False) -> torch.Tensor:
    """Shadow-ray query: True where some triangle lies at 0 < t < t_limit
    (a non-finite limit counts as 1e30)."""
    limit = torch.where(torch.isfinite(t_limit), t_limit, torch.full_like(t_limit, _BIG))
    best_t, _ = _walk(o.detach(), d.detach(), limit.detach(), bvh, backface_cull)
    return best_t < limit
