"""The cluster-traversal intersector of the wavefront ``pallas`` backend
for large scenes (more than ``intersect.FLAT_PANEL_MAX_TRIS`` triangles).

Triangles sit in slots, ``CLUSTER`` consecutive slots per cluster and
``SUPER`` consecutive clusters per super; clusters and supers carry AABBs.
The slot layout comes from the native binned-SAH build (one SAH leaf per
cluster, ``build_accel``) or, without a C++ compiler, from a Morton sort
of the centroids (``build_clusters``). The layout is the port's own: f32
(v0, e1, e2) records in slot order and the shading rows beside them; the
JAX package's limb-packed bf16 M-T rows were a device of its matrix unit.
Above the clusters sits an implicit ``ARITY``-ary tree in slot order
(``tree``, heap order, root first): each node's box is the min / max of
its children's, the clusters are its leaves, and the supers are one of
its levels. The kernel walks it front to back.

The kernel, written by hand in ``csrc/clustered.cu``, replaces the JAX
package's ``ops/pallas/clustered.py:_clustered_kernel``.
``run_clustered_plain`` is its plain PyTorch version, and
``ops/cuda/clustered_walk.py`` a model of its traversal order. The
wrappers ``clustered_closest`` and ``clustered_any`` run the plain version
for tensors on the CPU and launch the kernel for tensors on a CUDA
device; there is no fallback between the two. ``LAUNCHES`` counts kernel
launches and ``SHAPES`` keeps each wrapper's last launch shape.

Tie rule (kernel and plain version): among equal t the lowest original
triangle id wins, so the result does not depend on the order in which the
clusters are visited. (The JAX kernel resolves exact ties by visit
order.)
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ... import native
from ...config import RenderConfig
from ...models.scene import Geometry, Materials
from ..bvh import morton3d
from ..intersect import Hit, ray_triangle_edges
from ..shading import ShadingTable, build_shading_table
from . import build
from .megakernel import _check

LAUNCHES = {"clustered_closest": 0, "clustered_any": 0}
SHAPES = {}

# Triangles per cluster and clusters per super; children per tree node,
# the depth of the kernel's traversal stack and the lanes that walk one
# ray (csrc/clustered.cu's kCluster, kArity, kStack and kLanes). SUPER is
# a power of ARITY, so the supers are a level of the tree.
CLUSTER = 128
SUPER = 64
ARITY = 4
STACK = 64
LANES = 4
ATTR_COLS = ShadingTable.COLS
_TRI_COLS = 9
_AABB_COLS = 8
_BIG = 3.0e38
_INV_EPS = 1e-20
_NO_KEY = torch.iinfo(torch.int64).max
# Bounds on the plain version's intermediates: [rays x clusters] slab
# panels and [pairs x CLUSTER] Möller–Trumbore panels.
_PLAIN_SLAB_ELEMS = 1 << 23
_PLAIN_PAIRS = 1 << 15


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class ClusteredGeometry:
    """The slot layout on the device. Rebuild after vertex changes, as
    the reference rebuilds its BVH (CLBVHnode.cpp:185-207)."""

    tris: torch.Tensor         # [T_pad, 9] f32 v0, e1, e2 per slot; zero on padding
    cl_aabb: torch.Tensor      # [C_pad, 8] cluster lo.xyz, hi.xyz
    sup_aabb: torch.Tensor     # [S_pad, 8] super lo.xyz, hi.xyz
    # [N, 8] the tree's inner nodes (lo.xyz, hi.xyz) in heap order: node n's
    # children are n * ARITY + 1 ... n * ARITY + ARITY, and child N + j is
    # cluster j. N = (ARITY**depth - 1) / (ARITY - 1), ARITY**depth >= C_pad.
    tree: torch.Tensor
    slot_to_tri: torch.Tensor  # [T_pad] int32 original triangle id; 0 on padding
    # [T_pad / CLUSTER] int32 real slots per cluster: they are the first
    # ones of its CLUSTER slots, so the kernel tests no padding.
    cl_count: torch.Tensor
    # [T_pad, 34] f32 shading rows (ShadingTable layout) in slot order,
    # zero on padding, or None when built without materials: the kernel
    # returns the winner's row. Snapshot values; make_intersectors
    # refreshes the material columns from the live materials through
    # ``slot_mat`` [T_pad] int32 (the material of each slot).
    attrs: Optional[torch.Tensor] = None
    slot_mat: Optional[torch.Tensor] = None
    layout: str = "morton"     # "sah" (native build) or "morton"

    @property
    def num_supers(self) -> int:
        """Real supers (the AABB rows beyond them are padding)."""
        return max(self.tris.shape[0] // (SUPER * CLUSTER), 1)

    @property
    def num_slots(self) -> int:
        return self.tris.shape[0]

    @property
    def depth(self) -> int:
        """Levels of inner nodes above the clusters."""
        return _tree_depth(self.num_slots // CLUSTER)


def _slots_from_leaf_info(leaf_info, T: int):
    """Slot layout (numpy) from the native SAH leaf ranges: each leaf goes
    into its own CLUSTER-slot block. Returns (order [T_pad] int32, the
    original triangle per slot, 0 on padding; valid [T_pad] bool)."""
    order_np, starts, counts = leaf_info
    if len(counts) and int(np.max(counts)) > CLUSTER:
        raise ValueError(f"a leaf of {int(np.max(counts))} triangles does not fit "
                         f"a cluster of {CLUSTER} slots")
    C = max(len(starts), 1)
    S = max(-(-C // SUPER), 1)
    T_pad = S * SUPER * CLUSTER
    slot_src = np.full((T_pad,), -1, np.int32)
    if len(starts):
        leaf_ids = np.repeat(np.arange(C, dtype=np.int64), counts)
        within = np.arange(T, dtype=np.int64) - np.repeat(
            starts.astype(np.int64), counts)
        slot_src[leaf_ids * CLUSTER + within] = order_np
    return np.maximum(slot_src, 0), slot_src >= 0


def _corners(geometry: Geometry):
    return tuple(getattr(geometry, k).detach().to(torch.float32)
                 for k in ("v0", "v1", "v2"))


def build_clusters(geometry: Geometry, leaf_info=None,
                   materials: Optional[Materials] = None) -> ClusteredGeometry:
    """Cluster the triangles and build the AABB levels and the tree, on
    the geometry's device. ``leaf_info`` is a native SAH layout
    (``native.sah_order``: order, leaf starts, leaf counts; one leaf per
    cluster); without it the triangles are Morton-sorted by centroid into
    runs of CLUSTER. With ``materials`` the accel also carries the
    shading rows."""
    v0, v1, v2 = _corners(geometry)
    T = v0.shape[0]
    dev = v0.device
    st = None
    if materials is not None:
        st = build_shading_table(geometry, materials).table.detach().to(torch.float32)
    if leaf_info is not None:
        order, valid = _slots_from_leaf_info(leaf_info, T)
        return _assemble(v0, v1, v2, torch.from_numpy(order).to(dev),
                         torch.from_numpy(valid).to(dev), st, geometry.mat_idx,
                         "sah")
    cent = (v0 + v1 + v2) / 3.0
    lo = torch.amin(cent, dim=0)
    hi = torch.amax(cent, dim=0)
    codes = morton3d((cent - lo) / torch.clamp(hi - lo, min=1e-12))
    morder = torch.sort(codes, stable=True).indices.to(torch.int32)
    C = max(-(-T // CLUSTER), 1)
    S = max(-(-C // SUPER), 1)
    T_pad = S * SUPER * CLUSTER
    order = torch.nn.functional.pad(morder, (0, T_pad - T))
    valid = torch.arange(T_pad, device=dev) < T
    return _assemble(v0, v1, v2, order, valid, st, geometry.mat_idx, "morton")


def _assemble(v0, v1, v2, order, valid, st, mat_idx, layout) -> ClusteredGeometry:
    """Gather the triangles into slot order; build the records, the AABB
    levels, the tree and, with ``st``, the shading rows and slot materials."""
    order = order.to(torch.int64)
    real = valid[:, None]

    def take_pad(a):
        g = a[order]
        return torch.where(real, g, torch.full_like(g, _BIG))

    pv0, pv1, pv2 = take_pad(v0), take_pad(v1), take_pad(v2)
    zero = torch.zeros_like(pv0)
    tris = torch.cat([torch.where(real, pv0, zero), torch.where(real, pv1 - pv0, zero),
                      torch.where(real, pv2 - pv0, zero)], dim=1).contiguous()
    cl_aabb, sup_aabb, tree = _aabb_levels(pv0, pv1, pv2, real)
    attrs = slot_mat = None
    if st is not None:
        rows = st[order]
        attrs = torch.where(real, rows, torch.zeros_like(rows)).contiguous()
        slot_mat = torch.where(valid, mat_idx.to(order.device)[order],
                               torch.zeros_like(order)).to(torch.int32)
    return ClusteredGeometry(
        tris=tris, cl_aabb=cl_aabb, sup_aabb=sup_aabb, tree=tree,
        slot_to_tri=torch.where(valid, order, torch.zeros_like(order)).to(torch.int32),
        cl_count=valid.reshape(-1, CLUSTER).sum(dim=1).to(torch.int32),
        attrs=attrs, slot_mat=slot_mat, layout=layout)


def _tree_depth(C_pad: int) -> int:
    """Levels of inner nodes above ``C_pad`` clusters: the least depth
    with ARITY**depth >= C_pad."""
    depth, leaves = 0, 1
    while leaves < C_pad:
        depth, leaves = depth + 1, leaves * ARITY
    return depth


def _tree_nodes(C_pad: int) -> int:
    return (ARITY ** _tree_depth(C_pad) - 1) // (ARITY - 1)


def _aabb_levels(pv0, pv1, pv2, real):
    """Cluster and super AABB levels and the tree's inner nodes from
    slot-ordered corners."""
    T_pad = pv0.shape[0]
    C_pad = T_pad // CLUSTER
    S = C_pad // SUPER
    big = torch.full_like(pv0, _BIG)
    t_lo = torch.where(real, torch.minimum(torch.minimum(pv0, pv1), pv2), big)
    t_hi = torch.where(real, torch.maximum(torch.maximum(pv0, pv1), pv2), -big)

    def fix_empty(lo_, hi_):
        # Empty boxes come out of the reduction inverted (lo > hi), which
        # the min/max slab test would read as an infinite box: make them
        # far-away point boxes that every slab test rejects.
        empty = torch.any(lo_ > hi_, dim=1, keepdim=True)
        return (torch.where(empty, torch.full_like(lo_, _BIG), lo_),
                torch.where(empty, torch.full_like(hi_, _BIG), hi_))

    def pack_aabb(lo_, hi_, rows):
        # Padding rows are far-away point boxes (the slab test fails).
        out = torch.full((rows, _AABB_COLS), _BIG, dtype=torch.float32, device=lo_.device)
        out[:lo_.shape[0], 0:3], out[:lo_.shape[0], 3:6] = fix_empty(lo_, hi_)
        return out

    # Reduce with inverted-box neutral elements (+BIG/-BIG) so partially
    # padded groups stay tight, then normalise the empties of each level:
    # a parent's box is the min / max of its non-empty children's, so it
    # contains each of them bitwise.
    cl_lo = torch.amin(t_lo.reshape(C_pad, CLUSTER, 3), dim=1)
    cl_hi = torch.amax(t_hi.reshape(C_pad, CLUSTER, 3), dim=1)
    sup_lo = torch.amin(cl_lo.reshape(S, SUPER, 3), dim=1)
    sup_hi = torch.amax(cl_hi.reshape(S, SUPER, 3), dim=1)
    # The tree: the clusters padded with empty boxes to ARITY**depth
    # leaves, then one level per reduction by ARITY, up to the root.
    pad = ARITY ** _tree_depth(C_pad) - C_pad
    lo = torch.cat([cl_lo, cl_lo.new_full((pad, 3), _BIG)])
    hi = torch.cat([cl_hi, cl_hi.new_full((pad, 3), -_BIG)])
    levels = []
    while lo.shape[0] > 1:
        lo = torch.amin(lo.reshape(-1, ARITY, 3), dim=1)
        hi = torch.amax(hi.reshape(-1, ARITY, 3), dim=1)
        levels.append(pack_aabb(lo, hi, lo.shape[0]))
    rows = lambda n: max(_ceil_to(n, 8), 8)
    return (pack_aabb(cl_lo, cl_hi, rows(C_pad)), pack_aabb(sup_lo, sup_hi, rows(S)),
            torch.cat(levels[::-1]))


def build_accel(geometry: Geometry, materials: Optional[Materials] = None
                ) -> ClusteredGeometry:
    """The SAH slot layout from the native C++ SAH build when it is
    available (``native.available()``), else the Morton layout. With
    ``materials`` the accel carries shading rows, so closest hits return
    the winner's attributes from the traversal."""
    v0, v1, v2 = (a.cpu().numpy() for a in _corners(geometry))
    leaf_info = (native.sah_order(v0, v1, v2, leaf_size=CLUSTER)
                 if native.available() else None)
    return build_clusters(geometry, leaf_info=leaf_info, materials=materials)


def _check_layout(cg: ClusteredGeometry) -> None:
    """Fail loudly on an accel whose shapes are not this module's slot
    layout (CLUSTER slots per cluster, SUPER clusters per super): a
    mismatch would silently mis-index triangles."""
    T_pad = cg.tris.shape[0]
    C_pad = T_pad // CLUSTER
    S = max(C_pad // SUPER, 1)
    ok = (cg.tris.dim() == 2 and cg.tris.shape[1] == _TRI_COLS
          and T_pad % CLUSTER == 0 and C_pad % SUPER == 0
          and tuple(cg.cl_aabb.shape) == (max(_ceil_to(C_pad, 8), 8), _AABB_COLS)
          and tuple(cg.sup_aabb.shape) == (max(_ceil_to(S, 8), 8), _AABB_COLS)
          and tuple(cg.tree.shape) == (_tree_nodes(C_pad), _AABB_COLS)
          and tuple(cg.slot_to_tri.shape) == (T_pad,)
          and tuple(cg.cl_count.shape) == (C_pad,)
          and (cg.attrs is None or tuple(cg.attrs.shape) == (T_pad, ATTR_COLS)))
    if not ok:
        raise ValueError(
            f"accel layout mismatch: tris {tuple(cg.tris.shape)}, cl_aabb "
            f"{tuple(cg.cl_aabb.shape)}, sup_aabb {tuple(cg.sup_aabb.shape)}, tree "
            f"{tuple(cg.tree.shape)}; expected CLUSTER={CLUSTER}, SUPER={SUPER}, "
            f"ARITY={ARITY}: rebuild the accel")
    if (ARITY - 1) * cg.depth > STACK:
        raise ValueError(f"a tree of depth {cg.depth} outgrows the kernel's stack of "
                         f"{STACK} entries")


def _refresh_attrs(cg: ClusteredGeometry, materials: Materials) -> ClusteredGeometry:
    """The attrs with their material columns (kd, ks, ke, ns) taken from
    the live materials, so a prebuilt accel tracks material updates
    during optimisation."""
    mat_tab = torch.cat([materials.diffuse, materials.specular,
                         materials.emission, materials.roughness[:, None]],
                        dim=1).detach().to(torch.float32)      # [M, 10]
    live = mat_tab[cg.slot_mat.to(torch.int64)]
    attrs = torch.cat([cg.attrs[:, :ShadingTable.KD], live,
                       cg.attrs[:, ShadingTable.NS + 1:]], dim=1).contiguous()
    return dataclasses.replace(cg, attrs=attrs)


# ---------------------------------------------------------------------------
# Plain version of the kernel.

def _inverse(d: torch.Tensor) -> torch.Tensor:
    eps = torch.full_like(d, _INV_EPS)
    return 1.0 / torch.where(torch.abs(d) > _INV_EPS, d, eps)


def _slab(aabb, o, inv, t_far):
    """[r, N] slab hits of AABB rows [N, 8] against rays (o, inv [r, 3]),
    each bounded by its own t_far [r]: min(tmax, t_far) >= max(tmin, 0)."""
    t1 = (aabb[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t2 = (aabb[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    entry = torch.clamp(tmin, min=0.0)
    return torch.minimum(tmax, t_far[:, None]) >= entry


def run_clustered_plain(cg: ClusteredGeometry, o, d, t_init, backface_cull: bool,
                        with_rows: bool = False):
    """Plain version of the kernel: per ray, the closest hit with 0 < t <
    t_init, lowest original triangle id among equal t, over the slots of
    every cluster whose box the ray hits at t_init inside a super whose
    box it hits. Returns (t [R], slot [R] int32, -1 and t_init on a miss,
    rows [R, 34] or None). The kernel's any mode stops at the first hit;
    there only ``slot >= 0`` is defined."""
    R = o.shape[0]
    S = cg.num_supers
    C = S * SUPER
    dev = o.device
    inv = _inverse(d)
    lane = torch.arange(CLUSTER, device=dev)
    t_out = t_init.clone()
    slot_out = torch.full((R,), -1, dtype=torch.int64, device=dev)
    chunk = max(1, _PLAIN_SLAB_ELEMS // C)
    for s0 in range(0, R, chunk):
        oc, dc, ic, tc = (a[s0:s0 + chunk] for a in (o, d, inv, t_init))
        sup_hit = _slab(cg.sup_aabb[:S], oc, ic, tc)
        cl_hit = (_slab(cg.cl_aabb[:C], oc, ic, tc)
                  & sup_hit.repeat_interleave(SUPER, dim=1))
        ray, clu = torch.nonzero(cl_hit, as_tuple=True)
        # Per (ray, cluster) pair: the smallest key (t bits, triangle id);
        # t > 0, so the order of the int32 bits of t is the order of t.
        pair_key, pair_slot = [], []
        for p0 in range(0, ray.shape[0], _PLAIN_PAIRS):
            r, c = ray[p0:p0 + _PLAIN_PAIRS], clu[p0:p0 + _PLAIN_PAIRS]
            slots = c[:, None] * CLUSTER + lane[None, :]
            rec = cg.tris[slots]
            t, _, _, _ = ray_triangle_edges(oc[r][:, None], dc[r][:, None], rec[..., 0:3],
                                            rec[..., 3:6], rec[..., 6:9], backface_cull)
            ok = t < tc[r][:, None]
            key = ((t.contiguous().view(torch.int32).to(torch.int64) << 32)
                   | cg.slot_to_tri[slots].to(torch.int64))
            key = torch.where(ok, key, torch.full_like(key, _NO_KEY))
            kmin, pos = torch.min(key, dim=1)
            pair_key.append(kmin)
            pair_slot.append(c * CLUSTER + pos)
        n = oc.shape[0]
        best = torch.full((n,), _NO_KEY, dtype=torch.int64, device=dev)
        if pair_key:
            pk, ps = torch.cat(pair_key), torch.cat(pair_slot)
            best.scatter_reduce_(0, ray, pk, "amin")
            win = (pk == best[ray]) & (pk < _NO_KEY)
            slot = torch.full((n,), _NO_KEY, dtype=torch.int64, device=dev)
            slot.scatter_reduce_(0, ray[win], ps[win], "amin")
            hit = best < _NO_KEY
            t_bits = (best >> 32).to(torch.int32).view(torch.float32)
            t_out[s0:s0 + n] = torch.where(hit, t_bits, tc)
            slot_out[s0:s0 + n] = torch.where(hit, slot, torch.full_like(slot, -1))
    rows = None
    if with_rows:
        rows = cg.attrs[torch.clamp(slot_out, min=0)]
        rows = torch.where((slot_out >= 0)[:, None], rows, torch.zeros_like(rows))
    return t_out, slot_out.to(torch.int32), rows


# ---------------------------------------------------------------------------
# Kernel wrappers.

_BLOCK = 128             # threads per block (csrc/clustered.cu kClusterBlock)
_COUNTERS = {}           # (device index, stream) -> the persistent warps' counter


@functools.lru_cache(maxsize=None)
def _resident_blocks(index: int, any_hit: bool) -> int:
    """Blocks of the kernel that device ``index`` holds at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.library().mrt_clustered_blocks_per_sm(int(any_hit), ctypes.byref(per_sm))
    build.check(err, "clustered occupancy")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return max(sms * per_sm.value, 1)


def _counter(index: int, stream: int) -> torch.Tensor:
    """The stream's work counter: two int32, zero between launches (the
    kernel's last warp resets them), so launches on one stream share it."""
    c = _COUNTERS.get((index, stream))
    if c is None:
        c = _COUNTERS[(index, stream)] = torch.zeros((2,), dtype=torch.int32,
                                                     device=torch.device("cuda", index))
    return c


def _run(name: str, any_hit: bool, cg: ClusteredGeometry, o, d, t_init,
         backface_cull: bool, with_rows: bool, stats):
    device = o.device
    R = o.shape[0]
    _check_layout(cg)
    T_pad = cg.num_slots
    tensors = {"tris": (cg.tris, torch.float32, (T_pad, _TRI_COLS)),
               "cl_aabb": (cg.cl_aabb, torch.float32, tuple(cg.cl_aabb.shape)),
               "tree": (cg.tree, torch.float32, tuple(cg.tree.shape)),
               "slot_to_tri": (cg.slot_to_tri, torch.int32, (T_pad,)),
               "cl_count": (cg.cl_count, torch.int32, (T_pad // CLUSTER,)),
               "o": (o, torch.float32, (R, 3)), "d": (d, torch.float32, (R, 3)),
               "t_init": (t_init, torch.float32, (R,))}
    if with_rows:
        if cg.attrs is None:
            raise ValueError(f"{name}: rows asked for, but the accel was built "
                             "without materials")
        tensors["attrs"] = (cg.attrs, torch.float32, (T_pad, ATTR_COLS))
    for n, (t, dtype, shape) in tensors.items():
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{n} requires grad: intersection is not "
                             "differentiable; detach the inputs")
        _check(t, n, dtype, shape, device)
    if device.type == "cpu":
        if stats is not None:
            raise ValueError(f"{name}: stats are counted by the kernel only")
        return run_clustered_plain(cg, o, d, t_init, backface_cull, with_rows)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    if stats is not None:
        _check(stats, "stats", torch.int32, (R, 3), device)
    for n in ("tree", "cl_aabb"):   # the kernel reads their rows as float4 + float2
        if getattr(cg, n).data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=device)
    t_out = torch.empty((R,), **f32)
    slot = torch.empty((R,), dtype=torch.int32, device=device)
    rows = torch.empty((R, ATTR_COLS), **f32) if with_rows else None
    if R:
        index = device.index if device.index is not None else torch.cuda.current_device()
        # As many blocks as the card holds at once, no more than the rays need.
        grid = max(1, min(-(-R // (_BLOCK // LANES)), _resident_blocks(index, any_hit)))
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index).cuda_stream
            err = build.library().mrt_clustered(
                R, cg.tree.shape[0], cg.cl_count.shape[0], grid, int(backface_cull),
                int(any_hit), cg.tree.data_ptr(), cg.cl_aabb.data_ptr(), cg.tris.data_ptr(),
                cg.slot_to_tri.data_ptr(), cg.cl_count.data_ptr(),
                ptr(cg.attrs if with_rows else None),
                o.data_ptr(), d.data_ptr(), t_init.data_ptr(), t_out.data_ptr(),
                slot.data_ptr(), ptr(rows), ptr(stats), _counter(index, stream).data_ptr(),
                stream)
        build.check(err, name)
        LAUNCHES[name] += 1
        SHAPES[name] = {"rays": R, "slots": T_pad, "supers": cg.num_supers}
    return t_out, slot, rows


def clustered_closest(cg: ClusteredGeometry, o, d, t_init, backface_cull: bool = False,
                      with_rows: bool = True, stats: Optional[torch.Tensor] = None):
    """Closest hit below ``t_init`` [R] of rays o, d [R, 3]. Returns (t [R]
    float32, slot [R] int32, -1 and t_init on a miss, rows [R, 34] or
    None: the winner's shading row, zeros on a miss). ``stats`` (CUDA
    only), an int32 [R, 3] tensor, receives each ray's Möller–Trumbore
    tests, cluster visits and box (slab) tests."""
    return _run("clustered_closest", False, cg, o, d, t_init, backface_cull,
                with_rows and cg.attrs is not None, stats)


def clustered_any(cg: ClusteredGeometry, o, d, t_limit, backface_cull: bool = False,
                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Any hit with 0 < t < ``t_limit`` [R] (finite): bool [R]."""
    return _run("clustered_any", True, cg, o, d, t_limit, backface_cull, False,
                stats)[1] >= 0


def _rays(o, d):
    return (o.detach().to(torch.float32).contiguous(),
            d.detach().to(torch.float32).contiguous())


def intersect_clustered(o: torch.Tensor, d: torch.Tensor, cg: ClusteredGeometry,
                        t_max: float, backface_cull: bool = False) -> Hit:
    """Closest hit (original triangle ids). With shading rows in the accel
    the Hit carries the winner's row (zeros on a miss)."""
    o, d = _rays(o, d)
    t_init = torch.full((o.shape[0],), t_max, dtype=torch.float32, device=o.device)
    t_best, slot, rows = clustered_closest(cg, o, d, t_init, backface_cull)
    hit = slot >= 0
    tri = cg.slot_to_tri[torch.clamp(slot, min=0).to(torch.int64)].to(torch.int64)
    return Hit(t=torch.where(hit, t_best, t_init),
               tri_idx=torch.where(hit, tri, torch.zeros_like(tri)), hit=hit, rows=rows)


def occluded_clustered(o: torch.Tensor, d: torch.Tensor, t_limit: torch.Tensor,
                       cg: ClusteredGeometry, backface_cull: bool = False) -> torch.Tensor:
    """Shadow-ray occlusion (any hit below ``t_limit``; inf = the whole
    ray)."""
    o, d = _rays(o, d)
    t_limit = t_limit.detach().to(torch.float32)
    t_init = torch.where(torch.isfinite(t_limit), t_limit,
                         torch.full_like(t_limit, _BIG)).contiguous()
    return clustered_any(cg, o, d, t_init, backface_cull)


def make_intersectors(geometry: Geometry, cfg: RenderConfig, accel=None,
                      materials: Optional[Materials] = None):
    """(closest, any_hit) for ops/integrator.trace_paths. A prebuilt
    ``accel`` is checked and its material columns refreshed from
    ``materials``; without one the Morton layout is built here."""
    if accel is not None:
        _check_layout(accel)
        cg = accel
        if materials is not None and cg.attrs is not None and cg.slot_mat is not None:
            cg = _refresh_attrs(cg, materials)
    else:
        cg = build_clusters(geometry, materials=materials)
    closest = functools.partial(intersect_clustered, cg=cg, t_max=cfg.t_max,
                                backface_cull=cfg.backface_cull)
    any_hit = functools.partial(occluded_clustered, cg=cg,
                                backface_cull=cfg.backface_cull)
    return closest, any_hit
