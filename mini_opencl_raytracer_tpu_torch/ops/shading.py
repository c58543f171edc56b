"""Hit-attribute fetch: one [T, C] table of per-triangle shading data,
read by the winning triangle's index.

The JAX package fetches rows with a one-hot matmul because the TPU's
gather is slow; here the fetch is an index gather (``table[idx]``), the
plain form on a GPU. The winner's (t, u, v) are recomputed on its row and
interpolated as kernel_bvh.cl:144-147 does. Where the intersector already
fetched the rows (``Hit.rows``, the clustered kernel), ``_PrecomputedRows``
uses them and gives the table the gather's gradient.

The table's material columns come from ``material_rows``, the one rule
for the per-triangle material gather (the mega path's table uses it too):
one gather of the packed ``[M, 10]`` material block whose backward, on
CUDA, is the deterministic reduction of ``csrc/material_rows.cu``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.scene import Geometry, Materials
from . import known
from .cuda import material_rows as _mr
from .intersect import Hit, ray_triangle_edges


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, C], idx [R] -> [R, C] rows (an index gather)."""
    return table[idx]


class _PrecomputedRows(torch.autograd.Function):
    """``take_rows(table, idx)`` whose value a traversal kernel already
    fetched (``krows``, Hit.rows): the forward returns ``krows`` and the
    backward scatter-adds the cotangent rows into the table, the gather's
    gradient (the JAX custom VJP ``_precomputed_rows``, shading.py:50-82).
    Misses carry zero cotangents through the liveness masks. No gradient
    reaches ``idx`` or ``krows``."""

    @staticmethod
    def forward(ctx, table, idx, krows):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return krows.clone()

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        d_table = cot.new_zeros(ctx.table_shape).index_add_(0, idx, cot)
        return d_table, None, None


def pack_materials(materials: Materials) -> torch.Tensor:
    """[M, 10] material block: Kd, Ks, Ke, Ns, the table's KD..NS columns."""
    return torch.cat([materials.diffuse, materials.specular, materials.emission,
                      materials.roughness[:, None]], dim=1)


class _MaterialRows(torch.autograd.Function):
    """``packed[m]``, whose backward sums the cotangent rows by material
    with the CUDA reduction (``ops/cuda/material_rows``) in place of
    ``index_put_``'s. No gradient reaches ``m``."""

    @staticmethod
    def forward(ctx, packed, m):
        ctx.save_for_backward(m)
        ctx.num_materials = packed.shape[0]
        return packed[m]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot):
        (m,) = ctx.saved_tensors
        return _mr.reduce_by_material(cot, m, ctx.num_materials), None


def material_rows(materials: Materials, mat_idx: torch.Tensor) -> torch.Tensor:
    """[T, 10] per-triangle material columns (Kd, Ks, Ke, Ns) by
    ``mat_idx`` [T]. On a CUDA device: one gather of ``pack_materials``,
    whose backward is the kernel's reduction and reaches the four leaves
    through the cat. On the CPU: the plain autograd gather of each leaf,
    which keeps its gradients' bits (there one ``index_put_`` over [T, 10]
    sums in another order than four)."""
    m = mat_idx.to(torch.int64)
    if m.is_cuda:
        return _MaterialRows.apply(pack_materials(materials), m)
    return torch.cat([materials.diffuse[m], materials.specular[m], materials.emission[m],
                      materials.roughness[m][:, None]], dim=1)


class ShadingTable(NamedTuple):
    """[T, C] concatenated per-triangle shading attributes + column map."""

    table: torch.Tensor

    V0, V1, V2 = 0, 3, 6
    N0, N1, N2 = 9, 12, 15
    UV0, UV1, UV2 = 18, 20, 22
    KD, KS, KE = 24, 27, 30
    NS = 33
    COLS = 34


def build_shading_table(geometry: Geometry,
                        materials: Materials) -> ShadingTable:
    """Fold geometry corners + per-triangle material data into one table."""
    cols = [
        geometry.v0, geometry.v1, geometry.v2,
        geometry.n0, geometry.n1, geometry.n2,
        geometry.uv0, geometry.uv1, geometry.uv2,
        material_rows(materials, geometry.mat_idx),
    ]
    return ShadingTable(table=torch.cat(cols, dim=1))


class HitAttributes(NamedTuple):
    """Everything the integrator needs at a hit."""

    pos: torch.Tensor       # [R, 3]
    normal: torch.Tensor    # [R, 3] interpolated unit shading normal
    uv: Optional[torch.Tensor]  # [R, 2]; None where the table has no uvs
    kd: torch.Tensor        # [R, 3] material diffuse
    ks: torch.Tensor        # [R, 3] material specular
    ke: torch.Tensor        # [R, 3] material emission
    ns: torch.Tensor        # [R] material roughness/shininess exponent
    coverage: torch.Tensor  # [R] soft edge coverage in (0,1]; 1.0 when hard


def soft_coverage(u: torch.Tensor, v: torch.Tensor,
                  soft_sigma: float, kn=None) -> torch.Tensor:
    """Sigmoid coverage of the winner's barycentric edge margin
    min(u, v, 1-u-v): ~1 inside the triangle, 0.5 on an edge. The margin
    is scaled by 1/sigma (what torch does on CUDA for a division by a
    scalar, written out so the CPU and the kernels round alike)."""
    margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    return known.sigmoid(kn, "cov", margin * (1.0 / soft_sigma))


def winner_attributes(o, d, hit, v0, e1, e2, n0, n1, n2, kd, ks, ke, ns,
                      uvs=None, backface_cull: bool = False,
                      soft_sigma: float = 0.0, kn=None) -> HitAttributes:
    """Recompute (t, u, v) on the winner's gathered (v0, e1, e2) and
    interpolate position, normal and uv (kernel_bvh.cl:144-147). ``kn``:
    the known-value rows (ops/known.py)."""
    t, u, v, _ = ray_triangle_edges(o, d, v0, e1, e2, backface_cull, kn=kn)
    zero = torch.zeros_like(t)
    t = torch.where(hit, t, zero)
    u = torch.where(hit, u, zero)
    v = torch.where(hit, v, zero)
    if soft_sigma > 0.0:
        coverage = soft_coverage(u, v, soft_sigma, kn)
    else:
        coverage = torch.ones_like(t)
    uc, vc = u[:, None], v[:, None]
    w = 1.0 - uc - vc
    pos = o + d * t[:, None]
    normal = known.normalize(kn, "n_norm", uc * n1 + vc * n2 + w * n0)
    uv = None
    if uvs is not None:
        uv0, uv1, uv2 = uvs
        uv = uc * uv1 + vc * uv2 + w * uv0
    return HitAttributes(pos=pos, normal=normal, uv=uv, kd=kd, ks=ks, ke=ke,
                         ns=ns, coverage=coverage)


def winner_rows(table: torch.Tensor, hit: Hit) -> torch.Tensor:
    """[R, C] rows of the winners of ``hit`` in ``table`` [T, C]: the rows
    the intersector fetched (``hit.rows``), given the gather's gradient
    where one reaches the table, else ``take_rows``."""
    if hit.rows is None:
        return take_rows(table, hit.tri_idx)
    if table.requires_grad and torch.is_grad_enabled():
        return _PrecomputedRows.apply(table, hit.tri_idx, hit.rows)
    return hit.rows


def hit_attributes(o: torch.Tensor, d: torch.Tensor, hit: Hit,
                   st: ShadingTable, backface_cull: bool = False,
                   soft_sigma: float = 0.0) -> HitAttributes:
    """Fetch the winning triangle's row and recompute the intersection on
    it; ``soft_sigma`` > 0 adds the soft edge coverage. Rows the
    intersector fetched (``hit.rows``) are used as they are."""
    rows = winner_rows(st.table, hit)

    def c(off, n=3):
        return rows[:, off:off + n]

    v0 = c(st.V0)
    return winner_attributes(
        o, d, hit.hit, v0, c(st.V1) - v0, c(st.V2) - v0,
        c(st.N0), c(st.N1), c(st.N2), c(st.KD), c(st.KS), c(st.KE),
        rows[:, st.NS], uvs=(c(st.UV0, 2), c(st.UV1, 2), c(st.UV2, 2)),
        backface_cull=backface_cull, soft_sigma=soft_sigma)
