"""Ray-triangle intersection and the brute-force (oracle) intersector.

Standard Möller-Trumbore (``RayTriangle``, kernel_bvh.cl:98-153,
spec-cleaned as in the JAX package: optional backface culling, ``t > 0``),
vectorized over a [rays x triangles] panel. The brute-force closest hit
takes the smallest ``t`` below ``t_max``; ties go to the lowest triangle
index (``argmin`` returns the first minimum), the rule the CUDA
megakernel keeps with a strict ``<`` across triangles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.scene import Geometry
from . import known
from .linalg import cross, dot, normalize

_DET_EPS = 1e-10


@dataclasses.dataclass
class Hit:
    """Closest-hit record (IntersectData, kernel_bvh.cl:18-27)."""

    t: torch.Tensor        # [R] hit distance (t_max where miss)
    tri_idx: torch.Tensor  # [R] int64 triangle index (0 where miss)
    hit: torch.Tensor      # [R] bool
    # [R, ShadingTable.COLS] winner shading rows, zeros on misses, from
    # intersectors that fetch them during traversal (the clustered
    # kernel); None elsewhere. Snapshot values: ops/shading.hit_attributes
    # gives them take_rows' gradient.
    rows: Optional[torch.Tensor] = None


def ray_triangle_edges(o, d, v0, e1, e2, backface_cull: bool = False, kn=None):
    """Möller-Trumbore on (v0, e1 = v1 - v0, e2 = v2 - v0).

    All inputs broadcast; returns (t, u, v, valid) with t = +inf where
    invalid. ``kn``: the known-value rows (ops/known.py), for the
    reciprocal of the determinant."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    if backface_cull:
        valid = det > _DET_EPS
    else:
        valid = torch.abs(det) > _DET_EPS
    inv_det = torch.where(valid, known.recip(kn, "inv_det",
                                             torch.where(valid, det, torch.ones_like(det))),
                          torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    return t, u, v, valid


def ray_triangle(o, d, v0, v1, v2, backface_cull: bool = False):
    """Batched Möller-Trumbore on corner positions (see ray_triangle_edges)."""
    return ray_triangle_edges(o, d, v0, v1 - v0, v2 - v0, backface_cull)


def closest_hit_edges(o, d, v0, e1, e2, t_max: float,
                      backface_cull: bool = False, ray_chunk: int = 4096):
    """All-pairs closest hit over triangles given as (v0, e1, e2) [T, 3].

    Rays go in chunks of ``ray_chunk`` to bound the [chunk, T]
    intermediates. Returns (best_t [R], best_idx [R] int64), best_t = inf
    where no triangle is hit below ``t_max``."""
    R = o.shape[0]
    ts, idxs = [], []
    for start in range(0, R, max(ray_chunk, 1)):
        oc = o[start:start + ray_chunk, None, :]
        dc = d[start:start + ray_chunk, None, :]
        t_all, _, _, _ = ray_triangle_edges(oc, dc, v0[None], e1[None],
                                            e2[None], backface_cull)
        t_all = torch.where(t_all < t_max, t_all,
                            torch.full_like(t_all, float("inf")))
        best_t, best_idx = torch.min(t_all, dim=1)
        ts.append(best_t)
        idxs.append(best_idx)
    if not ts:
        return (torch.empty(0, dtype=o.dtype, device=o.device),
                torch.empty(0, dtype=torch.int64, device=o.device))
    return torch.cat(ts), torch.cat(idxs)


def intersect_brute(o: torch.Tensor, d: torch.Tensor, geometry: Geometry,
                    t_max: float, backface_cull: bool = False,
                    ray_chunk: int = 4096) -> Hit:
    """All-pairs closest hit: the oracle intersector. The winner's ``t``
    is recomputed on the winning triangle, as in the JAX package."""
    g = geometry
    e1, e2 = g.v1 - g.v0, g.v2 - g.v0
    best_t, best_idx = closest_hit_edges(o, d, g.v0, e1, e2, t_max,
                                         backface_cull, ray_chunk)
    hit = torch.isfinite(best_t)
    best_idx = torch.where(hit, best_idx, torch.zeros_like(best_idx))
    t_re, _, _, valid_re = ray_triangle_edges(
        o, d, g.v0[best_idx], e1[best_idx], e2[best_idx], backface_cull)
    t_out = torch.where(hit & valid_re, t_re, torch.full_like(t_re, t_max))
    return Hit(t=t_out, tri_idx=best_idx, hit=hit)


@dataclasses.dataclass
class ShadingPoint:
    """Interpolated surface data at a hit (IntersectData's pos / normal /
    uv, kernel_bvh.cl:144-147)."""

    pos: torch.Tensor      # [R, 3]
    normal: torch.Tensor   # [R, 3] interpolated unit shading normal
    uv: torch.Tensor       # [R, 2]
    mat_idx: torch.Tensor  # [R] int32


def shading_point(o: torch.Tensor, d: torch.Tensor, hit: Hit, geometry: Geometry,
                  backface_cull: bool = False) -> ShadingPoint:
    """Recompute differentiable (u, v) on the hit triangle and interpolate
    as kernel_bvh.cl:144-147: pos = o + d t; n = normalize(u n1 + v n2 +
    (1-u-v) n0); uv = u uv1 + v uv2 + (1-u-v) uv0. Misses get t = u = v
    = 0."""
    idx = hit.tri_idx.long()
    take = lambda a: a.index_select(0, idx)
    t, u, v, _ = ray_triangle(o, d, take(geometry.v0), take(geometry.v1),
                              take(geometry.v2), backface_cull=backface_cull)
    zero = torch.zeros_like(t)
    t = torch.where(hit.hit, t, zero)
    u = torch.where(hit.hit, u, zero)
    v = torch.where(hit.hit, v, zero)
    w = 1.0 - u - v
    pos = o + d * t[..., None]
    normal = normalize(u[..., None] * take(geometry.n1)
                       + v[..., None] * take(geometry.n2)
                       + w[..., None] * take(geometry.n0))
    uv = (u[..., None] * take(geometry.uv1)
          + v[..., None] * take(geometry.uv2)
          + w[..., None] * take(geometry.uv0))
    return ShadingPoint(pos=pos, normal=normal, uv=uv, mat_idx=take(geometry.mat_idx))


def occluded_edges(o, d, t_limit, v0, e1, e2, backface_cull: bool = False,
                   ray_chunk: int = 4096) -> torch.Tensor:
    """Any-hit query on (v0, e1, e2) triangles: True where some triangle
    lies at 0 < t < t_limit."""
    best_t, _ = closest_hit_edges(o, d, v0, e1, e2, float("inf"),
                                  backface_cull, ray_chunk)
    return torch.isfinite(best_t) & (best_t < t_limit)


def occluded_brute(o: torch.Tensor, d: torch.Tensor, t_limit: torch.Tensor,
                   geometry: Geometry, backface_cull: bool = False,
                   ray_chunk: int = 4096) -> torch.Tensor:
    """Any-hit query for shadow rays. Returns bool [R]: True if any
    triangle lies at 0 < t < t_limit."""
    g = geometry
    return occluded_edges(o, d, t_limit, g.v0, g.v1 - g.v0, g.v2 - g.v0,
                          backface_cull, ray_chunk)
