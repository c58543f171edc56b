"""The panel intersector of the wavefront ``pallas`` backend for small
scenes (at most ``intersect.FLAT_PANEL_MAX_TRIS`` triangles): a dense
Möller–Trumbore closest hit / any-hit of every ray against every
triangle.

The kernel, written by hand in ``csrc/panel.cu``, replaces the JAX
package's ``ops/pallas/panel.py:_panel_kernel``. ``run_panel_plain`` is
its plain PyTorch version: the same arithmetic (ops/intersect
.ray_triangle_edges) and the same tie rule (lowest index among equal t).
The wrappers ``panel_closest`` and ``panel_any`` run the plain version for
tensors on the CPU and launch the kernel for tensors on a CUDA device;
there is no fallback between the two. ``build.LAUNCHES`` counts kernel
launches.
The kernel culls the records per warp of rays before its exact test
(``csrc/bundle.cuh``); ``bundle_cull.cull_hits`` models that, counts
included, and ``stats=`` returns the kernel's per-ray count of exact tests.
"""

from __future__ import annotations

import functools

import torch

from ...config import RenderConfig
from ...models.scene import Geometry
from ..intersect import Hit, ray_triangle_edges
from . import build
from .build import check_tensor

# Records of the (v0, e1, e2) layout, padded as the JAX package pads.
_TRI_COLS = 9
_TRI_BLOCK = 512
# The largest scene the panel serves (ops/cuda/intersect
# .FLAT_PANEL_MAX_TRIS, the JAX package's dispatch threshold).
MAX_TRIS = 2048
_BIG = 3.0e38
# Bound on the plain version's [rays x triangles] panel elements per chunk.
_PLAIN_ELEMS = 1 << 22


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_triangles(geometry: Geometry) -> torch.Tensor:
    """[T_pad, 9] float32 records: v0, e1 = v1 - v0, e2 = v2 - v0. Padding
    rows are zero, so det == 0 and they never hit."""
    v0 = geometry.v0.detach().to(torch.float32)
    v1 = geometry.v1.detach().to(torch.float32)
    v2 = geometry.v2.detach().to(torch.float32)
    T = v0.shape[0]
    Tp = _ceil_to(max(T, 8), 8) if T <= _TRI_BLOCK else _ceil_to(T, _TRI_BLOCK)
    rec = torch.cat([v0, v1 - v0, v2 - v0], dim=1)
    return torch.nn.functional.pad(rec, (0, 0, 0, Tp - T)).contiguous()


def run_panel_plain(tris, o, d, t_init, backface_cull: bool):
    """Plain version of the kernel: per ray, the smallest t with 0 < t <
    t_init over all records and its index (-1 and t_init on a miss);
    among equal t the lowest index (``torch.min`` returns the first
    minimum). The kernel's any mode returns the first record it finds
    instead; there only ``idx >= 0`` is defined."""
    R, T = o.shape[0], tris.shape[0]
    v0, e1, e2 = tris[None, :, 0:3], tris[None, :, 3:6], tris[None, :, 6:9]
    chunk = max(1, _PLAIN_ELEMS // max(T, 1))
    ts, idxs = [], []
    for s in range(0, R, chunk):
        ti = t_init[s:s + chunk]
        t_all, _, _, _ = ray_triangle_edges(o[s:s + chunk, None], d[s:s + chunk, None],
                                            v0, e1, e2, backface_cull)
        t_all = torch.where(t_all < ti[:, None], t_all,
                            torch.full_like(t_all, float("inf")))
        best_t, best_idx = torch.min(t_all, dim=1)
        hit = torch.isfinite(best_t)
        ts.append(torch.where(hit, best_t, ti))
        idxs.append(torch.where(hit, best_idx, torch.full_like(best_idx, -1)))
    if not ts:
        return (torch.empty(0, dtype=torch.float32, device=o.device),
                torch.empty(0, dtype=torch.int32, device=o.device))
    return torch.cat(ts), torch.cat(idxs).to(torch.int32)


def _run(name: str, any_hit: bool, tris, o, d, t_init, backface_cull: bool, stats=None):
    device = o.device
    R = o.shape[0]
    T = tris.shape[0]
    if not 0 < T <= MAX_TRIS or tris.dim() != 2:
        raise ValueError(f"{name} takes [1..{MAX_TRIS}, {_TRI_COLS}] records, "
                         f"got {tuple(tris.shape)}")
    named = {"tris": tris, "o": o, "d": d, "t_init": t_init}
    build.refuse_grad(named)
    for n, shape in (("tris", (T, _TRI_COLS)), ("o", (R, 3)), ("d", (R, 3)),
                     ("t_init", (R,))):
        check_tensor(named[n], n, torch.float32, shape, device)
    if device.type == "cpu":
        if stats is not None:
            raise ValueError(f"{name}: stats are counted by the kernel only")
        return run_panel_plain(tris, o, d, t_init, backface_cull)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    if stats is not None:
        check_tensor(stats, "stats", torch.int32, (R,), device)
    t_out = torch.empty((R,), dtype=torch.float32, device=device)
    idx = torch.empty((R,), dtype=torch.int32, device=device)
    if R:
        build.launch(name, device, lambda _: (R, T, int(backface_cull), int(any_hit), tris,
                                              o, d, t_init, t_out, idx, stats))
    return t_out, idx


def panel_closest(tris, o, d, t_init, backface_cull: bool = False, stats=None):
    """Closest hit below ``t_init`` [R] of rays o, d [R, 3] against the
    [T_pad, 9] records. Returns (t [R] float32, idx [R] int32, -1 and
    t_init on a miss). ``stats`` (int32 [R], CUDA only) receives each
    ray's count of exact M-T tests."""
    return _run("panel_closest", False, tris, o, d, t_init, backface_cull, stats)


def panel_any(tris, o, d, t_limit, backface_cull: bool = False, stats=None) -> torch.Tensor:
    """Any hit with 0 < t < ``t_limit`` [R] (finite): bool [R]. ``stats``
    as in ``panel_closest``."""
    return _run("panel_any", True, tris, o, d, t_limit, backface_cull, stats)[1] >= 0


def _rays(o, d):
    return (o.detach().to(torch.float32).contiguous(),
            d.detach().to(torch.float32).contiguous())


def intersect_panel(o: torch.Tensor, d: torch.Tensor, geometry: Geometry,
                    tri_packed: torch.Tensor, t_max: float,
                    backface_cull: bool = False) -> Hit:
    """Closest hit through the panel kernel."""
    o, d = _rays(o, d)
    t_init = torch.full((o.shape[0],), t_max, dtype=torch.float32, device=o.device)
    t_best, idx = panel_closest(tri_packed, o, d, t_init, backface_cull)
    hit = idx >= 0
    return Hit(t=torch.where(hit, t_best, t_init),
               tri_idx=torch.where(hit, idx, torch.zeros_like(idx)).to(torch.int64),
               hit=hit)


def occluded_panel(o: torch.Tensor, d: torch.Tensor, t_limit: torch.Tensor,
                   geometry: Geometry, tri_packed: torch.Tensor,
                   backface_cull: bool = False) -> torch.Tensor:
    """Shadow-ray occlusion (any hit below ``t_limit``; inf = the whole
    ray) through the panel kernel."""
    o, d = _rays(o, d)
    t_limit = t_limit.detach().to(torch.float32)
    t_init = torch.where(torch.isfinite(t_limit), t_limit,
                         torch.full_like(t_limit, _BIG)).contiguous()
    return panel_any(tri_packed, o, d, t_init, backface_cull)


def make_intersectors(geometry: Geometry, cfg: RenderConfig):
    """(closest, any_hit) for ops/integrator.trace_paths."""
    tri_packed = pack_triangles(geometry)
    closest = functools.partial(intersect_panel, geometry=geometry,
                                tri_packed=tri_packed, t_max=cfg.t_max,
                                backface_cull=cfg.backface_cull)
    any_hit = functools.partial(occluded_panel, geometry=geometry,
                                tri_packed=tri_packed,
                                backface_cull=cfg.backface_cull)
    return closest, any_hit
