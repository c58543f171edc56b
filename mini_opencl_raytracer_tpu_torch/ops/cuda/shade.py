"""The wavefront's shading of one bounce as one CUDA kernel, where no
gradient is taken.

After each bounce's closest hit, ``ops/integrator.make_bounce_core`` runs
``ops/shading.hit_attributes`` and ``ops/integrator.shade_hit``: some 520
PyTorch launches a bounce, ~7.1 KB of traffic a ray. On a CUDA device, in
float32, without shadow rays and where no gradient is taken
(``integrator.fused_shading``), it calls ``shade_rows`` instead: the
kernel written by hand in ``csrc/shade.cu``, one thread a ray, which shares
the mega path's shading body (``csrc/shade.cuh``) and returns what
``shade_hit`` returns, bit for bit. It is not the port of a TPU kernel:
the JAX package leaves this work to XLA's fusion. ``shade_plain``
(``hit_attributes`` then ``shade_hit``) is its plain version, which the
wrapper runs for tensors on the CPU.

``build.LAUNCHES`` counts the kernel's launches; ``build.RAYS`` the rays
each path shaded, counted on the host from shapes: ``shade_fused`` the
kernel's, ``shade_plain`` those the integrator shaded in PyTorch on a CUDA
device. A captured program's replays add both as they add the launches
(jit.py, ``COUNTS`` ``shade_fused_rays`` / ``shade_plain_rays``).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import RenderConfig
from ..integrator import shade_hit
from ..intersect import Hit
from ..shading import ShadingTable, hit_attributes
from . import build
from .build import check_tensor
from .megakernel import LIGHT_COLS, params, unpack_lights


def shade_plain(hit: Hit, table, o, d, beta, radiance, alive, seeds, bounce: int,
                lights, cfg: RenderConfig):
    """``hit_attributes`` then ``shade_hit`` on the packed ``[L, 16]``
    lights: (o, d, beta, radiance, alive) of the next bounce."""
    at = hit_attributes(o, d, hit, ShadingTable(table), backface_cull=cfg.backface_cull,
                        soft_sigma=cfg.soft_edge_sigma)
    return shade_hit(at, hit.hit, o, d, beta, radiance, alive, seeds, bounce,
                     unpack_lights(lights), cfg)[:5]


def _check_rows(t: torch.Tensor, name: str, R: int, device) -> None:
    """o, d, beta and the radiance: [R, 3] float32 whose columns are
    adjacent; any row stride (0 for the camera's broadcast origin, 12 for
    the pipeline stages' packed state)."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (R, 3) \
            or t.stride(1) != 1 or t.stride(0) < 0:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}: expected float32 [{R}, 3] on {device} with "
                         "adjacent columns")


def shade_rows(hit: Hit, table: torch.Tensor, o, d, beta, radiance, alive, seeds,
               bounce: int, lights: torch.Tensor, cfg: RenderConfig):
    """One bounce's shading after the closest hit ``hit``: (o, d, beta,
    radiance, alive) of the next bounce, each new, as ``shade_plain``
    returns them. The winner's row is ``hit.rows``' (float32 [R, 34]) or,
    without rows, ``table[hit.tri_idx]`` (float32 [T, 34], int64 [R]).
    o, d, beta, radiance: float32 [R, 3] with adjacent columns (any row
    stride); alive and ``hit.hit`` bool [R]; seeds int64 [R] (u32
    values); ``lights`` [L, 16] (``megakernel.pack_lights``). Float32 and
    no shadow rays; nothing may require grad."""
    if cfg.shadow_rays:
        raise ValueError("shade_rows casts no shadow rays: cfg.shadow_rays takes "
                         "hit_attributes and shade_hit")
    if cfg.torch_dtype() != torch.float32:
        raise TypeError(f"shade_rows shades in float32, not {cfg.dtype}")
    device = alive.device
    R = alive.shape[0]
    named = {"o": o, "d": d, "beta": beta, "radiance": radiance, "table": table,
             "lights": lights, "rows": hit.rows}
    build.refuse_grad(named, "shade_rows takes no gradient")
    for name in ("o", "d", "beta", "radiance"):
        _check_rows(named[name], name, R, device)
    check_tensor(alive, "alive", torch.bool, (R,), device)
    check_tensor(hit.hit, "hit", torch.bool, (R,), device)
    check_tensor(seeds, "seeds", torch.int64, (R,), device)
    check_tensor(lights, "lights", torch.float32, (lights.shape[0], LIGHT_COLS), device)
    cols = ShadingTable.COLS
    if hit.rows is not None:
        check_tensor(hit.rows, "rows", torch.float32, (R, cols), device)
        if hit.rows.data_ptr() % 16:
            raise ValueError("rows must be 16-byte aligned")
    else:
        check_tensor(table, "table", torch.float32, (table.shape[0], cols), device)
        check_tensor(hit.tri_idx, "tri_idx", torch.int64, (R,), device)
    if device.type == "cpu":
        return shade_plain(hit, table, o, d, beta, radiance, alive, seeds, bounce, lights, cfg)
    if device.type != "cuda":
        raise ValueError(f"shade_rows runs on cpu or cuda, not {device}")
    f32 = dict(dtype=torch.float32, device=device)
    out = tuple(torch.empty((R, 3), **f32) for _ in range(4)) + (
        torch.empty((R,), dtype=torch.bool, device=device),)
    if R:
        p = params(cfg, R, 0, lights.shape[0], bounce)
        rows = hit.rows
        build.launch("shade", device, lambda _: (
            ctypes.addressof(p), rows, table if rows is None else None,
            hit.tri_idx if rows is None else None, hit.hit, alive, seeds, lights,
            *[v for t in (o, d, beta, radiance) for v in (t, t.stride(0))], *out),
            rays=("shade_fused", R))
    return out
