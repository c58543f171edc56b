"""Camera ray generation (``CreateRay``, kernel_bvh.cl:386-403): jittered
pinhole primary rays over a vector of flat pixel ids, with the vertical
FOV from ``RenderConfig.fov_deg``."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import Camera
from . import rng
from .linalg import cross, normalize


def tan_half_fov(cfg: RenderConfig) -> float:
    """tan(fov/2) rounded to float32, as a Python float. The plain path
    and the CUDA kernels use this one value."""
    return float(np.tan(np.float32(0.5 * cfg.fov_deg * math.pi / 180.0)))


def generate_rays(camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor,
                  seeds: torch.Tensor):
    """Jittered pinhole primary rays.

    Args:
      camera: Camera {position, front, up}.
      cfg: RenderConfig (width/height/fov).
      pixel_ids: [R] integer flat pixel indices (row-major, y*W + x).
      seeds: [R] int64 u32 per-pixel seeds for the jitter draws.

    Returns:
      (origins [R,3], directions [R,3] normalized).
    """
    return rays_from_basis(camera.position, cross(camera.front, camera.up),
                           camera.up, camera.front, cfg, pixel_ids, seeds)


def rays_from_basis(position, right, up, front, cfg: RenderConfig,
                    pixel_ids: torch.Tensor, seeds: torch.Tensor):
    """generate_rays on an explicit (position, right, up, front) basis,
    each [3]: the form the raygen-fused bounce kernel receives."""
    dtype = cfg.torch_dtype()
    w, h = cfg.width, cfg.height
    inv_w = 1.0 / float(w)
    inv_h = 1.0 / float(h)
    aspect = float(w) / float(h)
    angle = tan_half_fov(cfg)

    pid = pixel_ids.to(torch.int64)
    px = (pid % w).to(dtype)
    py = (pid // w).to(dtype)
    # Jitter in [0, 1) per axis (kernel_bvh.cl:394-395).
    jx = rng.uniform(seeds, rng.SITE_JITTER_X)
    jy = rng.uniform(seeds, rng.SITE_JITTER_Y)
    x = (2.0 * (px + jx) * inv_w - 1.0) * angle * aspect
    # Row 0 = top of the image (upright output, see the JAX package).
    y = (1.0 - 2.0 * (py + jy) * inv_h) * angle

    d = (x[:, None] * right[None, :]
         + y[:, None] * up[None, :]
         + front[None, :])
    directions = normalize(d)
    origins = position[None, :].expand_as(directions)
    return origins, directions
