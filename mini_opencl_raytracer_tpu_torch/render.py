"""Top-level headless render API.

  render_sample(scene, camera, cfg, frame)   -> linear radiance [H, W, 3]
  render(scene, camera, cfg, frames)         -> accumulated gamma image
  RenderState / accumulate / to_image        -> progressive refinement

Progressive accumulation keeps the linear radiance sum and a sample count
and applies gamma at readout (kernel_bvh.cl:449-455 re-derives the same
average from a gamma-encoded buffer every frame).

Backends resolve as in the JAX package (``resolve_backend``). This port
runs ``mega`` (the CUDA bounce kernels), ``pallas`` (the wavefront
integrator on the panel kernel for small scenes and the cluster-traversal
kernel for large ones) and the ``bruteforce`` oracle (plain PyTorch);
on the CPU every kernel runs as its plain PyTorch version. ``bvh`` raises
``NotImplementedError``; nothing else runs instead.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .config import RenderConfig
from .models.scene import Camera, Scene
from .ops import rng
from .ops.camera import generate_rays
from .ops.cuda import intersect as pallas_mod
from .ops.cuda import megakernel as mega_mod
from .ops.integrator import trace_paths
from .ops.intersect import intersect_brute, occluded_brute
from .ops.linalg import vmax

# Backends of the JAX package that are not ported yet, and where ROADMAP.md
# queues them.
_NOT_PORTED = {
    "bvh": "ROADMAP.md Queue 1 item 8 (the LBVH of ops/bvh.py)",
}


def resolve_backend(scene: Scene, cfg: RenderConfig) -> str:
    """``auto`` and ``mega`` give ``mega`` for eligible scenes and
    ``pallas`` otherwise; any other name is returned as it is."""
    if cfg.backend in ("auto", "mega"):
        return "mega" if mega_mod.eligible(scene, cfg) else "pallas"
    return cfg.backend


def _require_ported(backend: str, device: torch.device) -> None:
    if backend in ("mega", "pallas", "bruteforce"):
        return
    where = _NOT_PORTED.get(backend)
    if where is None:
        raise ValueError(f"unknown backend: {backend!r}")
    raise NotImplementedError(
        f"backend {backend!r} on {device.type} is not ported yet: {where}")


def make_intersectors(scene: Scene, cfg: RenderConfig, accel=None,
                      backend: Optional[str] = None):
    """(closest_hit_fn, any_hit_fn) of the wavefront integrator for
    ``bruteforce`` (the all-pairs oracle) or ``pallas`` (the panel and
    cluster-traversal kernels). ``mega`` has none (the whole bounce is one
    kernel) and resolves to ``pallas`` here, as in the JAX package."""
    if backend is None:
        backend = resolve_backend(scene, cfg)
        if backend == "mega":
            backend = "pallas"
    _require_ported(backend, scene.device)
    geo = scene.geometry
    if backend == "bruteforce":
        closest = functools.partial(
            intersect_brute, geometry=geo, t_max=cfg.t_max,
            backface_cull=cfg.backface_cull, ray_chunk=cfg.ray_chunk)
        any_hit = functools.partial(
            occluded_brute, geometry=geo,
            backface_cull=cfg.backface_cull, ray_chunk=cfg.ray_chunk)
        return closest, any_hit
    if backend == "pallas":
        return pallas_mod.make_intersectors(geo, cfg, accel=accel,
                                            materials=scene.materials)
    raise ValueError(f"unknown backend: {backend!r}")


def build_accel(scene: Scene, cfg: RenderConfig):
    """Acceleration data for the resolved backend, built once per scene
    and passed to ``render`` as ``accel``: the [T, 9] triangle records for
    ``mega``; for ``pallas`` the clustered slot layout above 2048
    triangles (native SAH when the C++ library builds) and None
    below; None for ``bruteforce``."""
    backend = resolve_backend(scene, cfg)
    _require_ported(backend, scene.device)
    if backend == "mega":
        return mega_mod.build_accel(scene.geometry)
    if backend == "pallas":
        return pallas_mod.build_accel(scene.geometry, cfg,
                                      materials=scene.materials)
    return None


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation carry: linear radiance sum + sample count."""

    radiance_sum: torch.Tensor  # [H, W, 3] linear
    num_samples: int

    @staticmethod
    def create(cfg: RenderConfig, device) -> "RenderState":
        return RenderState(
            radiance_sum=torch.zeros((cfg.height, cfg.width, 3),
                                     dtype=cfg.torch_dtype(), device=device),
            num_samples=0)

    def mean(self) -> torch.Tensor:
        return self.radiance_sum / max(self.num_samples, 1)


# Packet tile shape: 8 x 16 pixels. Rays are traced in tile-major order so
# neighbouring rays cover a square screen tile; per-pixel values do not
# depend on the order.
_TILE_H, _TILE_W = 8, 16


def _swizzled_ids(cfg: RenderConfig, device) -> Optional[torch.Tensor]:
    """Flat pixel ids in tile-major order, or None if the resolution does
    not tile evenly (then scanline order is used)."""
    H, W = cfg.height, cfg.width
    if H % _TILE_H or W % _TILE_W:
        return None
    ids = torch.arange(cfg.num_pixels, dtype=torch.int32, device=device)
    return (ids.reshape(H // _TILE_H, _TILE_H, W // _TILE_W, _TILE_W)
            .permute(0, 2, 1, 3).reshape(-1))


def _unswizzle_image(radiance: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """[R, 3] tile-major radiance -> [H, W, 3] image."""
    H, W = cfg.height, cfg.width
    return (radiance.reshape(H // _TILE_H, W // _TILE_W, _TILE_H, _TILE_W, 3)
            .permute(0, 2, 1, 3, 4).reshape(H, W, 3))


def _on(scene: Scene, camera: Camera, device):
    device = scene.device if device is None else torch.device(device)
    return scene.to(device), camera.to(device), device


def render_sample(scene: Scene, camera: Camera, cfg: RenderConfig,
                  frame: int = 0, accel=None, device=None) -> torch.Tensor:
    """Render one progressive sample -> linear radiance [H, W, 3].

    ``frame`` seeds the per-pixel RNG (the reference's frameCount,
    kernel_bvh.cl:445). ``device`` defaults to the scene's device; scene
    and camera are moved there."""
    scene, camera, device = _on(scene, camera, device)
    backend = resolve_backend(scene, cfg)
    _require_ported(backend, device)
    R = cfg.num_pixels
    pixel_ids = _swizzled_ids(cfg, device)
    swizzled = pixel_ids is not None
    if not swizzled:
        pixel_ids = torch.arange(R, dtype=torch.int32, device=device)
    if backend != "mega":
        closest, any_hit = make_intersectors(scene, cfg, accel=accel,
                                             backend=backend)

    total = torch.zeros((R, 3), dtype=cfg.torch_dtype(), device=device)
    for s in range(cfg.spp):
        fr = (int(frame) * cfg.spp + s) & 0xFFFFFFFF
        if backend == "mega" and cfg.fused_raygen:
            radiance = mega_mod.trace_paths_mega_cam(scene, cfg, camera,
                                                     pixel_ids, fr, accel=accel)
        else:
            seeds = rng.pixel_seeds(pixel_ids, fr)
            o, d = generate_rays(camera, cfg, pixel_ids, seeds)
            if backend == "mega":
                radiance = mega_mod.trace_paths_mega(scene, cfg, o, d, seeds,
                                                     accel=accel)
            else:
                radiance = trace_paths(scene, cfg, o, d, seeds, closest, any_hit)
        total = total + radiance
    total = total / cfg.spp
    if swizzled:
        return _unswizzle_image(total, cfg)
    return total.reshape(cfg.height, cfg.width, 3)


def accumulate(state: RenderState, sample: torch.Tensor,
               weight: int = 1) -> RenderState:
    """Progressive average update: the linear-space form of
    ``(avg*(N-1) + x) / N`` (kernel_bvh.cl:453-455)."""
    return RenderState(radiance_sum=state.radiance_sum + sample * weight,
                       num_samples=state.num_samples + weight)


def to_image(state_or_radiance, gamma: float = 2.2) -> torch.Tensor:
    """Gamma-encode linear radiance for display (kernel_bvh.cl:405-408)."""
    lin = (state_or_radiance.mean()
           if isinstance(state_or_radiance, RenderState)
           else state_or_radiance)
    return torch.pow(vmax(lin, 0.0), 1.0 / gamma)


def _accumulate_frames(scene, camera, cfg, frames, accel, device) -> RenderState:
    scene, camera, device = _on(scene, camera, device)
    state = RenderState.create(cfg, device)
    for f in range(frames):
        state = accumulate(state, render_sample(scene, camera, cfg, frame=f,
                                                accel=accel, device=device))
    return state


def render(scene: Scene, camera: Camera, cfg: RenderConfig, frames: int = 1,
           accel=None, device=None) -> torch.Tensor:
    """Render ``frames`` progressive samples -> gamma-encoded [H, W, 3]."""
    state = _accumulate_frames(scene, camera, cfg, frames, accel, device)
    return to_image(state, cfg.gamma)


def render_radiance(scene: Scene, camera: Camera, cfg: RenderConfig,
                    frames: int = 1, accel=None, device=None) -> torch.Tensor:
    """Like ``render`` but returns the linear mean radiance [H, W, 3]."""
    return _accumulate_frames(scene, camera, cfg, frames, accel,
                              device).mean()
