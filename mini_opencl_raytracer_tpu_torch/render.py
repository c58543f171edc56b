"""Top-level headless render API.

  render_sample(scene, camera, cfg, frame)   -> linear radiance [H, W, 3]
  render_ids(scene, camera, cfg, ids, ...)   -> radiance of a pixel slice
  render(scene, camera, cfg, frames)         -> accumulated gamma image
  RenderState / accumulate / to_image        -> progressive refinement

``render`` is the JAX package's jitted ``render``: on a CUDA device it
runs as one captured program of ``frames`` samples, the accumulation and
the gamma (jit.py), replayed on later calls with the same static
arguments and shapes. ``render_sample`` and ``render_radiance`` run
eagerly, as their JAX counterparts are not jitted themselves. A frame is
an int or a 0-d integer tensor (ops/rng.py).

Progressive accumulation keeps the linear radiance sum and a sample count
and applies gamma at readout (kernel_bvh.cl:449-455 re-derives the same
average from a gamma-encoded buffer every frame).

Backends resolve as in the JAX package (``resolve_backend``): ``mega``
(the CUDA bounce kernels), ``pallas`` (the wavefront integrator on the
panel kernel for small scenes and the cluster-traversal kernel for large
ones), ``bvh`` (the wavefront integrator on the LBVH walk kernel) and the
``bruteforce`` oracle (plain PyTorch). On the CPU every kernel runs as
its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import jit
from .config import BVHConfig, RenderConfig
from .models.scene import Camera, Scene
from .ops import bvh as bvh_mod
from .ops import rng
from .ops.cuda import intersect as pallas_mod
from .ops.cuda import megakernel as mega_mod
from .ops.cuda.raygen import camera_rays
from .ops.integrator import trace_paths
from .ops.intersect import intersect_brute, occluded_brute
from .ops.linalg import vmax


def resolve_backend(scene: Scene, cfg: RenderConfig) -> str:
    """``auto`` and ``mega`` give ``mega`` for eligible scenes and
    ``pallas`` otherwise; any other name is returned as it is."""
    if cfg.backend in ("auto", "mega"):
        return "mega" if mega_mod.eligible(scene, cfg) else "pallas"
    return cfg.backend


def make_intersectors(scene: Scene, cfg: RenderConfig,
                      bvh: Optional[bvh_mod.BVH] = None, accel=None,
                      backend: Optional[str] = None):
    """(closest_hit_fn, any_hit_fn) of the wavefront integrator for
    ``bruteforce`` (the all-pairs oracle), ``bvh`` (the LBVH walk; built
    here unless ``bvh`` or an ``accel`` that is a BVH is given) or
    ``pallas`` (the panel and cluster-traversal kernels). ``mega`` has
    none (the whole bounce is one kernel) and resolves to ``pallas`` here,
    as in the JAX package."""
    if backend is None:
        backend = resolve_backend(scene, cfg)
        if backend == "mega":
            backend = "pallas"
    if bvh is None and isinstance(accel, bvh_mod.BVH):
        bvh = accel
    geo = scene.geometry
    if backend == "bruteforce":
        closest = functools.partial(
            intersect_brute, geometry=geo, t_max=cfg.t_max,
            backface_cull=cfg.backface_cull, ray_chunk=cfg.ray_chunk)
        any_hit = functools.partial(
            occluded_brute, geometry=geo,
            backface_cull=cfg.backface_cull, ray_chunk=cfg.ray_chunk)
        return closest, any_hit
    if backend == "bvh":
        if bvh is None:
            bvh = bvh_mod.build_bvh(geo, BVHConfig())
        closest = functools.partial(bvh_mod.intersect_bvh, bvh=bvh, t_max=cfg.t_max,
                                    backface_cull=cfg.backface_cull)
        any_hit = functools.partial(bvh_mod.occluded_bvh, bvh=bvh,
                                    backface_cull=cfg.backface_cull)
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
    below; the LBVH for ``bvh``; None for ``bruteforce``."""
    backend = resolve_backend(scene, cfg)
    if backend == "bvh":
        return bvh_mod.build_bvh(scene.geometry, BVHConfig())
    if backend == "mega":
        return mega_mod.build_accel(scene.geometry)
    if backend == "pallas":
        return pallas_mod.build_accel(scene.geometry, cfg,
                                      materials=scene.materials)
    if backend == "bruteforce":
        return None
    raise ValueError(f"unknown backend: {backend!r}")


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


def render_ids(scene: Scene, camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor,
               frame, backend: str, intersectors=None, accel=None) -> torch.Tensor:
    """Radiance [len(pixel_ids), 3]: the mean of ``cfg.spp`` samples of the
    pixels ``pixel_ids`` (flat ids, in any order) at ``frame``, on the
    resolved ``backend``. ``intersectors`` are the (closest, any_hit) of a
    wavefront backend (``make_intersectors``), None on ``mega``. The body
    of ``render_sample`` and of the sharded paths of parallel/. ``frame``
    is an int or a 0-d integer tensor on the pixels' device."""
    total = torch.zeros((pixel_ids.shape[0], 3), dtype=cfg.torch_dtype(),
                        device=pixel_ids.device)
    for s in range(cfg.spp):
        fr = rng.sample_frame(frame, cfg.spp, s)
        if backend == "mega" and cfg.fused_raygen:
            radiance = mega_mod.trace_paths_mega_cam(scene, cfg, camera,
                                                     pixel_ids, fr, accel=accel)
        else:
            o, d, seeds = camera_rays(camera, cfg, pixel_ids, fr)
            if backend == "mega":
                radiance = mega_mod.trace_paths_mega(scene, cfg, o, d, seeds,
                                                     accel=accel)
            else:
                radiance = trace_paths(scene, cfg, o, d, seeds, *intersectors)
        total = total + radiance
    return total / cfg.spp


def render_sample(scene: Scene, camera: Camera, cfg: RenderConfig,
                  frame=0, accel=None, device=None) -> torch.Tensor:
    """Render one progressive sample -> linear radiance [H, W, 3].

    ``frame`` (an int, or a 0-d integer tensor on the device) seeds the
    per-pixel RNG (the reference's frameCount, kernel_bvh.cl:445).
    ``device`` defaults to the scene's device; scene and camera are moved
    there."""
    scene, camera, device = _on(scene, camera, device)
    backend = resolve_backend(scene, cfg)
    pixel_ids = _swizzled_ids(cfg, device)
    swizzled = pixel_ids is not None
    if not swizzled:
        pixel_ids = torch.arange(cfg.num_pixels, dtype=torch.int32, device=device)
    intersectors = (None if backend == "mega"
                    else make_intersectors(scene, cfg, accel=accel, backend=backend))
    total = render_ids(scene, camera, cfg, pixel_ids, frame, backend, intersectors,
                       accel=accel)
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


def _render(scene, camera, accel, cfg, frames):
    return to_image(_accumulate_frames(scene, camera, cfg, frames, accel, None),
                    cfg.gamma)


_render_compiled = jit.jit(_render, static_argnames=("cfg", "frames"))


def render(scene: Scene, camera: Camera, cfg: RenderConfig, frames: int = 1,
           accel=None, device=None) -> torch.Tensor:
    """Render ``frames`` progressive samples -> gamma-encoded [H, W, 3].

    On a CUDA device a compiled program (jit.py), keyed by ``cfg``,
    ``frames`` and the shapes of the scene, camera and accel: the first
    call runs eagerly and captures, later ones replay."""
    scene, camera, device = _on(scene, camera, device)
    return _render_compiled(scene, camera, accel, cfg=cfg, frames=frames)


def render_radiance(scene: Scene, camera: Camera, cfg: RenderConfig,
                    frames: int = 1, accel=None, device=None) -> torch.Tensor:
    """Like ``render`` but returns the linear mean radiance [H, W, 3]."""
    return _accumulate_frames(scene, camera, cfg, frames, accel,
                              device).mean()
