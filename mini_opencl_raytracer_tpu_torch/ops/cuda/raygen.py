"""The wavefront's ray generation as one CUDA kernel.

Each frame of the wavefront (``render.render_ids``) starts from a pixel's
seed (``ops/rng.pixel_seeds``) and its jittered pinhole ray
(``ops/camera.generate_rays``): some 89 PyTorch launches a frame and ~1,160
B of traffic a ray, the lowbias32 hash run in int64 masked to 32 bits.
``camera_rays`` routes that work (``raygen_route``, read from the input
alone):

* "fused" for pixel ids on a CUDA device, a float32 configuration and
  camera, and no gradient taken of the camera (grad mode off, or no camera
  leaf requires grad): ``raygen_fused``, the kernel written by hand in
  ``csrc/raygen.cu``, one thread a ray, 24 B a ray, whose arithmetic is K1's
  and K3's raygen (``csrc/raygen.cuh``), so seeds and directions are the
  plain version's bits; the origin is the camera's position expanded to
  [R, 3], as the plain version gives it (a dense origin would live through
  the first bounce's shading and raise the frame's peak memory);
* "plain" otherwise: ``raygen_plain``, ``pixel_seeds`` then
  ``generate_rays``, differentiable in the camera (the training step takes
  its gradient).

The kernel is not the port of a TPU kernel: the JAX package leaves this
work to XLA's fusion. ``raygen_fused`` runs ``raygen_plain`` for tensors on
the CPU and launches the kernel for CUDA tensors, or raises.

``build.LAUNCHES["raygen"]`` counts the kernel's launches; ``build.RAYS``
the rays each route generated, counted on the host from shapes:
``raygen_fused`` the kernel's, ``raygen_plain`` those PyTorch generated on a
CUDA device. A captured program's replays add them as they add the launches
(jit.py, ``COUNTS`` ``raygen_fused_rays``, ``raygen_plain_rays``).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import RenderConfig
from ...models.scene import Camera
from .. import rng
from ..camera import generate_rays
from . import build
from .build import check_tensor
from .megakernel import camera_vector, frame_word, params


def _leaves(camera: Camera):
    return {"camera.position": camera.position, "camera.front": camera.front,
            "camera.up": camera.up}


def raygen_route(camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor) -> str:
    """The route of ``camera_rays``: "fused" for ``pixel_ids`` on a CUDA
    device, ``cfg`` and the camera's leaves in float32, and no gradient
    taken of the camera; else "plain"."""
    leaves = _leaves(camera).values()
    if not (pixel_ids.is_cuda and cfg.torch_dtype() == torch.float32
            and all(t.dtype == torch.float32 for t in leaves)):
        return "plain"
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return "plain"
    return "fused"


def raygen_plain(camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor, frame):
    """(o, d, seeds): ``rng.pixel_seeds`` then ``generate_rays``; o is the
    camera's position expanded to [R, 3]."""
    seeds = rng.pixel_seeds(pixel_ids, frame)
    o, d = generate_rays(camera, cfg, pixel_ids, seeds)
    return o, d, seeds


def raygen_fused(camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor, frame):
    """(o, d, seeds) of ``pixel_ids`` (int32 [R], any order) at ``frame``
    (an int or a 0-d integer tensor on their device), as ``raygen_plain``
    gives them, bit for bit: d float32 [R, 3], o the camera's position
    expanded to [R, 3], seeds int64 [R] holding u32 values. Float32;
    nothing may require grad."""
    leaves = _leaves(camera)
    build.refuse_grad(leaves, "raygen_fused takes no gradient; camera_rays routes a camera "
                              "that requires grad to raygen_plain")
    if cfg.torch_dtype() != torch.float32:
        raise TypeError(f"raygen_fused runs in float32, not {cfg.dtype}")
    device, R = pixel_ids.device, pixel_ids.shape[0]
    check_tensor(pixel_ids, "pixel_ids", torch.int32, (R,), device)
    for name, t in leaves.items():
        check_tensor(t, name, torch.float32, (3,), device)
    if device.type == "cpu":
        return raygen_plain(camera, cfg, pixel_ids, frame)
    if device.type != "cuda":
        raise ValueError(f"raygen_fused runs on cpu or cuda, not {device}")
    return _launch(camera, cfg, pixel_ids, frame)


def _launch(camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor, frame):
    """The kernel's launch on the ids' device, on inputs ``raygen_fused``
    has checked: (o, d, seeds), d and seeds allocated here; no launch for
    R = 0."""
    device, R = pixel_ids.device, pixel_ids.shape[0]
    d = torch.empty((R, 3), dtype=torch.float32, device=device)
    seeds = torch.empty((R,), dtype=torch.int64, device=device)
    if R:
        p = params(cfg, R, 0, 0, 0)
        word, camv = frame_word(frame, device), camera_vector(camera)
        build.launch("raygen", device, lambda _: (
            ctypes.addressof(p), word, camv, pixel_ids, seeds, d), rays={"raygen_fused": R})
    return camera.position[None, :].expand_as(d), d, seeds


def camera_rays(camera: Camera, cfg: RenderConfig, pixel_ids: torch.Tensor, frame):
    """(o [R, 3], d [R, 3], seeds [R] int64 u32) of the pixel ids [R] at
    ``frame``, on the route ``raygen_route`` picks."""
    if raygen_route(camera, cfg, pixel_ids) == "fused":
        return raygen_fused(camera, cfg, pixel_ids.to(torch.int32).contiguous(), frame)
    if pixel_ids.is_cuda:
        build.RAYS["raygen_plain"] += pixel_ids.shape[0]
    return raygen_plain(camera, cfg, pixel_ids, frame)
