"""Differentiable-rendering utilities on ``torch.autograd``: gradient APIs
and finite-difference validation (the JAX package's ``grad.py``).

Forward rendering uses hard closest hits. Inside a fixed triangle
assignment the pixel value is a smooth function of vertices, normals,
materials, lights and camera, and the recompute-on-winner pattern
(ops/shading.winner_attributes; the backward bounce kernels' replay)
exposes exactly that smooth path to autodiff. At visibility silhouettes
the Dirac edge term is dropped unless ``soft_edge_sigma`` > 0.

``loss_fn`` below is any scalar function of the linear radiance image.
``accel`` is a prebuilt acceleration structure (``render.build_accel``),
passed on to the render.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from .config import RenderConfig
from .models.scene import Camera, Scene
from .render import render_radiance


def render_loss(scene: Scene, camera: Camera, cfg: RenderConfig,
                loss_fn: Callable[[torch.Tensor], torch.Tensor],
                frames: int = 1, accel=None) -> torch.Tensor:
    """Scalar loss of the rendered linear radiance."""
    return loss_fn(render_radiance(scene, camera, cfg, frames=frames,
                                   accel=accel))


def _leaves(obj, prefix=""):
    """(path, tensor) of every tensor leaf of nested dataclasses, in field
    order (the JAX pytree's leaf order)."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", v


def _rebuild(obj, values: dict, prefix=""):
    """Copy of ``obj`` with the leaves named in ``values`` replaced."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = f"{prefix}{f.name}"
        kw[f.name] = (_rebuild(v, values, path + ".") if dataclasses.is_dataclass(v)
                      else values.get(path, v))
    return dataclasses.replace(obj, **kw)


def _value_and_grad(f: Callable, tree):
    leaves = dict(_leaves(tree))
    floats = {k: v.detach().requires_grad_() for k, v in leaves.items()
              if v.is_floating_point()}
    with torch.enable_grad():
        out = f(_rebuild(tree, floats))
        grads = torch.autograd.grad(out, list(floats.values()),
                                    allow_unused=True)
    result = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for (k, x), g in zip(floats.items(), grads):
        result[k] = torch.zeros_like(x) if g is None else g
    return out.detach(), _rebuild(tree, result)


def grad_float_leaves(f: Callable, tree):
    """Gradient of the scalar ``f(tree)`` w.r.t. the float leaves of a
    dataclass tree. Integer leaves (``mat_idx``, ``light_type``) are held
    constant and get zero tensors of their own dtype. Returns a tree of
    the same structure."""
    return _value_and_grad(f, tree)[1]


@dataclasses.dataclass
class _SceneCamera:
    scene: Scene
    camera: Camera


def loss_and_grads(scene: Scene, camera: Camera, cfg: RenderConfig,
                   loss_fn: Callable[[torch.Tensor], torch.Tensor],
                   frames: int = 1, accel=None) -> Tuple[torch.Tensor, Scene, Camera]:
    """One training step's worth: the loss and its gradients w.r.t. the
    scene's and the camera's float leaves, from one forward and one
    backward pass (``scene_grad`` and ``camera_grad`` each take both)."""
    loss, g = _value_and_grad(
        lambda sc: render_loss(sc.scene, sc.camera, cfg, loss_fn, frames=frames,
                               accel=accel),
        _SceneCamera(scene, camera))
    return loss, g.scene, g.camera


def scene_grad(scene: Scene, camera: Camera, cfg: RenderConfig,
               loss_fn: Callable[[torch.Tensor], torch.Tensor],
               frames: int = 1, accel=None) -> Scene:
    """d(loss)/d(scene): gradients w.r.t. every float leaf of the scene
    (vertices, normals, uvs, materials, lights)."""
    camera = Camera(**{k: v.detach() for k, v in _leaves(camera)})
    return grad_float_leaves(
        lambda s: render_loss(s, camera, cfg, loss_fn, frames=frames,
                              accel=accel), scene)


def camera_grad(scene: Scene, camera: Camera, cfg: RenderConfig,
                loss_fn: Callable[[torch.Tensor], torch.Tensor],
                frames: int = 1, accel=None) -> Camera:
    """d(loss)/d(camera)."""
    scene = _rebuild(scene, {k: v.detach() for k, v in _leaves(scene)})
    return grad_float_leaves(
        lambda c: render_loss(scene, c, cfg, loss_fn, frames=frames,
                              accel=accel), camera)


def finite_difference(f: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Central finite differences of scalar ``f`` w.r.t. every element of
    ``x`` (dense; use on small parameter sets only)."""
    flat = x.detach().reshape(-1)
    out = torch.empty_like(flat)
    with torch.no_grad():
        for i in range(flat.shape[0]):
            e = torch.zeros_like(flat)
            e[i] = eps
            out[i] = (f((flat + e).reshape(x.shape))
                      - f((flat - e).reshape(x.shape))) / (2.0 * eps)
    return out.reshape(x.shape)


def fd_check(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             eps: float = 1e-3, rtol: float = 5e-2,
             atol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Compare the autodiff gradient with central FD. Returns
    (ad, fd, allclose)."""
    xg = x.detach().requires_grad_()
    with torch.enable_grad():
        (ad,) = torch.autograd.grad(f(xg), xg)
    fd = finite_difference(f, x, eps=eps)
    return ad, fd, bool(torch.allclose(ad, fd, rtol=rtol, atol=atol))
