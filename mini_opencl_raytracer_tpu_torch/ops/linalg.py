"""Small vector-math helpers over [..., 3] tensors (the reference's
``float3`` library, CLmathlib.hpp:18-118), broadcasting over leading
batch dimensions."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis -> [...], summed as
    (x + y) + z: a fixed order, the one the CUDA kernels use, so the two
    round alike (a reduction kernel may sum in another order)."""
    a, b = torch.broadcast_tensors(a, b)
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def vmax(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) with ``jnp.maximum``'s gradient: at a tie each side takes
    half (``torch.clamp`` would pass all of it to ``x``)."""
    return torch.maximum(x, x.new_full((), c))


def vmin(x: torch.Tensor, c: float) -> torch.Tensor:
    """min(x, c), split at a tie like ``jnp.minimum``."""
    return torch.minimum(x, x.new_full((), c))


def vclip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), half the gradient at a bound."""
    return vmin(vmax(x, lo), hi)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(vmax(dot(a, a), 0.0))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; returns a zero-safe unit vector. The inverse length
    is 1 / sqrt (both correctly rounded) rather than rsqrt, which is
    approximate on CUDA, so the plain path and the kernels agree."""
    return a * (1.0 / torch.sqrt(vmax(dot(a, a), eps)))[..., None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reference convention (kernel_bvh.cl:74-77): reflect the *outgoing*
    vector, ``-v + 2 (v.n) n``."""
    return -v + 2.0 * dot(v, n)[..., None] * n


def build_onb(n: torch.Tensor):
    """Orthonormal basis (s, t) around n, SampleHemisphereCosine's frame
    (kernel_bvh.cl:85-87): axis = |n.x|>0.001 ? +Y : +X;
    t = normalize(cross(axis, n)); s = cross(n, t)."""
    use_y = (torch.abs(n[..., 0]) > 1e-3)[..., None]
    axis = torch.where(
        use_y,
        torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device),
        torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device),
    )
    t = normalize(cross(axis, n))
    s = cross(n, t)
    return s, t


def spherical_dir(s, t, n, phi, sin_theta, cos_theta) -> torch.Tensor:
    """Direction from local spherical angles in the (s, t, n) frame
    (kernel_bvh.cl:89, 238)."""
    return normalize(
        s * (torch.cos(phi) * sin_theta)[..., None]
        + t * (torch.sin(phi) * sin_theta)[..., None]
        + n * cos_theta[..., None]
    )
