"""The gate that holds a kernel's outputs against its plain version's on
the same inputs (chip_smoke.py and tests/test_torch_cuda.py).

Forward: seeds bit-exact; winner indices equal on >= 99.99% of rays;
every float output with mean |diff| <= 1e-4 and frac(|diff| > 1e-3) <=
1e-4 (the forward gate of benchmarks/VERIFY_TPU.md); the intersection
kernels' any-hit occlusion exactly equal. Knife-edge decisions
(a ray on a shared edge, a sample on a validity threshold) may flip under
different float rounding; those flips are the gate's only allowed error.

Gradients: per-ray outputs (d_o, d_d, d_beta) take the forward gate
scaled by s = max |plain|: mean |diff| <= 1e-4 s and frac(|diff| >
1e-3 s) <= 1e-4. Sums over rays (d_table, d_lights, d_camv) and scene or
camera gradients per leaf: max |diff| <= 2e-3 max |reference| (the
gradient gate of benchmarks/VERIFY_TPU.md). Against central finite
differences: relative error <= 5e-2. Every value must be finite.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.cornell import cornell_scene
from ...models.scene import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
                             Geometry, Lights, Scene)

MEAN_TOL, ERR_TOL, FRAC_TOL, WINNER_AGREE = 1e-4, 1e-3, 1e-4, 0.9999
GRAD_TOL, FD_TOL = 2e-3, 5e-2
BOUNCE_FLOATS = ("o", "d", "beta", "alive", "radiance")
# Outputs of the backward wrappers, and which are per ray.
BOUNCE0_GRADS = ("d_table", "d_lights", "d_camv")
BOUNCE_GRADS = ("d_o", "d_d", "d_beta", "d_table", "d_lights")
PER_RAY = ("d_o", "d_d", "d_beta")


def check_float(label: str, kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    """Mean / tail gate on one float output; returns its max, mean and
    tail fraction of |diff|, and raises AssertionError outside the gate."""
    err = (kernel.float() - plain.float()).abs()
    stats = {"max": err.max().item(), "mean": err.mean().item(),
             "frac": (err > ERR_TOL).float().mean().item()}
    if not (stats["mean"] <= MEAN_TOL and stats["frac"] <= FRAC_TOL
            and bool(torch.isfinite(err).all())):
        raise AssertionError(f"{label}: kernel disagrees with its plain version "
                             f"{stats}")
    return stats


def check_bounce(label: str, k_out, p_out) -> dict:
    """Gate one bounce's outputs (o, d, beta, alive, radiance, winner,
    occ_bits[, seeds]) as the wrappers return them; returns the stats of
    each float output, the winner and occlusion-bit agreement, and
    ``max_abs_err`` over all float outputs."""
    stats = {n: check_float(f"{label}.{n}", k, p)
             for n, k, p in zip(BOUNCE_FLOATS, k_out, p_out)}
    stats["winner_agree"] = (k_out[5] == p_out[5]).float().mean().item()
    stats["occ_agree"] = (k_out[6] == p_out[6]).float().mean().item()
    if stats["winner_agree"] < WINNER_AGREE:
        raise AssertionError(f"{label}: winners agree on "
                             f"{stats['winner_agree']:.6f} < {WINNER_AGREE}")
    if len(k_out) > 7 and not torch.equal(k_out[7], p_out[7]):
        raise AssertionError(f"{label}: seeds are not bit-exact")
    stats["max_abs_err"] = max(stats[n]["max"] for n in BOUNCE_FLOATS)
    return stats


def check_hits(label: str, k_out, p_out) -> dict:
    """Gate a closest-hit kernel's (t, winner[, rows]) against its plain
    version's: winners equal on >= 99.99% of rays, t and rows under the
    forward gate. Returns the stats and ``max_abs_err``."""
    same = k_out[1] == p_out[1]
    stats = {"t": check_float(f"{label}.t", k_out[0], p_out[0])}
    if len(k_out) > 2 and k_out[2] is not None:
        # A row belongs to its winner: compare the rows of equal winners.
        stats["rows"] = check_float(f"{label}.rows", k_out[2][same], p_out[2][same])
    stats["winner_agree"] = same.float().mean().item()
    stats["hit_frac"] = (p_out[1] >= 0).float().mean().item()
    if stats["winner_agree"] < WINNER_AGREE:
        raise AssertionError(f"{label}: winners agree on "
                             f"{stats['winner_agree']:.6f} < {WINNER_AGREE}")
    stats["max_abs_err"] = max(v["max"] for v in stats.values() if isinstance(v, dict))
    return stats


def check_any(label: str, k_blocked: torch.Tensor, p_blocked: torch.Tensor) -> dict:
    """An any-hit kernel's occlusion must equal its plain version's."""
    if not torch.equal(k_blocked, p_blocked):
        n = (k_blocked != p_blocked).sum().item()
        raise AssertionError(f"{label}: occlusion differs on {n} of "
                             f"{k_blocked.numel()} rays")
    return {"blocked_frac": p_blocked.float().mean().item()}


def cotangents(next_beta: torch.Tensor, gen: torch.Generator):
    """Seeded standard-normal cotangents of (o', d', beta', radiance), each
    shaped like ``next_beta`` ([3, R]), on its device."""
    return tuple(torch.randn(next_beta.shape, generator=gen,
                             device=next_beta.device) for _ in range(4))


def _finite(label: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite values")


def check_grad_sum(label: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |diff| <= 2e-3 max |ref| for a sum over rays or a gradient
    leaf; returns max |diff| and its ratio to max |ref|."""
    _finite(label, got, ref)
    err = (got.double() - ref.double()).abs().max().item() if got.numel() else 0.0
    scale = ref.abs().max().item() if ref.numel() else 0.0
    stats = {"max": err, "scale": scale, "rel": err / scale if scale else err}
    if err > GRAD_TOL * scale:
        raise AssertionError(f"{label}: gradient outside the gate {stats}")
    return stats


def check_grad_rays(label: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The forward gate scaled by s = max |ref| on a per-ray gradient."""
    _finite(label, got, ref)
    s = ref.abs().max().item()
    err = (got.double() - ref.double()).abs()
    stats = {"max": err.max().item(), "mean": err.mean().item(),
             "frac": (err > ERR_TOL * s).double().mean().item(), "scale": s}
    if not (stats["mean"] <= MEAN_TOL * s and stats["frac"] <= FRAC_TOL):
        raise AssertionError(f"{label}: kernel disagrees with its plain version "
                             f"{stats}")
    return stats


def check_grads(label: str, k_out, p_out, names) -> dict:
    """Gate a backward wrapper's outputs ``names`` against the plain
    version's; returns per-output stats and ``max_abs_err``."""
    stats = {}
    for n, k, p in zip(names, k_out, p_out):
        check = check_grad_rays if n in PER_RAY else check_grad_sum
        stats[n] = check(f"{label}.{n}", k, p)
    stats["max_abs_err"] = max(v["max"] for v in stats.values())
    return stats


def check_fd(label: str, ad: float, fd: float) -> float:
    """|ad - fd| <= 5e-2 |fd|; returns the relative error."""
    rel = abs(ad - fd) / max(abs(fd), 1e-12)
    if not (rel <= FD_TOL and abs(fd) > 0):
        raise AssertionError(f"{label}: autodiff {ad} vs finite difference {fd} "
                             f"(relative error {rel})")
    return rel


# ---------------------------------------------------------------------------
# Inputs the backward gate runs on beside Cornell's defaults (chip_smoke.py
# phase 3b, tests/test_torch_cuda.py).

def shuffled_ids(num_pixels: int, seed: int, device) -> torch.Tensor:
    """A seeded permutation of the pixel ids: neighbouring rays start from
    pixels far apart, so a warp's rays see many winners."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(num_pixels, generator=gen).to(torch.int32).to(device)


def _t(a, device, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def two_light_scene(device) -> Scene:
    """Cornell with a point light and a spot light."""
    lights = Lights(
        position=_t([[0.0, -10.0, 16.0], [0.0, 10.0, 16.0]], device),
        direction=_t([[-0.5, 0.4, -0.1], [0.0, 0.1, -1.0]], device),
        light_type=_t([LIGHT_POINT, LIGHT_SPOT], device, torch.int32),
        intensity=_t([16.0, 12.0], device), attenuation=_t([0.8, 0.05], device),
        cos_cutoff=_t([0.9, 0.7], device))
    return cornell_scene(lights=lights, device=device)


def many_light_scene(device, n: int = 30, seed: int = 4) -> Scene:
    """Cornell with ``n`` seeded lights (30 is the mega path's limit), point,
    spot and directional in turn, placed in and around the box."""
    rs = np.random.default_rng(seed)
    kinds = np.array([LIGHT_POINT, LIGHT_SPOT, LIGHT_DIRECTIONAL])[np.arange(n) % 3]
    lights = Lights(
        position=_t(rs.uniform([-8.0, -12.0, 2.0], [8.0, 8.0, 16.0], (n, 3)), device),
        direction=_t(rs.normal(0.0, 1.0, (n, 3)), device),
        light_type=_t(kinds, device, torch.int32),
        intensity=_t(rs.uniform(2.0, 16.0, n), device),
        attenuation=_t(rs.uniform(0.05, 0.8, n), device),
        cos_cutoff=_t(rs.uniform(0.5, 0.95, n), device))
    return cornell_scene(lights=lights, device=device)


def soup_scene(device, n: int = 2048, seed: int = 3) -> Scene:
    """A seeded soup of ``n`` triangles in front of the camera, with the
    Cornell materials and light."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform([-10.0, -5.0, -2.0], [10.0, 10.0, 18.0], (n, 3))
    corners = [centers + rs.normal(0.0, 1.0, (n, 3)) for _ in range(3)]
    normal = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-12
    zeros2 = _t(np.zeros((n, 2)), device)
    geo = Geometry(v0=_t(corners[0], device), v1=_t(corners[1], device),
                   v2=_t(corners[2], device), n0=_t(normal, device),
                   n1=_t(normal, device), n2=_t(normal, device),
                   uv0=zeros2, uv1=zeros2, uv2=zeros2,
                   mat_idx=_t(rs.integers(0, 6, n), device, torch.int32))
    base = cornell_scene(device=device)
    return Scene(geometry=geo, materials=base.materials, lights=base.lights)
