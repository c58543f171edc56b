"""The gate that holds a kernel's outputs against its plain version's on
the same inputs (chip_smoke.py and tests/test_torch_cuda.py).

Seeds bit-exact; winner indices equal on >= 99.99% of rays; every float
output with mean |diff| <= 1e-4 and frac(|diff| > 1e-3) <= 1e-4 (the
forward gate of benchmarks/VERIFY_TPU.md). Knife-edge decisions (a ray on
a shared edge, a sample on a validity threshold) may flip under different
float rounding; those flips are the gate's only allowed error.
"""

from __future__ import annotations

import torch

MEAN_TOL, ERR_TOL, FRAC_TOL, WINNER_AGREE = 1e-4, 1e-3, 1e-4, 0.9999
BOUNCE_FLOATS = ("o", "d", "beta", "alive", "radiance")


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
