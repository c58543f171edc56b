"""The card's peaks and the least time of a piece of work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates): 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of
HBM3. Both assume the full power limit of 700 W; a roofline share is
stated against them with the card's power limit beside it.
"""

from __future__ import annotations

import subprocess
from typing import Iterable, Optional, Tuple

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_time(nbytes: float, flops: float) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the float32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def least_time_of(launches: Iterable[Tuple[float, float]]) -> Tuple[float, str]:
    """Least time of several launches, each bounded on its own; the side
    that bounds the larger part of the sum names the whole."""
    total = by_bytes = 0.0
    for nbytes, flops in launches:
        t, by = least_time(nbytes, flops)
        total += t
        by_bytes += t if by == "bytes" else 0.0
    return total, ("bytes" if by_bytes >= total - by_bytes else "operations")


def card(index: int = 0) -> Tuple[str, Optional[float]]:
    """(name, power limit in W or None) of the card, by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in out.split(","))
        return name, float(limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return "unknown", None
