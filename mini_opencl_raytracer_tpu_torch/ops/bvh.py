"""Morton codes (the JAX package's ``ops/bvh.py:45-62``).

They order the triangles of the clustered kernel's Morton layout
(ops/cuda/clustered.build_clusters) and the rays of the sorted wavefront
(ops/integrator._ray_sort_keys). Codes are int64 holding the uint32
value: torch on the CPU has no ``>>`` or ``*`` on uint32, so every step
is masked to 32 bits. The LBVH build and traversal (``build_bvh``,
``intersect_bvh``) are not ported yet.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value with two zero bits between
    them (standard Morton bit-dilation), in uint32 arithmetic."""
    v = v.to(torch.int64) & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(points01: torch.Tensor) -> torch.Tensor:
    """[N, 3] points in [0,1] -> 30-bit Morton codes (int64)."""
    q = torch.clamp(points01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (expand_bits_10(q[:, 0]) * 4
            + expand_bits_10(q[:, 1]) * 2
            + expand_bits_10(q[:, 2]))
