"""Counter-based, stateless RNG: the lowbias32 hash in counter mode.

Bit-identical to the JAX package's ``ops/rng.py``: every draw is a pure
function ``uniform(pixel_seed, counter)`` with a fixed draw-site layout,
so seeds and uniforms agree bit for bit with the reference and between
the CUDA kernels and their plain versions.

torch on the CPU implements neither ``>>`` nor ``+`` on ``uint32``, so
the u32 arithmetic runs in ``int64`` masked to 32 bits. An int64 product
of two values below 2**32 may wrap in two's complement, which leaves the
low 32 bits right, so ``& 0xFFFFFFFF`` after each multiply gives the u32
product. Seeds cross into the CUDA kernels as ``int32`` tensors holding
the u32 bits (``to_i32_bits`` / ``from_i32_bits``).

A frame is a Python int or a 0-d integer tensor (the JAX package's traced
``uint32``): ``sample_frame`` and ``pixel_seeds`` take either, and
``premix_t`` is ``premix`` on the device. A tensor frame stays on its
device, so a captured program (jit.py) reads it from memory instead of
freezing its value.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def mix_u32(x: torch.Tensor) -> torch.Tensor:
    """Finalizing 32-bit mixer (lowbias32) on int64 tensors holding u32."""
    x = x.to(torch.int64) & _MASK
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & _MASK
    x = x ^ (x >> 16)
    return x


def premix(counter: int) -> int:
    """Host half of ``hash_combine``: mix(counter) + GOLDEN, as a Python
    int. The kernels take these as scalar arguments."""
    c = int(counter) & _MASK
    c = c ^ (c >> 16)
    c = (c * _M1) & _MASK
    c = c ^ (c >> 15)
    c = (c * _M2) & _MASK
    c = c ^ (c >> 16)
    return (c + _GOLDEN) & _MASK


def premix_t(counter: torch.Tensor) -> torch.Tensor:
    """``premix`` on the device: a 0-d (or any) int64 tensor holding
    mix(counter) + GOLDEN, bitwise ``premix(int)`` for every u32."""
    return (mix_u32(counter) + _GOLDEN) & _MASK


def hash_combine(a: torch.Tensor, b) -> torch.Tensor:
    """Order-sensitive combine of two u32 streams; ``b`` is a Python int
    or a tensor."""
    if isinstance(b, torch.Tensor):
        mb = premix_t(b)
    else:
        mb = premix(b)
    return mix_u32((a.to(torch.int64) & _MASK) ^ mb)


def sample_frame(frame, spp: int, s: int):
    """The RNG frame of sample ``s`` of ``frame``: (frame * spp + s) mod
    2**32, a Python int for an int frame and a 0-d int64 tensor, computed
    on its device, for a tensor frame."""
    if isinstance(frame, torch.Tensor):
        return (frame.to(torch.int64) * spp + s) & _MASK
    return (int(frame) * spp + s) & _MASK


def pixel_seeds(pixel_ids: torch.Tensor, frame) -> torch.Tensor:
    """Per-pixel base seed for one frame/sample index (kernel_bvh.cl:445,
    with the frame fully mixed first); ``frame`` is an int or a 0-d
    integer tensor."""
    return hash_combine(pixel_ids,
                        frame if isinstance(frame, torch.Tensor) else int(frame))


def uniform(seed: torch.Tensor, counter) -> torch.Tensor:
    """Uniform float32 in [0, 1) for draw site ``counter``: the top 24
    bits of the hash, exact in float32."""
    bits = hash_combine(seed, counter)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same 32 bits."""
    x = x & _MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of u32 bits -> int64 u32 values."""
    return x.to(torch.int64) & _MASK


# Fixed draw-site layout per bounce, so every backend consumes the same
# sequence.
DRAWS_PER_BOUNCE = 8
SITE_LOBE = 0          # specular-vs-diffuse lobe pick (kernel_bvh.cl:298)
SITE_DIFF_PHI = 1      # SampleHemisphereCosine phi (kernel_bvh.cl:81)
SITE_DIFF_R2 = 2       # SampleHemisphereCosine sin^2(theta) (kernel_bvh.cl:82)
SITE_SPEC_PHI = 3      # SampleGGX phi (kernel_bvh.cl:229)
SITE_SPEC_COS = 4      # SampleGGX cosTheta draw (kernel_bvh.cl:231)
SITE_LIGHT_A = 5       # reserved for area-light sampling
SITE_LIGHT_B = 6
SITE_RESERVED = 7

# Raygen draws live before the bounce sites.
SITE_JITTER_X = 0  # kernel_bvh.cl:394
SITE_JITTER_Y = 1  # kernel_bvh.cl:395
RAYGEN_DRAWS = 2


def bounce_site(bounce: int, site: int) -> int:
    """Global counter for draw ``site`` at ``bounce``."""
    return RAYGEN_DRAWS + bounce * DRAWS_PER_BOUNCE + site
