"""The port's counter-based RNG against the JAX package's, bit for bit.

Seeds and uniforms must be bit-exact: they decide every sampling branch,
so any difference would make the port's paths diverge from the
reference's. The port computes u32 arithmetic in int64 masked to 32 bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mini_opencl_raytracer_tpu.ops import rng as jrng
from mini_opencl_raytracer_tpu.ops.pallas import megakernel as jmk
from mini_opencl_raytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

# A 16x16 = 256-pixel grid, and random u32 values from a fixed seed.
PIX = np.arange(256, dtype=np.uint32)
U32 = np.random.default_rng(7).integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def test_mix_u32_bit_exact():
    ref = np.asarray(jrng.mix_u32(jnp.asarray(U32)))
    got = trng.mix_u32(_t(U32)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("frame", [0, 1, 12345, 2**32 - 1])
def test_pixel_seeds_bit_exact(frame):
    ref = np.asarray(jrng.pixel_seeds(jnp.asarray(PIX), np.uint32(frame)))
    got = trng.pixel_seeds(_t(PIX), frame).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("bounce", [0, 8])
def test_uniform_and_premixed_counters_bit_exact(bounce):
    seeds = jrng.pixel_seeds(jnp.asarray(PIX), np.uint32(3))
    tseeds = _t(np.asarray(seeds))
    for site in range(5):
        counter = int(jrng.bounce_site(bounce, site))
        assert trng.bounce_site(bounce, site) == counter
        assert trng.premix(counter) == jmk._premixed_counter(counter)
        ref = np.asarray(jrng.uniform(seeds, counter))
        got = trng.uniform(tseeds, counter).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_hash_combine_tensor_operand():
    ref = np.asarray(jrng.hash_combine(jnp.asarray(PIX), jnp.asarray(U32)))
    got = trng.hash_combine(_t(PIX), _t(U32)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_i32_bits_round_trip():
    bits = trng.to_i32_bits(_t(U32))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), U32.view(np.int32))
    np.testing.assert_array_equal(trng.from_i32_bits(bits).numpy(),
                                  U32.astype(np.int64))
