"""The CUDA bounce kernels (forward and backward) against their plain
versions on a GPU.

Marked ``cuda``; skips without a CUDA device (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on a
machine without JAX; tests/conftest.py imports JAX, hence:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Gate: ops/cuda/parity.py, the one chip_smoke.py applies (seeds bit-exact,
winners equal on >= 99.99% of rays, every float output with mean |diff|
<= 1e-4 and frac(|diff| > 1e-3) <= 1e-4). At 128x128 the tail bound lets
4 of the 49152 entries of a [3, R] output differ, and the winner bound
1 of the 16384 rays.
"""

import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from mini_opencl_raytracer_tpu_torch.ops.cuda import parity


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {},
    dict(shadow_rays=True, direct_specular=True, specular_model="ggx"),
    dict(soft_edge_sigma=0.05, backface_cull=True),
])
def test_kernels_match_plain_on_card(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = P.RenderConfig(width=128, height=128, **kw)
    table, tris, lv = pmk._tables(P.cornell_scene(device=dev), cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device=dev))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    n0 = dict(pmk.LAUNCHES)
    k0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 1, cfg)
    p0 = pmk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
    state = (k0[0], k0[1], k0[2], k0[3], k0[7])
    k1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    p1 = pmk.bounce_fwd_plain(table, tris, lv, *state, 1, cfg)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES == dict(n0, bounce0_fwd=n0["bounce0_fwd"] + 1,
                                bounce_fwd=n0["bounce_fwd"] + 1)
    parity.check_bounce("bounce0_fwd", k0, p0)
    parity.check_bounce("bounce_fwd", k1, p1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {},
    dict(shadow_rays=True, direct_specular=True, specular_model="ggx"),
    dict(soft_edge_sigma=0.05, backface_cull=True),
])
def test_backward_kernels_match_plain_on_card(kw):
    """bounce0_bwd and bounce_bwd against their plain versions at 128x128,
    under parity.check_grads (per-ray mean and tail bounds scaled by the
    largest plain value; reduced outputs within 2e-3 of the largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = P.RenderConfig(width=128, height=128, **kw)
    table, tris, lv = pmk._tables(P.cornell_scene(device=dev), cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device=dev))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    f0 = pmk.bounce0_fwd(table, tris, lv, camv, pid, 1, cfg)
    cot0 = parity.cotangents(f0[2], gen)
    n0 = dict(pmk.LAUNCHES)
    k0 = pmk.bounce0_bwd(table, lv, camv, pid, 1, f0[5], f0[6], cot0, cfg)
    p0 = pmk.bounce0_bwd_plain(table, lv, camv, pid, 1, f0[5], f0[6], cot0, cfg)
    state = (f0[0], f0[1], f0[2], f0[3], f0[7])
    f1 = pmk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    cot1 = parity.cotangents(f1[2], gen)
    n1 = dict(pmk.LAUNCHES)
    k1 = pmk.bounce_bwd(table, lv, *state[:4], f0[7], f1[5], f1[6], cot1, 1, cfg)
    p1 = pmk.bounce_bwd_plain(table, lv, *state[:4], f0[7], f1[5], f1[6], cot1, 1, cfg)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES["bounce0_bwd"] == n0["bounce0_bwd"] + 1
    assert pmk.LAUNCHES["bounce_bwd"] == n1["bounce_bwd"] + 1
    parity.check_grads("bounce0_bwd", k0, p0, parity.BOUNCE0_GRADS)
    parity.check_grads("bounce_bwd", k1, p1, parity.BOUNCE_GRADS)
