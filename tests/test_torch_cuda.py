"""The CUDA bounce kernels against their plain versions on a GPU.

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
    assert pmk.LAUNCHES == {"bounce0_fwd": n0["bounce0_fwd"] + 1,
                            "bounce_fwd": n0["bounce_fwd"] + 1}
    parity.check_bounce("bounce0_fwd", k0, p0)
    parity.check_bounce("bounce_fwd", k1, p1)
