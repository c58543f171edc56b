#!/usr/bin/env python3
"""Per-ray clock64 cycles of the cluster-traversal kernel (K6), against
its Möller–Trumbore tests per ray, on BASELINE config 3's primary and
bounce-1 rays (pixel order and coherence-sorted).

    python3 scripts/k6_cycles.py

Builds the kernels with ``-DMRT_K6_CYCLES`` (a library of its own, keyed
by the flags), under which ``csrc/clustered.cu`` writes each ray's cycles
from the start of its walk to its end into the third column of
``stats``, in place of the box tests. Prints one launch's time, the mean,
p50 / p90 / p99 and largest cycles per ray, and the M-T tests of the
slowest 1% of rays. Run it in a process of its own. Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as cl
    from mini_opencl_raytracer_tpu_torch.ops.cuda import parity

    if build._LIB is not None:
        raise RuntimeError("the kernel library is already loaded without the cycle counts")
    build.NVCC_FLAGS.append("-DMRT_K6_CYCLES")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    bunny, cam = mrt.bunny_scene(device=dev), mrt.Camera.default(device=dev)
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    cg = mrt.build_accel(bunny, cfg3)
    rays = parity.wavefront_rays(bunny, cam, cfg3, *cl.make_intersectors(
        bunny.geometry, cfg3, accel=cg, materials=bunny.materials))
    card = smoke.card_line()
    for kind in ("primary", "bounce1", "bounce1_sorted"):
        o, d = rays[kind]
        ti = torch.full((o.shape[0],), cfg3.t_max, device=dev)
        st = torch.zeros((o.shape[0], 3), dtype=torch.int32, device=dev)
        cl.clustered_closest(cg, o, d, ti, stats=st)
        ms = smoke.events_ms(lambda: cl.clustered_closest(cg, o, d, ti, stats=st))
        c, t = st[:, 2].double().cpu(), st[:, 0].double().cpu()
        q = torch.quantile(c, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)).tolist()
        top = c >= q[2]
        print(f"{kind}: {o.shape[0]} rays, one launch {ms:.4f} ms; cycles per ray mean "
              f"{c.mean().item():.0f}, p50 / p90 / p99 {q[0]:.0f} / {q[1]:.0f} / {q[2]:.0f}, "
              f"max {c.max().item():.0f}; M-T tests per ray mean {t.mean().item():.1f}, max "
              f"{t.max().item():.0f}, of the slowest 1% {t[top].mean().item():.1f} "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
