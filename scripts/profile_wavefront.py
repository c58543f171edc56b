#!/usr/bin/env python3
"""Where the time of a wavefront (``pallas`` backend) frame goes on the
card: one ``render`` frame per case under ``torch.profiler``, after a
warm-up frame, with the frame's time by CUDA events outside the profiler.

    python3 scripts/profile_wavefront.py [--top 12]

Cases: BASELINE config 3 (bunny, 512x512, 2 bounces, SAH accel) with the
coherence sort on and off, and Cornell 1920x1080 x 9 bounces with
``backend="pallas"`` (the panel). For each: ms per frame of three frames
(events), device busy ms (the sum of the kernels' CUDA time; the aten
rows that launched them are not counted again) and the idle share
against the fastest frame, K6's device time and its share of busy, and
the top kernels by CUDA time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

# The package is not installed where this runs: import it from the checkout.
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_wavefront: needs a CUDA device", file=sys.stderr)
        return 2
    import mini_opencl_raytracer_tpu_torch as mrt
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    cam = mrt.Camera.default()
    bunny = mrt.bunny_scene()
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    accel = mrt.build_accel(bunny, cfg3)
    cases = [("config 3 sorted", bunny, cfg3, accel),
             ("config 3 unsorted", bunny, dataclasses.replace(cfg3, sort_rays=False), accel),
             ("Cornell 1080p x 9 pallas", mrt.cornell_scene(),
              mrt.RenderConfig(width=1920, height=1080, bounces=9, backend="pallas"), None)]
    for label, scene, cfg, acc in cases:
        with torch.no_grad():
            run = lambda: mrt.render(scene, cam, cfg, frames=1, accel=acc)
            run()
            torch.cuda.synchronize()
            frames = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                frames.append(start.elapsed_time(end))
            frame_ms = min(frames)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                            or getattr(e, "self_cuda_time_total", 0))
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in rows) / 1e3
        print(f"\n== {label}: " + ", ".join(f"{f:.3f}" for f in frames)
              + f" ms/frame (events); device busy {busy:.3f} ms in the profiled frame; "
              f"idle share {max(0.0, 1 - busy / frame_ms):.3f} of the fastest ({card})",
              flush=True)
        k6 = sum(dev_us(e) for e in rows if "clustered_kernel" in e.key) / 1e3
        if k6:
            print(f"  K6 (clustered_kernel) {k6:.3f} ms, {k6 / busy:.3f} of busy")
        rows.sort(key=dev_us, reverse=True)
        for e in rows[:args.top]:
            print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
