#!/usr/bin/env python3
"""Where the dp training step's time goes, beside the single-device step,
for one or more checkouts of the port in one call, in turns (e.g. parent,
change, change, parent), each in a fresh process.

    python3 scripts/profile_dp_step.py OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

Per checkout: Cornell 1920x1080 x 9 bounces on one CUDA device, an NCCL
group of one rank (a FileStore under the checkout's build/), and three
steps: ``grad.loss_and_grads`` of the mean radiance and
``parallel.shard.train_step_dp`` with ``grad_buckets`` 1 and 4. After a
warm-up, each step is timed 7 times in turns by the host clock to a
``torch.cuda.synchronize`` (median and min, ms/step). Then one step of
each under ``torch.profiler``: the device busy time, the host time of the
step, the host time of the CUDA runtime calls that wait on the device
(synchronize and blocking copies), and the host ops that take most self
CPU time. Needs a CUDA device.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
          "cudaMemcpy", "cudaMemcpyAsync")


def child(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch import grad
    from mini_opencl_raytracer_tpu_torch.config import MeshConfig
    from mini_opencl_raytracer_tpu_torch.parallel import multihost, shard
    from mini_opencl_raytracer_tpu_torch.parallel.mesh import make_mesh

    assert mrt.__file__.startswith(root), mrt.__file__
    dev = torch.device("cuda")
    scene, cam = mrt.cornell_scene(device=dev), mrt.Camera.default(device=dev)
    cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        multihost.initialize(coordinator_address=f"file://{tmp}/store", num_processes=1,
                             process_id=0, device=dev)
        mesh = make_mesh(MeshConfig(dp=1, tp=1), device_type="cuda")
        steps = {
            "loss_and_grads": lambda: grad.loss_and_grads(scene, cam, cfg,
                                                          lambda im: im.mean()),
            "train_step_dp(1)": lambda: shard.train_step_dp(scene, cam, cfg, mesh),
            "train_step_dp(4)": lambda: shard.train_step_dp(scene, cam, cfg, mesh,
                                                            grad_buckets=4),
        }
        for fn in steps.values():
            fn()
        torch.cuda.synchronize()
        times = {name: [] for name in steps}
        for _ in range(7):
            for name, fn in steps.items():
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        line = "; ".join(f"{n} {statistics.median(t):.4f} ms/step (min {min(t):.4f})"
                         for n, t in times.items())
        print(f"{root}: {line}", flush=True)
        for name, fn in steps.items():
            print(f"{root}: {name} under the profiler: " + profiled(torch, profile,
                                                                    ProfilerActivity, fn),
                  flush=True)
        torch.distributed.destroy_process_group()


def profiled(torch, profile, activities, fn) -> str:
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
    with profile(activities=[activities.CPU, activities.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    busy = sum(dev_us(e) for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    cpu = [e for e in ev if e.device_type == torch.autograd.DeviceType.CPU]
    waits = {e.key: (e.self_cpu_time_total / 1e3, e.count) for e in cpu
             if e.key in _WAITS}
    cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    top = ", ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
                    for e in cpu[:12])
    return (f"{host_ms:.3f} ms by the host clock, device busy {busy:.3f} ms; waits "
            + ", ".join(f"{k} {t:.3f} ms x{c}" for k, (t, c) in waits.items())
            + f"; top host ops (self): {top}")


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        child(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0 else "card unknown",
          flush=True)
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
