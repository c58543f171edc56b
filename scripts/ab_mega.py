#!/usr/bin/env python3
"""The mega path's forward frame and training step, timed for two or more
checkouts of the port in one call, in turns (e.g. parent, change, change,
parent), each in a fresh process.

    python3 scripts/ab_mega.py OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

Per checkout: Cornell 1920x1080 x 9 bounces, defaults; after a warm-up,
the median of 7 ``render(frames=4)`` calls under ``torch.no_grad()``
(ms/frame, CUDA events) and of 7 ``grad.loss_and_grads`` steps (ms/step).
Scene and camera are built with ``device="cuda"`` so that checkouts with
either default device run the same thing. Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch import grad

    assert mrt.__file__.startswith(root), mrt.__file__
    dev = torch.device("cuda")
    scene, cam = mrt.cornell_scene(device=dev), mrt.Camera.default(device=dev)
    cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    loss_fn = lambda img: img.mean()

    def events(fn, count):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / count

    with torch.no_grad():
        mrt.render(scene, cam, cfg, frames=1)
        fwd = [events(lambda: mrt.render(scene, cam, cfg, frames=4), 4) for _ in range(7)]
    grad.loss_and_grads(scene, cam, cfg, loss_fn)
    step = [events(lambda: grad.loss_and_grads(scene, cam, cfg, loss_fn), 1)
            for _ in range(7)]
    print(f"{root}: forward {statistics.median(fwd):.4f} ms/frame "
          f"(min {min(fwd):.4f}), step {statistics.median(step):.4f} ms/step "
          f"(min {min(step):.4f})", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--child", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
