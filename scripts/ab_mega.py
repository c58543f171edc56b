#!/usr/bin/env python3
"""The mega path's forward frame and training step, timed for two or more
checkouts of the port in one call, in turns (e.g. parent, change, change,
parent), each in a fresh process.

    python3 scripts/ab_mega.py OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

Per checkout: Cornell 1920x1080 x 9 bounces, defaults; after a warm-up,
the median of 7 ``render(frames=4)`` calls under ``torch.no_grad()``
(ms/frame, CUDA events) and of 7 ``grad.loss_and_grads`` steps (ms/step);
then the forward kernels alone on the main path's state, ``bounce0_fwd``
(K1) and ``bounce_fwd`` (K2) at bounce 1, by CUDA events over 20
launches (``chip_smoke.time_ms``), and the backward wrappers with seeded
cotangents, ``bounce0_bwd`` at bounce 0 and ``bounce_bwd`` at bounces 1, 4
and 8: device time per call (``chip_smoke.device_ms``: CUDA events around
20 calls queued behind a sleep kernel, after a warm-up).
Scene and camera are built with ``device="cuda"`` so that checkouts with
either default device run the same thing. Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import os
import statistics
import subprocess
import sys


def child(root: str) -> None:
    root = os.path.abspath(root)
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
          f"(min {min(step):.4f}); " + kernel_times(torch, mrt, cfg, scene, cam),
          flush=True)


def kernel_times(torch, mrt, cfg, scene, cam) -> str:
    from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids

    # The timer of chip_smoke.py, from this script's checkout (a parent
    # checkout may lack it); it imports only torch.
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernel_ms = smoke.device_ms

    table, tris, lv = mk._tables(scene, cfg, None)
    camv = mk.camera_vector(cam)
    ids = _swizzled_ids(cfg, camv.device)
    gen = torch.Generator(device=camv.device).manual_seed(1)
    cot = lambda x: tuple(torch.randn(x.shape, generator=gen, device=x.device) for _ in range(4))
    f = mk.bounce0_fwd(table, tris, lv, camv, ids, 0, cfg)
    s1 = (f[0], f[1], f[2], f[3], f[7])
    out = {"bounce0_fwd": smoke.time_ms(
               lambda: mk.bounce0_fwd(table, tris, lv, camv, ids, 0, cfg), 20),
           "bounce_fwd b1": smoke.time_ms(lambda: mk.bounce_fwd(table, tris, lv, *s1, 1, cfg), 20)}
    c = cot(f[2])
    out["bounce0_bwd b0"] = (kernel_ms(
        lambda: mk.bounce0_bwd(table, lv, camv, ids, 0, f[5], f[6], c, cfg)))
    state = (f[0], f[1], f[2], f[3], f[7])
    for b in range(1, 9):
        f = mk.bounce_fwd(table, tris, lv, *state, b, cfg)
        if b in (1, 4, 8):
            c = cot(f[2])
            out[f"bounce_bwd b{b}"] = kernel_ms(
                lambda: mk.bounce_bwd(table, lv, *state, f[5], f[6], c, b, cfg))
        state = (f[0], f[1], f[2], f[3], state[4])
    return ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())


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
