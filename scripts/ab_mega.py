#!/usr/bin/env python3
"""The mega path's forward frame and training step, timed for two or more
checkouts of the port in one call, in turns (e.g. parent, change, change,
parent), each in a fresh process.

    python3 scripts/ab_mega.py [--resid] OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

Per checkout: Cornell 1920x1080 x 9 bounces, defaults; after a warm-up
call of the same key (where ``render`` is compiled, its capture), the
median of 7 ``render(frames=4)`` calls under ``torch.no_grad()``
(ms/frame, CUDA events) and of 7 ``grad.loss_and_grads`` steps (ms/step);
then the forward kernels alone on the main path's state, ``bounce0_fwd``
(K1) and ``bounce_fwd`` (K2) at bounce 1, by CUDA events over 20
launches (``chip_smoke.time_ms``), and K1 by device time; K2 at each bounce 1-8 from the carried
state (the kernels' own outputs) and their sum, K2 at bounce 1 with every
ray dead and with every ray alive, and the backward wrappers with seeded
cotangents, ``bounce0_bwd`` at bounce 0 and ``bounce_bwd`` at bounces 1, 4
and 8: device time per call (``chip_smoke.device_ms``: CUDA events around
20 calls queued behind a sleep kernel, after a warm-up). Then K2 at each
bounce 1-8 and their sum at 1080p x 9 on scenes whose live rays run more
Moller-Trumbore tests than Cornell's 36: seeded soups of 256, 512 and
2048 triangles (``parity.soup_scene``; 2048 is the mega path's limit),
and Cornell under 2, 8 and 30 lights with shadow rays
(``parity.two_light_scene``, ``parity.many_light_scene``; 36 tests a
light more).
Then the backward's residual mode (``cfg.bwd_residuals``): K2 with rows
(``bounce_fwd(save_resid=True)``) and K4 reading them (``bounce_bwd(resid=
...)``) beside K2 and K4 at each bounce 1-8 of the same state, and their
sums (device time), and the compiled step (``jit`` of ``loss_and_grads``)
with rows and without, 7 pairs in turns, medians (CUDA events). Any
checkout since the residual mode was ported runs it: the rows go from the
forward's output to the backward as they are. ``--resid`` times the
residual mode alone (~20 s a checkout).
Scene and camera are built with ``device="cuda"`` so that checkouts with
either default device run the same thing. Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import os
import re
import statistics
import subprocess
import sys


def child(root: str, resid_only: bool = False) -> None:
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

    if resid_only:
        print(f"{root}: residual mode: " + resid_times(torch, mrt, grad, cfg, scene, cam, events),
              flush=True)
        return
    with torch.no_grad():
        mrt.render(scene, cam, cfg, frames=4)
        fwd = [events(lambda: mrt.render(scene, cam, cfg, frames=4), 4) for _ in range(7)]
    grad.loss_and_grads(scene, cam, cfg, loss_fn)
    step = [events(lambda: grad.loss_and_grads(scene, cam, cfg, loss_fn), 1)
            for _ in range(7)]
    print(f"{root}: forward {statistics.median(fwd):.4f} ms/frame "
          f"(min {min(fwd):.4f}), step {statistics.median(step):.4f} ms/step "
          f"(min {min(step):.4f}); " + kernel_times(torch, mrt, cfg, scene, cam),
          flush=True)
    print(f"{root}: residual mode: " + resid_times(torch, mrt, grad, cfg, scene, cam, events),
          flush=True)


def resid_times(torch, mrt, grad, cfg, scene, cam, events) -> str:
    import dataclasses
    from mini_opencl_raytracer_tpu_torch.jit import jit
    from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as mk, parity
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids

    smoke = _smoke()
    table, tris, lv = mk._tables(scene, cfg, None)
    camv = mk.camera_vector(cam)
    f = mk.bounce0_fwd(table, tris, lv, camv, _swizzled_ids(cfg, camv.device), 0, cfg)
    state, seeds = f[:4], f[7]
    gen = torch.Generator(device=camv.device).manual_seed(2)
    t = {k: [] for k in ("K2", "K2 with rows", "K4", "K4 with rows")}
    for b in range(1, cfg.bounces):
        kc = mk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg)
        rows = mk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg, save_resid=True)[7]
        args = (table, lv, *state, seeds, kc[5], kc[6], parity.cotangents(kc[2], gen), b, cfg)
        t["K2"].append(smoke.device_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, seeds, b,
                                                             cfg)))
        t["K2 with rows"].append(smoke.device_ms(
            lambda: mk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg, save_resid=True)))
        t["K4"].append(smoke.device_ms(lambda: mk.bounce_bwd(*args)))
        t["K4 with rows"].append(smoke.device_ms(lambda: mk.bounce_bwd(*args, resid=rows)))
        state = kc[:4]
    out = [f"{k} [{', '.join(f'{x:.4f}' for x in v)}] sum {sum(v):.4f}" for k, v in t.items()]
    # Bounce 1's rays cut to those alive with a winner.
    f = mk.bounce0_fwd(table, tris, lv, camv, _swizzled_ids(cfg, camv.device), 0, cfg)
    kc = mk.bounce_fwd(table, tris, lv, *f[:4], f[7], 1, cfg)
    keep = parity.live_rays(f[3], kc[5]).nonzero()[:, 0]
    st = tuple(x[:, keep].contiguous() for x in f[:3]) + (f[3][keep].contiguous(),)
    sd = f[7][keep].contiguous()
    ck = mk.bounce_fwd(table, tris, lv, *st, sd, 1, cfg)
    rows = mk.bounce_fwd(table, tris, lv, *st, sd, 1, cfg, save_resid=True)[7]
    args = (table, lv, *st, sd, ck[5], ck[6], parity.cotangents(ck[2], gen), 1, cfg)
    c = {"K2": smoke.device_ms(lambda: mk.bounce_fwd(table, tris, lv, *st, sd, 1, cfg)),
         "K2 with rows": smoke.device_ms(lambda: mk.bounce_fwd(table, tris, lv, *st, sd, 1, cfg,
                                                              save_resid=True)),
         "K4": smoke.device_ms(lambda: mk.bounce_bwd(*args)),
         "K4 with rows": smoke.device_ms(lambda: mk.bounce_bwd(*args, resid=rows))}
    out.append(f"bounce 1 cut to its {keep.numel()} rays with a winner: "
               + ", ".join(f"{k} {v:.4f}" for k, v in c.items()))
    # K2 with rows at bounce 1, by kernel (the wrapper's launches and memsets).
    by_kernel = per_kernel(torch, lambda: mk.bounce_fwd(table, tris, lv, *f[:4], f[7], 1, cfg,
                                                        save_resid=True))
    out.append("K2 with rows at bounce 1 by kernel (device ms a call, torch.profiler): "
               + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))
    loss_fn = lambda img: img.mean()
    frame = lambda i: torch.full((), i, dtype=torch.int64, device=camv.device)
    comp = {m: jit(lambda s, fr, c=dataclasses.replace(cfg, bwd_residuals=m):
                   grad.loss_and_grads(s, cam, c, loss_fn)) for m in (False, True)}
    with torch.enable_grad():
        for m in comp:
            comp[m](scene, frame(0))
        ms = {m: [] for m in comp}
        for i in range(7):
            for m in comp:
                ms[m].append(events(lambda: comp[m](scene, frame(i + 1)), 1))
    med = {m: statistics.median(v) for m, v in ms.items()}
    out.append(f"compiled step without rows {med[False]:.4f} ms, with rows {med[True]:.4f} ms "
               f"(medians of 7 in turns), with / without {med[True] / med[False]:.3f}")
    return "; ".join(out)


def per_kernel(torch, fn, calls: int = 10) -> dict:
    """Device time a call of each kernel ``fn`` launches, summed by name
    over ``calls`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            name = re.search(r"(\w+_kernel|Memset\w*|memset\w*)", e.key)
            key = name.group(1) if name else e.key[:40]
            out[key] = out.get(key, 0.0) + us / 1e3 / calls
    return out


def _smoke():
    """The timers of chip_smoke.py, from this script's checkout (a parent
    checkout may lack them); it imports only torch."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def kernel_times(torch, mrt, cfg, scene, cam) -> str:
    from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as mk, parity
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids

    smoke = _smoke()
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
           "bounce_fwd b1 events": smoke.time_ms(
               lambda: mk.bounce_fwd(table, tris, lv, *s1, 1, cfg), 20)}
    out["bounce0_fwd device"] = kernel_ms(
        lambda: mk.bounce0_fwd(table, tris, lv, camv, ids, 0, cfg))
    dead = s1[:3] + (torch.zeros_like(s1[3]), s1[4])
    full = s1[:3] + (torch.ones_like(s1[3]), s1[4])
    out["bounce_fwd b1 every ray dead"] = kernel_ms(
        lambda: mk.bounce_fwd(table, tris, lv, *dead, 1, cfg))
    out["bounce_fwd b1 every ray alive"] = kernel_ms(
        lambda: mk.bounce_fwd(table, tris, lv, *full, 1, cfg))
    c = cot(f[2])
    out["bounce0_bwd b0"] = (kernel_ms(
        lambda: mk.bounce0_bwd(table, lv, camv, ids, 0, f[5], f[6], c, cfg)))
    state = (f[0], f[1], f[2], f[3], f[7])
    k2 = []
    for b in range(1, 9):
        k2.append(kernel_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, b, cfg)))
        out[f"bounce_fwd b{b}"] = k2[-1]
        f = mk.bounce_fwd(table, tris, lv, *state, b, cfg)
        if b in (1, 4, 8):
            c = cot(f[2])
            out[f"bounce_bwd b{b}"] = kernel_ms(
                lambda: mk.bounce_bwd(table, lv, *state, f[5], f[6], c, b, cfg))
        state = (f[0], f[1], f[2], f[3], state[4])
    out["bounce_fwd b1-8"] = sum(k2)
    shadow = mrt.RenderConfig(width=cfg.width, height=cfg.height, bounces=cfg.bounces,
                              shadow_rays=True)
    scenes = [(f"soup of {n} triangles", parity.soup_scene(camv.device, n), cfg)
              for n in (256, 512, 2048)]
    scenes.append(("2 lights + shadow rays", parity.two_light_scene(camv.device), shadow))
    scenes += [(f"{n} lights + shadow rays", parity.many_light_scene(camv.device, n), shadow)
               for n in (8, 30)]
    for name, scene2, cfg2 in scenes:
        table, tris, lv = mk._tables(scene2, cfg2, None)
        f = mk.bounce0_fwd(table, tris, lv, camv, ids, 0, cfg2)
        state, k2 = (f[0], f[1], f[2], f[3], f[7]), []
        for b in range(1, 9):
            k2.append(kernel_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, b, cfg2)))
            out[f"{name} bounce_fwd b{b}"] = k2[-1]
            f = mk.bounce_fwd(table, tris, lv, *state, b, cfg2)
            state = (f[0], f[1], f[2], f[3], state[4])
        out[f"{name} bounce_fwd b1-8"] = sum(k2)
    return ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[-1], resid_only="--resid" in sys.argv)
        return 0
    flags = [a for a in sys.argv[1:] if a == "--resid"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for root in (a for a in sys.argv[1:] if a != "--resid"):
        subprocess.run([sys.executable, __file__, "--child"] + flags + [root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
