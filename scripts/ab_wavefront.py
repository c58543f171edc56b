#!/usr/bin/env python3
"""The wavefront's intersection kernels (K6, the cluster traversal, and
K5, the panel) and the paths that run them, timed for two or more
checkouts of the port in one call, in turns (e.g. parent, change, change,
parent), each in a fresh process.

    python3 scripts/ab_wavefront.py [--kernels-only] OLD_ROOT NEW_ROOT NEW_ROOT OLD_ROOT

Per checkout, after a warm-up, each number the median and the least of 3
repeats (5 for frames and steps, whose host time varies more):
``clustered_closest`` by CUDA events over 20 launches on the ray sets of
``chip_smoke.py`` phase 13 (BASELINE config 3 primary rays; its bounce-1
rays in pixel order, coherence-sorted and shuffled; sponza 3840x2160
primary rays), and ``clustered_any`` on config 3's shadow rays;
``panel_closest`` the same way on Cornell's 1920x1080 primary rays and
bounce-1 rays (pixel order and sorted), and the any-hit kernel alone
(``panel._run``, by ``chip_smoke.device_ms``) on its shadow rays toward
light 0 (phase 8's sets); then, unless
``--kernels-only``, path A's ``render`` ms/frame
(config 3 sorted and unsorted over 4 frames, bunny 1920x1080 x 9 and
sponza 3840x2160 x 1 over 2), path C's ``loss_and_grads`` ms/step at
config 3 (3 steps), and the mega path's Cornell 1920x1080 x 9 forward
(4 frames) and training step, and path B's Cornell 1920x1080 x 9
forward on the panel (``backend="pallas"``, 4 frames). Scenes, accels and rays are built with each
checkout's own package (``device="cuda"``); the ray sets come from this
script's ``chip_smoke.wavefront_rays``. Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import statistics
import subprocess
import sys


def _smoke():
    """chip_smoke.py of this script's checkout (it imports only torch)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(root: str, kernels_only: bool) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch import grad
    from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as cl
    from mini_opencl_raytracer_tpu_torch.ops.cuda import panel

    assert mrt.__file__.startswith(root), mrt.__file__
    smoke = _smoke()

    def med(fn, n=3):
        runs = [fn() for _ in range(n)]
        return statistics.median(runs), min(runs)

    dev = torch.device("cuda")
    cam = mrt.Camera.default(device=dev)
    bunny, sponza = mrt.bunny_scene(device=dev), mrt.sponza_scene(device=dev)
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    acc = {"bunny": mrt.build_accel(bunny, cfg3), "sponza": mrt.build_accel(sponza, cfg3)}
    rays = smoke.wavefront_rays(mrt, torch, bunny, cam, cfg3, *cl.make_intersectors(
        bunny.geometry, cfg3, accel=acc["bunny"], materials=bunny.materials))
    big = smoke.wavefront_rays(mrt, torch, sponza, cam,
                               mrt.RenderConfig(width=3840, height=2160, bounces=1),
                               *cl.make_intersectors(sponza.geometry, cfg3, accel=acc["sponza"],
                                                     materials=sponza.materials))
    o1, d1 = rays["bounce1"]
    shuffle = torch.randperm(o1.shape[0], generator=torch.Generator(device=dev).manual_seed(5),
                             device=dev)
    out = {}
    for label, cg, (o, d) in (("K6 config 3 primary", acc["bunny"], rays["primary"]),
                              ("K6 bounce-1 pixel order", acc["bunny"], rays["bounce1"]),
                              ("K6 bounce-1 sorted", acc["bunny"], rays["bounce1_sorted"]),
                              ("K6 bounce-1 shuffled", acc["bunny"],
                               (o1[shuffle].contiguous(), d1[shuffle].contiguous())),
                              ("K6 sponza 4K primary", acc["sponza"], big["primary"])):
        ti = torch.full((o.shape[0],), cfg3.t_max, device=dev)
        out[label] = med(lambda: smoke.time_ms(lambda: cl.clustered_closest(cg, o, d, ti), 20))
    so, sd, tl = rays["shadow"]
    out["K6 config 3 shadow (any)"] = med(lambda: smoke.time_ms(
        lambda: cl.clustered_any(acc["bunny"], so, sd, tl), 20))
    cornell = mrt.cornell_scene(device=dev)
    cfg_b = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    tri5 = panel.pack_triangles(cornell.geometry)
    r5 = smoke.wavefront_rays(mrt, torch, cornell, cam, cfg_b,
                              *panel.make_intersectors(cornell.geometry, cfg_b))
    for kind in ("primary", "bounce1", "bounce1_sorted"):
        o, d = r5[kind]
        ti = torch.full((o.shape[0],), cfg_b.t_max, device=dev)
        out[f"K5 {kind}"] = med(lambda: smoke.time_ms(
            lambda: panel.panel_closest(tri5, o, d, ti), 20))
    so, sd, tl = r5["shadow"]
    # The kernel alone by device time: panel_any's idx >= 0 is a kernel of
    # its own, and the wrapper's Python outlasts the kernel at this size.
    out["K5 shadow (any, device)"] = med(lambda: smoke.device_ms(
        lambda: panel._run("panel_any", True, tri5, so, sd, tl, False)))
    if not kernels_only:
        loss_fn = lambda img: img.mean()
        cases = (("config 3 sorted", bunny, cfg3, 4, "bunny"),
                 ("config 3 unsorted", bunny, dataclasses.replace(cfg3, sort_rays=False), 4,
                  "bunny"),
                 ("bunny 1080p x 9", bunny, mrt.RenderConfig(width=1920, height=1080, bounces=9),
                  2, "bunny"),
                 ("sponza 4K x 1", sponza, mrt.RenderConfig(width=3840, height=2160, bounces=1),
                  2, "sponza"),
                 ("path B Cornell 1080p x 9", cornell,
                  dataclasses.replace(cfg_b, backend="pallas"), 4, None),
                 ("mega Cornell 1080p x 9", cornell, cfg_b, 4, None))
        with torch.no_grad():
            for label, sc, cfg, n, name in cases:
                a = acc[name] if name else None
                mrt.render(sc, cam, cfg, frames=1, accel=a)
                out[label + " ms/frame"] = med(lambda: smoke.events_ms(
                    lambda: mrt.render(sc, cam, cfg, frames=n, accel=a), n), 5)
        grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc["bunny"])
        out["path C config 3 ms/step"] = med(lambda: smoke.events_ms(
            lambda: [grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc["bunny"])
                     for _ in range(3)], 3), 5)
        cornell, cfg_m = cases[-1][1], cases[-1][2]
        grad.loss_and_grads(cornell, cam, cfg_m, loss_fn)
        out["mega step ms/step"] = med(lambda: smoke.events_ms(
            lambda: grad.loss_and_grads(cornell, cam, cfg_m, loss_fn)), 5)
    print(f"{root}: " + "; ".join(f"{k} {m:.4f} (min {lo:.4f})" for k, (m, lo) in out.items()),
          flush=True)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--kernels-only"]
    kernels_only = len(args) < len(sys.argv) - 1
    if len(args) > 1 and args[0] == "--child":
        child(args[1], kernels_only)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for root in args:
        subprocess.run([sys.executable, __file__, "--child", root]
                       + (["--kernels-only"] if kernels_only else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
