#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits nonzero:

1. device: needs a CUDA device (never runs on the CPU instead); prints its
   name and ``nvidia-smi`` name and power limit;
2. build: compiles csrc/*.cu with nvcc and prints the build time and the
   per-kernel register / spill report;
3. each bounce kernel against its plain PyTorch version on the card: at
   the main path's shape (1920x1080, the tile-ordered pixel ids that
   ``render_sample`` passes, every bounce of 9), and at 512x512 for
   Cornell defaults, for two lights with shadow rays, direct specular
   and GGX, and for backface culling with soft edges;
4. the forward render (9 bounces, 512x512) through the kernels against the
   plain integrator on the card;
5. the main path: ``render`` of Cornell at 1920x1080, 9 bounces, 4 frames,
   with launch counts, image checks and ms/frame; then each kernel's time
   against its plain version at 1080p.

Gate for kernel vs plain (phases 3 and 4): ops/cuda/parity.py.

The last lines are one JSON object per kernel run summary and the device
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

SOURCE ="mini_opencl_raytracer_tpu_torch/csrc/megakernel.cu"
REPLACES = {
    "bounce0_fwd": "mini_opencl_raytracer_tpu/ops/pallas/megakernel.py:1134",
    "bounce_fwd": "mini_opencl_raytracer_tpu/ops/pallas/megakernel.py:1041",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log_stats(label: str, stats: dict) -> None:
    """One line: max/mean/tail-fraction of |diff| per float output, then
    the agreement fractions."""
    log(f"  {label} (max/mean/frac): " + "; ".join(
        f"{k} {v['max']:.2e}/{v['mean']:.2e}/{v['frac']:.2e}"
        if isinstance(v, dict) else f"{k} {v:.6g}" for k, v in stats.items()))


def two_light_scene(mrt, torch, device):
    lights = mrt.Lights(
        position=torch.tensor([[0.0, -10.0, 16.0], [0.0, 10.0, 16.0]], device=device),
        direction=torch.tensor([[-0.5, 0.4, -0.1], [0.0, 0.1, -1.0]], device=device),
        light_type=torch.tensor([mrt.LIGHT_POINT, mrt.LIGHT_SPOT], dtype=torch.int32,
                                device=device),
        intensity=torch.tensor([16.0, 12.0], device=device),
        attenuation=torch.tensor([0.8, 0.05], device=device),
        cos_cutoff=torch.tensor([0.9, 0.7], device=device))
    return mrt.cornell_scene(lights=lights, device=device)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call on the current stream, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch.ops import rng
    from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from mini_opencl_raytracer_tpu_torch.ops.cuda import parity
    from mini_opencl_raytracer_tpu_torch.ops.integrator import trace_paths
    from mini_opencl_raytracer_tpu_torch.ops.intersect import (intersect_brute,
                                                               occluded_brute)
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids

    # 1. Device.
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[1 device] nvidia-smi: {card}")

    # 2. Build.
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log(f"[2 build] {build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in build.LAST_BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. Each kernel against its plain version: at the main path's shape
    # (1080p, tile-ordered pixel ids, all 9 bounces), then at 512x512.
    max_err = {"bounce0_fwd": 0.0, "bounce_fwd": 0.0}
    cam = mrt.Camera.default(device=dev)
    camv = mk.camera_vector(cam)
    main_cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    cases = (("main path 1920x1080 tiled ids", mrt.cornell_scene(device=dev),
              main_cfg, _swizzled_ids(main_cfg, dev), 0,
              range(1, main_cfg.bounces)),
             ("defaults", mrt.cornell_scene(device=dev), mrt.RenderConfig(), None,
              7, (1, 2)),
             ("2lights+shadow+dspec+ggx", two_light_scene(mrt, torch, dev),
              mrt.RenderConfig(shadow_rays=True, direct_specular=True,
                               specular_model="ggx"), None, 7, (1, 2)),
             ("backface_cull+soft_edge", mrt.cornell_scene(device=dev),
              mrt.RenderConfig(backface_cull=True, soft_edge_sigma=0.05), None,
              7, (1, 2)))
    for label, scene, cfg, pid, frame, bounces in cases:
        table, tris, lv = mk._tables(scene, cfg, None)
        if pid is None:
            pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
        k0 = mk.bounce0_fwd(table, tris, lv, camv, pid, frame, cfg)
        p0 = mk.bounce0_fwd_plain(table, tris, lv, camv, pid, frame, cfg)
        torch.cuda.synchronize()
        stats = parity.check_bounce(f"bounce0_fwd, {label}", k0, p0)
        log(f"[3 kernel] bounce0_fwd, {label}, {cfg.width}x{cfg.height}: "
            "seeds bit-exact")
        log_stats("bounce0_fwd", stats)
        max_err["bounce0_fwd"] = max(max_err["bounce0_fwd"], stats["max_abs_err"])
        state = (k0[0], k0[1], k0[2], k0[3], k0[7])
        for b in bounces:
            k1 = mk.bounce_fwd(table, tris, lv, *state, b, cfg)
            p1 = mk.bounce_fwd_plain(table, tris, lv, *state, b, cfg)
            torch.cuda.synchronize()
            stats = parity.check_bounce(f"bounce_fwd (bounce {b}), {label}", k1, p1)
            log(f"[3 kernel] bounce_fwd (bounce {b}), {label}, "
                f"{cfg.width}x{cfg.height}")
            log_stats("bounce_fwd", stats)
            max_err["bounce_fwd"] = max(max_err["bounce_fwd"], stats["max_abs_err"])
            state = (p1[0], p1[1], p1[2], p1[3], k0[7])

    # 4. The forward render through the kernels against the plain integrator.
    for label, scene, cfg, _, _, _ in cases[1:]:
        cfg = dataclasses.replace(cfg, bounces=9, ray_chunk=1 << 16)
        img_k = mrt.render_radiance(scene, cam, cfg, frames=1)
        pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
        seeds = rng.pixel_seeds(pid, 0)
        o, d = generate_rays(cam, cfg, pid, seeds)
        closest = lambda o_, d_: intersect_brute(o_, d_, scene.geometry, cfg.t_max,
                                                 cfg.backface_cull, cfg.ray_chunk)
        any_hit = lambda o_, d_, tl: occluded_brute(o_, d_, tl, scene.geometry,
                                                    cfg.backface_cull, cfg.ray_chunk)
        img_p = trace_paths(scene, cfg, o, d, seeds, closest, any_hit).reshape(
            cfg.height, cfg.width, 3)
        torch.cuda.synchronize()
        log(f"[4 slice] render_radiance 512x512x9 vs plain integrator, {label}")
        log_stats("radiance", {"radiance": parity.check_float(
            f"render_radiance, {label}", img_k, img_p)})

    # 5. The main path: Cornell 1080p, 9 bounces, 4 frames.
    scene, cfg, main_ids = cases[0][1], cases[0][2], cases[0][3]
    frames = 4
    mrt.render(scene, cam, cfg, frames=1)  # warm-up
    torch.cuda.synchronize()
    for key in mk.LAUNCHES:
        mk.LAUNCHES[key] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    img = mrt.render(scene, cam, cfg, frames=frames)
    end.record()
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    ms_frame = start.elapsed_time(end) / frames
    log(f"[5 main] launches {launches}")
    expect = {"bounce0_fwd": frames, "bounce_fwd": frames * (cfg.bounces - 1)}
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if tuple(img.shape) != (1080, 1920, 3) or not torch.isfinite(img).all():
        raise AssertionError("image is not a finite [1080, 1920, 3] tensor")
    if (img < 0).any():
        raise AssertionError("image has negative values")
    nonzero = (img.amax(dim=-1) > 0).float().mean().item()
    third = cfg.width // 3
    left, right = img[:, :third].mean(dim=(0, 1)), img[:, -third:].mean(dim=(0, 1))
    log(f"[5 main] nonzero {nonzero:.4f}; left third rgb {left.tolist()}; "
        f"right third rgb {right.tolist()}")
    if nonzero <= 0.5:
        raise AssertionError(f"only {nonzero:.3f} of the pixels are nonzero")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("Cornell box is not upright (red left, green right)")
    mrays = cfg.width * cfg.height * cfg.bounces / (ms_frame * 1e-3) / 1e6
    log(f"[5 main] {ms_frame:.3f} ms/frame, {mrays:.1f} Mrays/s "
        f"(1920x1080, 9 bounces; {kind}; {card})")

    # Kernel and plain version times at 1080p (outside the counted run).
    table, tris, lv = mk._tables(scene, cfg, None)
    b0 = mk.bounce0_fwd(table, tris, lv, camv, main_ids, 0, cfg)
    state = (b0[0], b0[1], b0[2], b0[3], b0[7])
    times = {
        "bounce0_fwd": (
            time_ms(lambda: mk.bounce0_fwd(table, tris, lv, camv, main_ids, 0, cfg), 20),
            time_ms(lambda: mk.bounce0_fwd_plain(table, tris, lv, camv, main_ids, 0, cfg), 3)),
        "bounce_fwd": (
            time_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, 1, cfg), 20),
            time_ms(lambda: mk.bounce_fwd_plain(table, tris, lv, *state, 1, cfg), 3)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"[5 main] {name} at 1080p: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
            f"({kind}; {card})")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("bounce0_fwd", "bounce_fwd")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
