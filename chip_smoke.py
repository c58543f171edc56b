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
3b. each backward kernel against its plain version on the card, with
   seeded cotangents, and against a second run of itself (bitwise): at the main path's shape (1080p, tile-ordered ids,
   bounces 0-8 on the forward's winners and state), at 512x512 in the
   three configurations of phase 3, and on a seeded soup of 2048
   triangles (the mega path's limit) at 256x256;
4. the forward render (9 bounces, 512x512) through the kernels against the
   plain integrator on the card;
5. the forward path under ``torch.no_grad()``: ``render`` of Cornell at
   1920x1080, 9 bounces, 4 frames, with launch counts, image checks and
   ms/frame; then each forward kernel's time against its plain version;
6. the training step, the slice's main path: the loss of
   ``mean(render_sample)`` and its gradients w.r.t. every float leaf of
   the scene and the camera (``grad.loss_and_grads``) for Cornell at
   1920x1080 with 9 bounces, with launch counts per step, finiteness, ms
   per step and fwd+bwd rays/s; then each backward kernel's time against
   its plain version;
7. the slice against the oracle: ``scene_grad`` / ``camera_grad`` on mega
   against bruteforce (torch autograd) at 512x512 x 9 bounces, central
   finite differences at 256x256 x 9, and Adam steps on the diffuse
   albedo against a 1080p target.

Gates (phases 3, 3b, 4, 7): ops/cuda/parity.py.

The last lines are one JSON object with a summary per kernel, the card's
name and power limit, and the device line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

_CSRC = "mini_opencl_raytracer_tpu_torch/csrc/"
_TPU = "mini_opencl_raytracer_tpu/ops/pallas/megakernel.py:"
KERNELS = ("bounce0_fwd", "bounce_fwd", "bounce0_bwd", "bounce_bwd")
SOURCES = {"bounce0_fwd": _CSRC + "megakernel.cu", "bounce_fwd": _CSRC + "megakernel.cu",
           "bounce0_bwd": _CSRC + "megakernel_bwd.cu",
           "bounce_bwd": _CSRC + "megakernel_bwd.cu"}
REPLACES = {"bounce0_fwd": _TPU + "1134", "bounce_fwd": _TPU + "1041",
            "bounce0_bwd": _TPU + "1173", "bounce_bwd": _TPU + "1329"}


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


def log_grads(label: str, stats: dict) -> None:
    """One line per backward check: per output, max |diff| and either the
    mean / tail fraction (per ray) or the ratio to the largest value."""
    log(f"  {label}: " + "; ".join(
        f"{k} max {v['max']:.2e} "
        + (f"mean {v['mean']:.2e} frac {v['frac']:.2e} (s {v['scale']:.2e})"
           if "mean" in v else f"rel {v['rel']:.2e} (s {v['scale']:.2e})")
        for k, v in stats.items() if isinstance(v, dict)))


def repeatable(label: str, first, second) -> None:
    """The backward kernels sum without atomics, in a fixed order: two runs
    on the same inputs must be bitwise equal."""
    import torch
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two runs of the kernel differ")


def soup_scene(mrt, torch, device, n: int = 2048, seed: int = 3):
    """A seeded soup of ``n`` triangles in front of the camera, with the
    Cornell materials and light."""
    import numpy as np
    rs = np.random.default_rng(seed)
    centers = rs.uniform([-10.0, -5.0, -2.0], [10.0, 10.0, 18.0], (n, 3))
    corners = [centers + rs.normal(0.0, 1.0, (n, 3)) for _ in range(3)]
    normal = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-12
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=device)
    zeros2 = t(np.zeros((n, 2)))
    geo = mrt.Geometry(v0=t(corners[0]), v1=t(corners[1]), v2=t(corners[2]),
                       n0=t(normal), n1=t(normal), n2=t(normal),
                       uv0=zeros2, uv1=zeros2, uv2=zeros2,
                       mat_idx=t(rs.integers(0, 6, n), torch.int32))
    base = mrt.cornell_scene(device=device)
    return mrt.Scene(geometry=geo, materials=base.materials, lights=base.lights)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch.ops import rng
    from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
    from mini_opencl_raytracer_tpu_torch import grad
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

    # 3. Each forward kernel against its plain version: at the main path's
    # shape (1080p, tile-ordered pixel ids, all 9 bounces), then at 512x512.
    max_err = dict.fromkeys(KERNELS, 0.0)
    cam = mrt.Camera.default(device=dev)
    camv = mk.camera_vector(cam)
    main_cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    main_ids = _swizzled_ids(main_cfg, dev)
    cases = (("main path 1920x1080 tiled ids", mrt.cornell_scene(device=dev),
              main_cfg, main_ids, 0, range(1, main_cfg.bounces)),
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

    # 3b. Each backward kernel against its plain version, on the forward
    # kernels' winners and state, with seeded cotangents shared by both.
    gen = torch.Generator(device=dev).manual_seed(1234)
    soup_cfg = mrt.RenderConfig(width=256, height=256)
    bwd_cases = cases + (("soup of 2048 triangles", soup_scene(mrt, torch, dev),
                          soup_cfg, None, 2, (1,)),)
    for label, scene, cfg, pid, frame, bounces in bwd_cases:
        table, tris, lv = mk._tables(scene, cfg, None)
        if pid is None:
            pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
        f0 = mk.bounce0_fwd(table, tris, lv, camv, pid, frame, cfg)
        cot = parity.cotangents(f0[2], gen)
        args = (table, lv, camv, pid, frame, f0[5], f0[6], cot, cfg)
        k, pl = mk.bounce0_bwd(*args), mk.bounce0_bwd_plain(*args)
        repeatable(f"bounce0_bwd, {label}", k, mk.bounce0_bwd(*args))
        stats = parity.check_grads(f"bounce0_bwd, {label}", k, pl, parity.BOUNCE0_GRADS)
        log(f"[3b kernel] bounce0_bwd, {label}, {cfg.width}x{cfg.height}, "
            f"T={tris.shape[0]}")
        log_grads("bounce0_bwd", stats)
        max_err["bounce0_bwd"] = max(max_err["bounce0_bwd"], stats["max_abs_err"])
        state, seeds = f0[:4], f0[7]
        for b in bounces:
            f1 = mk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg)
            cot = parity.cotangents(f1[2], gen)
            args = (table, lv, *state, seeds, f1[5], f1[6], cot, b, cfg)
            k, pl = mk.bounce_bwd(*args), mk.bounce_bwd_plain(*args)
            repeatable(f"bounce_bwd (bounce {b}), {label}", k, mk.bounce_bwd(*args))
            stats = parity.check_grads(f"bounce_bwd (bounce {b}), {label}", k, pl,
                                       parity.BOUNCE_GRADS)
            log(f"[3b kernel] bounce_bwd (bounce {b}), {label}, {cfg.width}x{cfg.height}")
            log_grads("bounce_bwd", stats)
            max_err["bounce_bwd"] = max(max_err["bounce_bwd"], stats["max_abs_err"])
            state = f1[:4]

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

    # 5. The forward path: Cornell 1080p, 9 bounces, 4 frames, no gradient.
    scene, cfg = cases[0][1], main_cfg
    frames = 4
    with torch.no_grad():
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
    log(f"[5 forward] launches {launches}")
    expect = {"bounce0_fwd": frames, "bounce_fwd": frames * (cfg.bounces - 1),
              "bounce0_bwd": 0, "bounce_bwd": 0}
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if tuple(img.shape) != (1080, 1920, 3) or not torch.isfinite(img).all():
        raise AssertionError("image is not a finite [1080, 1920, 3] tensor")
    if (img < 0).any():
        raise AssertionError("image has negative values")
    nonzero = (img.amax(dim=-1) > 0).float().mean().item()
    third = cfg.width // 3
    left, right = img[:, :third].mean(dim=(0, 1)), img[:, -third:].mean(dim=(0, 1))
    log(f"[5 forward] nonzero {nonzero:.4f}; left third rgb {left.tolist()}; "
        f"right third rgb {right.tolist()}")
    if nonzero <= 0.5:
        raise AssertionError(f"only {nonzero:.3f} of the pixels are nonzero")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("Cornell box is not upright (red left, green right)")
    mrays = cfg.width * cfg.height * cfg.bounces / (ms_frame * 1e-3) / 1e6
    log(f"[5 forward] {ms_frame:.3f} ms/frame, {mrays:.1f} Mrays/s "
        f"(1920x1080, 9 bounces; {kind}; {card})")

    # Kernel and plain version times at 1080p (outside the counted runs).
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

    # 6. The training step: loss and gradients w.r.t. every float leaf of
    # the scene and the camera, Cornell 1080p x 9 bounces.
    loss_fn = lambda im: im.mean()
    grad.loss_and_grads(scene, cam, cfg, loss_fn)  # warm-up
    torch.cuda.synchronize()
    for key in mk.LAUNCHES:
        mk.LAUNCHES[key] = 0
    loss, g_scene, g_cam = grad.loss_and_grads(scene, cam, cfg, loss_fn)
    torch.cuda.synchronize()
    per_step = dict(mk.LAUNCHES)
    log(f"[6 train] launches per step {per_step}; loss {loss.item():.6f}")
    expect = {"bounce0_fwd": 1, "bounce_fwd": 8, "bounce0_bwd": 1, "bounce_bwd": 8}
    if per_step != expect:
        raise AssertionError(f"launch counts per step {per_step}, expected {expect}")
    leaves = list(grad._leaves(g_scene)) + [(f"camera.{k}", v) for k, v in grad._leaves(g_cam)]
    for name, g in leaves:
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"gradient of {name} is not finite")
    for name in ("materials.diffuse", "lights.intensity", "camera.position"):
        g = dict(leaves)[name]
        log(f"[6 train] d loss / d {name} = {g.flatten()[:6].tolist()}")
        if not bool((g != 0).any()):
            raise AssertionError(f"gradient of {name} is zero")
    steps = 5
    for key in mk.LAUNCHES:
        mk.LAUNCHES[key] = 0
    start.record()
    for _ in range(steps):
        grad.loss_and_grads(scene, cam, cfg, loss_fn)
    end.record()
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    if launches != {k: v * steps for k, v in expect.items()}:
        raise AssertionError(f"launch counts over {steps} steps: {launches}")
    ms_step = start.elapsed_time(end) / steps
    rays = cfg.width * cfg.height * cfg.bounces / (ms_step * 1e-3)
    log(f"[6 train] {ms_step:.3f} ms/step, {rays / 1e6:.1f} Mrays/s fwd+bwd "
        f"(1920x1080, 9 bounces, {steps} steps; {kind}; {card})")

    # Backward kernel and plain version times at 1080p (main path state).
    cot0 = parity.cotangents(b0[2], gen)
    b1 = mk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    cot1 = parity.cotangents(b1[2], gen)
    bwd0 = (table, lv, camv, main_ids, 0, b0[5], b0[6], cot0, cfg)
    bwd1 = (table, lv, *state, b1[5], b1[6], cot1, 1, cfg)
    times["bounce0_bwd"] = (time_ms(lambda: mk.bounce0_bwd(*bwd0), 20),
                            time_ms(lambda: mk.bounce0_bwd_plain(*bwd0), 3))
    times["bounce_bwd"] = (time_ms(lambda: mk.bounce_bwd(*bwd1), 20),
                           time_ms(lambda: mk.bounce_bwd_plain(*bwd1), 3))
    for name in KERNELS:
        k_ms, p_ms = times[name]
        log(f"[5/6 time] {name} at 1080p: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
            f"({kind}; {card})")

    # 7. The slice against the oracle, by finite differences, and in use.
    cfg7 = mrt.RenderConfig(width=512, height=512, bounces=9, ray_chunk=1 << 16)
    got = {}
    for backend in ("mega", "bruteforce"):
        c = dataclasses.replace(cfg7, backend=backend)
        got[backend] = (dict(grad._leaves(grad.scene_grad(scene, cam, c, loss_fn))),
                        dict(grad._leaves(grad.camera_grad(scene, cam, c, loss_fn))))
    worst = 0.0
    for part, prefix in ((0, ""), (1, "camera.")):
        for name, g_m in got["mega"][part].items():
            g_b = got["bruteforce"][part][name]
            if not g_m.is_floating_point():
                continue
            st = parity.check_grad_sum(f"{prefix}{name} mega vs bruteforce", g_m, g_b)
            worst = max(worst, st["rel"])
    log(f"[7 oracle] scene_grad + camera_grad, mega vs bruteforce, 512x512x9: "
        f"largest max|diff| / max|bruteforce| over leaves {worst:.3e} (gate 2e-3)")

    cfg_fd = mrt.RenderConfig(width=256, height=256, bounces=9)

    def with_leaf(group: str, leaf: str, index, value):
        obj = getattr(scene, group)
        t = getattr(obj, leaf).clone()
        t[index] = value
        return dataclasses.replace(scene, **{group: dataclasses.replace(obj, **{leaf: t})})

    for group, leaf, index, eps in (("materials", "diffuse", (4, 0), 1e-2),
                                    ("lights", "intensity", (0,), 1e-1)):
        x0 = getattr(getattr(scene, group), leaf)[index].clone()
        f = lambda v: mrt.render_radiance(with_leaf(group, leaf, index, v), cam,
                                          cfg_fd).mean()
        ad, fd, _ = grad.fd_check(f, x0, eps=eps)
        rel = parity.check_fd(f"{group}.{leaf}{list(index)}", ad.item(), fd.item())
        log(f"[7 fd] {group}.{leaf}{list(index)} 256x256x9: autodiff {ad.item():.6e}, "
            f"central FD {fd.item():.6e}, relative error {rel:.3e} (gate 5e-2)")

    with torch.no_grad():
        target = mrt.render_radiance(scene, cam, cfg)
    kd = (scene.materials.diffuse * 0.3 + 0.2).requires_grad_()
    opt = torch.optim.Adam([kd], lr=5e-2)
    history = []
    for i in range(6):
        s_kd = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, diffuse=kd))
        loss = ((mrt.render_radiance(s_kd, cam, cfg) - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        history.append(loss.item())
        log(f"[7 adam] step {i}: loss {history[-1]:.6e}")
    if not history[-1] < history[0]:
        raise AssertionError(f"Adam did not lower the loss: {history}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
