#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits nonzero:

1. device: needs a CUDA device (never runs on the CPU instead); prints its
   name and ``nvidia-smi`` name and power limit;
2. build: compiles csrc/*.cu with nvcc (one process per source, in
   parallel) and the native SAH library with g++, and prints the build
   times and the per-kernel register / spill report;
3. each bounce kernel against its plain PyTorch version on the card: at
   the main path's shape (1920x1080, the tile-ordered pixel ids that
   ``render_sample`` passes, every bounce of 9), and at 512x512 for
   Cornell defaults, for two lights with shadow rays, direct specular
   and GGX, and for backface culling with soft edges; all of K1's
   outputs bitwise equal to the plain version's and its M-T tests
   per ray (``stats``), without shadow rays equal ray by ray to the model
   of its per-warp cull (ops/cuda/bundle_cull.py), on those cases and on
   a soup of 2048 triangles and a camera grazing the floor (with
   culling and shadow rays);
3b. each backward kernel against its plain version on the card, with
   seeded cotangents, and against a second run of itself (bitwise): at
   the main path's shape (1080p, tile-ordered ids, bounces 0-8 on the
   forward's winners and state), at 512x512 in the
   three configurations of phase 3, and on a seeded soup of 2048
   triangles (the mega path's limit) at 256x256; then the reduction
   cases: shuffled pixel ids at 1080p (incoherent winners), a soup of 512
   triangles (the largest table partial in shared memory), 30 lights
   with shadow rays, a 1080p state with every ray dead, and the
   shared-memory table branch against the global one (bitwise);
4. the forward render (9 bounces, 512x512) through the kernels against the
   plain integrator on the card;
5. the forward path under ``torch.no_grad()``: ``render`` of Cornell at
   1920x1080, 9 bounces, 4 frames, with launch counts, image checks and
   ms/frame; then each forward kernel's time against its plain version;
6. the training step, the slice's main path: the loss of
   ``mean(render_sample)`` and its gradients w.r.t. every float leaf of
   the scene and the camera (``grad.loss_and_grads``) for Cornell at
   1920x1080 with 9 bounces, with launch counts per step, finiteness, ms
   per step and fwd+bwd rays/s; one step under ``torch.profiler``: device
   time per kernel (K1-K4 and the backward's finishing sum) and the idle
   share of that step; then each backward kernel's time against its plain
   version;
7. the slice against the oracle: ``scene_grad`` / ``camera_grad`` on mega
   against bruteforce (torch autograd) at 512x512 x 9 bounces, central
   finite differences at 256x256 x 9, and Adam steps on the diffuse
   albedo against a 1080p target;
8. the panel kernel (K5) against its plain version on Cornell: primary,
   bounce-1 and shadow rays of the 1080p wavefront (render_sample's
   tile-ordered ids), and the same at 512x512 with backface culling; then
   bitwise (t, idx), and t, idx and M-T counts per ray equal to the model
   of its cull (closest and any), on those sets (bounce-1 also sorted)
   and on the cull's adversarial sets (ops/cuda/parity.cull_ray_sets:
   vertices and edges, coplanar floor and box bottoms, grazing rays,
   directions with +0 / -0 components, limits inf and 3e38, padding rows,
   a soup of 2048 triangles), with and without backface culling;
9. the cluster-traversal kernel (K6) against its plain version: primary,
   bounce-1 and shadow rays, rows included, on the bunny scene (SAH
   layout) and the sponza scene at 512x512, and on bunny's Morton layout;
   on bunny SAH also an open limit (inf) on rays along (1, 1, 1), bitwise;
   and two-triangle scenes where a triangle grazed at cos 1e-3 or 1e-4
   hides behind a decoy (parity.grazing_decoys), bitwise;
10. path B, the wavefront on the panel: Cornell 1920x1080 x 9 with
   ``backend="pallas"`` against the mega path (same frames; defaults, then
   shadow rays and direct specular), its gradients at 512x512 x 9 against
   mega's K3/K4, launch counts and ms/frame beside mega's;
11. path A, large scenes on K6: ``build_accel`` of the bunny and sponza
   scenes (SAH required), ``render(frames=4)`` at BASELINE config 3
   (bunny, 512x512, 2 bounces) with launch counts, image checks, ms/frame
   sorted and unsorted (bitwise equal images), against the plain K6 in
   the same integrator, then bunny at 1920x1080 x 9 and sponza at
   3840x2160 x 1 (config 5's single-GPU row);
12. path C: ``grad.loss_and_grads`` on bunny at config 3 through K6 (all
   leaves finite, diffuse gradient non-zero, ms/step), and a prebuilt
   accel tracking a material update;
13. K5 and K6 alone by CUDA events (20 launches) against their plain
   versions (3 calls) at the paths' shapes, K5 on Cornell's 1080p primary,
   bounce-1 (pixel order and sorted) and shadow rays with its M-T tests
   per ray and its bound beside the bound that charges every pair, K6 on the bounce-1 rays in
   pixel order, coherence-sorted and shuffled, with its Möller–Trumbore
   tests, cluster visits and box tests per ray and the share of idle
   lanes per warp; on config 3's primary rays the kernel's (t, slot) and
   counts against the model of its walk (ops/cuda/clustered_walk.py,
   equal).

Gates (phases 3, 3b, 4, 7-12): ops/cuda/parity.py. The forward
intersection kernels' bounds count 45 flops for each (ray, triangle)
pair whose line meets the triangle below the ray's limit (``hit_pairs``),
what the inputs need; the bound that charged every pair is printed beside
them (phases 5/6 and 13).

The last lines are one JSON object with a summary per kernel (launches
from the run of the path that uses it, errors, times, bound), the card's
name and power limit, and the device line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

_CSRC = "mini_opencl_raytracer_tpu_torch/csrc/"
_TPU = "mini_opencl_raytracer_tpu/ops/pallas/"
KERNELS = ("bounce0_fwd", "bounce_fwd", "bounce0_bwd", "bounce_bwd", "panel", "clustered")
SOURCES = {"bounce0_fwd": _CSRC + "megakernel.cu", "bounce_fwd": _CSRC + "megakernel.cu",
           "bounce0_bwd": _CSRC + "megakernel_bwd.cu",
           "bounce_bwd": _CSRC + "megakernel_bwd.cu",
           "panel": _CSRC + "panel.cu", "clustered": _CSRC + "clustered.cu"}
REPLACES = {"bounce0_fwd": _TPU + "megakernel.py:1134", "bounce_fwd": _TPU + "megakernel.py:1041",
            "bounce0_bwd": _TPU + "megakernel.py:1173", "bounce_bwd": _TPU + "megakernel.py:1329",
            "panel": _TPU + "panel.py:83", "clustered": _TPU + "clustered.py:350"}
# The card's peaks for the bound (H100 SXM datasheet: f32 outside the
# tensor cores, HBM3).
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Float operations of one Möller–Trumbore test (ops/intersect
# .ray_triangle_edges: two crosses, four dots, a subtraction, a divide,
# three products).
MT_FLOPS = 45
# Float operations of the backward of one bounce (csrc/megakernel_bwd.cu:
# ray_adjoint, counted by hand from the source, one replay: the kernel's
# second replay is not counted). Each +, -, *, /, min, max, compare-select,
# sqrt, exp, log, sin, cos and pow counts one; a dot 5, a cross 9, a
# normalize 11, a normalize's adjoint 30. Per ray with a winner: "live" =
# the winner point (81) and its adjoint (190), the next-ray update (14),
# emission (18), plus the BRDF sample of its lobe; per path that goes on:
# "on" = the adjoint's head (76) and the ONB's adjoint (69), the lobe's
# adjoint, and per light it sees the light's weight and adjoint (point 38 +
# 121, spot 53 + 166, directional 34 + 85; direct specular 27 + 86 more);
# soft edges 58 per live ray; K3's raygen (37) and its adjoint (48) for
# every ray.
ADJ_FLOPS = {"live": 303, "diffuse": 77, "blinn": 165, "ggx": 170, "on": 145,
             "diffuse_adj": 67, "blinn_adj": 266, "ggx_adj": 282, "point": 159, "spot": 219,
             "directional": 119, "dspec": 113, "soft": 58, "raygen": 85}


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``, after a warm-up: CUDA events
    around ``reps`` back-to-back calls queued behind a sleep kernel. Events
    around calls that the card runs as the host issues them time the host
    once a call's kernels take less than its Python (the backward
    wrappers' do); behind the sleep the host has queued every call before
    the card reaches the first. (torch.profiler's sums dropped kernels in
    some windows on the H100 machine.) Raises if the host was not done
    queueing when the sleep ended, even after longer sleeps."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 1 << 25
    for _ in range(3):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < 0.9 * ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise AssertionError(f"device_ms: the host took {host_ms:.3f} ms to queue {reps} calls, "
                         "longer than the sleep before them")


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


def events_ms(fn, count: int = 1) -> float:
    """ms of one call of ``fn`` (which runs ``count`` units: frames,
    steps) by CUDA events around it, divided by ``count``."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def profile_step(torch, step, card: str) -> None:
    """One training step under torch.profiler: device time per kernel (K1-K4,
    the backward's finishing sum, the rest), device busy time, and the idle
    share of that same step against its own time by CUDA events around it
    (the profiler's host overhead included). A trace that lacks some of the
    step's kernel launches is taken again."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
    expect = {"bounce0_fwd_kernel": 1, "bounce_fwd_kernel": 8, "bounce0_bwd_kernel": 1,
              "bounce_bwd_kernel": 8, "finish_kernel": 9}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
        ms_step = start.elapsed_time(end)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in rows) / 1e3
        if busy == 0:
            log("[6 profile] torch.profiler shows no device time: not measured")
            return
        per = {n: [0.0, 0] for n in tuple(expect) + ("other",)}
        for e in rows:
            n = next((n for n in expect if n + "<" in e.key or n + "(" in e.key), "other")
            per[n][0] += dev_us(e) / 1e3
            per[n][1] += e.count
        whole = all(per[n][1] == c for n, c in expect.items())
        if whole:
            break
        log(f"[6 profile] the trace lacks launches ({ {n: per[n][1] for n in expect} }): "
            "taken again")
    log(f"[6 profile] one step under the profiler: device busy {busy:.3f} ms of "
        f"{ms_step:.3f} ms (events around it), idle share "
        f"{max(0.0, 1.0 - busy / ms_step):.3f}; " + "; ".join(
            f"{n} {t:.3f} ms ({c} launches)" for n, (t, c) in per.items()) + f" ({card})"
        + ("" if whole else "; trace incomplete, busy is a lower bound"))
    rows.sort(key=dev_us, reverse=True)
    for e in rows[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:5d} x {e.key[:100]}")


def adjoint_flops(torch, rng, cfg, lv, seeds, alive, winner, occ, alive_next, bounce: int,
                  first: bool) -> int:
    """Float operations the backward of one bounce needs on these rays:
    one replay and its adjoint per ray with a winner, by lobe and by light
    type (ADJ_FLOPS), raygen and its adjoint for every ray of K3."""
    F = ADJ_FLOPS
    n = lambda m: int(m.sum().item())
    live = (alive > 0) & (winner >= 0)
    on = live & (alive_next > 0)      # paths that go on: lobe and light adjoints
    u = rng.uniform(rng.from_i32_bits(seeds), rng.bounce_site(bounce, rng.SITE_LOBE))
    spec = u > (1.0 - cfg.specular_prob)
    lobe = "ggx" if cfg.specular_model == "ggx" else "blinn"
    ops = n(live) * (F["live"] + (F["soft"] if cfg.soft_edge_sigma > 0 else 0))
    ops += n(live & ~spec) * F["diffuse"] + n(live & spec) * F[lobe]
    ops += n(on) * F["on"] + n(on & ~spec) * F["diffuse_adj"] + n(on & spec) * F[lobe + "_adj"]
    for li, t in enumerate(lv[:, 6].round().int().tolist()):
        seen = on & (((occ >> li) & 1) == 0) if cfg.shadow_rays else on
        kind = "directional" if t <= 0 else "point" if t == 1 else "spot"
        ops += n(seen) * (F[kind] + (F["dspec"] if cfg.direct_specular else 0))
    return ops + (alive.numel() * F["raygen"] if first else 0)


def bwd_bytes(cfg, alive, winner, first: bool) -> int:
    """Bytes the backward of one bounce must move on these rays, by class.
    K4: a dead ray reads alive and the (o, d, beta) cotangents and writes
    d(o, d, beta) (76 B); an alive ray that misses also reads its winner
    and the radiance cotangent (92 B); a ray with a winner reads its state
    (o, d, beta, alive, seeds, winner, and occlusion with shadow rays on)
    and the four cotangents, and writes d(o, d, beta). K3: a miss reads its
    pixel id, winner and the (o, d) cotangents (32 B); a ray with a winner
    its pixel id, winner, occlusion and the four cotangents."""
    occ = 4 if cfg.shadow_rays else 0
    R = alive.numel()
    live = int(((alive > 0) & (winner >= 0)).sum().item())
    if first:
        return (R - live) * 32 + live * (8 + occ + 48)
    dead = int((alive <= 0).sum().item())
    return dead * 76 + (R - dead - live) * 92 + live * (48 + occ + 48 + 36)


def reset_counts(*tables) -> None:
    for table in tables:
        for key in table:
            table[key] = 0


def bound(nbytes: float, flops: float) -> dict:
    """The least time of the work on the card: the larger of its bytes
    over the memory rate and its operations over the f32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def wavefront_rays(mrt, torch, scene, cam, cfg, closest, any_hit):
    """The rays the wavefront integrator hands its intersector in a
    render_sample of ``cfg`` (frame 0): primary rays in tile order; the
    bounce-1 rays of the live paths in that order and coherence-sorted as
    ops/integrator sorts them; the shadow rays of the primary hits toward
    light 0 (origin, direction, t_limit)."""
    from mini_opencl_raytracer_tpu_torch.ops import integrator, rng
    from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
    from mini_opencl_raytracer_tpu_torch.ops.shading import (build_shading_table,
                                                              hit_attributes)
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids
    dev = cam.position.device
    pid = _swizzled_ids(cfg, dev)
    seeds = rng.pixel_seeds(pid, 0)
    o, d = generate_rays(cam, cfg, pid, seeds)
    o = o.contiguous()
    R = o.shape[0]
    with torch.no_grad():
        step = integrator.make_bounce_core(scene, cfg, closest, any_hit)
        o1, d1, _, _, alive, _ = step((o, d, torch.ones_like(o), torch.zeros_like(o),
                                       torch.ones((R,), dtype=torch.bool, device=dev),
                                       seeds), 0)
        o1, d1 = o1[alive].contiguous(), d1[alive].contiguous()
        g = scene.geometry
        pts = torch.cat([g.v0, g.v1, g.v2])
        keys = integrator._ray_sort_keys(o1, d1, pts.amin(0), pts.amax(0))
        perm = torch.sort(keys, stable=True).indices
        h = closest(o, d)
        at = hit_attributes(o, d, h, build_shading_table(g, scene.materials))
        pos = at.pos[h.hit]
        to_l = scene.lights.position[0] - pos
        dist = torch.linalg.norm(to_l, dim=1)
        l_unit = (to_l / dist[:, None]).contiguous()
        shadow = ((pos + l_unit * cfg.ray_epsilon).contiguous(), l_unit,
                  (dist - 2.0 * cfg.ray_epsilon).contiguous())
    return {"primary": (o, d.contiguous()), "bounce1": (o1, d1),
            "bounce1_sorted": (o1[perm].contiguous(), d1[perm].contiguous()),
            "shadow": shadow}


def hit_pairs(torch, tris, o, d, limit, cull: bool, live=None) -> int:
    """The (ray, record) pairs whose line meets the triangle at 0 < t <
    limit (the exact test accepts them): what the intersection needs, by
    the plain version's panel on the card. A culling kernel runs ~45 flops
    for each of these and no more than it must for the rest."""
    from mini_opencl_raytracer_tpu_torch.ops.intersect import ray_triangle_edges
    n, chunk = 0, max(1, (1 << 22) // tris.shape[0])
    for s in range(0, o.shape[0], chunk):
        t, _, _, _ = ray_triangle_edges(o[s:s + chunk, None], d[s:s + chunk, None],
                                        tris[None, :, 0:3], tris[None, :, 3:6],
                                        tris[None, :, 6:9], cull)
        ok = t < limit[s:s + chunk, None]
        if live is not None:
            ok &= live[s:s + chunk, None]
        n += int(ok.sum().item())
    return n


def k5_exact(label, torch, panel, bc, tris, o, d, limit, cull: bool) -> float:
    """K5 against its plain version bitwise (closest: t and idx), and
    against the model of its cull (ops/cuda/bundle_cull.py: t, idx and
    each ray's M-T count, closest and any); returns the mean count of the
    closest mode."""
    R = o.shape[0]
    st, sa = (torch.zeros((R,), dtype=torch.int32, device=o.device) for _ in range(2))
    k = panel.panel_closest(tris, o, d, limit, cull, stats=st)
    ka = panel._run("panel_any", True, tris, o, d, limit, cull, sa)
    p = panel.run_panel_plain(tris, o, d, limit, cull)
    m, ma = bc.cull_hits(tris, o, d, limit, cull), bc.cull_hits(tris, o, d, limit, cull, True)
    torch.cuda.synchronize()
    eq = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    if not eq(k, p):
        raise AssertionError(f"K5 {label}: (t, idx) differ from the plain version's on "
                             f"{int((k[1] != p[1]).sum().item())} rays")
    if not (eq(k, m[:2]) and torch.equal(st, m[2]) and eq(ka, ma[:2]) and torch.equal(sa, ma[2])):
        raise AssertionError(f"K5 {label}: outputs or M-T counts differ from the model of "
                             f"its cull on {int((st != m[2]).sum().item())} / "
                             f"{int((sa != ma[2]).sum().item())} rays (closest / any)")
    if not torch.equal(ka[1] >= 0, p[1] >= 0):
        raise AssertionError(f"K5 {label}: any-hit occlusion differs from the plain version's")
    mean = st.float().mean().item()
    log(f"  panel {label} ({R} rays, {tris.shape[0]} records, cull {cull}): bitwise equal to "
        f"plain; t, idx and M-T counts equal the model's, closest and any; M-T tests per ray "
        f"{mean:.3f} closest, {sa.float().mean().item():.3f} any")
    return mean


K1_OUTS = ("o", "d", "beta", "alive", "radiance", "winner", "occ", "seeds")


def k1_counts(label, torch, mk, bc, rng, table, tris, lv, camv, pid, frame: int, cfg,
              k0, p0) -> float:
    """K1's outputs, all eight, bitwise against its plain version's, a
    second launch with stats bitwise equal to the first, and its M-T tests
    per ray: without shadow rays equal, ray by ray, to the model of its
    cull on the plain version's camera rays."""
    from mini_opencl_raytracer_tpu_torch.ops.camera import rays_from_basis
    R = pid.numel()
    st = torch.zeros((R,), dtype=torch.int32, device=pid.device)
    again = mk.bounce0_fwd(table, tris, lv, camv, pid, frame, cfg, stats=st)
    torch.cuda.synchronize()
    bit = {n: torch.equal(a, b) for n, a, b in zip(K1_OUTS, k0, p0)}
    if not all(bit.values()):
        raise AssertionError(f"K1 {label}: outputs differ from plain: {bit}")
    if not all(torch.equal(a, b) for a, b in zip(again, k0)):
        raise AssertionError(f"K1 {label}: a launch with stats differs from one without")
    msg = ""
    if not cfg.shadow_rays:
        seeds = rng.pixel_seeds(pid, frame)
        o, d = rays_from_basis(camv[0:3], camv[3:6], camv[6:9], camv[9:12], cfg, pid, seeds)
        limit = torch.full((R,), min(cfg.t_max, 3.0e38), device=pid.device)
        model = bc.cull_hits(tris, o.contiguous(), d.contiguous(), limit, cfg.backface_cull)[2]
        if not torch.equal(model, st):
            raise AssertionError(f"K1 {label}: M-T counts differ from the model of its cull "
                                 f"on {int((model != st).sum().item())} rays")
        msg = ", equal to the model's on every ray"
    mean = st.float().mean().item()
    log(f"  bounce0_fwd {label}: bitwise equal to plain: {', '.join(bit)}"
        + f"; M-T tests per ray {mean:.3f} (of {tris.shape[0]} triangles"
        + (" + shadow rays" if cfg.shadow_rays else "") + f"){msg}")
    return mean


def check_intersector(label, torch, parity, closest_k, closest_p, any_k, any_p,
                      rays, t_max) -> float:
    """Closest hits of the primary and bounce-1 rays and occlusion of the
    shadow rays, kernel against plain version; returns the largest
    |diff| of the closest outputs."""
    worst = 0.0
    for kind in ("primary", "bounce1"):
        o, d = rays[kind]
        t_init = torch.full((o.shape[0],), t_max, device=o.device)
        k, p = closest_k(o, d, t_init), closest_p(o, d, t_init)
        torch.cuda.synchronize()
        st = parity.check_hits(f"{label} {kind}", k, p)
        worst = max(worst, st["max_abs_err"])
        log(f"  {label} {kind} ({o.shape[0]} rays): winners agree "
            f"{st['winner_agree']:.6f}, hit {st['hit_frac']:.4f}, t max/mean/frac "
            f"{st['t']['max']:.2e}/{st['t']['mean']:.2e}/{st['t']['frac']:.2e}"
            + (f", rows max {st['rows']['max']:.2e}" if "rows" in st else ""))
    so, sd, tl = rays["shadow"]
    st = parity.check_any(f"{label} shadow", any_k(so, sd, tl), any_p(so, sd, tl))
    log(f"  {label} shadow ({so.shape[0]} rays): occlusion equal, blocked "
        f"{st['blocked_frac']:.4f}")
    return worst


def plain_clustered(cl, torch, cg, cfg):
    """The wavefront's (closest, any_hit) on K6's plain version, as
    ops/cuda/clustered.make_intersectors builds them on the kernel."""
    from mini_opencl_raytracer_tpu_torch.ops.intersect import Hit

    def closest(o, d):
        t_init = torch.full((o.shape[0],), cfg.t_max, device=o.device)
        t, slot, rows = cl.run_clustered_plain(cg, o.contiguous(), d.contiguous(), t_init,
                                               cfg.backface_cull, cg.attrs is not None)
        hit = slot >= 0
        tri = cg.slot_to_tri[slot.clamp(min=0).long()].long()
        return Hit(t=t, tri_idx=torch.where(hit, tri, torch.zeros_like(tri)), hit=hit,
                   rows=rows)

    def any_hit(o, d, t_limit):
        t_init = torch.where(torch.isfinite(t_limit), t_limit, torch.full_like(t_limit, 3e38))
        return cl.run_clustered_plain(cg, o.contiguous(), d.contiguous(), t_init.contiguous(),
                                      cfg.backface_cull)[1] >= 0

    return closest, any_hit


def idle_lanes(stats, rays_per_warp: int) -> dict:
    """Mean Möller–Trumbore tests, cluster visits and box tests per ray,
    and the share of idle lanes: per warp of ``rays_per_warp`` consecutive
    rays, 1 - mean / max of the tests."""
    import torch
    tests = stats[:, 0].float()
    pad = (-tests.shape[0]) % rays_per_warp
    warps = torch.nn.functional.pad(tests, (0, pad)).reshape(-1, rays_per_warp)
    busy = warps.sum() / (warps.amax(1).sum() * rays_per_warp).clamp(min=1)
    return {"tests": tests.mean().item(), "visits": stats[:, 1].float().mean().item(),
            "boxes": stats[:, 2].float().mean().item(),
            "total_tests": int(stats[:, 0].sum().item()), "idle": 1.0 - busy.item()}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch.ops import rng
    from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
    from mini_opencl_raytracer_tpu_torch import grad
    from mini_opencl_raytracer_tpu_torch import native
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    from mini_opencl_raytracer_tpu_torch.ops.cuda import bundle_cull as bc
    from mini_opencl_raytracer_tpu_torch.ops.cuda import clustered as cl
    from mini_opencl_raytracer_tpu_torch.ops.cuda.clustered_walk import walk
    from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from mini_opencl_raytracer_tpu_torch.ops.cuda import panel
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
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native SAH library (native/*.cpp) did not build")
    log(f"[2 build] {native.library_path().name} (g++, native/) in "
        f"{time.perf_counter() - t0:.1f} s")

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
             ("2lights+shadow+dspec+ggx", parity.two_light_scene(dev),
              mrt.RenderConfig(shadow_rays=True, direct_specular=True,
                               specular_model="ggx"), None, 7, (1, 2)),
             ("backface_cull+soft_edge", mrt.cornell_scene(device=dev),
              mrt.RenderConfig(backface_cull=True, soft_edge_sigma=0.05), None,
              7, (1, 2)))
    k1_mean = {}
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
        k1_mean[label] = k1_counts(label, torch, mk, bc, rng, table, tris, lv, camv, pid, frame,
                                   cfg, k0, p0)
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

    # 3, the cull of K1 beyond Cornell's camera: a soup of 2048 triangles
    # and a camera grazing the floor (culling, shadow rays).
    for label, scene3, cam3, cfg3_ in parity.k1_cull_cases(dev):
        table, tris, lv = mk._tables(scene3, cfg3_, None)
        camv3 = mk.camera_vector(cam3)
        pid = torch.arange(cfg3_.num_pixels, dtype=torch.int32, device=dev)
        k0 = mk.bounce0_fwd(table, tris, lv, camv3, pid, 5, cfg3_)
        p0 = mk.bounce0_fwd_plain(table, tris, lv, camv3, pid, 5, cfg3_)
        torch.cuda.synchronize()
        stats = parity.check_bounce(f"bounce0_fwd, {label}", k0, p0)
        log(f"[3 kernel] bounce0_fwd, {label}, {cfg3_.width}x{cfg3_.height}")
        log_stats("bounce0_fwd", stats)
        max_err["bounce0_fwd"] = max(max_err["bounce0_fwd"], stats["max_abs_err"])
        k1_counts(label, torch, mk, bc, rng, table, tris, lv, camv3, pid, 5, cfg3_, k0, p0)

    # 3b. Each backward kernel against its plain version, on the forward
    # kernels' winners and state, with seeded cotangents shared by both.
    gen = torch.Generator(device=dev).manual_seed(1234)
    soup_cfg = mrt.RenderConfig(width=256, height=256)
    bwd_cases = cases + (("soup of 2048 triangles", parity.soup_scene(dev),
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

    # 3b, reduction cases of the backward kernels: each against its plain
    # version and a second run of itself, and, where the table partial fits
    # shared memory, against the global-memory branch (bitwise: same order).
    cornell = cases[0][1]
    shuffled = parity.shuffled_ids(main_cfg.num_pixels, 11, dev)
    red_cases = (("shuffled ids", cornell, main_cfg, shuffled, True),
                 ("soup of 512 triangles", parity.soup_scene(dev, n=512), soup_cfg, None, True),
                 ("30 lights + shadow rays", parity.many_light_scene(dev),
                  mrt.RenderConfig(width=512, height=512, shadow_rays=True), None, True),
                 ("every ray dead", cornell, main_cfg, main_ids, False))
    for label, scene, cfg, pid, first in red_cases:
        table, tris, lv = mk._tables(scene, cfg, None)
        if pid is None:
            pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
        f0 = mk.bounce0_fwd(table, tris, lv, camv, pid, 3, cfg)
        f1 = mk.bounce_fwd(table, tris, lv, *f0[:4], f0[7], 1, cfg)
        alive, winner = f0[3], f1[5]
        if label == "every ray dead":
            alive, winner = torch.zeros_like(alive), torch.full_like(winner, -1)
        groups = f1[5].reshape(-1, 32).sort(dim=1).values
        distinct = ((groups[:, 1:] != groups[:, :-1]) & (groups[:, 1:] >= 0)).sum(1) + (
            groups[:, 0] >= 0)
        T_pad = table.shape[0]
        branch = "shared" if mk.bwd_plan(1, T_pad, 1, 1, True).smem_table else "global"
        runs = [("bounce_bwd (bounce 1)", mk.bounce_bwd, mk.bounce_bwd_plain,
                 (table, lv, *f0[:3], alive, f0[7], winner, f1[6],
                  parity.cotangents(f1[2], gen), 1, cfg), parity.BOUNCE_GRADS)]
        if first:
            runs.insert(0, ("bounce0_bwd", mk.bounce0_bwd, mk.bounce0_bwd_plain,
                            (table, lv, camv, pid, 3, f0[5], f0[6],
                             parity.cotangents(f0[2], gen), cfg), parity.BOUNCE0_GRADS))
        for name, kernel, plain, args, names in runs:
            k, pl = kernel(*args), plain(*args)
            repeatable(f"{name}, {label}", k, kernel(*args))
            stats = parity.check_grads(f"{name}, {label}", k, pl, names)
            if branch == "shared":
                saved, mk._SMEM_ROWS = mk._SMEM_ROWS, 0
                k_global = kernel(*args)
                mk._SMEM_ROWS = saved
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(k, k_global)):
                    raise AssertionError(f"{name}, {label}: the table branches differ")
            log(f"[3b kernel] {name}, {label}, {cfg.width}x{cfg.height}, T_pad={T_pad} "
                f"({branch} table{', = global branch bitwise' if branch == 'shared' else ''}); "
                f"bounce-1 distinct live winners per 32 rays: mean "
                f"{distinct.float().mean().item():.2f}, min {distinct.min().item()}")
            log_grads(name, stats)
            key = "bounce0_bwd" if name == "bounce0_bwd" else "bounce_bwd"
            max_err[key] = max(max_err[key], stats["max_abs_err"])

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
    profile_step(torch, lambda: grad.loss_and_grads(scene, cam, cfg, loss_fn), card)

    # Backward kernel and plain version times at 1080p (main path state).
    cot0 = parity.cotangents(b0[2], gen)
    b1 = mk.bounce_fwd(table, tris, lv, *state, 1, cfg)
    cot1 = parity.cotangents(b1[2], gen)
    bwd0 = (table, lv, camv, main_ids, 0, b0[5], b0[6], cot0, cfg)
    bwd1 = (table, lv, *state, b1[5], b1[6], cot1, 1, cfg)
    # The backward kernels by device time (the wrapper's two launches):
    # their calls are host-bound, so events would time the host.
    times["bounce0_bwd"] = (device_ms(lambda: mk.bounce0_bwd(*bwd0)),
                            time_ms(lambda: mk.bounce0_bwd_plain(*bwd0), 3))
    times["bounce_bwd"] = (device_ms(lambda: mk.bounce_bwd(*bwd1)),
                           time_ms(lambda: mk.bounce_bwd_plain(*bwd1), 3))
    for name in KERNELS[:4]:
        k_ms, p_ms = times[name]
        log(f"[5/6 time] {name} at 1080p: kernel {k_ms:.4f} ms "
            f"({'device time' if 'bwd' in name else 'events'}), plain {p_ms:.3f} ms "
            f"({kind}; {card})")
    for name, args in (("bounce0_bwd", bwd0), ("bounce_bwd", bwd1)):
        fn = getattr(mk, name)
        log(f"[5/6 time] {name} wrapper call, events over 20 back-to-back calls: "
            f"{time_ms(lambda: fn(*args), 20):.4f} ms (host and device; {card})")

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

    # Bounds of the mega kernels at the shapes timed above (bytes: each
    # input read once, each output written once, for the backward what each
    # ray's class needs, bwd_bytes; operations: the M-T tests of the rays
    # that intersect, and for the backward the operations its rays need,
    # adjoint_flops).
    R_main, T_main = main_ids.numel(), tris.shape[0]
    tab_bytes = table.numel() * 4 + tris.numel() * 4 + lv.numel() * 4
    alive1 = int((b0[3] > 0).sum().item())
    flops0 = adjoint_flops(torch, rng, cfg, lv, b0[7], torch.ones_like(b0[3]), b0[5], b0[6],
                           b0[3], 0, True)
    flops1 = adjoint_flops(torch, rng, cfg, lv, state[4], state[3], b1[5], b1[6], b1[3], 1,
                           False)
    bwd_tab_bytes = 2 * (table.numel() + lv.numel()) * 4
    by0 = bwd_bytes(cfg, torch.ones_like(b0[3]), b0[5], True) + bwd_tab_bytes + 2 * 16 * 4
    by1 = bwd_bytes(cfg, state[3], b1[5], False) + bwd_tab_bytes
    # The forward kernels' operations: 45 flops for each (ray, triangle)
    # pair whose line meets the triangle below the ray's limit (hit_pairs);
    # the dense bound, which charges every pair, is printed beside it.
    from mini_opencl_raytracer_tpu_torch.ops.camera import rays_from_basis
    seeds0 = rng.pixel_seeds(main_ids, 0)
    o0, d0 = rays_from_basis(camv[0:3], camv[3:6], camv[6:9], camv[9:12], cfg, main_ids, seeds0)
    lim = torch.full((R_main,), min(cfg.t_max, 3.0e38), device=dev)
    need0 = hit_pairs(torch, tris, o0, d0, lim, cfg.backface_cull)
    need1 = hit_pairs(torch, tris, b0[0].T, b0[1].T, lim, cfg.backface_cull, b0[3] > 0)
    dense = {"bounce0_fwd": bound(R_main * (4 + 64) + tab_bytes, R_main * T_main * MT_FLOPS),
             "bounce_fwd": bound(R_main * (44 + 60) + tab_bytes, alive1 * T_main * MT_FLOPS)}
    bounds = {"bounce0_fwd": bound(R_main * (4 + 64) + tab_bytes, need0 * MT_FLOPS),
              "bounce_fwd": bound(R_main * (44 + 60) + tab_bytes, need1 * MT_FLOPS),
              "bounce0_bwd": bound(by0, flops0), "bounce_bwd": bound(by1, flops1)}
    for name, fl, nb in (("bounce0_bwd", flops0, by0), ("bounce_bwd", flops1, by1)):
        log(f"[6 bound] {name} at 1080p: {nb / 1e6:.2f} MB and {fl / 1e9:.4f} GFLOP needed "
            f"({nb / R_main:.1f} B and {fl / R_main:.1f} per ray), bound "
            f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}); kernel "
            f"{times[name][0]:.4f} ms (bound / kernel "
            f"{bounds[name]['bound_ms'] / times[name][0]:.1%})")
    for name, need in (("bounce0_fwd", need0), ("bounce_fwd", need1)):
        b_new, b_old = bounds[name], dense[name]
        log(f"[5/6 bound] {name} at 1080p: {need} (ray, triangle) pairs meet below the limit "
            f"({need / R_main:.3f} per ray): bound {b_new['bound_ms']:.4f} ms "
            f"({b_new['bound_by']}), {b_new['bound_ms'] / times[name][0]:.1%} of the kernel; "
            f"charging every pair (the dense bound): {b_old['bound_ms']:.4f} ms "
            f"({b_old['bound_by']}), {b_old['bound_ms'] / times[name][0]:.1%}")
    log(f"[5/6 count] bounce0_fwd M-T tests per ray at 1080p (main path): "
        f"{k1_mean[cases[0][0]]:.3f} of {T_main} triangles")
    launches = {k: launches[k] for k in mk.LAUNCHES}

    # 8. K5 against its plain version: the 1080p Cornell wavefront's
    # primary, bounce-1 and shadow rays, then 512x512 with culling.
    cornell = scene
    tri_k5 = panel.pack_triangles(cornell.geometry)
    max_err["panel"] = 0.0
    for label, cfg8 in (("1920x1080", main_cfg),
                        ("512x512 backface_cull", mrt.RenderConfig(backface_cull=True))):
        cull = cfg8.backface_cull
        rays_b = wavefront_rays(mrt, torch, cornell, cam, cfg8,
                                *panel.make_intersectors(cornell.geometry, cfg8))
        log(f"[8 kernel] panel (K5), Cornell {label}")
        max_err["panel"] = max(max_err["panel"], check_intersector(
            "panel", torch, parity,
            lambda o, d, ti: panel.panel_closest(tri_k5, o, d, ti, cull),
            lambda o, d, ti: panel.run_panel_plain(tri_k5, o, d, ti, cull),
            lambda o, d, tl: panel.panel_any(tri_k5, o, d, tl, cull),
            lambda o, d, tl: panel.run_panel_plain(tri_k5, o, d, tl, cull)[1] >= 0,
            rays_b, cfg8.t_max))
        for kind_r in ("primary", "bounce1", "bounce1_sorted", "shadow"):
            o, d = rays_b[kind_r][:2]
            limit = (rays_b[kind_r][2] if kind_r == "shadow"
                     else torch.full((o.shape[0],), cfg8.t_max, device=dev))
            k5_exact(f"{label} {kind_r}", torch, panel, bc, tri_k5, o, d, limit, cull)
        if label == "1920x1080":
            rays_k5 = rays_b
    log("[8 kernel] panel (K5) on the adversarial sets of its cull (parity.cull_ray_sets)")
    for name, (geo, o, d, limit) in parity.cull_ray_sets(dev).items():
        for cull in (False, True):
            k5_exact(name, torch, panel, bc, panel.pack_triangles(geo), o, d, limit, cull)

    # 9. K6 against its plain version on the bunny and sponza scenes.
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    t0 = time.perf_counter()
    bunny = mrt.bunny_scene(device=dev)
    torch.cuda.synchronize()
    t_bunny_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    sponza = mrt.sponza_scene(device=dev)
    torch.cuda.synchronize()
    t_sponza_scene = time.perf_counter() - t0
    accels, build_s = {}, {}
    for name, sc in (("bunny", bunny), ("sponza", sponza)):
        mrt.build_accel(sc, cfg3)  # warm-up: the first build loads the library
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accels[name] = mrt.build_accel(sc, cfg3)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
    max_err["clustered"] = 0.0
    for name, sc, cg in (("bunny SAH", bunny, accels["bunny"]),
                         ("sponza SAH", sponza, accels["sponza"]),
                         ("bunny Morton", bunny,
                          cl.build_clusters(bunny.geometry, materials=bunny.materials))):
        rays_c = wavefront_rays(mrt, torch, sc, cam, cfg3,
                                *cl.make_intersectors(sc.geometry, cfg3, accel=cg,
                                                      materials=sc.materials))
        log(f"[9 kernel] clustered (K6), {name} ({sc.num_triangles} triangles, "
            f"{cg.num_slots} slots, {cg.num_supers} supers), 512x512")
        max_err["clustered"] = max(max_err["clustered"], check_intersector(
            "clustered", torch, parity,
            lambda o, d, ti: cl.clustered_closest(cg, o, d, ti),
            lambda o, d, ti: cl.run_clustered_plain(cg, o, d, ti, False, with_rows=True),
            lambda o, d, tl: cl.clustered_any(cg, o, d, tl),
            lambda o, d, tl: cl.run_clustered_plain(cg, o, d, tl, False)[1] >= 0,
            rays_c, cfg3.t_max))
        if name == "bunny SAH":
            rays_k6 = rays_c
            # An open limit on rays from the bunny along (1, 1, 1): there
            # the far-point boxes above the tree's leaf padding (832 of
            # 1024 leaf slots real) pass the slab test.
            o = rays_c["bounce1"][0]
            d = torch.ones_like(o)
            ti = torch.full((o.shape[0],), float("inf"), device=dev)
            k, p = (cl.clustered_closest(cg, o, d, ti),
                    cl.run_clustered_plain(cg, o, d, ti, False, with_rows=True))
            k_any = cl.clustered_any(cg, o, d, ti)
            # Bitwise: a miss keeps t = inf, where a difference is nan.
            if not (all(torch.equal(a, b) for a, b in zip(k, p)) and torch.equal(k_any, p[1] >= 0)):
                raise AssertionError("K6 at an open limit differs from its plain version")
            log(f"  clustered open limit along (1, 1, 1) ({o.shape[0]} rays): bitwise equal, "
                f"closest and any, hit {(p[1] >= 0).float().mean().item():.4f}")
    # K6 at grazing incidence behind a decoy (parity.grazing_decoys): the
    # grazed triangle F, whose M-T t lies below its own box's entry, wins.
    decoys = 0
    for cos in (1e-3, 1e-4):
        for cg_d, o, d, t_f, _, _ in parity.grazing_decoys(dev, cos):
            ti = torch.full((1,), 1e5, device=dev)
            k, p = cl.clustered_closest(cg_d, o, d, ti), cl.run_clustered_plain(cg_d, o, d, ti, False)
            if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
                    and p[1].item() == cl.CLUSTER and p[0].item() == t_f
                    and bool(cl.clustered_any(cg_d, o, d, ti).item())):
                raise AssertionError(f"K6 behind a grazing decoy (cos {cos}) differs from its "
                                     "plain version or misses the grazed triangle")
            decoys += 1
    log(f"  clustered behind grazing decoys (cos 1e-3, 1e-4): {decoys} scenes, (t, slot) "
        "bitwise equal, the grazed triangle wins in each")

    # 10. Path B: Cornell through the wavefront on K5 against the mega path.
    for label, kw in (("defaults", {}),
                      ("shadow_rays+direct_specular",
                       dict(shadow_rays=True, direct_specular=True))):
        cfg_b = dataclasses.replace(main_cfg, **kw)
        with torch.no_grad():
            img_p = mrt.render_radiance(cornell, cam, dataclasses.replace(cfg_b, backend="pallas"))
            img_m = mrt.render_radiance(cornell, cam, cfg_b)
        torch.cuda.synchronize()
        log(f"[10 path B] Cornell 1920x1080x9 pallas vs mega, {label}")
        log_stats("radiance", {"radiance": parity.check_float(
            f"pallas vs mega, {label}", img_p, img_m)})
    cfg_g = mrt.RenderConfig(width=512, height=512, bounces=9)
    g_pal = grad.loss_and_grads(cornell, cam, dataclasses.replace(cfg_g, backend="pallas"),
                                loss_fn)
    g_meg = grad.loss_and_grads(cornell, cam, cfg_g, loss_fn)
    worst = 0.0
    for part, prefix in ((1, ""), (2, "camera.")):
        ref = dict(grad._leaves(g_meg[part]))
        for name, g in grad._leaves(g_pal[part]):
            if g.is_floating_point():
                worst = max(worst, parity.check_grad_sum(f"{prefix}{name} pallas vs mega",
                                                         g, ref[name])["rel"])
    log(f"[10 path B] loss_and_grads 512x512x9 pallas vs mega (K3/K4): loss "
        f"{g_pal[0].item():.6f} vs {g_meg[0].item():.6f}; largest max|diff| / "
        f"max|mega| over leaves {worst:.3e} (gate 2e-3)")
    path_b = {}
    for label, kw in (("defaults", {}), ("shadow_rays+direct_specular",
                                         dict(shadow_rays=True, direct_specular=True))):
        cfg_b = dataclasses.replace(main_cfg, **kw)
        cfg_p = dataclasses.replace(cfg_b, backend="pallas")
        with torch.no_grad():
            mrt.render(cornell, cam, cfg_p, frames=1)  # warm-up
            torch.cuda.synchronize()
            reset_counts(mk.LAUNCHES, panel.LAUNCHES, cl.LAUNCHES)
            ms_p = events_ms(lambda: mrt.render(cornell, cam, cfg_p, frames=frames), frames)
            counts = dict(panel.LAUNCHES)
            ms_m = events_ms(lambda: mrt.render(cornell, cam, cfg_b, frames=frames), frames)
        L = cornell.lights.count
        expect = {"panel_closest": frames * 9,
                  "panel_any": frames * 9 * L if cfg_b.shadow_rays else 0}
        log(f"[10 path B] {label}: launches over {frames} frames {counts}; pallas "
            f"{ms_p:.3f} ms/frame, mega {ms_m:.3f} ms/frame (1920x1080x9; {card})")
        if counts != expect:
            raise AssertionError(f"panel launches {counts}, expected {expect}")
        path_b[label] = counts
    launches["panel"] = sum(path_b["defaults"].values())

    # 11. Path A: large scenes through K6.
    for name, sc in (("bunny", bunny), ("sponza", sponza)):
        cg = accels[name]
        leaves = int((cg.cl_aabb[:cg.num_supers * cl.SUPER, 0] < 1e38).sum().item())
        log(f"[11 path A] build_accel {name}: {sc.num_triangles} triangles, layout "
            f"{cg.layout}, {leaves} leaves, {cg.num_supers} supers, {cg.num_slots} slots, "
            f"{cg.tree.shape[0]} inner tree nodes (arity {cl.ARITY}, depth {cg.depth}), "
            f"{build_s[name]:.3f} s (scene {t_bunny_scene if name == 'bunny' else t_sponza_scene:.3f} s)")
        if cg.layout != "sah":
            raise AssertionError(f"{name}: accel layout {cg.layout}, expected sah")
    acc3 = accels["bunny"]
    with torch.no_grad():
        mrt.render(bunny, cam, cfg3, frames=1, accel=acc3)  # warm-up
        torch.cuda.synchronize()
        reset_counts(mk.LAUNCHES, panel.LAUNCHES, cl.LAUNCHES)
        img3 = None

        def run3():
            nonlocal img3
            img3 = mrt.render(bunny, cam, cfg3, frames=frames, accel=acc3)

        ms3 = events_ms(run3, frames)
        path_a = dict(cl.LAUNCHES)
        cfg3u = dataclasses.replace(cfg3, sort_rays=False)
        img3u = None

        def run3u():
            nonlocal img3u
            img3u = mrt.render(bunny, cam, cfg3u, frames=frames, accel=acc3)

        ms3u = events_ms(run3u, frames)
    expect = {"clustered_closest": frames * cfg3.bounces, "clustered_any": 0}
    log(f"[11 path A] config 3 (bunny 512x512x2, SAH accel, 4 frames): launches {path_a}; "
        f"last launch {cl.SHAPES['clustered_closest']}")
    if path_a != expect:
        raise AssertionError(f"clustered launches {path_a}, expected {expect}")
    launches["clustered"] = sum(path_a.values())
    nonzero = (img3.amax(dim=-1) > 0).float().mean().item()
    if (tuple(img3.shape) != (512, 512, 3) or not torch.isfinite(img3).all()
            or (img3 < 0).any() or nonzero <= 0.5):
        raise AssertionError(f"config 3 image: shape {tuple(img3.shape)}, nonzero {nonzero}")
    if not torch.equal(img3, img3u):
        raise AssertionError("sorted and unsorted wavefronts differ")
    rays3 = cfg3.num_pixels * cfg3.bounces
    log(f"[11 path A] config 3: nonzero {nonzero:.4f}; sorted {ms3:.3f} ms/frame, "
        f"{rays3 / ms3 / 1e3:.2f} Mrays/s; unsorted {ms3u:.3f} ms/frame; images bitwise "
        f"equal ({kind}; {card})")
    pid3 = _swizzled_ids(cfg3, dev)
    seeds3 = rng.pixel_seeds(pid3, 0)
    o3, d3 = generate_rays(cam, cfg3, pid3, seeds3)
    with torch.no_grad():
        rad = [trace_paths(bunny, cfg3, o3, d3, seeds3, *intersectors)
               for intersectors in (cl.make_intersectors(bunny.geometry, cfg3, accel=acc3,
                                                         materials=bunny.materials),
                                    plain_clustered(cl, torch, acc3, cfg3))]
    torch.cuda.synchronize()
    log("[11 path A] config 3 radiance through K6 vs the plain version, same integrator")
    log_stats("radiance", {"radiance": parity.check_float("config 3 K6 vs plain", *rad)})
    for name, sc, cfg_a, n in (("bunny 1920x1080x9", bunny,
                                mrt.RenderConfig(width=1920, height=1080, bounces=9), 2),
                               ("sponza 3840x2160x1 (config 5, one GPU)", sponza,
                                mrt.RenderConfig(width=3840, height=2160, bounces=1), 2)):
        acc = accels[name.split()[0]]
        with torch.no_grad():
            mrt.render(sc, cam, cfg_a, frames=1, accel=acc)  # warm-up
            torch.cuda.synchronize()
            ms = events_ms(lambda: mrt.render(sc, cam, cfg_a, frames=n, accel=acc), n)
        log(f"[11 path A] {name}: {ms:.3f} ms/frame, "
            f"{cfg_a.num_pixels * cfg_a.bounces / ms / 1e3:.2f} Mrays/s ({n} frames; {card})")

    # 12. Path C: gradients through the wavefront on K6 at config 3.
    grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc3)  # warm-up
    torch.cuda.synchronize()
    steps_c = 3
    out_c = []
    reset_counts(mk.LAUNCHES, panel.LAUNCHES, cl.LAUNCHES)
    ms_c = events_ms(lambda: out_c.extend(
        grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc3) for _ in range(steps_c)),
        steps_c)
    expect = {"clustered_closest": steps_c * cfg3.bounces, "clustered_any": 0}
    if cl.LAUNCHES != expect:
        raise AssertionError(f"path C launches {cl.LAUNCHES}, expected {expect}")
    loss_c, gs_c, gc_c = out_c[-1]
    for name, g in list(grad._leaves(gs_c)) + [(f"camera.{k}", v)
                                               for k, v in grad._leaves(gc_c)]:
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"path C: gradient of {name} is not finite")
    gkd = gs_c.materials.diffuse
    if not bool((gkd != 0).any()):
        raise AssertionError("path C: the diffuse gradient is zero")
    log(f"[12 path C] loss_and_grads bunny config 3 (SAH accel): launches over {steps_c} "
        f"steps {expect}; loss {loss_c.item():.6f}, all leaves finite, d/d diffuse "
        f"{gkd.flatten()[:6].tolist()}; {ms_c:.3f} ms/step ({card})")
    s2 = dataclasses.replace(bunny, materials=dataclasses.replace(
        bunny.materials, diffuse=bunny.materials.diffuse * 0.25))
    with torch.no_grad():
        want = mrt.render_sample(s2, cam, cfg3, accel=mrt.build_accel(s2, cfg3))
        got = mrt.render_sample(s2, cam, cfg3, accel=acc3)
        base = mrt.render_sample(bunny, cam, cfg3, accel=acc3)
    upd = (got - want).abs().max().item()
    moved = (base - want).abs().max().item()
    log(f"[12 path C] prebuilt accel after a material update: max |stale - fresh| "
        f"{upd:.3e} (gate 1e-5), max |before - after| {moved:.3e} (must exceed 1e-3)")
    if not (torch.allclose(got, want, atol=1e-5, rtol=1e-5) and moved > 1e-3):
        raise AssertionError("a prebuilt accel does not track material updates")

    # 13. K5 and K6 alone against their plain versions at the paths' shapes.
    t_max = main_cfg.t_max
    full = lambda o: torch.full((o.shape[0],), t_max, device=o.device)
    T5 = tri_k5.shape[0]
    for kind_r in ("primary", "bounce1", "bounce1_sorted", "shadow"):
        o, d = rays_k5[kind_r][:2]
        ti = rays_k5[kind_r][2] if kind_r == "shadow" else full(o)
        R5 = o.shape[0]
        st = torch.zeros((R5,), dtype=torch.int32, device=dev)
        # Device time of the kernel alone: panel._run, not panel_any, whose
        # idx >= 0 is a kernel of its own.
        any_r = kind_r == "shadow"
        name_r = "panel_any" if any_r else "panel_closest"
        panel._run(name_r, any_r, tri_k5, o, d, ti, False, stats=st)
        k_ms = device_ms(lambda: panel._run(name_r, any_r, tri_k5, o, d, ti, False))
        p_ms = time_ms(lambda: panel.run_panel_plain(tri_k5, o, d, ti, False), 3)
        need = hit_pairs(torch, tri_k5, o, d, ti, False)
        b5 = bound(R5 * 36 + tri_k5.numel() * 4, need * MT_FLOPS)
        b5_dense = bound(R5 * 36 + tri_k5.numel() * 4, R5 * cornell.num_triangles * MT_FLOPS)
        log(f"[13 time] panel (K5) Cornell 1080p {kind_r} ({R5} rays): kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.3f} ms; M-T tests per ray {st.float().mean().item():.3f} of {T5} "
            f"records; {need} pairs meet ({need / R5:.3f} per ray): bound "
            f"{b5['bound_ms']:.4f} ms ({b5['bound_by']}), {b5['bound_ms'] / k_ms:.1%} of the "
            f"kernel; charging every pair (the dense bound): {b5_dense['bound_ms']:.4f} ms "
            f"({b5_dense['bound_by']}) ({card})")
        if kind_r == "primary":
            times["panel"] = (k_ms, p_ms)
            bounds["panel"] = b5
    big_rays = wavefront_rays(mrt, torch, sponza, cam,
                              mrt.RenderConfig(width=3840, height=2160, bounces=1),
                              *cl.make_intersectors(sponza.geometry, cfg3,
                                                    accel=accels["sponza"],
                                                    materials=sponza.materials))
    o1, d1 = rays_k6["bounce1"]
    shuffle = torch.randperm(o1.shape[0], generator=torch.Generator(device=dev).manual_seed(5),
                             device=dev)
    for label, cg, (o, d) in (("config 3 primary", acc3, rays_k6["primary"]),
                              ("config 3 bounce-1, pixel order", acc3, rays_k6["bounce1"]),
                              ("config 3 bounce-1, sorted", acc3, rays_k6["bounce1_sorted"]),
                              ("config 3 bounce-1, shuffled", acc3,
                               (o1[shuffle].contiguous(), d1[shuffle].contiguous())),
                              ("sponza 4K primary", accels["sponza"], big_rays["primary"])):
        ti = full(o)
        st = torch.zeros((o.shape[0], 3), dtype=torch.int32, device=dev)
        k_out = cl.clustered_closest(cg, o, d, ti, stats=st)
        slot = k_out[1]
        lanes = idle_lanes(st, 32 // cl.LANES)
        winners = int(torch.unique(slot[slot >= 0]).numel())
        k_ms = time_ms(lambda: cl.clustered_closest(cg, o, d, ti), 20)
        msg = (f"[13 time] clustered (K6) {label} ({o.shape[0]} rays): kernel {k_ms:.4f} ms; "
               f"{lanes['tests']:.1f} M-T tests, {lanes['visits']:.2f} cluster visits and "
               f"{lanes['boxes']:.1f} box tests per ray, idle lanes {lanes['idle']:.3f}")
        # Bytes: rays in (o, d, t_init), t / slot / row out, a 36-byte
        # record per real triangle, the 24-byte boxes of the real clusters
        # and the tree's real nodes, and the rows of this run's distinct
        # winners (slot_to_tri is read only on exact ties). Operations: the
        # M-T tests the kernel ran, all on real slots; its box tests are its
        # own traversal's cost, not the function's, and are not counted.
        rows_bytes = 4 * cl.ATTR_COLS
        clusters = int((cg.cl_count > 0).sum().item())
        nodes = int((cg.tree[:, 0] < 1e38).sum().item())
        b6 = bound(o.shape[0] * (28 + 8 + rows_bytes) + int(cg.cl_count.sum().item()) * 36
                   + (clusters + nodes) * 24 + winners * rows_bytes,
                   lanes["total_tests"] * MT_FLOPS)
        msg += (f"; {winners} distinct winners; bound {b6['bound_ms']:.4f} ms "
                f"({b6['bound_by']}), {b6['bound_ms'] / k_ms:.1%} of the kernel")
        if label == "config 3 primary":
            p_ms = time_ms(lambda: cl.run_clustered_plain(cg, o, d, ti, False, True), 3)
            msg += f"; plain {p_ms:.3f} ms"
            times["clustered"] = (k_ms, p_ms)
            bounds["clustered"] = b6
            # The counts of the walk's model, step by step, on the same rays.
            w_t, w_slot, w_st = walk(cg, o, d, ti)
            if not (torch.equal(w_st, st) and torch.equal(w_t, k_out[0])
                    and torch.equal(w_slot, slot)):
                raise AssertionError("K6's (t, slot, counts) differ from the model of its walk "
                                     f"on {int((w_st != st).any(1).sum().item())} rays")
            log(f"[13 walk] config 3 primary: K6's (t, slot) and counts equal its walk's "
                f"model on every ray; box tests per ray {lanes['boxes']:.2f}, M-T tests "
                f"{lanes['tests']:.2f}")
        log(msg + f" ({card})")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
         "library_ms": None}
        for name in KERNELS]}))
    log(f"[done] chip_smoke.py in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
