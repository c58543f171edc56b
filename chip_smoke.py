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
   culling and shadow rays); every one of K2's outputs bitwise equal to
   the plain version's on each of those bounces and on its edge cases
   (parity.K2_CASES: every ray dead, every ray alive, a seeded 10% alive,
   R = 1, 255 and 257, shuffled ids, 30 lights with shadow rays, backface
   culling with soft edges) and on the adversarial rays of
   parity.cull_ray_sets, every ray alive, at the limit 3e38;
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
   ms/frame; then each forward kernel's time against its plain version,
   and K2 at each bounce 1-8 of the main step from its carried state: its
   device time and their sum, the live fraction, the warps with a live
   lane and their lane use before (one thread a ray) and now (packed per
   tile), and its bound by ray class (``fwd_bytes``);
6. the training step, the slice's main path: the loss of
   ``mean(render_sample)`` and its gradients w.r.t. every float leaf of
   the scene and the camera (``grad.loss_and_grads``) for Cornell at
   1920x1080 with 9 bounces, with launch counts per step, finiteness, ms
   per step and fwd+bwd rays/s; one step under ``torch.profiler``: device
   time per kernel (K1-K4 and the backward's finishing sum), K2's share of
   the busy time and the idle share of that step; then each backward
   kernel's time against its plain version;
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
   equal);
14. the shell on the card: ``python -m mini_opencl_raytracer_tpu_torch.cli``
   in subprocesses (``--device cuda``), each printing the kernels' launch
   counts of its process. ``write_cornell_obj`` then ``load_scene``
   (leaves equal ``cornell_scene()``'s within 1e-5, native = Python
   parser); ``cli render`` of that OBJ at 1920x1080 x 9, 4 frames with
   ``--checkpoint``, then ``--resume`` for 4 more: the resumed image
   bitwise equal to an 8-frame ``render`` in process, the PNG of the
   first run equal to the 4-frame image's bytes; ``cli benchmark`` at
   1080p x 9 with ``--occupancy``; ``cli optimize --steps 10`` at
   512x512 x 9 (K1-K4; the loss falls, every step finite); ``cli render
   --backend pallas`` at 512x512 x 9 (K5) against mega (PFM); the bunny
   written as an OBJ (``load_scene`` timed), ``cli render`` at config 3
   (K6) against the in-process render of ``bunny_scene()`` (optimize,
   pallas and the bunny run beside render and resume, benchmark alone);
   the LBVH
   (``backend="bvh"``): ``build_bvh`` on both scenes, the walk kernel
   (csrc/bvh.cu) bitwise against its plain version (``walk_plain``) on
   primary, bounce-1, shadow and shared-edge rays, with both times, its
   M-T tests per ray and its bound; ``intersect_bvh`` / ``occluded_bvh``
   against the brute-force oracle (Cornell, 512x512) and K6 (bunny,
   256x256); and ``render(backend="bvh")`` of Cornell at 512x512 x 4
   against mega, its image on the plain walk bitwise the kernel's, with
   ms/frame compiled, on the plain walk, and mega's;
15. the parallel paths (``parallel/``). 15a, an NCCL group of one rank in
   this process (a file store under ``build/``): ``render_sample_dp`` of
   Cornell 1920x1080 x 9 against ``render_sample`` (bitwise, or within the
   radiance gates with the difference printed; ms a call beside
   ``render_sample``'s, timed the same way), ``train_step_dp`` with
   ``grad_buckets`` 1 and 4 against ``loss_and_grads`` (loss to 1e-6, the
   scene gradients in the gradient gate, K1-K4 launches per step =
   buckets x (1, 8, 1, 8), ms/step beside ``loss_and_grads``' timed the
   same way just before, one step of one bucket under ``torch.profiler``
   as phase 6 profiles its step), and
   ``render_sample_ring`` / ``render_sample_a2a`` at tp=1 on sponza 4K x 1
   against ``render_sample``. 15b, four ranks sharing the card over gloo
   (``python -m torch.distributed.run --standalone --nproc-per-node 4
   chip_smoke.py --parallel-child OUTDIR``; NCCL refuses two ranks on one
   GPU): dp=4 render and ``train_step_dp(grad_buckets=4)`` at Cornell
   1080p x 9 (K1-K4) against 15a's; on a 2 x 2 mesh the ring on sponza 4K
   x 1 (BASELINE config 5, K6 on 129,810-triangle slices), the all-to-all
   on the bunny at config 3 (K6) and the ring on Cornell 1080p x 9 (K5 on
   18-triangle slices); ``render_sample_pp`` (4 stages, Cornell 512x512 x
   8, 8 microbatches, K5) and ``render_sample_ep`` (ep=4, Cornell 512x512
   x 9, default capacity and capacity 4, K5), each against the
   single-device render. Each rank checks and logs its launches of K1-K6,
   ms per call and the bytes it hands to each collective; the times of
   15b are gloo staging through host memory on one shared card, and each
   entry point runs eagerly there by jit's rule (gloo on CUDA), as the
   ranks say on stderr. 15a also runs each of the six entry points
   compiled (a CUDA graph over the NCCL group) against the same call under
   ``jit.disable_jit()`` (``compiled_against_eager``): dp and
   ``train_step_dp`` (buckets 1 and 4) at Cornell 1080p x 9, ring and
   all-to-all at tp=1 on the bunny at config 3, pp at pp=1 (Cornell
   512x512 x 8, 2 microbatches) and ep at ep=1 (Cornell 512x512 x 9), bitwise at an int
   frame, a tensor frame and after a material update, the launches and
   collective bytes of 3 replays equal to 3 eager calls', five pairs in
   turns by CUDA events and one profiled call each; pp and ep against the
   single-device render; ``render_sample_pp``'s gradient (pp=1, eager,
   Cornell 512x512 x 8) with remat on and off: bitwise (deterministic
   algorithms), ms/step, peak memory; and a capture that fails under NCCL
   raises;
16. the compiled programs (jit.py: CUDA graphs, the JAX package's
   ``jax.jit``): the eager main step and config 3 frame under
   ``torch.cuda.set_sync_debug_mode("error")``; ``render`` on mega (Cornell 1920x1080 x 9, 4 frames),
   the training step (``jit`` of ``loss_and_grads``: loss and every float
   leaf's gradient), a config 3 frame (K6), a path B frame (K5) and
   ``scan_frames`` of 8 frames and ``render(backend="bvh")`` (Cornell
   512x512 x 4, the walk kernel), each bitwise equal to the eager call on
   the same inputs at several tensor frames and after a material update,
   with the launches of 3 replays equal to 3 eager calls'; ms/frame or
   ms/step compiled against eager in five pairs in turns (CUDA events),
   and the device busy time of one call of each under torch.profiler.
   Since ``render`` is compiled, phases 5, 10, 11 and 14 call it once at
   the measured key (eager run and capture) before they time a replay.
17. the backward's two modes. ``remat`` (the default; ops/integrator
   ._remat): on the wavefront gradient steps, path C (bunny 512x512 x 2)
   and path A (bunny 1920x1080 x 9, K6, sorted), the loss and every
   gradient bitwise equal with remat on and off (both under
   ``torch.use_deterministic_algorithms``), K6 launches a step (the
   recompute doubles them), the peak device memory of a step, ms/step in
   five pairs in turns and one profiled step each; sponza 3840x2160 x 9
   with remat on (peak memory, ms/step) beside the projection of remat off
   from the bunny's bytes a ray a bounce; the CLI optimize's compiled step
   on the bunny (a CUDA graph whose backward recomputes through K6, each
   captured K6 launch with its own counter) against eager, remat on and
   off. ``bwd_residuals``: the main step (Cornell 1920x1080 x 9) with the
   residual variants of K2 and K4 (launches, every gradient against the
   recompute mode per leaf, peak memory, the compiled step in five pairs
   in turns with one profiled step each, bitwise eager); K2 and K4 with
   and without rows at bounces 1-8 by device time, each variant bitwise
   its twin (K4 in the gradient gate with direct specular) and against its
   plain version at bounce 1 (K2 ranks the plain version's rays, 0 ..
   count - 1, and the rows K4 reads, megakernel.rows_read, read back
   through each one's ranks are bitwise the plain version's), in
   the options of parity.RESID_OPTIONS (Blinn 17 rows, GGX 16, shadow rays
   17, direct specular 20, soft edges 18), beside the times of the rows
   by ray (PERF.md), and with Blinn on bounce 1's rays compacted to those with a winner (every ray
   ranked); and on parity.RESID_CASES' states (K2_CASES, no ray ranked to
   every ray ranked) in each option. Since remat is on
   by default, phase 12's path C step launches K6 twice a bounce.
18. the material gather's backward (``csrc/material_rows.cu``, the
   backward of ``ops/shading.material_rows``): on the cotangent each table
   builder hands it (the bunny's wavefront table, a [T, 34] gradient's
   columns; Cornell's mega table, a transposed slice), recorded from a
   backward through the builder, against a float64 ``index_add_``
   (within 1e-6 of the sum of |cotangent| by material) and against the
   plain ``index_put_`` it replaces (within that plus the plain serial
   sum's own rounding, n 2^-24 of the sum of |cotangent| for n rows),
   bitwise equal to a second call; device time beside the plain version's
   and ``index_add_``'s (float atomics, run to run bits reported) and its
   bound; ``build.LAUNCHES["material_rows_bwd"]`` of one eager bunny config 3 step, one
   Cornell 1080p x 9 step and three replays of the compiled bunny step,
   each counted from 0: one launch a step.
19. the wavefront's fused shading (``csrc/shade.cu``: ``hit_attributes``
   and ``shade_hit`` of one bounce in one kernel where no gradient is
   taken): every output bitwise equal to ``hit_attributes`` +
   ``shade_hit`` on the same closest hit (``parity.check_shade``) on
   ``parity.SHADE_CASES``: the bunny at 512x512 (config 3's shape) at
   bounce 0 and at a sorted, parked bounce 1 with a radiance carry,
   sponza at 384x216 (rows from K6), Cornell on K5 and on the LBVH walk
   (rows from the table), GGX, soft edges, direct specular, backface
   culling and 30 lights of the three types; then its device time by
   events over 20 launches against its bound (bytes a ray: o, d, beta,
   radiance in and out, alive, hit, seed, the winner's 136-byte row) and
   the plain version's (3 calls), at config 3's bounce 0 and sorted
   bounce 1 and at sponza 3840x2160's bounce 0 (8.29 M rays); and its
   launches and rays in three replays of the compiled config 3 render
   (one a bounce and frame, ``build.RAYS`` all fused).
20. the wavefront shading's adjoint (``csrc/shade_bwd.cu``: the VJP of
   phase 19's kernel, where a gradient is taken): against autograd of
   ``shade_plain`` on ``parity.SHADE_CASES`` under the gradient gates
   (``parity.check_grads``), every output bitwise equal to a second call;
   its device time (``device_ms``, 20 calls) against its bound (bytes a
   ray: o, d, beta, the four cotangents, alive, hit, seed, the three
   [R, 3] gradients, and the 136-byte row and its gradient) and the plain
   version's (3 calls), at config 3's bounce 0 and sorted bounce 1; and
   per replay of the compiled config 3 step: two forward and one adjoint
   launch a bounce, ``jit.COUNTS`` 4 x R fused, 2 x R adjoint rays and
   none shaded in PyTorch.
21. the wavefront's raygen (``csrc/raygen.cu``: ``rng.pixel_seeds`` and
   ``generate_rays`` in one kernel where no gradient of the camera is
   taken): seeds, origins and directions bitwise ``raygen_plain`` at
   sponza 3840x2160's and config 3's tile-ordered ids (int and tensor
   frames); the kernel's device time (``device_ms``, 20 launches) against
   its bound (24 B a ray: the id read, the seed and d written), the
   wrapper's and the plain version's times by events (20 and 3 calls);
   per replay of the compiled config 3 and sponza 4K renders (4 frames):
   four launches and ``jit.COUNTS`` 4 x R rays from the kernel, none from
   PyTorch; per replay of the compiled config 3 step: none from the
   kernel, R from PyTorch (the camera's gradient); and K1's and K3's
   SASS (``scripts/kernel_sass.py``): instruction counts, and with
   ``against`` (a parent checkout) whether each is the same instruction
   for instruction. Alone: a script under ``build/`` that calls
   ``chip_smoke.phase21(...)`` (see its signature).
22. the wavefront's shadow rays at the shape of the configuration
   ``bunny-1080p-b2-shadows`` (``portbench/configs/``: config 3's 69,732
   triangles, its two point lights, 1920x1080 x 2, shadow rays, direct
   specular): the rays K6's any-hit mode is handed in an eager
   ``render_sample`` of frame 0, recorded at ``clustered_any`` (bounce 0
   in tile order, bounce 1 in the sorted order, one launch a light), each
   launch's occlusion bitwise ``run_clustered_plain``'s on the same rays
   and limits, with its device time (``device_ms``, 20 launches); and per
   replay of the compiled render (4 frames), the counts zeroed just
   before: K6's launches by mode and ``build.RAYS`` / ``jit.COUNTS``'
   closest, any-hit, plain-shaded and ``wave_shadow`` rays. Alone: a
   script under ``build/`` that calls ``chip_smoke.phase22(...)``.

Gates (phases 3, 3b, 4, 7-12, 14, 15): ops/cuda/parity.py. The forward
intersection kernels' bounds count 45 flops for each (ray, triangle)
pair whose line meets the triangle below the ray's limit (``hit_pairs``),
what the inputs need; the bound that charged every pair is printed beside
them (phases 5/6 and 13).

The last lines are one JSON object with a summary per kernel (launches
from the run of the path that uses it, errors, times, bound; the residual
variants' from phase 17's main step), the card's
name and power limit, and the device line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

_CSRC = "mini_opencl_raytracer_tpu_torch/csrc/"
_TPU = "mini_opencl_raytracer_tpu/ops/pallas/"
KERNELS = ("bounce0_fwd", "bounce_fwd", "bounce0_bwd", "bounce_bwd", "panel", "clustered",
           "bvh_walk", "bounce_fwd_resid", "bounce_bwd_resid", "material_rows_bwd", "shade",
           "shade_adjoint", "raygen")
SOURCES = {"bounce0_fwd": _CSRC + "megakernel.cu", "bounce_fwd": _CSRC + "megakernel.cu",
           "bounce0_bwd": _CSRC + "megakernel_bwd.cu",
           "bounce_bwd": _CSRC + "megakernel_bwd.cu",
           "bounce_fwd_resid": _CSRC + "megakernel.cu",
           "bounce_bwd_resid": _CSRC + "megakernel_bwd.cu",
           "panel": _CSRC + "panel.cu", "clustered": _CSRC + "clustered.cu",
           "bvh_walk": _CSRC + "bvh.cu", "material_rows_bwd": _CSRC + "material_rows.cu",
           "shade": _CSRC + "shade.cu", "shade_adjoint": _CSRC + "shade_bwd.cu",
           "raygen": _CSRC + "raygen.cu"}
# The walk kernel replaces no Pallas kernel: the JAX package's LBVH walk is
# a jnp while_loop.
REPLACES = {"bounce0_fwd": _TPU + "megakernel.py:1134", "bounce_fwd": _TPU + "megakernel.py:1041",
            "bounce0_bwd": _TPU + "megakernel.py:1173", "bounce_bwd": _TPU + "megakernel.py:1329",
            "panel": _TPU + "panel.py:83", "clustered": _TPU + "clustered.py:350",
            # The residual variants (cfg.bwd_residuals): _bounce_fwd_kernel
            # with save_resid, _bounce_bwd_kernel reading the rows.
            "bounce_fwd_resid": _TPU + "megakernel.py:1041",
            "bounce_bwd_resid": _TPU + "megakernel.py:1329",
            "bvh_walk": "mini_opencl_raytracer_tpu/ops/bvh.py:173 _intersect_one",
            # Nor the material gather's backward: the VJP of jnp.take (a
            # scatter-add) in the JAX package's build_shading_table.
            "material_rows_bwd": "mini_opencl_raytracer_tpu/ops/shading.py:111 jnp.take's VJP",
            # Nor the wavefront's shading: hit_attributes and the shading of
            # make_bounce_core's bounce_step, which XLA fuses.
            "shade": "mini_opencl_raytracer_tpu/ops/integrator.py:321 bounce_step's shading",
            # Nor its adjoint: jax.vjp of that shading, which XLA fuses.
            "shade_adjoint": "mini_opencl_raytracer_tpu/ops/integrator.py:321 bounce_step's "
                             "shading, its VJP",
            # Nor the wavefront's raygen: pixel_seeds and generate_rays in
            # the JAX package's render_ids, which XLA fuses.
            "raygen": "mini_opencl_raytracer_tpu/ops/camera.py:22 generate_rays and "
                      "ops/rng.py:42 pixel_seeds"}
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
# Of those, the operations K4 with rows (kResid) reads instead of
# computing, counted the same way (a draw's scaling counts one; its integer
# hash, like everywhere here, none): per ray with a winner the 1 / det and
# the pick's draw and compare (3); soft edges the margin and the sigmoid
# (9); the diffuse draws' terms (11); Blinn's draws, angle, cos, sin, the
# clamp and log of u2, cos_h's divide and exp, sin_h's sqrt, cos^alpha's
# divide, product and exp, the roughness (17); GGX's draws, angle, cos,
# sin, roughness, clamped u2, cos_h's clamp and sqrt, sin_h's sqrt (14);
# per light seen the distance of the replay (dot, max, sqrt) and of the
# adjoint (max, sqrt) (9); direct specular the replay's two max and pow,
# the adjoint's pow and log (5).
RESID_SAVED = {"live": 3, "soft": 9, "diffuse": 11, "blinn": 17, "ggx": 14, "light": 9,
               "dspec": 5}


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


def profile_step(torch, step, card: str, label: str = "6 profile") -> None:
    """One training step under torch.profiler: device time per kernel (K1-K4,
    the backward's finishing sum, the rest), device busy time, and the idle
    share of that same step against its own time by CUDA events around it
    (the profiler's host overhead included). A trace that lacks some of the
    step's kernel launches is taken again. Lines start with ``[label]``."""
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
            log(f"[{label}] torch.profiler shows no device time: not measured")
            return
        per = {n: [0.0, 0] for n in tuple(expect) + ("other",)}
        for e in rows:
            n = next((n for n in expect if n + "<" in e.key or n + "(" in e.key), "other")
            per[n][0] += dev_us(e) / 1e3
            per[n][1] += e.count
        whole = all(per[n][1] == c for n, c in expect.items())
        if whole:
            break
        log(f"[{label}] the trace lacks launches ({ {n: per[n][1] for n in expect} }): "
            "taken again")
    log(f"[{label}] one step under the profiler: device busy {busy:.3f} ms of "
        f"{ms_step:.3f} ms (events around it), idle share "
        f"{max(0.0, 1.0 - busy / ms_step):.3f}; " + "; ".join(
            f"{n} {t:.3f} ms ({c} launches)" for n, (t, c) in per.items())
        + f"; K2 (bounce_fwd_kernel) {per['bounce_fwd_kernel'][0] / busy:.1%} of busy ({card})"
        + ("" if whole else "; trace incomplete, busy is a lower bound"))
    rows.sort(key=dev_us, reverse=True)
    for e in rows[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:5d} x {e.key[:100]}")


def adjoint_classes(rng, cfg, lv, seeds, alive, winner, occ, alive_next, bounce: int):
    """The rays that set a bounce's backward work: (live: alive with a
    winner, spec: the lobe pick of the bounce's draw, on: live paths that go
    on, [(light kind, the rays on that see it)])."""
    live = (alive > 0) & (winner >= 0)
    on = live & (alive_next > 0)
    u = rng.uniform(rng.from_i32_bits(seeds), rng.bounce_site(bounce, rng.SITE_LOBE))
    spec = u > (1.0 - cfg.specular_prob)
    seen = []
    for li, t in enumerate(lv[:, 6].round().int().tolist()):
        kind = "directional" if t <= 0 else "point" if t == 1 else "spot"
        seen.append((kind, on & (((occ >> li) & 1) == 0) if cfg.shadow_rays else on))
    return live, spec, on, seen


def adjoint_flops(torch, rng, cfg, lv, seeds, alive, winner, occ, alive_next, bounce: int,
                  first: bool, resid: bool = False) -> int:
    """Float operations the backward of one bounce needs on these rays:
    one replay and its adjoint per ray with a winner, by lobe and by light
    type (ADJ_FLOPS), raygen and its adjoint for every ray of K3. With
    ``resid`` (K4 reading the rows) less what the rows replace
    (RESID_SAVED)."""
    F = ADJ_FLOPS
    S = RESID_SAVED if resid else dict.fromkeys(RESID_SAVED, 0)
    n = lambda m: int(m.sum().item())
    live, spec, on, seen = adjoint_classes(rng, cfg, lv, seeds, alive, winner, occ, alive_next,
                                           bounce)
    lobe = "ggx" if cfg.specular_model == "ggx" else "blinn"
    soft = F["soft"] - S["soft"] if cfg.soft_edge_sigma > 0 else 0
    dspec = F["dspec"] - S["dspec"] if cfg.direct_specular else 0
    ops = n(live) * (F["live"] - S["live"] + soft)
    ops += n(live & ~spec) * (F["diffuse"] - S["diffuse"]) + n(live & spec) * (F[lobe] - S[lobe])
    ops += n(on) * F["on"] + n(on & ~spec) * F["diffuse_adj"] + n(on & spec) * F[lobe + "_adj"]
    for kind, m in seen:
        ops += n(m) * (F[kind] - S["light"] + dspec)
    return ops + (alive.numel() * F["raygen"] if first else 0)


def resid_row_bytes(mk, cfg, num_lights: int, classes, write: bool) -> int:
    """Bytes of the known-value rows and their ranks on these rays
    (mk.rows_read, the rank-indexed layout): K2 (``write``) writes the
    shared rows and the picked lobe's of each ray alive with a winner, the
    lights' of each whose path goes on, every ray's rank (4 B) and the
    count; K4 reads the same rows but a light's only on the rays that see
    it, and the rank of each ray alive with a winner. ``classes``:
    adjoint_classes'."""
    live, spec, on, seen = classes
    read = mk.rows_read(cfg, num_lights)
    n = lambda m: int(m.sum().item())
    per_light = len(read["lights"]) // num_lights
    rows = (n(live) * len(read["all"]) + n(live & ~spec) * len(read["diffuse"])
            + n(live & spec) * len(read["specular"]))
    rows += (n(on) * num_lights if write else sum(n(m) for _, m in seen)) * per_light
    ranks = live.numel() + 1 if write else n(live)
    return 4 * (rows + ranks)


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


def fwd_bytes(alive) -> int:
    """Bytes K2 must move on these rays, by class: a ray that is not alive
    reads alive and (o, d, beta) and writes its pass-through (o, d, beta,
    radiance, alive, winner, occlusion bits), 100 B; a live ray also reads
    its seed, 104 B. (The table, triangles and lights, read once, are added
    by the caller.)"""
    live = int((alive > 0).sum().item())
    return (alive.numel() - live) * 100 + live * 104


# Rays of K2's tile where a live ray runs at most 256 M-T tests, as on
# Cornell (csrc/megakernel.cu, mrt_bounce_fwd).
K2_TILE = 128


def lane_use(torch, alive, tile: int) -> dict:
    """How K2 fills its warps on these rays. Before (the design it replaced: one
    thread per ray, a warp of 32 consecutive rays runs the bounce if one of
    them is alive): the share of warps with a live lane and the live lanes'
    share of those warps. Now (csrc/megakernel.cu's rule, per tile of
    ``tile`` rays: its live rays packed into ceil(live / 32) warps where
    that is fewer than the warps holding them, else run in place): the
    warps that run the bounce, as a share of the same R / 32, and their
    live lanes' share."""
    live = (alive > 0).cpu()
    R = live.numel()
    n = int(live.sum().item())
    per_tile = -(-R // tile) * tile
    pad = torch.zeros(per_tile, dtype=torch.bool)
    pad[:R] = live
    counts = pad.view(-1, tile // 32, 32).sum(2)
    holding = (counts > 0).sum(1)
    packed = (counts.sum(1) + 31) // 32
    before = int(holding.sum().item())
    now = int(torch.minimum(packed, holding).sum().item())
    warps = -(-R // 32)
    return {"live": n / R, "warps_before": before / warps,
            "use_before": n / (32 * before) if before else 0.0,
            "warps_now": now / warps, "use_now": n / (32 * now) if now else 0.0}


def reset_counts(*tables) -> None:
    for table in tables:
        for key in table:
            table[key] = 0


# The mega path's launch names (ops/cuda/build.LAUNCHES).
MEGA = ("bounce0_fwd", "bounce_fwd", "bounce_fwd_resid", "bounce0_bwd", "bounce_bwd",
        "bounce_bwd_resid")


def launch_counts(*names) -> dict:
    """The launches counted under ``names`` (ops/cuda/build.LAUNCHES)."""
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    return {k: build.LAUNCHES[k] for k in names}


def reset_kernel_counts() -> None:
    """Zero every kernel's launch and ray counts (ops/cuda/build.py)."""
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    reset_counts(build.LAUNCHES, build.RAYS)


def bound(nbytes: float, flops: float) -> dict:
    """The least time of the work on the card: the larger of its bytes
    over the memory rate and its operations over the f32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def k2_exact(label, torch, mk, parity, table, tris, lv, state, bounce: int, cfg):
    """K2 against its plain version on the card: every output bitwise
    (parity.check_bitwise). Returns (kernel outputs, plain outputs, max
    |diff| over the float outputs)."""
    k = mk.bounce_fwd(table, tris, lv, *state, bounce, cfg)
    p = mk.bounce_fwd_plain(table, tris, lv, *state, bounce, cfg)
    torch.cuda.synchronize()
    err = parity.check_bitwise(label, k, p)
    log(f"[3 kernel] {label}: {state[3].numel()} rays, {int((state[3] > 0).sum().item())} "
        "alive, every output bitwise the plain version's")
    return k, p, err


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


_CLI = "mini_opencl_raytracer_tpu_torch.cli"
# Runs the CLI as ``python -m`` does (runpy), then prints that process's
# kernel launch counts on stderr (they start at 0 in a new process).
_CLI_RUNNER = f"""
import json, runpy, sys
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
try:
    runpy.run_module({_CLI!r}, run_name="__main__", alter_sys=True)
finally:
    counts = {{k: v for k, v in build.LAUNCHES.items()
              if k.startswith(("bounce", "panel", "clustered"))}}
    print("LAUNCHES " + json.dumps(counts), file=sys.stderr)
"""


def cli_start(args):
    """Start ``python -m mini_opencl_raytracer_tpu_torch.cli ARGS`` from the
    repo root in a subprocess; ``cli_finish`` waits for it."""
    import os
    return (args, time.perf_counter(),
            subprocess.Popen([sys.executable, "-c", _CLI_RUNNER] + [str(a) for a in args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__))))


def cli_finish(run, timeout: int = 600):
    """(stdout, stderr, launch counts, seconds) of a ``cli_start``ed run.
    Raises unless it exits 0 within ``timeout`` s (killing it if not)."""
    args, t0, proc = run
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(map(str, args))} exited {proc.returncode}:\n"
                             f"{err[-3000:]}")
    line = [ln for ln in err.splitlines() if ln.startswith("LAUNCHES ")][-1]
    return out, err, json.loads(line[len("LAUNCHES "):]), sec


def cli_run(args, timeout: int = 600):
    """``cli_start`` then ``cli_finish``."""
    return cli_finish(cli_start(args), timeout)


def expect_launches(label: str, counts: dict, want: dict) -> None:
    """A CLI run launched each kernel of ``want`` that many times and no
    other kernel."""
    if counts != {name: want.get(name, 0) for name in counts}:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def read_png(torch, path: str):
    """An RGB8 PNG as a [H, W, 3] uint8 tensor: through PIL where it is
    installed, else the unfiltered form utils/image._write_png_pure writes."""
    import numpy as np
    try:
        from PIL import Image
        return torch.from_numpy(np.asarray(Image.open(path)).copy())
    except ImportError:
        pass
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: filtered PNG rows need PIL to read")
    return torch.from_numpy(raw[:, 1:].reshape(h, w, 3).copy())


def read_pfm(torch, path: str):
    """A PFM written by utils/image.write_pfm as a [H, W, 3] float32 tensor."""
    import numpy as np
    with open(path, "rb") as f:
        if f.readline() != b"PF\n":
            raise AssertionError(f"{path}: not an RGB PFM")
        w, h = (int(x) for x in f.readline().split())
        if float(f.readline()) >= 0:
            raise AssertionError(f"{path}: not little-endian")
        arr = np.frombuffer(f.read(), "<f4").reshape(h, w, 3)[::-1]
    return torch.from_numpy(arr.copy())


def write_scene_obj(scene, directory: str, stem: str):
    """Test scaffolding: ``scene`` as an .obj/.mtl pair with flat per-corner
    v/vt/vn records, ``usemtl`` runs and materials named by the Cornell
    table, every float as ``%.9g`` (float32 round-trips exactly)."""
    import os
    import numpy as np
    from mini_opencl_raytracer_tpu_torch.models.cornell import CORNELL_MATERIAL_NAMES
    g, m = scene.geometry, scene.materials
    names = CORNELL_MATERIAL_NAMES[:m.count]
    obj, mtl = (os.path.join(directory, f"{stem}.{ext}") for ext in ("obj", "mtl"))
    fmt = lambda a: "\n".join(" ".join("%.9g" % x for x in row) for row in a)
    with open(mtl, "w") as f:
        for i, name in enumerate(names):
            f.write(f"newmtl {name}\n")
            for key, arr in (("Kd", m.diffuse), ("Ks", m.specular), ("Ke", m.emission)):
                f.write(f"{key} {fmt(arr[i:i + 1].cpu().numpy())}\n")
            f.write(f"Ns %.9g\nNi %.9g\n" % (m.roughness[i].item(), m.ior[i].item()))
    corners = lambda a, b, c: np.stack([x.cpu().numpy() for x in (a, b, c)], 1).reshape(
        -1, a.shape[1])
    T = g.num_triangles
    mats = g.mat_idx.cpu().numpy()
    with open(obj, "w") as f:
        f.write(f"mtllib {stem}.mtl\n")
        for tag, arr in (("v", corners(g.v0, g.v1, g.v2)), ("vt", corners(g.uv0, g.uv1, g.uv2)),
                         ("vn", corners(g.n0, g.n1, g.n2))):
            f.write("\n".join(f"{tag} " + row for row in fmt(arr).split("\n")) + "\n")
        starts = np.flatnonzero(np.r_[True, mats[1:] != mats[:-1]])
        for s0, s1 in zip(starts, list(starts[1:]) + [T]):
            f.write(f"usemtl {names[mats[s0]]}\n")
            i = 3 * np.arange(s0, s1) + 1
            f.write("\n".join(f"f {a}/{a}/{a} {a + 1}/{a + 1}/{a + 1} {a + 2}/{a + 2}/{a + 2}"
                               for a in i) + "\n")
    return obj, mtl


def leaf_diff(torch, a, b) -> float:
    """Largest |difference| over the geometry and material leaves of two
    scenes (inf where a leaf's shape or dtype differs)."""
    worst = 0.0
    for group in ("geometry", "materials"):
        ga, gb = getattr(a, group), getattr(b, group)
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            if x.shape != y.shape or x.dtype != y.dtype:
                return float("inf")
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst


def phase14(mrt, torch, parity, cl, dev, card: str, ms_phase5: float) -> dict:
    """The shell on the card (module docstring, phase 14). Returns the
    walk kernel's row: its ms, the plain walk's, its bound, its error."""
    import os
    import tempfile
    from mini_opencl_raytracer_tpu_torch.models import objloader
    from mini_opencl_raytracer_tpu_torch.ops import bvh as pbvh
    from mini_opencl_raytracer_tpu_torch.ops.cuda import bvh as bvh_k
    from mini_opencl_raytracer_tpu_torch.utils import checkpoint as ckpt
    from mini_opencl_raytracer_tpu_torch.utils.image import to_uint8
    t_phase = time.perf_counter()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    cam = mrt.Camera.from_angles([0.0, -25.0, 8.5], 1.571, 1.571, device=dev)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        at = lambda name: os.path.join(tmp, name)
        # 14.1 Scene ingest.
        obj, _ = mrt.write_cornell_obj(tmp)
        scene = mrt.load_scene(obj, device=dev)
        diff = leaf_diff(torch, scene, mrt.cornell_scene(device=dev))
        names = {n: i for i, n in enumerate(mrt.load_mtl(obj[:-4] + ".mtl")[0])}
        if objloader._native_triangles(obj, names) is None:
            raise AssertionError("load_obj did not take the native parser")
        native_py = leaf_diff(torch, mrt.load_scene(obj, device=dev),
                              mrt.Scene(*mrt.load_obj(obj, use_native=False, device=dev)[:2],
                                        lights=scene.lights))
        log(f"[14 shell] write_cornell_obj + load_scene: {scene.num_triangles} triangles, "
            f"max |leaf - cornell_scene()| {diff:.2e} (gate 1e-5); native vs Python parser "
            f"max |diff| {native_py:.1e}")
        if not (diff <= 1e-5 and native_py == 0.0):
            raise AssertionError("the Cornell OBJ does not load as cornell_scene()")

        # Three CLI runs that wait for nothing, started together: optimize
        # (14.4), render --backend pallas (14.5), the bunny as an OBJ (14.6).
        bunny = mrt.bunny_scene(device=dev)
        bobj, _ = write_scene_obj(bunny, tmp, "bunny")
        runs = {"optimize": cli_start(["optimize", "--steps", 10, "--lr", 0.1, "--device",
                                       "cuda"]),
                "pallas": cli_start(["render", "--scene", obj, "--width", 512, "--height", 512,
                                     "--frames", 1, "--backend", "pallas", "--out",
                                     at("p.pfm"), "--device", "cuda"]),
                "bunny": cli_start(["render", "--scene", bobj, "--width", 512, "--height", 512,
                                    "--bounces", 2, "--frames", 4, "--out", at("bunny.npy"),
                                    "--device", "cuda"])}

        try:
            # 14.2 cli render 1080p x 9, 4 frames, checkpoint; resume 4 more
            # (the optimize, pallas and bunny runs below go on beside it).
            cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
            args = ["render", "--scene", obj, "--width", 1920, "--height", 1080, "--bounces", 9,
                    "--device", "cuda"]
            _, _, n1, s1 = cli_run(args + ["--frames", 4, "--checkpoint", at("st.npz"),
                                           "--out", at("four.png")])
            _, err2, n2, s2 = cli_run(args + ["--frames", 4, "--resume", at("st.npz"),
                                              "--checkpoint", at("st8.npz"),
                                              "--out", at("eight.npy")])
            for label, n in (("render", n1), ("render --resume", n2)):
                expect_launches(label, n, {"bounce0_fwd": 4, "bounce_fwd": 32})
            if "resumed at 4 samples" not in err2:
                raise AssertionError(f"cli render --resume: {err2[-500:]}")
            with torch.no_grad():
                four = mrt.render(scene, cam, cfg, frames=4)
                eight = mrt.render(scene, cam, cfg, frames=8)
            import numpy as np
            got8 = torch.from_numpy(np.load(at("eight.npy"))).to(dev)
            state = ckpt.load_render_state(at("st8.npz"), mrt.RenderState.create(cfg, dev))
            png = read_png(torch, at("four.png"))
            third = cfg.width // 3
            left, right = got8[:, :third].mean((0, 1)), got8[:, -third:].mean((0, 1))
            log(f"[14 shell] cli render 1920x1080x9: 4 frames {s1:.1f} s, --resume 4 more "
                f"{s2:.1f} s (process, CUDA init and library load included, beside three other "
                f"CLI processes); launches {n2}; "
                f"resumed image bitwise equal to render(frames=8): {torch.equal(got8, eight)}; "
                f"checkpoint {state.num_samples} samples; PNG {tuple(png.shape)} equal to the "
                f"4-frame image's bytes: {torch.equal(png, torch.from_numpy(to_uint8(four)))}; "
                f"left third rgb {left.tolist()}, right third rgb {right.tolist()}")
            if not (torch.equal(got8, eight) and state.num_samples == 8
                    and torch.equal(png, torch.from_numpy(to_uint8(four)))
                    and tuple(got8.shape) == (1080, 1920, 3) and bool(torch.isfinite(got8).all())
                    and left[0] > left[1] and right[1] > right[0]):
                raise AssertionError("cli render / resume disagrees with the in-process render")

            # 14.4 cli optimize, 10 steps at 512x512 x 9 through K1-K4.
            out, err, n4, s4 = cli_finish(runs["optimize"])
            losses = [float(ln.split()[-1]) for ln in err.splitlines() if ln.startswith("step ")]
            res = json.loads(out.strip().splitlines()[-1])
            log(f"[14 shell] cli optimize 512x512x9 --steps 10 --lr 0.1 ({s4:.1f} s): losses "
                f"{losses}; {res}; launches {n4}")
            expect_launches("optimize", n4, {"bounce0_fwd": 11, "bounce_fwd": 88,
                                             "bounce0_bwd": 10, "bounce_bwd": 80})
            if not (len(losses) == 10 and all(np.isfinite(losses)) and losses[-1] < losses[0]
                    and np.isfinite(res["final_loss"])):
                raise AssertionError(f"cli optimize: the loss did not fall: {losses}")

            # 14.5 cli render --backend pallas (K5) against mega.
            cfg5 = mrt.RenderConfig(width=512, height=512, bounces=9)
            _, _, n5, s5 = cli_finish(runs["pallas"])
            expect_launches("render --backend pallas", n5, {"panel_closest": 9})
            lin = read_pfm(torch, at("p.pfm")).to(dev)
            with torch.no_grad():
                mega = mrt.render_radiance(scene, cam, cfg5, frames=1)
            log(f"[14 shell] cli render --backend pallas 512x512x9 ({s5:.1f} s, launches {n5}) "
                "vs mega in process")
            log_stats("radiance", {"radiance": parity.check_float("cli pallas vs mega", lin, mega)})

            # 14.6 The bunny as an OBJ through K6.
            _, _, n6, s6 = cli_finish(runs["bunny"])
            t0 = time.perf_counter()
            bscene = mrt.load_scene(bobj, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            bdiff = leaf_diff(torch, bscene, bunny)
            cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
            expect_launches("render bunny", n6, {"clustered_closest": 8})
            got = torch.from_numpy(np.load(at("bunny.npy"))).to(dev)
            with torch.no_grad():
                ref = mrt.render(bunny, cam, cfg3, frames=4, accel=mrt.build_accel(bunny, cfg3))
            log(f"[14 shell] bunny OBJ ({os.path.getsize(bobj) / 2**20:.1f} MiB): load_scene "
                f"{bscene.num_triangles} triangles in {t_load:.3f} s (native parser); max |leaf - "
                f"bunny_scene()| {bdiff:.1e}; cli render config 3, 4 frames ({s6:.1f} s, launches "
                f"{n6}) vs render of bunny_scene() in process: bitwise {torch.equal(got, ref)}")
            log_stats("image", {"image": parity.check_float("cli bunny vs in process", got, ref)})
            if bscene.num_triangles != bunny.num_triangles or bdiff != 0.0:
                raise AssertionError("the bunny OBJ does not load as bunny_scene()")
        finally:
            for _, _, proc in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()

        # 14.3 cli benchmark 1080p x 9 with occupancy, alone on the card.
        out, _, n3, s3 = cli_run(["benchmark", "--scene", obj, "--width", 1920, "--height",
                                  1080, "--bounces", 9, "--occupancy", "--device", "cuda"])
        bench = json.loads(out.strip().splitlines()[-1])
        log(f"[14 shell] cli benchmark ({s3:.1f} s): {json.dumps(bench)}")
        log(f"[14 shell] cli benchmark 1920x1080x9: {bench['seconds_per_frame'] * 1e3:.3f} "
            f"ms/frame (events over 8 frames back to back, median of 5) against phase 5's "
            f"render(frames=4) {ms_phase5:.3f} ms/frame; launches {n3} ({card})")
        expect_launches("benchmark", n3, {"bounce0_fwd": 48, "bounce_fwd": 384,
                                          "panel_closest": 9})
        occ = bench["live_ray_fraction_per_bounce"]
        if not (bench["backend"] == "mega" and len(occ) == 9
                and all(0.0 <= x <= 1.0 for x in occ)
                and all(b <= a for a, b in zip(occ, occ[1:]))):
            raise AssertionError(f"cli benchmark: {bench}")

        # 14.7 The LBVH walk kernel against its plain version (bitwise),
        # and through intersect_bvh against the oracle (Cornell) and K6
        # (the bunny; its rays are 256x256, as the plain walk is a host loop
        # of a step per node popped, hundreds on the bunny).
        cfg_r = mrt.RenderConfig(width=512, height=512, bounces=4)
        acc_b = mrt.build_accel(bunny, cfg3)
        row = {"max_abs_err": 0.0}
        for label, sc, cfg_w, ref_fns in (
                ("Cornell OBJ", scene, cfg_r, mrt.make_intersectors(
                    scene, dataclasses.replace(cfg_r, backend="bruteforce"))),
                ("bunny", bunny, mrt.RenderConfig(width=256, height=256, bounces=4),
                 cl.make_intersectors(bunny.geometry, cfg3, accel=acc_b,
                                      materials=bunny.materials))):
            t0 = time.perf_counter()
            b = mrt.build_bvh(sc.geometry)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            rays = parity.wavefront_rays(sc, cam, cfg_w, *ref_fns)
            full = lambda o: torch.full((o.shape[0],), cfg_w.t_max, device=dev)
            sets = {kind: rays[kind] + (full(rays[kind][0]),) for kind in ("primary", "bounce1")}
            o_e, d_e = parity.shared_edge_rays(sc.geometry)
            sets.update({"shared edges": (o_e, d_e, full(o_e)), "shadow": rays["shadow"]})
            log(f"[14 shell] build_bvh {label}: {sc.num_triangles} triangles, {b.num_leaves} "
                f"leaves, depth {b.depth}, {t_build:.3f} s")
            for kind, (o, d, ti) in sets.items():
                stats = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
                out = {}
                p_ms = events_ms(lambda: out.update(ref=pbvh.walk_plain(o, d, ti, b, False,
                                                                         stats=stats)))
                got = bvh_k.walk(o, d, ti, b)
                torch.cuda.synchronize()
                ref = out["ref"]
                if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                    bad = int(((got[0] != ref[0]) | (got[1] != ref[1])).sum().item())
                    raise AssertionError(f"bvh_walk {label} {kind}: (t, slot) differ from "
                                         f"the plain walk's on {bad} rays")
                k_ms = time_ms(lambda: bvh_k.walk(o, d, ti, b), 20)
                # Bytes: each ray's o, d, t_init in and t, slot out; the tree
                # once (24-byte node boxes, 36-byte slot corners).
                # Operations: 45 flops for each M-T test the walk runs.
                tests = int(stats.sum().item())
                bd = bound(o.shape[0] * 40 + b.num_nodes * 24 + b.pv0.shape[0] * 36,
                           tests * MT_FLOPS)
                log(f"[14 bvh] walk kernel {label} {kind} ({o.shape[0]} rays): (t, slot) "
                    f"bitwise the plain walk's, hit {(got[0] < ti).float().mean().item():.4f}; "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms; {tests / o.shape[0]:.1f} "
                    f"M-T tests a ray; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), "
                    f"{bd['bound_ms'] / k_ms:.1%} of the kernel ({card})")
                if label == "bunny" and kind == "primary":
                    row.update(ms=k_ms, plain_ms=p_ms, bound=bd)
            msg = []
            for kind_r in ("primary", "bounce1"):
                o, d = rays[kind_r]
                h, r = mrt.intersect_bvh(o, d, b, t_max=cfg_w.t_max), ref_fns[0](o, d)
                as_hits = lambda x: (torch.where(x.hit, x.t, torch.full_like(x.t, cfg_w.t_max)),
                                     torch.where(x.hit, x.tri_idx.long(), -1))
                st = parity.check_hits(f"bvh {label} {kind_r}", as_hits(h), as_hits(r))
                msg.append(f"{kind_r} {o.shape[0]} rays: winners {st['winner_agree']:.6f}, "
                           f"hit {st['hit_frac']:.4f}")
            o, d, tl = rays["shadow"]
            parity.check_any(f"bvh {label} shadow", mrt.occluded_bvh(o, d, tl, b),
                             ref_fns[1](o, d, tl))
            log(f"[14 shell] intersect_bvh (the walk kernel) {label} vs "
                f"{'bruteforce' if label.startswith('Cornell') else 'K6'}: " + "; ".join(msg)
                + f"; occluded_bvh on {o.shape[0]} shadow rays equal")
        # render(backend="bvh"): against mega, and on the walk's plain
        # version (the host loop the walk kernel replaced) against the kernel,
        # bitwise.
        cfg_bvh = dataclasses.replace(cfg_r, backend="bvh")
        n = 2
        with torch.no_grad():
            acc = mrt.build_accel(scene, cfg_bvh)
            img_b = mrt.render_radiance(scene, cam, cfg_bvh, frames=n, accel=acc)
            img_m = mrt.render_radiance(scene, cam, cfg_r, frames=n)
            log("[14 shell] render(backend='bvh') Cornell OBJ 512x512x4 vs mega")
            log_stats("radiance", {"radiance": parity.check_float("bvh vs mega", img_b, img_m)})
            out = {}
            kernel_walk = pbvh._walk
            pbvh._walk = pbvh.walk_plain
            try:
                ms_p = events_ms(lambda: out.update(img=mrt.render_radiance(
                    scene, cam, cfg_bvh, frames=n, accel=acc)), n)
            finally:
                pbvh._walk = kernel_walk
            if not torch.equal(out["img"], img_b):
                raise AssertionError("render(backend='bvh') on the plain walk differs from "
                                     "the kernel's")
            mrt.render(scene, cam, cfg_bvh, frames=n, accel=acc)  # warm-up and capture
            ms_b = events_ms(lambda: mrt.render(scene, cam, cfg_bvh, frames=n, accel=acc), n)
            acc_m = mrt.build_accel(scene, cfg_r)
            mrt.render(scene, cam, cfg_r, frames=n, accel=acc_m)  # warm-up and capture
            ms_m = events_ms(lambda: mrt.render(scene, cam, cfg_r, frames=n, accel=acc_m), n)
        log(f"[14 shell] Cornell 512x512x4: bvh compiled (walk kernel) {ms_b:.3f} ms/frame, "
            f"eager on the plain walk {ms_p:.3f} ms/frame (bitwise the kernel's image), mega "
            f"{ms_m:.3f} ms/frame ({n} frames each; {card})")
    log(f"[14 shell] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return row


# Phase 15: the parallel paths.

def kernel_counts() -> dict:
    """Launches of K1-K6 and the walk kernel since the last reset_all,
    nonzero entries only."""
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    return {k: v for k, v in build.LAUNCHES.items()
            if v and k not in ("material_rows_bwd", "shade", "shade_adjoint")}


def reset_all() -> None:
    from mini_opencl_raytracer_tpu_torch.parallel import comm
    reset_kernel_counts()
    reset_counts(comm.BYTES)


def timed_call(torch, label: str, fn, want: dict, reps: int = 1):
    """``fn`` once to warm up, then ``reps`` times with the launch and byte
    counts at 0: (the last result, ms a call by the host clock to a
    synchronize, the launches and the bytes handed to each collective a
    call). Raises unless the launches a call are ``want``."""
    from mini_opencl_raytracer_tpu_torch.parallel import comm
    fn()
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    counts = {k: v // reps for k, v in kernel_counts().items()}
    if kernel_counts() != {k: v * reps for k, v in want.items()}:
        raise AssertionError(f"{label}: launches {kernel_counts()} in {reps} calls, "
                             f"expected {want} a call")
    return out, ms, counts, {k: v // reps for k, v in comm.BYTES.items() if v}


def check_image(parity, label: str, got, ref) -> str:
    """Bitwise, or within the radiance gates; returns which."""
    if tuple(got.shape) != tuple(ref.shape):
        raise AssertionError(f"{label}: shape {tuple(got.shape)}, expected {tuple(ref.shape)}")
    if got.equal(ref):
        return "bitwise equal"
    st = parity.check_float(label, got, ref)
    return (f"within the radiance gates (max {st['max']:.2e}, mean {st['mean']:.2e}, "
            f"frac {st['frac']:.2e})")


def check_scene_grads(parity, grad, label: str, got, ref) -> float:
    """Every float scene leaf within 2e-3 of max |reference|; the largest
    ratio."""
    ref = dict(grad._leaves(ref))
    return max(parity.check_grad_sum(f"{label} {name}", g, ref[name])["rel"]
               for name, g in grad._leaves(got) if g.is_floating_point())


# Ranks of phase 15b, all on the one card.
_RANKS = 4


def parallel_child(outdir: str) -> int:
    """One rank of phase 15b, started by ``torch.distributed.run``: joins
    the launcher's gloo group with its tensors and kernels on cuda:0 (the
    four ranks share one card), runs every scenario, writes its launches,
    ms per call and collective bytes to OUTDIR/rank<r>.log, and rank 0
    saves the results to OUTDIR."""
    import os
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch import grad
    from mini_opencl_raytracer_tpu_torch.config import MeshConfig
    from mini_opencl_raytracer_tpu_torch.parallel import expert, multihost, pipeline, shard
    from mini_opencl_raytracer_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda:0")
    if not multihost.initialize(backend="gloo", device=dev):
        raise AssertionError("initialize() found no launcher environment")
    rank = dist.get_rank()
    if dist.get_world_size() != _RANKS:
        raise AssertionError(f"world size {dist.get_world_size()}, expected {_RANKS}")
    # gloo is a host transport: the meshes are host meshes, the tensors and
    # kernels stay on cuda:0 (parallel/comm.py stages each collective).
    m41 = make_mesh(MeshConfig(dp=4, tp=1), device_type="cpu")
    m22 = make_mesh(MeshConfig(dp=2, tp=2), device_type="cpu")
    mpp = init_device_mesh("cpu", (4,), mesh_dim_names=("pp",))
    cam = mrt.Camera.default(device=dev)
    cornell = mrt.cornell_scene(device=dev)
    main_cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    cfg512 = lambda b: mrt.RenderConfig(width=512, height=512, bounces=b)
    img = lambda x: {"img": x.cpu()}

    def run(name, fn, want, save):
        out, ms, counts, nbytes = timed_call(torch, f"15b rank {rank} {name}", fn, want)
        with open(os.path.join(outdir, f"rank{rank}.log"), "a") as f:
            f.write(f"[15b rank {rank}] {name}: {ms:.1f} ms a call; launches {counts}; "
                    f"bytes {nbytes}\n")
        if rank == 0:
            torch.save(save(out), os.path.join(outdir, f"{name}.pt"))

    with torch.no_grad():
        run("dp4 Cornell 1080p x 9", lambda: shard.render_sample_dp(cornell, cam, main_cfg, m41),
            {"bounce0_fwd": 1, "bounce_fwd": 8}, img)
    run("train_step_dp(grad_buckets=4) Cornell 1080p x 9",
        lambda: shard.train_step_dp(cornell, cam, main_cfg, m41, grad_buckets=4),
        {"bounce0_fwd": 4, "bounce_fwd": 32, "bounce0_bwd": 4, "bounce_bwd": 32},
        lambda r: dict(grad._leaves(r[1]), loss=r[0].cpu()))
    with torch.no_grad():
        sponza = mrt.sponza_scene(device=dev)
        run("ring 2x2 sponza 4K x 1 (config 5)",
            lambda: shard.render_sample_ring(sponza, cam, mrt.RenderConfig(
                width=3840, height=2160, bounces=1), m22), {"clustered_closest": 2}, img)
        del sponza
        bunny = mrt.bunny_scene(device=dev)
        run("a2a 2x2 bunny 512x512 x 2 (config 3)",
            lambda: shard.render_sample_a2a(bunny, cam, cfg512(2), m22),
            {"clustered_closest": 2}, img)
        run("ring 2x2 Cornell 1080p x 9",
            lambda: shard.render_sample_ring(cornell, cam, main_cfg, m22),
            {"panel_closest": 18}, img)
        run("pp4 Cornell 512x512 x 8, n_micro 8",
            lambda: pipeline.render_sample_pp(cornell, cam, cfg512(8), mpp, n_micro=8),
            {"panel_closest": 2 * (8 + _RANKS - 1)}, img)
        for cap in (None, 4):
            run(f"ep4 Cornell 512x512 x 9, capacity {cap or 'default'}",
                lambda: expert.render_sample_ep(cornell, cam, cfg512(9), m41,
                                                capacity=cap),
                {"panel_closest": 9}, img)
    dist.destroy_process_group()
    return 0


def phase15(mrt, torch, parity, grad, dev, card: str, cam, cornell, bunny, sponza,
            accels, ms_step: float) -> None:
    """The parallel paths on the card (module docstring, phase 15)."""
    import os
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from mini_opencl_raytracer_tpu_torch.config import MeshConfig
    from mini_opencl_raytracer_tpu_torch.jit import disable_jit, jit
    from mini_opencl_raytracer_tpu_torch.parallel import comm, expert, multihost, pipeline, shard
    from mini_opencl_raytracer_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    main_cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    cfg5 = mrt.RenderConfig(width=3840, height=2160, bounces=1)
    cfg512 = lambda b: mrt.RenderConfig(width=512, height=512, bounces=b)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # 15a. An NCCL group of one rank in this process: real NCCL
        # collectives on device tensors.
        multihost.initialize(coordinator_address=f"file://{tmp}/store", num_processes=1,
                             process_id=0, device=dev)
        mesh = make_mesh(MeshConfig(dp=1, tp=1), device_type="cuda")
        mpp = init_device_mesh("cuda", (1,), mesh_dim_names=("pp",))
        log(f"[15a nccl] backend {dist.get_backend()}, world {dist.get_world_size()}, "
            f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")
        with torch.no_grad():
            ref_main, ms_ref, _, _ = timed_call(
                torch, "15a render_sample", lambda: mrt.render_sample(cornell, cam, main_cfg),
                {"bounce0_fwd": 1, "bounce_fwd": 8}, reps=5)
            img_dp, ms, n, nb = timed_call(
                torch, "15a dp", lambda: shard.render_sample_dp(cornell, cam, main_cfg, mesh),
                {"bounce0_fwd": 1, "bounce_fwd": 8}, reps=5)
        how = check_image(parity, "15a render_sample_dp vs render_sample", img_dp, ref_main)
        log(f"[15a nccl] render_sample_dp Cornell 1080p x 9 vs render_sample: {how}; "
            f"{ms:.3f} ms a call (5 calls) against render_sample's {ms_ref:.3f} timed the "
            f"same way just before; launches {n}; bytes {nb} a call ({card})")
        want_step = {"bounce0_fwd": 1, "bounce_fwd": 8, "bounce0_bwd": 1, "bounce_bwd": 8}
        (loss_ref, g_ref, _), _, _, _ = timed_call(
            torch, "15a loss_and_grads",
            lambda: grad.loss_and_grads(cornell, cam, main_cfg, lambda im: im.mean()),
            want_step)
        train = {}
        for k in (1, 4):
            # The single-device step timed the same way just before, so
            # that the two share the host's state of the moment.
            _, ms_ref, _, _ = timed_call(
                torch, "15a loss_and_grads",
                lambda: grad.loss_and_grads(cornell, cam, main_cfg, lambda im: im.mean()),
                want_step, reps=5)
            (loss, g), ms, n, nb = timed_call(
                torch, f"15a train_step_dp {k}",
                lambda: shard.train_step_dp(cornell, cam, main_cfg, mesh, grad_buckets=k),
                {"bounce0_fwd": k, "bounce_fwd": 8 * k, "bounce0_bwd": k, "bounce_bwd": 8 * k},
                reps=5)
            rel = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
            worst = check_scene_grads(parity, grad, f"15a train_step_dp({k})", g, g_ref)
            log(f"[15a nccl] train_step_dp(grad_buckets={k}) Cornell 1080p x 9 vs "
                f"loss_and_grads: loss {loss.item():.7f} vs {loss_ref.item():.7f} (rel "
                f"{rel:.1e}, gate 1e-6); largest max|diff| / max|ref| over scene leaves "
                f"{worst:.2e} (gate 2e-3); {ms:.3f} ms/step (5 steps) against "
                f"loss_and_grads' {ms_ref:.3f} timed the same way just before (phase 6: "
                f"{ms_step:.3f}); launches {n}; bytes {nb} a step ({card})")
            if rel > 1e-6:
                raise AssertionError(f"15a train_step_dp({k}): loss off by {rel:.2e}")
            train[k] = (loss, g)
        # Where a dp step's time goes, beside phase 6's profile.
        profile_step(torch, lambda: shard.train_step_dp(cornell, cam, main_cfg, mesh), card,
                     label="15a profile")
        with torch.no_grad():
            ref5 = mrt.render_sample(sponza, cam, cfg5, accel=accels["sponza"])
            for name, fn in (("ring", shard.render_sample_ring),
                             ("a2a", shard.render_sample_a2a)):
                got, ms, n, nb = timed_call(torch, f"15a {name}",
                                            lambda: fn(sponza, cam, cfg5, mesh),
                                            {"clustered_closest": 1})
                how = check_image(parity, f"15a {name} sponza", got, ref5)
                log(f"[15a nccl] render_sample_{name} tp=1 sponza 4K x 1 (config 5) vs "
                    f"phase 11's render_sample: {how}; {ms:.3f} ms a call (the slice's "
                    f"accel built in the call); launches {n}; bytes {nb} ({card})")
            del got

        # Each entry point compiled (a graph replayed over the NCCL group)
        # against the same call under jit.disable_jit(), at an int frame, a
        # tensor frame and after a material update, with their launches and
        # collective bytes; pp at pp=1 and ep at ep=1.
        def eager_of(fn):
            def run(s, a, f):
                with disable_jit():
                    return fn(s, a, f)
            return run

        frame = lambda f: torch.full((), f, dtype=torch.int64, device=dev)
        entries = [
            ("render_sample_dp Cornell 1080p x 9", cornell, "call",
             lambda s, a, f: shard.render_sample_dp(s, cam, main_cfg, mesh, f))]
        entries += [(f"train_step_dp(grad_buckets={k}) Cornell 1080p x 9", cornell, "step",
                     lambda s, a, f, k=k: shard.train_step_dp(s, cam, main_cfg, mesh, f,
                                                              grad_buckets=k))
                    for k in (1, 4)]
        entries += [
            ("render_sample_ring tp=1 bunny 512x512 x 2 (config 3)", bunny, "call",
             lambda s, a, f: shard.render_sample_ring(s, cam, cfg3, mesh, f)),
            ("render_sample_a2a tp=1 bunny 512x512 x 2 (config 3)", bunny, "call",
             lambda s, a, f: shard.render_sample_a2a(s, cam, cfg3, mesh, f)),
            ("render_sample_pp pp=1 Cornell 512x512 x 8, n_micro 2", cornell, "call",
             lambda s, a, f: pipeline.render_sample_pp(s, cam, cfg512(8), mpp, f)),
            ("render_sample_ep ep=1 Cornell 512x512 x 9", cornell, "call",
             lambda s, a, f: expert.render_sample_ep(s, cam, cfg512(9), mesh, f,
                                                     ep_axis="dp"))]
        compiled_fns = (shard.render_sample_dp, shard._train_step_dp, shard._ring, shard._a2a,
                        pipeline.render_sample_pp, expert.render_sample_ep)
        for label, sc, unit, call in entries:
            updated = dataclasses.replace(sc, materials=dataclasses.replace(
                sc.materials, diffuse=sc.materials.diffuse * 0.7 + 0.1))
            checks = [("int frame 11", sc, 11), ("tensor frame 12", sc, frame(12)),
                      ("after a material update", updated, frame(13))]
            compiled_against_eager(torch, f"[15a nccl] {label}", sc, None, call, eager_of(call),
                                   checks, 1, unit, card, grad=unit == "step")
            for fn in compiled_fns:
                fn.clear()
        with torch.no_grad():
            for label, got, ref in (
                    ("render_sample_pp pp=1", pipeline.render_sample_pp(
                        cornell, cam, cfg512(8), mpp),
                     mrt.render_sample(cornell, cam, cfg512(8))),
                    ("render_sample_ep ep=1", expert.render_sample_ep(
                        cornell, cam, cfg512(9), mesh, ep_axis="dp"),
                     mrt.render_sample(cornell, cam, cfg512(9)))):
                log(f"[15a nccl] {label} Cornell 512x512 vs the single-device render_sample: "
                    f"{check_image(parity, '15a ' + label, got, ref)}")
        for fn in compiled_fns:
            fn.clear()

        # The pipeline's gradient (eager: a compiled parallel call takes no
        # argument that requires grad) with remat on and off: its stages'
        # make_bounce_step checkpoints each bounce (phase 17 has the rest).
        pp_g, pp_ms, pp_pk = {}, {}, {}
        for r in (False, True):
            c8 = dataclasses.replace(cfg512(8), remat=r)
            step = lambda c8=c8: grad.grad_float_leaves(
                lambda sc: pipeline.render_sample_pp(sc, cam, c8, mpp, 0, n_micro=2).mean(),
                cornell)
            with disable_jit():
                pp_g[r] = deterministic(torch, step)
                _, pp_pk[r] = peak_mib(torch, step)
                pp_ms[r] = median(in_turns({"s": lambda i: step()}, pairs=3)["s"])
        if not same_tree(torch, pp_g[False], pp_g[True]):
            raise AssertionError("15a: render_sample_pp gradients differ with remat on and off")
        log(f"[15a nccl] render_sample_pp pp=1 gradient (Cornell 512x512 x 8, 2 microbatches, "
            f"eager): bitwise equal with remat on and off (deterministic algorithms); ms/step "
            f"off {pp_ms[False]:.2f}, on {pp_ms[True]:.2f}; peak memory off {pp_pk[False]:.1f} "
            f"MiB, on {pp_pk[True]:.1f} MiB ({card})")

        # Under NCCL a capture that fails raises (here: a host read).
        @jit(static_argnames=("mesh",))
        def syncs(x, mesh):
            return comm.psum(x, comm.Axis(mesh, "dp")) * x.sum().item()

        try:
            syncs(torch.ones(4, device=dev), mesh)
        except RuntimeError as e:
            if "capturing" not in str(e):
                raise
            log(f"[15a nccl] a capture that fails raises: {str(e).splitlines()[0][:160]}")
        else:
            raise AssertionError("15a: a capture with a host read did not raise")
        dist.destroy_process_group()

        # 15b. Four ranks on the one card over gloo, by PyTorch's launcher.
        outdir = os.path.join(tmp, "ranks")
        os.makedirs(outdir)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", str(_RANKS), os.path.abspath(__file__),
                            "--parallel-child", outdir],
                           capture_output=True, text=True, timeout=600, cwd=root)
        for rank in range(_RANKS):
            path = os.path.join(outdir, f"rank{rank}.log")
            if os.path.exists(path):
                with open(path) as f:
                    log(f.read().rstrip())
        if r.returncode != 0:
            raise AssertionError(f"phase 15b: the ranks exited {r.returncode}:\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-5000:]}")
        # Each entry point ran eagerly by jit's rule (gloo on CUDA), said once
        # per rank on stderr.
        said = sorted(set(re.findall(r"\[jit\] \S+ runs eagerly on \S+: the groups of axes "
                                     r".*? which no CUDA graph can hold", r.stderr)))
        for ln in said:
            log(f"[15b gloo] {ln}")
        missing = [name for name in ("render_sample_dp", "_train_step_dp", "_ring", "_a2a",
                                     "render_sample_pp", "render_sample_ep")
                   if not any(ln.startswith(f"[jit] {name} runs eagerly") for ln in said)]
        if missing:
            raise AssertionError(f"15b: no eager-by-rule line for {missing}")
        log(f"[15b gloo] {_RANKS} ranks on one card in {time.perf_counter() - t0:.1f} s "
            f"(start-up included); their times are gloo staging through host memory on one "
            f"shared card and say nothing about scaling over several GPUs ({card})")
        res = lambda name: torch.load(os.path.join(outdir, f"{name}.pt"))
        got = res("dp4 Cornell 1080p x 9")["img"].to(dev)
        log(f"[15b gloo] dp4 Cornell 1080p x 9 vs 15a's: "
            f"{check_image(parity, '15b dp4', got, img_dp)}")
        t4 = res("train_step_dp(grad_buckets=4) Cornell 1080p x 9")
        loss4, g4 = train[4]
        rel = abs(t4["loss"].item() - loss4.item()) / abs(loss4.item())
        g_got = grad._rebuild(g4, {k: v.to(dev) for k, v in t4.items() if k != "loss"})
        worst = check_scene_grads(parity, grad, "15b train_step_dp(4)", g_got, g4)
        log(f"[15b gloo] train_step_dp(grad_buckets=4) vs 15a's: loss rel {rel:.1e} (gate "
            f"1e-6); largest max|diff| / max|ref| {worst:.2e} (gate 2e-3)")
        if rel > 1e-6:
            raise AssertionError(f"15b train_step_dp: loss off by {rel:.2e}")
        with torch.no_grad():
            refs = {"ring 2x2 sponza 4K x 1 (config 5)": ref5,
                    "a2a 2x2 bunny 512x512 x 2 (config 3)":
                        mrt.render_sample(bunny, cam, cfg3, accel=accels["bunny"]),
                    "ring 2x2 Cornell 1080p x 9": ref_main,
                    "pp4 Cornell 512x512 x 8, n_micro 8":
                        mrt.render_sample(cornell, cam, cfg512(8))}
            ref_ep = mrt.render_sample(cornell, cam, cfg512(9))
        for cap in ("default", 4):
            refs[f"ep4 Cornell 512x512 x 9, capacity {cap}"] = ref_ep
        for name, ref in refs.items():
            how = check_image(parity, f"15b {name}", res(name)["img"].to(dev), ref)
            log(f"[15b gloo] {name} vs the single-device render_sample: {how}")
    log(f"[15 parallel] phase 15 in {time.perf_counter() - t_phase:.1f} s")


# Phase 16: the compiled programs (jit.py) against eager.

def same_tree(torch, a, b) -> bool:
    """Bitwise equal trees of tensors (same structure, every leaf equal)."""
    from mini_opencl_raytracer_tpu_torch.jit import flatten
    la, da = flatten(a)
    lb, db = flatten(b)
    return da == db and all(torch.equal(x, y) for x, y in zip(la, lb))


def busy_ms(torch, fn):
    """Device busy time of one call of ``fn`` (the sum of its kernels'
    device time under torch.profiler) and the call's ms by CUDA events
    around it; busy is None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms = events_ms(fn)
    busy = sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return (busy or None), ms


def run_counts() -> dict:
    """kernel_counts() and the bytes handed to each collective since the
    last reset_all."""
    from mini_opencl_raytracer_tpu_torch.parallel import comm
    return dict(kernel_counts(), **{f"bytes {k}": v for k, v in comm.BYTES.items() if v})


def in_turns(fns: dict, units: int = 1, pairs: int = 5) -> dict:
    """ms per unit of each of two calls by CUDA events, ``pairs`` pairs in
    turns (a, b; b, a; ...); each call gets the pair's index: {name: [ms,
    ...]}."""
    names = list(fns)
    t = {n: [] for n in names}
    for i in range(pairs):
        for n in (names if i % 2 == 0 else names[::-1]):
            t[n].append(events_ms(lambda: fns[n](i), units))
    return t


def median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def busy_line(b, ms, units: int = 1) -> str:
    """busy_ms's (busy, wall) per unit, with the idle share."""
    if b is None:
        return "not measured"
    return f"busy {b / units:.4f} of {ms / units:.4f} ms, idle {max(0.0, 1.0 - b / ms):.3f}"


def compiled_against_eager(torch, label: str, scene, acc, compiled, eager, checks,
                           units: int, unit: str, card: str, grad: bool = False) -> dict:
    """A compiled call against the eager call, each called as
    fn(scene, accel, frame): bitwise equal at each of ``checks`` ((what,
    scene, frame)); the launches and collective bytes of 3 replays equal
    to 3 eager calls'; then ms per ``unit`` in five pairs in turns (eager,
    compiled; compiled, eager; ...) by CUDA events, and the device busy
    time of one profiled call of each. Returns the counts of the 3
    replays."""
    dev = scene.geometry.v0.device
    frame = lambda f: torch.full((), f, dtype=torch.int64, device=dev)
    with torch.enable_grad() if grad else torch.no_grad():
        for what, sc, f in checks:
            got = compiled(sc, acc, f)
            ref = eager(sc, acc, f)
            torch.cuda.synchronize()
            if not same_tree(torch, got, ref):
                raise AssertionError(f"{label}, {what}: compiled differs from eager")
        reset_all()
        eager(scene, acc, frame(1))
        one = run_counts()
        reset_all()
        for f in range(3):
            compiled(scene, acc, frame(f))
        three = run_counts()
        if not one or three != {k: 3 * v for k, v in one.items()}:
            raise AssertionError(f"{label}: launches and bytes of 3 replays {three}, one "
                                 f"eager call {one}")
        t = in_turns({"eager": lambda i: eager(scene, acc, frame(100 + i)),
                      "compiled": lambda i: compiled(scene, acc, frame(100 + i))}, units)
        busy_e = busy_ms(torch, lambda: eager(scene, acc, frame(7)))
        busy_c = busy_ms(torch, lambda: compiled(scene, acc, frame(7)))
    wins = sum(c < e for c, e in zip(t["compiled"], t["eager"]))
    fmt = lambda side: ", ".join(f"{x:.4f}" for x in t[side])
    log(f"{label}: bitwise equal to eager ({'; '.join(w for w, _, _ in checks)}); "
        f"launches and bytes of 3 replays = 3 x {one}")
    log(f"{label}: ms/{unit} eager {median(t['eager']):.4f} (median; {fmt('eager')}), "
        f"compiled {median(t['compiled']):.4f} ({fmt('compiled')}); compiled faster in "
        f"{wins}/5 pairs; profiled, per {unit}: eager {busy_line(*busy_e, units)}, compiled "
        f"{busy_line(*busy_c, units)} ({card})")
    return three


def phase16(mrt, torch, grad, dev, card: str, cam, cornell, bunny, acc3, main_cfg,
            cfg3) -> dict:
    """16. Compiled programs. First the eager main step and config 3
    frame under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    synchronisation, the condition of their capture). Then ``render``
    (mega, Cornell 1080p x 9, 4 frames), the training step (``jit`` of ``grad.loss_and_grads``: the
    loss and every float leaf's gradient), a config 3 frame (K6), a path B
    frame (Cornell 1080p x 9 ``pallas``, K5), ``scan_frames`` of 8
    mega frames and ``render(backend="bvh")`` (Cornell 512x512 x 4, 4
    frames, the LBVH walk kernel), each bitwise against eager on the same
    inputs, at three frames (tensor frames, read from memory at each
    replay) and after a material update; launches of 3 replays equal to 3
    eager calls' (``compiled_against_eager``); then five pairs in turns by
    CUDA events, and one call of each under torch.profiler for the device
    busy time. Returns the launches of the bvh render's 3 replays."""
    from mini_opencl_raytracer_tpu_torch.jit import jit
    from mini_opencl_raytracer_tpu_torch.utils.metrics import scan_frames
    t_phase = time.perf_counter()
    loss_fn = lambda im: im.mean()
    cfg_b = dataclasses.replace(main_cfg, backend="pallas")
    frame = lambda f: torch.full((), f, dtype=torch.int64, device=dev)

    def sample(cfg):
        return lambda s, a, f: mrt.render_sample(s, cam, cfg, frame=f, accel=a)

    def render_eager(s, a, f):
        return mrt.to_image(mrt.render_radiance(s, cam, main_cfg, frames=4, accel=a),
                            main_cfg.gamma)

    def step_eager(s, a, f):
        return grad.loss_and_grads(s, cam, main_cfg, loss_fn, accel=a)

    cfg_bvh = mrt.RenderConfig(width=512, height=512, bounces=4, backend="bvh")

    def bvh_eager(s, a, f):
        return mrt.to_image(mrt.render_radiance(s, cam, cfg_bvh, frames=4, accel=a),
                            cfg_bvh.gamma)

    def scan_eager(s, a, f):
        tot = None
        for k in range(8):
            v = mrt.render_sample(s, cam, main_cfg, frame=(f + k) & 0xFFFFFFFF,
                                  accel=a).mean()
            tot = v if tot is None else tot + v
        return tot

    # What a capture needs: the eager main step and config 3 frame make no
    # host synchronisation (after one call, which reads the light types).
    for label, fn in (("main step", lambda: step_eager(cornell, None, None)),
                      ("config 3 frame", lambda: mrt.render_sample(bunny, cam, cfg3,
                                                                   frame=frame(5),
                                                                   accel=acc3))):
        with torch.no_grad() if label == "config 3 frame" else torch.enable_grad():
            fn()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        log(f"[16 sync] eager {label} under torch.cuda.set_sync_debug_mode('error'): "
            "no host synchronisation")

    scan8 = scan_frames(lambda fr, data: mrt.render_sample(data[0], cam, main_cfg, frame=fr,
                                                           accel=data[1]).mean(), 8)
    # (label, scene, accel, compiled call, eager call, units a call, unit)
    paths = [
        ("render (mega, Cornell 1080p x 9, 4 frames)", cornell, None,
         lambda s, a, f: mrt.render(s, cam, main_cfg, frames=4, accel=a), render_eager, 4,
         "frame"),
        ("step (loss_and_grads, Cornell 1080p x 9)", cornell, None, jit(step_eager),
         step_eager, 1, "step"),
        ("config 3 frame (bunny 512x512 x 2, K6)", bunny, acc3, jit(sample(cfg3)),
         sample(cfg3), 1, "frame"),
        ("path B frame (Cornell 1080p x 9 pallas, K5)", cornell, None, jit(sample(cfg_b)),
         sample(cfg_b), 1, "frame"),
        ("scan_frames of 8 (mega, Cornell 1080p x 9)", cornell, None,
         lambda s, a, f: scan8(f, (s, a)), scan_eager, 8, "frame"),
        ("render (bvh, Cornell 512x512 x 4, 4 frames)", cornell,
         mrt.build_accel(cornell, cfg_bvh),
         lambda s, a, f: mrt.render(s, cam, cfg_bvh, frames=4, accel=a), bvh_eager, 4,
         "frame"),
    ]
    for label, scene, acc, compiled, eager, units, unit in paths:
        updated = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, diffuse=scene.materials.diffuse * 0.7 + 0.1))
        checks = [("frame 11", scene, frame(11)), ("frame 12", scene, frame(12)),
                  ("frame 2**32 - 1", scene, frame(2**32 - 1)),
                  ("after a material update", updated, frame(13))]
        three = compiled_against_eager(torch, f"[16 compiled] {label}", scene, acc, compiled,
                                       eager, checks, units, unit, card, grad=unit == "step")
        if label.startswith("render (bvh"):
            bvh_launches = three
        if hasattr(compiled, "clear"):
            compiled.clear()
    from mini_opencl_raytracer_tpu_torch.render import _render_compiled
    _render_compiled.clear()
    log(f"[16 compiled] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return bvh_launches


def peak_mib(torch, fn):
    """(fn(), the peak device memory in MiB that the call allocates above
    what was allocated before it: torch.cuda.max_memory_allocated after
    reset_peak_memory_stats)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def deterministic(torch, fn):
    """fn() under torch.use_deterministic_algorithms(True): index_add_ and
    the gathers' backward then sum in a fixed order (their CUDA kernels
    otherwise add with atomics, in run order). New tensors are not filled
    (the mode's fill_uninitialized_memory): every kernel writes its
    outputs. With the fill, a path A step (bunny 1080p x 9) took 11.5 s
    in this mode against ~0.5 s in the default one."""
    import torch.utils.deterministic as det
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


# K2 / K4 with rows at the ray's own index (the layout before ranks), as
# PERF.md records them for the NVIDIA H100 80GB HBM3 at 700 W: device ms at
# 1080p bounce 1 and over bounces 1-8 as the rays come, and the variants'
# ratios to their twins on the rays compacted to those with a winner.
PARENT_RESID = {"K2 with rows": (0.2018, 1.6876, 1.324), "K4 with rows": (0.3211, 1.9664, 1.088)}


def compacted_times(torch, mk, parity, table, tris, lv, state, seeds, kc, b: int, cfg, gen,
                    k2: dict, k4: dict, card: str) -> None:
    """K2 and K4 with and without rows (device time) on bounce ``b``'s rays
    compacted to those alive with a winner, in ray order, beside their
    ratios on the rays as they come (``k2`` / ``k4``' first entries) and
    the rows by ray's (PARENT_RESID): every ray is then ranked (K2's
    ranks checked to be 0 .. R - 1, each once, and its count R), so what
    is left of the ratio is the rows' own cost."""
    keep = parity.live_rays(state[3], kc[5]).nonzero().squeeze(1)
    st = tuple(x[:, keep].contiguous() for x in state[:3]) + (state[3][keep].contiguous(),)
    sd = seeds[keep].contiguous()
    ck = mk.bounce_fwd(table, tris, lv, *st, sd, b, cfg)
    resid = mk.bounce_fwd(table, tris, lv, *st, sd, b, cfg, save_resid=True)[7]
    n = keep.numel()
    order = torch.sort(resid.rank.long()).values
    if not (torch.equal(order, torch.arange(n, device=keep.device)) and resid.count.item() == n):
        raise AssertionError(f"[17 time] bounce {b} compacted: K2 does not rank every ray "
                             f"once (count {resid.count.item()} of {n})")
    args = (table, lv, *st, sd, ck[5], ck[6], parity.cotangents(ck[2], gen), b, cfg)
    t = {"K2": device_ms(lambda: mk.bounce_fwd(table, tris, lv, *st, sd, b, cfg)),
         "K2 with rows": device_ms(lambda: mk.bounce_fwd(table, tris, lv, *st, sd, b, cfg,
                                                         save_resid=True)),
         "K4": device_ms(lambda: mk.bounce_bwd(*args)),
         "K4 with rows": device_ms(lambda: mk.bounce_bwd(*args, resid=resid))}
    par = PARENT_RESID
    log(f"[17 time] 1080p bounce {b} compacted to its {n} rays with a winner (every ray "
        f"ranked), device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f"; with rows / without: K2 {t['K2 with rows'] / t['K2']:.3f} (as the rays come "
        f"{k2['on'][0] / k2['off'][0]:.3f}; rows by ray {par['K2 with rows'][2]:.3f} "
        f"compacted), K4 "
        f"{t['K4 with rows'] / t['K4']:.3f} (as they come {k4['on'][0] / k4['off'][0]:.3f}; "
        f"rows by ray {par['K4 with rows'][2]:.3f} compacted) ({card})")


def phase17(mrt, torch, grad, parity, mk, rng, dev, card: str, cam, cornell, bunny, sponza,
            accels, main_cfg, main_ids) -> dict:
    """17. The backward's two modes. 17.1 ``remat`` on the wavefront
    gradient steps (path C, bunny 512x512 x 2; path A, bunny 1920x1080 x
    9): loss and every gradient bitwise equal between remat on and off
    (both under torch.use_deterministic_algorithms), K6 launches a step (B
    off, 2B on: the recompute), peak memory of a step, ms/step in five
    pairs in turns and one profiled step each; sponza 3840x2160 x 9 with
    remat on (peak memory, ms/step) beside the bunny-derived projection of
    remat off; the CLI optimize's compiled value-and-grad step on the bunny
    (a CUDA graph whose backward recomputes through K6): against eager, K6
    launches a replay, ms/step and peak memory, remat on and off. 17.2
    ``bwd_residuals`` on the main step (Cornell 1920x1080 x 9, mega):
    launches (the residual variants of K2 and K4), every gradient against
    the recompute mode (gate, and bitwise where the design allows; largest
    difference per leaf), peak memory, the compiled step in five pairs in
    turns with one profiled step each; K2 and K4 with and without rows at
    bounces 1-8 of the main path by device time, each variant bitwise its
    recompute twin (K4 in the gate with direct specular) and against its
    plain version at bounce 1 (the same rays ranked, the same count, the
    rows K4 reads bitwise through each one's ranks, gradients), in the
    options of
    parity.RESID_OPTIONS (Blinn, GGX, shadow rays, direct specular, soft
    edges), with Blinn also on bounce 1's rays compacted to those with a
    winner (compacted_times); then on parity.RESID_CASES' states in each
    option.
    Returns the two variants' rows of the kernels line."""
    from mini_opencl_raytracer_tpu_torch.jit import disable_jit, jit
    t_phase = time.perf_counter()
    loss_fn = lambda im: im.mean()

    # 17.1 remat.
    acc_b = accels["bunny"]
    per_ray = {}
    for label, cfg in (("path C (bunny 512x512 x 2)", mrt.RenderConfig(width=512, height=512,
                                                                       bounces=2)),
                       ("path A (bunny 1920x1080 x 9)", mrt.RenderConfig(width=1920, height=1080,
                                                                         bounces=9))):
        steps = {r: (lambda r=r: grad.loss_and_grads(bunny, cam, dataclasses.replace(cfg, remat=r),
                                                    loss_fn, accel=acc_b))
                 for r in (False, True)}
        for r in (False, True):
            steps[r]()
        torch.cuda.synchronize()
        got = {r: deterministic(torch, steps[r]) for r in (False, True)}
        if not same_tree(torch, got[False], got[True]):
            raise AssertionError(f"[17 remat] {label}: gradients of remat on and off differ")
        default = [steps[False]() for _ in range(2)]
        torch.cuda.synchronize()
        rerun = same_tree(torch, *default)
        lau = {}
        for r in (False, True):
            reset_all()
            steps[r]()
            torch.cuda.synchronize()
            lau[r] = kernel_counts()
            want = {"clustered_closest": cfg.bounces * (2 if r else 1)}
            if lau[r] != want:
                raise AssertionError(f"[17 remat] {label} remat={r}: launches {lau[r]}, "
                                     f"expected {want}")
        peak = {r: peak_mib(torch, steps[r])[1] for r in (False, True)}
        t = in_turns({"off": lambda i: steps[False](), "on": lambda i: steps[True]()})
        busy = {r: busy_ms(torch, steps[r]) for r in (False, True)}
        rays = cfg.num_pixels * cfg.bounces
        per_ray[label] = {r: peak[r] * 2**20 / rays for r in (False, True)}
        log(f"[17 remat] {label}: loss and every gradient bitwise equal, remat on vs off "
            f"(deterministic algorithms; two default-mode steps bitwise: {rerun}, index_add_'s "
            f"atomics); K6 launches a step off {lau[False]}, on "
            f"{lau[True]}")
        log(f"[17 remat] {label}: peak memory a step off {peak[False]:.1f} MiB "
            f"({per_ray[label][False]:.1f} B a ray a bounce), on {peak[True]:.1f} MiB "
            f"({per_ray[label][True]:.1f} B), {peak[False] / peak[True]:.2f}x less; ms/step off "
            f"{median(t['off']):.3f} (median; {', '.join(f'{x:.3f}' for x in t['off'])}), on "
            f"{median(t['on']):.3f} ({', '.join(f'{x:.3f}' for x in t['on'])}), on / off "
            f"{median(t['on']) / median(t['off']):.3f}; profiled: off {busy_line(*busy[False])}, "
            f"on {busy_line(*busy[True])} ({card})")

    cfg4 = mrt.RenderConfig(width=3840, height=2160, bounces=9)
    step4 = lambda: grad.loss_and_grads(sponza, cam, cfg4, loss_fn, accel=accels["sponza"])
    res4, pk4 = peak_mib(torch, step4)
    for name, g in list(grad._leaves(res4[1])) + list(grad._leaves(res4[2])):
        if not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"[17 remat] sponza 4K x 9: gradient of {name} not finite")
    del res4
    ms4 = events_ms(step4)
    rays4 = cfg4.num_pixels * cfg4.bounces
    proj = per_ray["path A (bunny 1920x1080 x 9)"][False] * rays4 / 2**30
    log(f"[17 remat] sponza 3840x2160 x 9, remat on: peak memory {pk4:.1f} MiB "
        f"({pk4 * 2**20 / rays4:.1f} B a ray a bounce), {ms4:.1f} ms/step, all gradients "
        f"finite; remat off not run: projection from the bunny 1080p step's "
        f"{per_ray['path A (bunny 1920x1080 x 9)'][False]:.1f} B a ray a bounce, {proj:.1f} GiB "
        f"(a projection, not a measurement; {card})")

    # The CLI optimize's compiled step (cli.cmd_optimize) on the bunny.
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    with torch.no_grad():
        target = mrt.render_sample(bunny, cam, cfg3, frame=0, accel=acc_b)
    kd0 = (bunny.materials.diffuse * 0.2 + 0.4).clamp(0.0, 1.0)

    def value_and_grad(cfg):
        def fn(diffuse):
            diffuse = diffuse.detach().requires_grad_()
            s = dataclasses.replace(bunny, materials=dataclasses.replace(bunny.materials,
                                                                         diffuse=diffuse))
            loss = torch.mean((mrt.render_sample(s, cam, cfg, frame=0, accel=acc_b) - target) ** 2)
            (g,) = torch.autograd.grad(loss, diffuse)
            return loss.detach(), g
        return fn

    for r in (False, True):
        fn = value_and_grad(dataclasses.replace(cfg3, remat=r))
        comp = jit(fn)
        before = torch.cuda.memory_allocated()
        _, pk = peak_mib(torch, lambda: comp(kd0))   # the eager run and the capture
        pool = (torch.cuda.memory_allocated() - before) / 2**20
        with disable_jit():
            ref = fn(kd0)
        reset_all()
        rep = comp(kd0 * 0.9)
        torch.cuda.synchronize()
        n = kernel_counts()
        want = {"clustered_closest": cfg3.bounces * (2 if r else 1)}
        if n != want:
            raise AssertionError(f"[17 remat] compiled optimize step remat={r}: launches {n}, "
                                 f"expected {want}")
        rep = comp(kd0)
        st = parity.check_grad_sum(f"[17 remat] compiled optimize step remat={r}", rep[1], ref[1])
        rel = abs(rep[0].item() - ref[0].item()) / abs(ref[0].item())
        if rel > 1e-5:
            raise AssertionError(f"[17 remat] compiled optimize step: loss {rep[0]} vs {ref[0]}")
        ms = median(in_turns({"c": lambda i: comp(kd0)}, pairs=3)["c"])
        log(f"[17 remat] the CLI optimize's compiled step on the bunny (512x512 x 2, K6), "
            f"remat={r}: a replay launches {n}; against eager: loss rel {rel:.1e}, d/d diffuse "
            f"max|diff| / max|ref| {st['rel']:.2e} (gate 2e-3); {ms:.3f} ms/step; the first "
            f"call (eager run and capture) peaks at {pk:.1f} MiB, the graph keeps {pool:.1f} "
            f"MiB ({card})")
        comp.clear()

    # 17.2 bwd_residuals on the main step.
    cfg_r = dataclasses.replace(main_cfg, bwd_residuals=True)
    step_r = lambda: grad.loss_and_grads(cornell, cam, cfg_r, loss_fn)
    step_c = lambda: grad.loss_and_grads(cornell, cam, main_cfg, loss_fn)
    step_r()
    step_c()
    torch.cuda.synchronize()
    reset_kernel_counts()
    res_r = step_r()
    torch.cuda.synchronize()
    launches = launch_counts(*MEGA)
    want = dict(dict.fromkeys(MEGA, 0), bounce0_fwd=1, bounce_fwd_resid=8, bounce0_bwd=1,
                bounce_bwd_resid=8)
    if launches != want:
        raise AssertionError(f"[17 resid] launches of a step {launches}, expected {want}")
    res_c = step_c()
    torch.cuda.synchronize()
    diffs = []
    for (name, a), (_, b) in zip(list(grad._leaves(res_r[1])) + list(grad._leaves(res_r[2])),
                                 list(grad._leaves(res_c[1])) + list(grad._leaves(res_c[2]))):
        if not a.is_floating_point():
            continue
        st = parity.check_grad_sum(f"[17 resid] {name}", a, b)
        same = " =" if torch.equal(a, b) else ""
        diffs.append(f"{name} {st['max']:.2e}/{st['scale']:.2e}{same}")
    log(f"[17 resid] loss_and_grads Cornell 1920x1080 x 9, bwd_residuals on vs off: loss "
        f"{res_r[0].item():.7f} vs {res_c[0].item():.7f} (bitwise "
        f"{torch.equal(res_r[0], res_c[0])}); launches a step {launches}; max|diff| / max|ref| "
        f"per leaf (= bitwise): {'; '.join(diffs)}")
    del res_r, res_c
    peak = {"on": peak_mib(torch, step_r)[1], "off": peak_mib(torch, step_c)[1]}
    frame = lambda f: torch.full((), f, dtype=torch.int64, device=dev)
    def step_with(c):
        return lambda s, a, f: grad.loss_and_grads(s, cam, c, loss_fn)

    comp = {"on": jit(step_with(cfg_r)), "off": jit(step_with(main_cfg))}
    with torch.enable_grad():
        for m in comp:
            comp[m](cornell, None, frame(0))
        eager_r = grad.loss_and_grads(cornell, cam, cfg_r, loss_fn)
        if not same_tree(torch, comp["on"](cornell, None, frame(1)), eager_r):
            raise AssertionError("[17 resid] the compiled step with rows differs from eager")
        t = in_turns({m: (lambda i, m=m: comp[m](cornell, None, frame(3))) for m in ("off", "on")})
        busy = {m: busy_ms(torch, lambda m=m: comp[m](cornell, None, frame(4))) for m in comp}
    log(f"[17 resid] compiled step (jit of loss_and_grads, Cornell 1920x1080 x 9), bitwise "
        f"eager with rows: ms/step off {median(t['off']):.4f} (median; "
        f"{', '.join(f'{x:.4f}' for x in t['off'])}), on {median(t['on']):.4f} "
        f"({', '.join(f'{x:.4f}' for x in t['on'])}), on / off "
        f"{median(t['on']) / median(t['off']):.3f}; profiled: off {busy_line(*busy['off'])}, on "
        f"{busy_line(*busy['on'])}; peak memory of an eager step off {peak['off']:.1f} MiB, on "
        f"{peak['on']:.1f} MiB ({card})")
    for c in comp.values():
        c.clear()

    # K2 / K4 with and without rows at bounces 1-8 of the main path, and
    # each variant against its plain version at bounce 1, in each option.
    gen = torch.Generator(device=dev).manual_seed(1717)
    camv = mk.camera_vector(cam)
    row = {}
    for option, (kw, n_rows) in parity.RESID_OPTIONS.items():
        cfg = dataclasses.replace(main_cfg, **kw)
        table, tris, lv = mk._tables(cornell, cfg, None)
        b0 = mk.bounce0_fwd(table, tris, lv, camv, main_ids, 0, cfg)
        seeds = b0[7]
        state = b0[:4]
        k2, k4 = {"off": [], "on": []}, {"off": [], "on": []}
        for b in range(1, cfg.bounces):
            kc = mk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg)
            kr = mk.bounce_fwd(table, tris, lv, *state, seeds, b, cfg, save_resid=True)
            torch.cuda.synchronize()
            if kr[7].rows.shape[0] != n_rows or not all(torch.equal(x, y)
                                                        for x, y in zip(kr[:7], kc)):
                raise AssertionError(f"[17 resid] {option} bounce {b}: K2 with rows "
                                     f"({kr[7].rows.shape[0]} rows) changes its outputs")
            cot = parity.cotangents(kc[2], gen)
            args = (table, lv, *state, seeds, kc[5], kc[6], cot, b, cfg)
            g_r = mk.bounce_bwd(*args, resid=kr[7])
            g_c = mk.bounce_bwd(*args)
            torch.cuda.synchronize()
            bw = parity.check_resid_bwd(f"[17 resid] {option} bounce {b} K4", g_r, g_c, cfg)
            k2["off"].append(device_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, seeds, b,
                                                             cfg)))
            k2["on"].append(device_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, seeds, b,
                                                            cfg, save_resid=True)))
            k4["off"].append(device_ms(lambda: mk.bounce_bwd(*args)))
            k4["on"].append(device_ms(lambda: mk.bounce_bwd(*args, resid=kr[7])))
            if b == 1:
                pl = mk.bounce_fwd_plain(table, tris, lv, *state, seeds, b, cfg, save_resid=True)
                rows = parity.check_resid_rows(f"[17 resid] {option} K2 rows", kr[7], pl[7],
                                               kr[3], cfg, lv.shape[0])
                if not rows["bitwise"]:
                    raise AssertionError(f"[17 resid] {option}: K2's rows, read back through "
                                         f"its ranks, are not bitwise the plain version's")
                pg = mk.bounce_bwd_plain(*args, resid=pl[7])
                gst = parity.check_grads(f"[17 resid] {option} K4 with rows", g_r, pg,
                                         parity.BOUNCE_GRADS)
                live = int(rows["live"])
                if option == "blinn":
                    p2 = time_ms(lambda: mk.bounce_fwd_plain(table, tris, lv, *state, seeds, b,
                                                             cfg, save_resid=True), 2)
                    p4 = time_ms(lambda: mk.bounce_bwd_plain(*args, resid=pl[7]), 2)
                    tab_bytes = (table.numel() + tris.numel() + lv.numel()) * 4
                    lim = torch.full((main_ids.numel(),), min(cfg.t_max, 3.0e38), device=dev)
                    need = hit_pairs(torch, tris, state[0].T, state[1].T, lim, cfg.backface_cull,
                                     state[3] > 0)
                    classes = adjoint_classes(rng, cfg, lv, seeds, state[3], kc[5], kc[6],
                                              kc[3], b)
                    flops4 = adjoint_flops(torch, rng, cfg, lv, seeds, state[3], kc[5], kc[6],
                                           kc[3], b, False, resid=True)
                    rows2 = resid_row_bytes(mk, cfg, lv.shape[0], classes, write=True)
                    rows4 = resid_row_bytes(mk, cfg, lv.shape[0], classes, write=False)
                    by2 = fwd_bytes(state[3]) + rows2 + tab_bytes
                    by4 = (bwd_bytes(cfg, state[3], kc[5], False) - live * 4 + rows4
                           + 2 * (table.numel() + lv.numel()) * 4)
                    row = {"bounce_fwd_resid": dict(ms=k2["on"][0], plain_ms=p2,
                                                    bound=bound(by2, need * MT_FLOPS),
                                                    err=rows["max_abs_err"]),
                           "bounce_bwd_resid": dict(ms=k4["on"][0], plain_ms=p4,
                                                    bound=bound(by4, flops4),
                                                    err=gst["max_abs_err"])}
                    log(f"[17 bound] bounce_fwd_resid at 1080p bounce 1: {by2 / 1e6:.2f} MB "
                        f"({live} rays with a winner write {rows2 / 1e6:.2f} MB of rows and "
                        f"ranks, every ray its rank), bound "
                        f"{row['bounce_fwd_resid']['bound']['bound_ms']:.4f} ms; "
                        f"bounce_bwd_resid: {by4 / 1e6:.2f} MB ({rows4 / 1e6:.2f} MB of rows "
                        f"and ranks read, no seed), {flops4 / 1e9:.4f} GFLOP, bound "
                        f"{row['bounce_bwd_resid']['bound']['bound_ms']:.4f} ms; plain {p2:.3f} / "
                        f"{p4:.3f} ms; rows by ray: bounds 0.0682 / 0.0620 ms ({card})")
                if option == "blinn":
                    compacted_times(torch, mk, parity, table, tris, lv, state, seeds, kc, b, cfg,
                                    gen, k2, k4, card)
                log(f"[17 resid] {option}, 1080p bounce 1: K2 rows ({n_rows} a ray) vs plain on "
                    f"{live} live rays: max {rows['max']:.2e}, bitwise {rows['bitwise']}; K4 "
                    f"with rows bitwise K4 without: {bw['bitwise']}; vs plain max "
                    f"{gst['max_abs_err']:.2e}")
            state = kc[:4]
        fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
        par = PARENT_RESID
        was = (f"; rows by ray: K2 with rows {par['K2 with rows'][0]:.4f} at bounce 1, "
               f"sum {par['K2 with rows'][1]:.4f}; K4 with rows {par['K4 with rows'][0]:.4f}, "
               f"sum {par['K4 with rows'][1]:.4f}" if option == "blinn" else "")
        log(f"[17 time] {option}, 1080p bounces 1-8, device ms: K2 off [{fmt(k2['off'])}] sum "
            f"{sum(k2['off']):.4f}, with rows [{fmt(k2['on'])}] sum {sum(k2['on']):.4f}; K4 off "
            f"[{fmt(k4['off'])}] sum {sum(k4['off']):.4f}, with rows [{fmt(k4['on'])}] sum "
            f"{sum(k4['on']):.4f}{was} ({card})")

    # The variants on RESID_CASES' states (K2_CASES, and every ray ranked),
    # in each option.
    n_cases = 0
    for option in parity.RESID_OPTIONS:
        for name in parity.RESID_CASES:
            label = f"[17 cases] {option} / {name}"
            scene, cfg, state, b = parity.resid_case(name, option, dev)
            table, tris, lv = mk._tables(scene, cfg, None)
            kr = mk.bounce_fwd(table, tris, lv, *state, b, cfg, save_resid=True)
            kc = mk.bounce_fwd(table, tris, lv, *state, b, cfg)
            pl = mk.bounce_fwd_plain(table, tris, lv, *state, b, cfg, save_resid=True)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(kr[:7], kc)):
                raise AssertionError(f"{label}: K2 with rows changes its outputs")
            parity.check_bitwise(label, kr[:7], pl[:7])
            rows = parity.check_resid_rows(label, kr[7], pl[7], kr[3], cfg, lv.shape[0])
            if not rows["bitwise"]:
                raise AssertionError(f"{label}: K2's rows, read back through its ranks, are "
                                     f"not bitwise the plain version's")
            cot = parity.cotangents(kc[2], gen)
            args = (table, lv, *state, kc[5], kc[6], cot, b, cfg)
            g_r = mk.bounce_bwd(*args, resid=kr[7])
            parity.check_resid_bwd(label, g_r, mk.bounce_bwd(*args), cfg)
            gst = parity.check_grads(label, g_r, mk.bounce_bwd_plain(*args, resid=pl[7]),
                                     parity.BOUNCE_GRADS)
            row["bounce_fwd_resid"]["err"] = max(row["bounce_fwd_resid"]["err"],
                                                 rows["max_abs_err"])
            row["bounce_bwd_resid"]["err"] = max(row["bounce_bwd_resid"]["err"],
                                                 gst["max_abs_err"])
            n_cases += 1
    log(f"[17 cases] K2 and K4 with rows on {n_cases} states (parity.RESID_CASES x "
        f"RESID_OPTIONS): K2's outputs bitwise its plain version's and its twin's without rows, "
        f"ranking the plain version's rays 0 .. count - 1 (no ray ranked, every ray ranked), "
        f"the rows read back through them bitwise, K4 in the gradient gate of its plain "
        f"version and its twin (bitwise but with direct specular)")
    row["bounce_fwd_resid"]["launches"] = launches["bounce_fwd_resid"]
    row["bounce_bwd_resid"]["launches"] = launches["bounce_bwd_resid"]
    log(f"[17] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return row


def phase18(mrt, torch, grad, dev, card: str, cam, cornell, bunny, acc3, cfg3,
            main_cfg) -> dict:
    """18. The material gather's backward (module docstring, phase 18).
    Returns the kernel's summary row, from the bunny's cotangent and step."""
    from mini_opencl_raytracer_tpu_torch.jit import jit
    from mini_opencl_raytracer_tpu_torch.ops import shading
    from mini_opencl_raytracer_tpu_torch.ops.cuda import material_rows as pmr
    from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as mk
    t_phase = time.perf_counter()
    loss_fn = lambda im: im.mean()
    names = ("diffuse", "specular", "emission", "roughness")
    gen = torch.Generator(device=dev).manual_seed(18)
    row = {}
    for label, scene, build_table in (
            ("bunny, wavefront table", bunny,
             lambda g, m: shading.build_shading_table(g, m).table),
            ("Cornell, mega table", cornell, mk.build_mega_table)):
        # The cotangent as the builder hands it over, recorded in a
        # backward through the table.
        seen, reduce = [], pmr.reduce_by_material
        leaves = {k: getattr(scene.materials, k).detach().requires_grad_(True) for k in names}
        table = build_table(scene.geometry, dataclasses.replace(scene.materials, **leaves))
        pmr.reduce_by_material = lambda c, m, n: seen.append((c, m, n)) or reduce(c, m, n)
        try:
            torch.autograd.grad(table, list(leaves.values()),
                                torch.randn(table.shape, generator=gen, device=dev))
        finally:
            pmr.reduce_by_material = reduce
        (cot, mi, M), = seen
        T = mi.shape[0]
        got = pmr.reduce_by_material(cot, mi, M)
        repeatable(f"[18 material] {label}", [got], [pmr.reduce_by_material(cot, mi, M)])
        plain = pmr.reduce_plain(cot, mi, M)
        lib = [cot.new_zeros((M, 10)).index_add_(0, mi, cot) for _ in range(2)]
        ref = torch.zeros((M, 10), dtype=torch.float64, device=dev).index_add_(0, mi, cot.double())
        scale = torch.zeros_like(ref).index_add_(0, mi, cot.double().abs())
        rows_of = torch.bincount(mi, minlength=M).double()[:, None]
        d_ref = (got.double() - ref).abs()
        d_plain = (got.double() - plain.double()).abs()
        rel = lambda d: (d / scale.clamp_min(1e-30)).max().item()
        if not ((d_ref <= 1e-6 * scale).all() and
                (d_plain <= (1e-6 + rows_of * 2.0**-24) * scale).all()):
            raise AssertionError(f"[18 material] {label}: the reduction differs from the "
                                 f"float64 sum by {rel(d_ref):.2e} and from index_put_ by "
                                 f"{rel(d_plain):.2e} of the sum of |cotangent|")
        ms = device_ms(lambda: pmr.reduce_by_material(cot, mi, M))
        plain_ms = device_ms(lambda: pmr.reduce_plain(cot, mi, M))
        lib_ms = device_ms(lambda: cot.new_zeros((M, 10)).index_add_(0, mi, cot))
        G = -(-T // pmr.rows_per_block(M))
        b = bound(T * (10 * 4 + 8) + 2 * G * M * 10 * 4 + M * 10 * 4, T * 10)
        log(f"[18 material] {label}: T {T}, M {M}, {int(rows_of.max().item())} rows on one "
            f"material; cotangent [T, 10] strides {tuple(cot.stride())}; against float64 "
            f"{rel(d_ref):.2e}, against index_put_ {rel(d_plain):.2e} of the sum of |cotangent|, "
            f"max abs {d_plain.max().item():.3e}; two calls bitwise; kernel {ms:.4f} ms "
            f"(both launches, {G} blocks), index_put_ {plain_ms:.3f} ms, index_add_ "
            f"{lib_ms:.4f} ms (two calls bitwise: {torch.equal(lib[0], lib[1])}); bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {b['bound_ms'] / ms:.1%} of the kernel "
            f"({card})")
        if not row:
            row = {"err": d_plain.max().item(), "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound": b}

    # One launch a training step of the main paths, counted from 0.
    c_step = jit(lambda s, a: grad.loss_and_grads(s, cam, cfg3, loss_fn, accel=a))
    steps = (("eager bunny 512x512 x 2 step (config 3, the bunny-512-b2 cells' shape)", 1,
              lambda: grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc3)),
             ("eager Cornell 1920x1080 x 9 step (mega)", 1,
              lambda: grad.loss_and_grads(cornell, cam, main_cfg, loss_fn)),
             ("3 replays of the compiled bunny config 3 step", 3,
              lambda: [c_step(bunny, acc3) for _ in range(3)]))
    for label, n, step in steps:
        step()
        torch.cuda.synchronize()
        reset_kernel_counts()
        step()
        torch.cuda.synchronize()
        counts = launch_counts("material_rows_bwd")
        if counts != {"material_rows_bwd": n}:
            raise AssertionError(f"[18 material] {label}: launches {counts}, "
                                 f"expected {n} material_rows_bwd")
        log(f"[18 material] {label}: launches {counts}")
        if label.startswith("eager bunny"):
            row["launches"] = counts["material_rows_bwd"]
    c_step.clear()
    log(f"[18 material] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return row


def shade_time(torch, parity, shade, card: str, label: str, scene, cfg, closest, carry,
               bounce: int) -> dict:
    """The fused shading of one bounce of ``carry`` bitwise against the plain
    version, then its time by events over 20 launches, the plain
    version's over 3, and its bound: per ray d, beta and the radiance in,
    alive, hit and the seed, the four [R, 3] outputs and alive (o once
    where it is the camera's broadcast origin), and the 136-byte row of
    each ray alive with a winner."""
    from mini_opencl_raytracer_tpu_torch.ops.cuda.megakernel import pack_lights
    from mini_opencl_raytracer_tpu_torch.ops.shading import build_shading_table
    o, d, beta, rad, alive, seeds = carry
    with torch.no_grad():
        hit = closest(o, d)
        st = build_shading_table(scene.geometry, scene.materials)
        lv = pack_lights(scene.lights)
        args = (hit, st.table, o, d, beta, rad, alive, seeds, bounce, lv, cfg)
        parity.check_shade(f"[19 shade] {label}", shade.shade_rows(*args),
                           shade.shade_plain(*args))
        ms = time_ms(lambda: shade.shade_rows(*args), 20)
        plain_ms = time_ms(lambda: shade.shade_plain(*args), 3)
    R, need = alive.shape[0], int((alive & hit.hit).sum().item())
    b = bound(R * (12 * 3 + 2 + 8 + 49) + (12 if o.stride(0) == 0 else 12 * R) + need * 136, 0)
    log(f"[19 shade] {label}: {R} rays, {int(alive.sum().item())} alive, {need} with a winner, "
        f"rows from {'K6' if hit.rows is not None else 'the table'}; bitwise; kernel {ms:.4f} "
        f"ms (events, 20 launches), plain {plain_ms:.3f} ms (3); bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), {b['bound_ms'] / ms:.1%} of the kernel ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound": b}


def phase19(mrt, torch, parity, dev, card: str, cam) -> dict:
    """19. The wavefront's fused shading (module docstring, phase 19).
    Returns the kernel's summary row: time at sponza 4K's bounce 0,
    launches of a compiled config 3 render's replay."""
    from mini_opencl_raytracer_tpu_torch.ops import rng
    from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build, shade
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids
    t_phase = time.perf_counter()
    for name in parity.SHADE_CASES:
        scene, cfg, closest, carry, b = parity.shade_case(name, dev)
        fused, plain, hit = parity.shade_pair(scene, cfg, closest, carry, b)
        parity.check_shade(f"[19 shade] {name}", fused, plain)
        alive = carry[4]
        log(f"[19 shade] {name}: every output bitwise hit_attributes + shade_hit; "
            f"{alive.shape[0]} rays, {alive.float().mean().item():.4f} alive, "
            f"{(alive & hit.hit).float().mean().item():.4f} alive with a winner, "
            f"{fused[4].float().mean().item():.4f} go on")
        if name.startswith("bunny"):
            shade_time(torch, parity, shade, card, name, scene, cfg, closest, carry, b)
    sponza = mrt.sponza_scene(device=dev)
    cfg5 = mrt.RenderConfig(width=3840, height=2160, bounces=1)
    closest, _ = mrt.make_intersectors(sponza, cfg5, accel=mrt.build_accel(sponza, cfg5))
    pid = _swizzled_ids(cfg5, dev)
    seeds = rng.pixel_seeds(pid, 5)
    o, d = generate_rays(cam, cfg5, pid, seeds)
    R = pid.shape[0]
    carry = (o, d, torch.ones((R, 3), device=dev), torch.zeros((R, 3), device=dev),
             torch.ones((R,), dtype=torch.bool, device=dev), seeds)
    row = shade_time(torch, parity, shade, card, "sponza 3840x2160 bounce 0", sponza, cfg5,
                     closest, carry, 0)
    del carry, o, d, seeds

    # One launch a bounce and frame in a compiled config 3 render's replays.
    bunny = mrt.bunny_scene(device=dev)
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    acc3 = mrt.build_accel(bunny, cfg3)
    with torch.no_grad():
        mrt.render(bunny, cam, cfg3, frames=4, accel=acc3)
        torch.cuda.synchronize()
        reset_kernel_counts()
        for _ in range(3):
            mrt.render(bunny, cam, cfg3, frames=4, accel=acc3)
        torch.cuda.synchronize()
    want = 3 * 4 * cfg3.bounces
    counts = launch_counts("shade")
    rays = {k: build.RAYS[k] for k in ("shade_fused", "shade_plain")}
    if counts != {"shade": want} or rays != {
            "shade_fused": want * cfg3.num_pixels, "shade_plain": 0}:
        raise AssertionError(f"[19 shade] 3 replays of the config 3 render: launches "
                             f"{counts}, rays {rays}; expected {want} launches, "
                             "every ray fused")
    log(f"[19 shade] 3 replays of the compiled config 3 render (4 frames): launches "
        f"{counts}, rays {rays}")
    row["launches"] = want // 3
    log(f"[19 shade] phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return row


def adjoint_time(torch, parity, shade, card: str, label: str, scene, cfg, closest, carry,
                 bounce: int) -> dict:
    """The shading's adjoint at one bounce of ``carry`` against its plain
    version under the gradient gates, bitwise call to call, then its device
    time (20 calls), the plain version's (events, 3 calls) and its bound:
    per ray o, d, beta, the four cotangents and the three gradients (o
    once where it is the camera's broadcast origin), alive, hit and the
    seed, and the 136-byte row and its gradient (every row's gradient is
    written)."""
    gen = torch.Generator(device=carry[0].device).manual_seed(13)
    args = parity.adjoint_inputs(scene, cfg, closest, carry, gen)
    got = shade.shade_adjoint(*args, bounce, cfg)
    again = shade.shade_adjoint(*args, bounce, cfg)
    stats = parity.check_grads(f"[20 adjoint] {label}", got,
                               shade.shade_adjoint_plain(*args, bounce, cfg), parity.SHADE_GRADS)
    for n, a, b in zip(parity.SHADE_GRADS, got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"[20 adjoint] {label}: {n} differs between two calls")
    ms = device_ms(lambda: shade.shade_adjoint(*args, bounce, cfg))
    plain_ms = time_ms(lambda: shade.shade_adjoint_plain(*args, bounce, cfg), 3)
    o, alive, hit = args[1], args[4], args[5]
    R, need = alive.shape[0], int((alive & hit).sum().item())
    b = bound(R * (12 * 9 + 2 + 8 + 136) + (12 if o.stride(0) == 0 else 12 * R) + need * 136, 0)
    log(f"[20 adjoint] {label}: {R} rays, {need} with a winner; within the gates "
        f"(max |diff| {stats['max_abs_err']:.3g}), bitwise call to call; kernel {ms:.4f} ms "
        f"(device, 20 calls), plain {plain_ms:.3f} ms (3); bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), {b['bound_ms'] / ms:.1%} of the kernel ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound": b, "err": stats["max_abs_err"]}


def phase20(mrt, torch, parity, dev, card: str, cam) -> dict:
    """20. The wavefront shading's adjoint (module docstring, phase 20).
    Returns the kernel's summary row: time at config 3's bounce 0, launches
    of a compiled config 3 step's replay."""
    from mini_opencl_raytracer_tpu_torch import grad, jit
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build, shade
    t_phase = time.perf_counter()
    row, err = None, 0.0
    for name in parity.SHADE_CASES:
        scene, cfg, closest, carry, b = parity.shade_case(name, dev)
        r = adjoint_time(torch, parity, shade, card, name, scene, cfg, closest, carry, b)
        err = max(err, r["err"])
        row = row or r
    bunny = mrt.bunny_scene(device=dev)
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    acc3 = mrt.build_accel(bunny, cfg3)
    step = jit.jit(lambda s, c, a: grad.loss_and_grads(s, c, cfg3, lambda im: im.mean(),
                                                       accel=a))
    step(bunny, cam, acc3)
    torch.cuda.synchronize()
    reset_kernel_counts()
    keys = ("shade_fused_rays", "shade_adjoint_rays", "shade_plain_rays")
    before = {k: jit.COUNTS[k] for k in keys}
    for _ in range(3):
        step(bunny, cam, acc3)
    torch.cuda.synchronize()
    R = cfg3.num_pixels
    counts = launch_counts("shade", "shade_adjoint")
    rays = {k: jit.COUNTS[k] - v for k, v in before.items()}
    want = ({"shade": 3 * 2 * cfg3.bounces, "shade_adjoint": 3 * cfg3.bounces},
            {"shade_fused_rays": 3 * 2 * cfg3.bounces * R,
             "shade_adjoint_rays": 3 * cfg3.bounces * R, "shade_plain_rays": 0})
    if (counts, rays) != want:
        raise AssertionError(f"[20 adjoint] 3 replays of the config 3 step: launches {counts}, "
                             f"rays {rays}; expected {want}")
    log(f"[20 adjoint] 3 replays of the compiled config 3 step: launches {counts}, rays {rays}")
    row = dict(row, launches=cfg3.bounces, err=err)
    log(f"[20 adjoint] phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return row


def raygen_time(torch, card: str, label: str, cfg, pid, cam) -> dict:
    """The raygen kernel on ``pid`` bitwise ``raygen_plain`` at an int and
    a tensor frame, then its device time over 20 launches (``device_ms``),
    the wrapper's and the plain version's by events (20 and 3 calls), and
    its bound: 4 B read and 20 B written a ray."""
    import ctypes
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build, megakernel, raygen
    dev = pid.device
    for fr in (5, torch.full((), 2**32 - 3, dtype=torch.int64, device=dev)):
        got, want = raygen.raygen_fused(cam, cfg, pid, fr), raygen.raygen_plain(cam, cfg, pid, fr)
        torch.cuda.synchronize()
        for name, a, b in zip(("o", "d", "seeds"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"[21 raygen] {label}: {name} differs from raygen_plain "
                                     f"at frame {fr}")
    R = pid.shape[0]
    _, d, seeds = got
    p = megakernel.params(cfg, R, 0, 0, 0)
    word, camv = megakernel.frame_word(5, dev), megakernel.camera_vector(cam)
    ms = device_ms(lambda: build.launch("raygen", dev, lambda _: (
        ctypes.addressof(p), word, camv, pid, seeds, d)))
    wrapper_ms = time_ms(lambda: raygen.camera_rays(cam, cfg, pid, 5), 20)
    plain_ms = time_ms(lambda: raygen.raygen_plain(cam, cfg, pid, 5), 3)
    b = bound(24 * R, 0)
    log(f"[21 raygen] {label}: {R} rays; o, d and seeds bitwise raygen_plain (int and tensor "
        f"frames); kernel {ms:.4f} ms (device time, 20 launches), camera_rays {wrapper_ms:.4f} "
        f"ms (events, 20 calls), plain {plain_ms:.3f} ms (3); bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}: {24 * R / 1e6:.1f} MB), {b['bound_ms'] / ms:.1%} of the kernel "
        f"({card})")
    return {"ms": ms, "plain_ms": plain_ms, "wrapper_ms": wrapper_ms, "bound": b}


def raygen_sass(against=None) -> None:
    """K1's and K3's SASS (``scripts/kernel_sass.py``): each kernel's
    instruction count in this build and, with ``against`` (the root of
    another checkout, built in its own process), whether each is the same
    instruction for instruction there."""
    import importlib.util
    from pathlib import Path
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    path = Path(__file__).resolve().parent / "scripts" / "kernel_sass.py"
    spec = importlib.util.spec_from_file_location("kernel_sass", path)
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    lib = build.build()
    for name, copies in sorted(ks.sass_text(lib, "bounce0").items()):
        log(f"[21 raygen] sass {name}: {[len(c) for c in copies]} instructions")
    if against is None:
        return
    for name, (same, a, b) in ks.compare(lib, Path(against), "bounce0").items():
        log(f"[21 raygen] sass against {against}: {name}: "
            f"{'same SASS' if same else 'SASS differs' if a and b else 'in one only'} "
            f"({a} / {b} instructions)")
        if not same:
            raise AssertionError(f"[21 raygen] {name}: SASS differs from {against}'s")


def phase21(mrt, torch, dev, card: str, cam, against=None) -> dict:
    """21. The wavefront's raygen (module docstring, phase 21). ``against``:
    the root of a checkout whose K1 / K3 SASS this build's must equal.
    Returns the kernel's summary row: time at sponza 4K's ids, launches of
    a compiled render's replay."""
    from mini_opencl_raytracer_tpu_torch import grad, jit
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids
    t_phase = time.perf_counter()
    cfg5 = mrt.RenderConfig(width=3840, height=2160, bounces=1)
    cfg3 = mrt.RenderConfig(width=512, height=512, bounces=2)
    with torch.no_grad():
        row = raygen_time(torch, card, "sponza 3840x2160", cfg5, _swizzled_ids(cfg5, dev), cam)
        raygen_time(torch, card, "config 3 512x512", cfg3, _swizzled_ids(cfg3, dev), cam)
    keys = ("raygen_fused_rays", "raygen_plain_rays")
    for name, scene, cfg in (("config 3", mrt.bunny_scene(device=dev), cfg3),
                             ("sponza 4K", mrt.sponza_scene(device=dev), cfg5)):
        acc = mrt.build_accel(scene, cfg)
        with torch.no_grad():
            mrt.render(scene, cam, cfg, frames=4, accel=acc)
            torch.cuda.synchronize()
            reset_kernel_counts()
            before = {k: jit.COUNTS[k] for k in keys}
            mrt.render(scene, cam, cfg, frames=4, accel=acc)
            torch.cuda.synchronize()
        got = (launch_counts("raygen"), {k: jit.COUNTS[k] - v for k, v in before.items()})
        want = ({"raygen": 4}, {"raygen_fused_rays": 4 * cfg.num_pixels, "raygen_plain_rays": 0})
        if got != want:
            raise AssertionError(f"[21 raygen] a replay of the {name} render: {got}, "
                                 f"expected {want}")
        log(f"[21 raygen] a replay of the compiled {name} render (4 frames): launches "
            f"{got[0]}, rays {got[1]}")
        del acc
    bunny = mrt.bunny_scene(device=dev)
    acc3 = mrt.build_accel(bunny, cfg3)
    step = jit.jit(lambda s, c, a: grad.loss_and_grads(s, c, cfg3, lambda im: im.mean(),
                                                       accel=a))
    step(bunny, cam, acc3)
    torch.cuda.synchronize()
    before = {k: jit.COUNTS[k] for k in keys}
    step(bunny, cam, acc3)
    torch.cuda.synchronize()
    rays = {k: jit.COUNTS[k] - v for k, v in before.items()}
    if rays != {"raygen_fused_rays": 0, "raygen_plain_rays": cfg3.num_pixels}:
        raise AssertionError(f"[21 raygen] a replay of the config 3 step: rays {rays}")
    log(f"[21 raygen] a replay of the compiled config 3 step: rays {rays} (the camera's "
        "gradient: PyTorch)")
    raygen_sass(against)
    row["launches"] = 4
    log(f"[21 raygen] phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return row


SHADOWS_CONFIG = "portbench/configs/bunny-1080p-b2-shadows.json"


def shadows_scene(mrt, torch, dev, width: int = 1920, height: int = 1080):
    """(scene, camera, cfg) of the configuration ``SHADOWS_CONFIG``: the
    program's ``bunny_scene`` lit by the file's light records, its camera,
    its render block at ``width`` x ``height``."""
    from pathlib import Path
    conf = json.loads((Path(__file__).resolve().parent / SHADOWS_CONFIG).read_text())
    recs = conf["scene"]["lights"]
    if any(r["type"] != "point" for r in recs):
        raise AssertionError(f"{SHADOWS_CONFIG}: point lights only, got {recs}")
    col = lambda k: torch.tensor([r[k] for r in recs], dtype=torch.float32, device=dev)
    lights = mrt.Lights(position=col("position"), direction=col("direction"),
                        light_type=torch.full((len(recs),), mrt.LIGHT_POINT,
                                              dtype=torch.int32, device=dev),
                        intensity=col("intensity"), attenuation=col("attenuation"),
                        cos_cutoff=col("cos_cutoff"))
    cam = mrt.Camera(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                        for k, v in conf["camera"].items()})
    cfg = mrt.RenderConfig(**{**conf["render"], "width": width, "height": height})
    return mrt.bunny_scene(lights=lights, device=dev), cam, cfg


def shadow_launches(mrt, torch, cl, scene, cam, cfg, acc) -> list:
    """[(cg, o, d, t_init, blocked)] of every launch of K6's any-hit mode
    in an eager ``render_sample`` of frame 0: the inputs as
    ``occluded_clustered`` hands them to ``clustered_any``, and its
    answer, in launch order (bounce by bounce, a light each)."""
    shots, real = [], cl.clustered_any

    def record(cg, o, d, t_limit, backface_cull=False, stats=None):
        blocked = real(cg, o, d, t_limit, backface_cull, stats)
        shots.append((cg, o.clone(), d.clone(), t_limit.clone(), blocked.clone()))
        return blocked

    cl.clustered_any = record
    try:
        with torch.no_grad():
            mrt.render_sample(scene, cam, cfg, frame=0, accel=acc)
    finally:
        cl.clustered_any = real
    return shots


def phase22(mrt, torch, parity, cl, dev, card: str) -> dict:
    """22. The wavefront's shadow rays at the configuration
    bunny-1080p-b2-shadows' shape (module docstring, phase 22). Returns
    K6's any-hit device ms a launch at bounce 0 and 1 (light 0) and the
    counts of a replay."""
    from mini_opencl_raytracer_tpu_torch import jit
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    t_phase = time.perf_counter()
    scene, cam, cfg = shadows_scene(mrt, torch, dev)
    R, L, frames = cfg.num_pixels, scene.lights.count, 4
    if (scene.num_triangles, L, mrt.resolve_backend(scene, cfg)) != (69_732, 2, "pallas"):
        raise AssertionError(f"[22 shadows] the scene: {scene.num_triangles} triangles, "
                             f"{L} lights, backend {mrt.resolve_backend(scene, cfg)}")
    acc = mrt.build_accel(scene, cfg)
    shots = shadow_launches(mrt, torch, cl, scene, cam, cfg, acc)
    if [s[1].shape[0] for s in shots] != [R] * (L * cfg.bounces):
        raise AssertionError(f"[22 shadows] any-hit launches of a sample: "
                             f"{[s[1].shape[0] for s in shots]}, expected {L * cfg.bounces} "
                             f"of {R} rays")
    ms = {}
    for i, (cg, o, d, t, blocked) in enumerate(shots):
        b, light = divmod(i, L)
        label = f"[22 shadows] bounce {b} light {light}"
        plain = cl.run_clustered_plain(cg, o, d, t, cfg.backface_cull)[1] >= 0
        again = cl.clustered_any(cg, o, d, t, cfg.backface_cull)
        torch.cuda.synchronize()
        st = parity.check_any(label, blocked, plain)
        parity.check_any(label + " (a second launch)", again, plain)
        if light == 0:
            ms[b] = device_ms(lambda: cl.clustered_any(cg, o, d, t, cfg.backface_cull))
        log(f"{label}: {o.shape[0]} rays, occlusion bitwise run_clustered_plain's (and a "
            f"second launch's), blocked {st['blocked_frac']:.4f}, limits finite "
            f"{torch.isfinite(t).float().mean().item():.4f}"
            + (f"; {ms[b]:.4f} ms (device time, 20 launches), "
               f"{ms[b] * 1e6 / o.shape[0]:.4f} ns a ray ({card})" if light == 0 else ""))
    del shots
    with torch.no_grad():
        mrt.render(scene, cam, cfg, frames=frames, accel=acc)
        torch.cuda.synchronize()
        reset_kernel_counts()
        before = dict(jit.COUNTS)
        mrt.render(scene, cam, cfg, frames=frames, accel=acc)
        torch.cuda.synchronize()
    n = cfg.bounces * frames
    kinds = ("clustered_closest", "clustered_any", "shade_plain", "shade_fused", "wave_shadow")
    want_rays = {"clustered_closest": R * n, "clustered_any": R * L * n, "shade_plain": R * n,
                 "shade_fused": 0, "wave_shadow": R * L * n}
    got = (launch_counts("clustered_closest", "clustered_any"),
           {k: build.RAYS[k] for k in kinds},
           {k: jit.COUNTS[k + "_rays"] - before[k + "_rays"] for k in kinds},
           jit.COUNTS["replays"] - before["replays"])
    want = ({"clustered_closest": n, "clustered_any": L * n}, want_rays, want_rays, 1)
    if got != want:
        raise AssertionError(f"[22 shadows] a replay of the compiled render: {got}, "
                             f"expected {want}")
    log(f"[22 shadows] a replay of the compiled render ({frames} frames, counts zeroed "
        f"before): launches {got[0]}, rays {got[1]} (build.RAYS and jit.COUNTS alike)")
    log(f"[22 shadows] phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return {"any_ms": ms, "launches": got[0], "rays": got[1]}


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
    from mini_opencl_raytracer_tpu_torch.render import _render_compiled, _swizzled_ids

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
            k1, p1, err = k2_exact(f"bounce_fwd (bounce {b}), {label}", torch, mk, parity,
                                   table, tris, lv, state, b, cfg)
            max_err["bounce_fwd"] = max(max_err["bounce_fwd"], err)
            state = (p1[0], p1[1], p1[2], p1[3], k0[7])

    # 3, K2's edge cases, bitwise (parity.K2_CASES: the alive masks and
    # shuffled ids at the main path's 1920x1080, the prefixes R = 1, 255,
    # 257 of the shuffled state, 30 lights with shadow rays and backface
    # culling with soft edges at 960x540), then the adversarial rays of
    # parity.cull_ray_sets, every ray alive, at the limit 3e38.
    k2_cases = [(f"{name}, {w}x{h}",) + parity.k2_case(name, dev, w, h)
                for name in parity.K2_CASES
                for w, h in [(960, 540) if name in ("30 lights + shadow rays",
                                                   "backface_cull + soft_edge") else (1920, 1080)]]
    for label, scene2, cfg2, state2, b2 in k2_cases + parity.k2_ray_set_cases(dev):
        table, tris, lv = mk._tables(scene2, cfg2, None)
        err = k2_exact(f"bounce_fwd, {label}", torch, mk, parity, table, tris, lv, state2, b2,
                       cfg2)[2]
        max_err["bounce_fwd"] = max(max_err["bounce_fwd"], err)

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
        # The first call runs eagerly and captures (jit.py); the measured
        # call replays.
        mrt.render(scene, cam, cfg, frames=frames)
        torch.cuda.synchronize()
        reset_kernel_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = mrt.render(scene, cam, cfg, frames=frames)
        end.record()
        torch.cuda.synchronize()
    launches = launch_counts(*MEGA)
    ms_frame = start.elapsed_time(end) / frames
    log(f"[5 forward] launches {launches}")
    expect = dict(dict.fromkeys(MEGA, 0), bounce0_fwd=frames,
                  bounce_fwd=frames * (cfg.bounces - 1))
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
    # By device time, as the backward kernels below: on a loaded host a
    # wrapper's Python outlasts its kernel, and events would time the host.
    times = {
        "bounce0_fwd": (
            device_ms(lambda: mk.bounce0_fwd(table, tris, lv, camv, main_ids, 0, cfg)),
            time_ms(lambda: mk.bounce0_fwd_plain(table, tris, lv, camv, main_ids, 0, cfg), 3)),
        "bounce_fwd": (
            device_ms(lambda: mk.bounce_fwd(table, tris, lv, *state, 1, cfg)),
            time_ms(lambda: mk.bounce_fwd_plain(table, tris, lv, *state, 1, cfg), 3)),
    }

    # K2 at each bounce 1-8 of the main step, from the carried state (the
    # kernels' own outputs): device time, the bound by ray class
    # (fwd_bytes; operations: 45 flops for each pair of a live ray that
    # meets a triangle below the limit), and how the rays fill its warps.
    k2_states, st = [], state
    for b in range(1, cfg.bounces):
        k2_states.append(st)
        out = mk.bounce_fwd(table, tris, lv, *st, b, cfg)
        st = (out[0], out[1], out[2], out[3], st[4])
    lim2 = torch.full((main_ids.numel(),), min(cfg.t_max, 3.0e38), device=dev)
    k2_tab = table.numel() * 4 + tris.numel() * 4 + lv.numel() * 4
    k2_bounds, k2_ms = [], []
    for b, st in enumerate(k2_states, 1):
        k2_ms.append(device_ms(lambda: mk.bounce_fwd(table, tris, lv, *st, b, cfg)))
        need = hit_pairs(torch, tris, st[0].T, st[1].T, lim2, cfg.backface_cull, st[3] > 0)
        nb = fwd_bytes(st[3]) + k2_tab
        k2_bounds.append(bound(nb, need * MT_FLOPS))
        u = lane_use(torch, st[3], K2_TILE)
        log(f"[5/6 K2] bounce {b}: {k2_ms[-1]:.4f} ms (device time); live "
            f"{u['live']:.4f}; warps with a live lane {u['warps_before']:.4f} (one thread a "
            f"ray) -> warps run {u['warps_now']:.4f} (packed per tile); lane use "
            f"{u['use_before']:.4f} -> {u['use_now']:.4f}; {nb / 1e6:.2f} MB, {need} pairs "
            f"meet; bound {k2_bounds[-1]['bound_ms']:.4f} ms ({k2_bounds[-1]['bound_by']}), "
            f"{k2_bounds[-1]['bound_ms'] / k2_ms[-1]:.1%} of the kernel ({card})")
    log(f"[5/6 K2] bounces 1-8: {sum(k2_ms):.4f} ms (device time), bound "
        f"{sum(x['bound_ms'] for x in k2_bounds):.4f} ms ({card})")

    # 6. The training step: loss and gradients w.r.t. every float leaf of
    # the scene and the camera, Cornell 1080p x 9 bounces.
    loss_fn = lambda im: im.mean()
    grad.loss_and_grads(scene, cam, cfg, loss_fn)  # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    loss, g_scene, g_cam = grad.loss_and_grads(scene, cam, cfg, loss_fn)
    torch.cuda.synchronize()
    per_step = launch_counts(*MEGA)
    log(f"[6 train] launches per step {per_step}; loss {loss.item():.6f}")
    expect = dict(dict.fromkeys(MEGA, 0), bounce0_fwd=1, bounce_fwd=8, bounce0_bwd=1,
                  bounce_bwd=8)
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
    reset_kernel_counts()
    start.record()
    for _ in range(steps):
        grad.loss_and_grads(scene, cam, cfg, loss_fn)
    end.record()
    torch.cuda.synchronize()
    launches = launch_counts(*MEGA)
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
            f"(device time), plain {p_ms:.3f} ms "
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
             "bounce_fwd": bound(fwd_bytes(b0[3]) + tab_bytes, alive1 * T_main * MT_FLOPS)}
    bounds = {"bounce0_fwd": bound(R_main * (4 + 64) + tab_bytes, need0 * MT_FLOPS),
              "bounce_fwd": bound(fwd_bytes(b0[3]) + tab_bytes, need1 * MT_FLOPS),
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
    launches = {k: launches[k] for k in MEGA}

    # 8. K5 against its plain version: the 1080p Cornell wavefront's
    # primary, bounce-1 and shadow rays, then 512x512 with culling.
    cornell = scene
    tri_k5 = panel.pack_triangles(cornell.geometry)
    max_err["panel"] = 0.0
    for label, cfg8 in (("1920x1080", main_cfg),
                        ("512x512 backface_cull", mrt.RenderConfig(backface_cull=True))):
        cull = cfg8.backface_cull
        rays_b = parity.wavefront_rays(cornell, cam, cfg8,
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
        rays_c = parity.wavefront_rays(sc, cam, cfg3,
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
            mrt.render(cornell, cam, cfg_p, frames=frames)  # warm-up and capture
            mrt.render(cornell, cam, cfg_b, frames=frames)
            torch.cuda.synchronize()
            reset_kernel_counts()
            ms_p = events_ms(lambda: mrt.render(cornell, cam, cfg_p, frames=frames), frames)
            counts = launch_counts("panel_closest", "panel_any")
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
        mrt.render(bunny, cam, cfg3, frames=frames, accel=acc3)  # warm-up and capture
        mrt.render(bunny, cam, dataclasses.replace(cfg3, sort_rays=False), frames=frames,
                   accel=acc3)
        torch.cuda.synchronize()
        reset_kernel_counts()
        img3 = None

        def run3():
            nonlocal img3
            img3 = mrt.render(bunny, cam, cfg3, frames=frames, accel=acc3)

        ms3 = events_ms(run3, frames)
        path_a = launch_counts("clustered_closest", "clustered_any")
        cfg3u = dataclasses.replace(cfg3, sort_rays=False)
        img3u = None

        def run3u():
            nonlocal img3u
            img3u = mrt.render(bunny, cam, cfg3u, frames=frames, accel=acc3)

        ms3u = events_ms(run3u, frames)
    expect = {"clustered_closest": frames * cfg3.bounces, "clustered_any": 0}
    log(f"[11 path A] config 3 (bunny 512x512x2, SAH accel, 4 frames): launches {path_a}")
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
            mrt.render(sc, cam, cfg_a, frames=n, accel=acc)  # warm-up and capture
            torch.cuda.synchronize()
            ms = events_ms(lambda: mrt.render(sc, cam, cfg_a, frames=n, accel=acc), n)
        log(f"[11 path A] {name}: {ms:.3f} ms/frame, "
            f"{cfg_a.num_pixels * cfg_a.bounces / ms / 1e3:.2f} Mrays/s ({n} frames; {card})")
    _render_compiled.clear()   # the 1080p and 4K graphs' memory

    # 12. Path C: gradients through the wavefront on K6 at config 3.
    grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc3)  # warm-up
    torch.cuda.synchronize()
    steps_c = 3
    out_c = []
    reset_kernel_counts()
    ms_c = events_ms(lambda: out_c.extend(
        grad.loss_and_grads(bunny, cam, cfg3, loss_fn, accel=acc3) for _ in range(steps_c)),
        steps_c)
    # With remat (the default) the backward recomputes each bounce, K6
    # included: twice the forward's launches.
    expect = {"clustered_closest": steps_c * cfg3.bounces * 2, "clustered_any": 0}
    path_c = launch_counts("clustered_closest", "clustered_any")
    if path_c != expect:
        raise AssertionError(f"path C launches {path_c}, expected {expect}")
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
    big_rays = parity.wavefront_rays(sponza, cam,
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

    # 14. The shell on the card, and the LBVH walk kernel.
    row = phase14(mrt, torch, parity, cl, dev, card, ms_frame)
    times["bvh_walk"] = (row["ms"], row["plain_ms"])
    bounds["bvh_walk"] = row["bound"]
    max_err["bvh_walk"] = row["max_abs_err"]

    # 15. The parallel paths on the card.
    phase15(mrt, torch, parity, grad, dev, card, cam, cornell, bunny, sponza, accels, ms_step)

    # 16. The compiled programs against eager.
    launches["bvh_walk"] = phase16(mrt, torch, grad, dev, card, cam, cornell, bunny, acc3,
                                   main_cfg, cfg3)["bvh_walk"]

    # 17. The backward's two modes: remat and the residual variants.
    for name, r in phase17(mrt, torch, grad, parity, mk, rng, dev, card, cam, cornell, bunny,
                           sponza, accels, main_cfg, main_ids).items():
        launches[name] = r["launches"]
        max_err[name] = r["err"]
        times[name] = (r["ms"], r["plain_ms"])
        bounds[name] = r["bound"]

    # 18. The material gather's backward.
    r = phase18(mrt, torch, grad, dev, card, cam, cornell, bunny, acc3, cfg3, main_cfg)
    launches["material_rows_bwd"] = r["launches"]
    max_err["material_rows_bwd"] = r["err"]
    times["material_rows_bwd"] = (r["ms"], r["plain_ms"])
    bounds["material_rows_bwd"] = r["bound"]
    library = {"material_rows_bwd": r["library_ms"]}

    # 19. The wavefront's fused shading.
    r = phase19(mrt, torch, parity, dev, card, cam)
    launches["shade"] = r["launches"]
    max_err["shade"] = 0.0
    times["shade"] = (r["ms"], r["plain_ms"])
    bounds["shade"] = r["bound"]

    # 20. The wavefront shading's adjoint.
    r = phase20(mrt, torch, parity, dev, card, cam)
    launches["shade_adjoint"] = r["launches"]
    max_err["shade_adjoint"] = r["err"]
    times["shade_adjoint"] = (r["ms"], r["plain_ms"])
    bounds["shade_adjoint"] = r["bound"]

    # 21. The wavefront's raygen.
    r = phase21(mrt, torch, dev, card, cam)
    launches["raygen"] = r["launches"]
    max_err["raygen"] = 0.0
    times["raygen"] = (r["ms"], r["plain_ms"])
    bounds["raygen"] = r["bound"]

    # 22. The wavefront's shadow rays at bunny-1080p-b2-shadows' shape.
    phase22(mrt, torch, parity, cl, dev, card)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
         "library_ms": library.get(name)}
        for name in KERNELS]}))
    log(f"[done] chip_smoke.py in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2]))
    sys.exit(main())
