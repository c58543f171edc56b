"""Timing and throughput metrics (the JAX package's ``utils/metrics.py``).

Replaces the reference's clock()-based FPS counter (CLEngineBase.cpp:
193-196). A call's time is taken with CUDA events when its output lies on
a CUDA device (PyTorch returns before the card finishes, so a host clock
would time the enqueue) and with ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..config import default_device
from ..jit import flatten, jit


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _on_cuda(out) -> bool:
    t = _first_tensor(out)
    return t is not None and t.device.type == "cuda"


def _seconds(call: Callable[[], Any], cuda: bool) -> float:
    """Seconds of one call, the device finished."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    call()
    return time.perf_counter() - t0


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def time_fn(f: Callable[..., Any], iters: int = 5, warmup: int = 1) -> float:
    """Median seconds per call of ``f``, the device finished.

    ``f`` is called with the iteration index if it takes an argument
    (feed it into the work, e.g. as the frame seed, so calls differ).
    The first warm-up call's output says where the work runs (CUDA events
    if it holds a CUDA tensor); at least one warm-up call is made."""
    import inspect

    try:
        inspect.signature(f).bind(0)
        call = f
    except TypeError:
        call = lambda i: f()
    cuda = _on_cuda(call(1_000_000))
    for w in range(1, warmup):
        call(1_000_000 + w)
    return _median(_seconds(lambda: call(i), cuda) for i in range(iters))


def _frames(f: Callable[..., Any], inner: int, base: torch.Tensor, data: Any):
    tot = None
    for k in range(inner):
        fr = (base + k) & 0xFFFFFFFF
        v = f(fr) if data is None else f(fr, data)
        tot = v if tot is None else tot + v
    return tot


def _base_device(base, data) -> torch.device:
    if isinstance(base, torch.Tensor):
        return base.device
    leaves, _ = flatten(data)
    return leaves[0].device if leaves else default_device()


def scan_frames(f: Callable[..., Any], inner: int) -> Callable[..., Any]:
    """``inner`` distinct frames of a scalar-returning ``f(frame)`` (or
    ``f(frame, data)``) as one call ``batched(base, data=None)`` that
    returns the sum of their scalars: the JAX package's ``lax.scan``, here
    one compiled program (jit.py) of the ``inner`` frames. Frame k is
    ``base + k`` (mod 2**32), a 0-d int64 tensor computed on the device
    from one device ``base``, so every call's frames are distinct without
    a new capture. ``base`` is an int or a 0-d integer tensor; an int goes
    to the device of ``data``'s tensors (the default device without
    any)."""
    program = jit(functools.partial(_frames, f, inner))

    def batched(base, data=None):
        if not isinstance(base, torch.Tensor):
            base = torch.full((), int(base) & 0xFFFFFFFF, dtype=torch.int64,
                              device=_base_device(base, data))
        return program(base.to(torch.int64), data)

    return batched


def time_scan_fn(f: Callable[..., Any], inner: int = 8, iters: int = 5,
                 warmup: int = 1, data: Any = None) -> float:
    """Median seconds per FRAME of ``f`` (see ``scan_frames``): each sample
    times one call of ``inner`` distinct frames (on CUDA a replay of the
    compiled program) and divides by ``inner``; distinct bases keep every
    frame's arguments unique."""
    batched = scan_frames(f, inner)
    sec = time_fn(lambda i: batched((7919 * (i + 1)) & 0xFFFFFFFF, data),
                  iters=iters, warmup=warmup)
    return sec / inner


def time_scan_slope(f: Callable[..., Any], inner_lo: int = 8, inner_hi: int = 40,
                    iters: int = 5, data: Any = None) -> float:
    """Marginal seconds per frame of ``f``: the slope between ``inner_lo``
    and ``inner_hi`` frames a call (two compiled programs, replayed),
    median over ``iters`` interleaved (lo, hi) pairs. The constant cost of
    a call (the first launch's latency, the final synchronisation)
    cancels."""
    b_lo, b_hi = scan_frames(f, inner_lo), scan_frames(f, inner_hi)
    cuda = _on_cuda(b_lo(7, data))
    b_hi(11, data)
    slopes = []
    for i in range(iters):
        t_lo = _seconds(lambda: b_lo(7919 * (2 * i + 1), data), cuda)
        t_hi = _seconds(lambda: b_hi(7919 * (2 * i + 2), data), cuda)
        slopes.append((t_hi - t_lo) / (inner_hi - inner_lo))
    return _median(slopes)


@torch.no_grad()
def bounce_occupancy(scene, camera, cfg, frame: int = 0) -> torch.Tensor:
    """Per-bounce live-ray fractions [bounces]: how much of each bounce's
    lockstep work is spent on dead lanes. Runs the wavefront integrator
    with stats on the configured wavefront backend (``mega`` resolves to
    ``pallas``), rays in scanline order."""
    from ..ops.cuda.raygen import camera_rays
    from ..ops.integrator import trace_paths
    from ..render import make_intersectors

    closest, any_hit = make_intersectors(scene, cfg)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32, device=scene.device)
    o, d, seeds = camera_rays(camera.to(scene.device), cfg, pix, frame)
    _, stats = trace_paths(scene, cfg, o, d, seeds, closest, any_hit, with_stats=True)
    return stats


def render_metrics(seconds_per_frame: float, width: int, height: int,
                   bounces: int, spp: int = 1) -> Dict[str, float]:
    """Structured throughput record for one render configuration; 'rays'
    counts one ray per pixel per bounce per sample (CLRaytracer.cpp:53
    extended to bounces)."""
    rays = width * height * bounces * spp
    return {
        "seconds_per_frame": seconds_per_frame,
        "fps": 1.0 / seconds_per_frame,
        "rays_per_frame": float(rays),
        "rays_per_second": rays / seconds_per_frame,
        "mrays_per_second": rays / seconds_per_frame / 1e6,
    }
