"""Reductions that several metric files share (each metric's file,
``metrics/<name>.py``, picks one)."""

from __future__ import annotations


def rate(ctx) -> float:
    """Rays of every call completed in the window over its seconds."""
    return ctx.rays_per_call * ctx.calls / ctx.window_s


def graph_launch_idle_ms(ctx):
    """Per call: ms in which the device is idle while the host is inside
    ``cudaGraphLaunch``, the CUDA runtime call that starts a compiled
    program's replay; None where nothing replayed."""
    tr = ctx.trace
    if tr is None or tr.calls == 0 or not any(n == "cudaGraphLaunch" for n, _, _ in tr.host):
        return None
    return tr.idle_inside("cudaGraphLaunch") / tr.calls * 1e3


def torch_ops_ms(ctx):
    """Per call: device ms of everything that is not one of the program's
    own CUDA kernels (PyTorch's elementwise kernels, reductions, copies)."""
    tr = ctx.trace
    if tr is None or tr.calls == 0 or tr.busy_s <= 0:
        return None
    return tr.other_seconds(ctx.program_kernels) / tr.calls * 1e3


def device_idle_pct(ctx):
    """100 x (1 - busy / wall) over the traced window."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(ctx, kernel_seconds: float, launches):
    """100 x least time / kernel time, with (bound by, power limit) as a
    note; None where the kernel did not run."""
    from . import peaks
    if kernel_seconds <= 0:
        return None
    least, by = peaks.least_time_of(launches)
    return 100.0 * least / kernel_seconds, {"bound_by": by,
                                            "power_limit_w": getattr(ctx, "power_limit_w", None),
                                            "least_ms": least * 1e3,
                                            "kernel_ms": kernel_seconds * 1e3}
