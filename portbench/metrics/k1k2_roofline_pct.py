"""Kernels: K1 / K2's share of their roofline in an image: the least time
of their launches (work/k1k2.py, from the shapes and the reference's
rays) over the device time of ``bounce0_fwd_kernel`` and
``bounce_fwd_kernel`` per image, from the trace of the compiled render."""

from portbench.harness.readers import roofline_pct

KERNELS = ("bounce0_fwd_kernel", "bounce_fwd_kernel")


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    t = ctx.trace.kernel_seconds(KERNELS) / ctx.trace.calls
    return roofline_pct(ctx, t, ctx.cell.work("k1k2").count(ctx))
