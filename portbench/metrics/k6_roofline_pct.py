"""Kernels: K6's share of its roofline in an image: the least time of its
launches (work/k6.py, from the shapes and the reference's rays) over the
device time of ``clustered_kernel`` per image, from the trace of the
compiled render."""

from portbench.harness.readers import roofline_pct


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    t = ctx.trace.kernel_seconds(["clustered_kernel"]) / ctx.trace.calls
    return roofline_pct(ctx, t, ctx.cell.work("k6").count(ctx))
