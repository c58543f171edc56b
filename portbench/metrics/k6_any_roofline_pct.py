"""Kernels: K6's any-hit launches' share of their roofline in an image:
the least time of an image's any-hit launches (work/k6_any.py, from the
shapes and the reference's ray classes) over the device time of the
any-hit instances of ``clustered_kernel`` (``clustered_kernel<true>``)
per image, from the trace of the compiled render."""

from portbench.harness.readers import roofline_pct


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    work = ctx.cell.work("k6_any")
    t = work.seconds(ctx.trace, True) / ctx.trace.calls
    return roofline_pct(ctx, t, work.count(ctx))
