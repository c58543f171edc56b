"""Kernels: K4's share of its roofline in a training step: the least time
of its launches (work/k4.py, from the reference's ray classes) over the
device time of ``bounce_bwd_kernel`` and the ``finish_kernel`` launch that
follows each, per step, from the trace of the compiled step."""

from portbench.harness.readers import roofline_pct


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    t = ctx.trace.kernel_seconds(["bounce_bwd_kernel"], then="finish_kernel") / ctx.trace.calls
    return roofline_pct(ctx, t, ctx.cell.work("k4").count(ctx))
