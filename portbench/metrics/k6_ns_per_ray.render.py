"""Kernels: K6's device time per ray handed to it, in the render cells:
the device time of ``clustered_kernel`` per image, from the trace of the
compiled render, over the rays the program handed K6 per replay, in ns.
The rays come from the program's ``jit.COUNTS`` (``clustered_closest_rays``
and ``clustered_any_rays``: what the capture counted from the launches'
shapes, added by every replay), so the eager warm-up does not dilute
them; the closest-hit and any-hit rays per call are the note. None where
the program keeps no such count, as one from before it does not, or
where nothing replayed or K6 did not run."""

from portbench.harness import spans

KINDS = ("clustered_closest", "clustered_any")


def read(ctx):
    c, tr = spans.counts(), ctx.trace
    keys = [k + "_rays" for k in KINDS]
    if c is None or not c.get("replays") or any(k not in c for k in keys):
        return None
    if tr is None or tr.calls == 0:
        return None
    rays = {k: c[k] / c["replays"] for k in keys}
    seconds = tr.kernel_seconds(["clustered_kernel"]) / tr.calls
    if seconds <= 0 or sum(rays.values()) <= 0:
        return None
    return seconds / sum(rays.values()) * 1e9, {k + "_per_call": v for k, v in rays.items()}
