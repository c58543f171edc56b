"""Kernels: K6's closest-hit launches' device time per ray handed to them,
in a render cell that also runs K6's any-hit mode: the device time of the
closest-hit instances of ``clustered_kernel`` (``clustered_kernel<false>``,
told apart from the any-hit ``<true>`` by name in the trace;
work/k6_any.py) per image, from the trace of the compiled render, over the
rays the program handed K6's closest-hit mode per replay (``jit.COUNTS``
``clustered_closest_rays``), in ns; the note gives those rays per call.
None where the program keeps no such count, or where nothing replayed or
no closest-hit launch ran."""

from portbench.harness import spans


def read(ctx):
    c, tr = spans.counts(), ctx.trace
    if c is None or not c.get("replays") or not c.get("clustered_closest_rays"):
        return None
    if tr is None or tr.calls == 0:
        return None
    rays = c["clustered_closest_rays"] / c["replays"]
    seconds = ctx.cell.work("k6_any").seconds(tr, False) / tr.calls
    if seconds <= 0:
        return None
    return seconds / rays * 1e9, {"clustered_closest_rays_per_call": rays}
