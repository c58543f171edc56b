"""Kernels: K6's any-hit launches' device time per ray handed to them, in
a render cell with shadow rays: the device time of the any-hit instances
of ``clustered_kernel`` (``clustered_kernel<true>``, told apart from the
closest-hit ``<false>`` by name in the trace; work/k6_any.py) per image,
from the trace of the compiled render, over the rays the program handed
K6's any-hit mode per replay (``jit.COUNTS`` ``clustered_any_rays``:
what the capture counted from the launches' shapes, added by every
replay), in ns. The note gives those rays per call and the shadow-ray
slots the wavefront's light loop handed its any-hit intersector per call
(``wave_shadow_rays``, where the program keeps that count); the
closest-hit launches are k6_closest_ns_per_ray.render's. None where the
program keeps no such count, or where nothing replayed or no any-hit
launch ran."""

from portbench.harness import spans


def read(ctx):
    c, tr = spans.counts(), ctx.trace
    if c is None or not c.get("replays") or not c.get("clustered_any_rays"):
        return None
    if tr is None or tr.calls == 0:
        return None
    work = ctx.cell.work("k6_any")
    rays = c["clustered_any_rays"] / c["replays"]
    seconds = work.seconds(tr, True) / tr.calls
    if seconds <= 0:
        return None
    note = {"clustered_any_rays_per_call": rays}
    if "wave_shadow_rays" in c:
        note["wave_shadow_rays_per_call"] = c["wave_shadow_rays"] / c["replays"]
    return seconds / rays * 1e9, note
