"""Kernels: K1 / K2's device time per ray handed to them, in a render
cell: the device time of ``bounce0_fwd_kernel`` and ``bounce_fwd_kernel``
per image, from the trace of the compiled render, over the rays the
program handed K1 / K2 per replay, in ns. The rays come from the
program's ``jit.COUNTS`` (``mega_fwd_rays``: what the capture counted
from the launches' shapes, added by every replay), so the eager warm-up
does not dilute them; the note gives them per call, and the shadow rays'
any-hit slots per call (``mega_shadow_rays``: the rays times the lights
of each launch that casts shadow rays). None where the program keeps no
such count, as one from before it does not, or where nothing replayed
or K1 / K2 did not run."""

from portbench.harness import spans

KERNELS = ("bounce0_fwd_kernel", "bounce_fwd_kernel")


def read(ctx):
    c, tr = spans.counts(), ctx.trace
    if c is None or not c.get("replays") or "mega_fwd_rays" not in c:
        return None
    if tr is None or tr.calls == 0:
        return None
    rays = c["mega_fwd_rays"] / c["replays"]
    seconds = tr.kernel_seconds(KERNELS) / tr.calls
    if seconds <= 0 or rays <= 0:
        return None
    return seconds / rays * 1e9, {"mega_fwd_rays_per_call": rays,
                                  "mega_shadow_rays_per_call":
                                      c.get("mega_shadow_rays", 0) / c["replays"]}
