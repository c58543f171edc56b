"""Readers of the compiled-program layer's own spans and counts.

The program's compiled calls (its ``jit`` module) open host ranges named
``mrt.jit.*`` in the profiler's trace and keep ``COUNTS``, a dict of
plain numbers that the run reads after its window from the module that
``run.py`` loaded from the checkout (``sys.modules``; nothing is
imported here). Each reader returns None where the program has neither,
as a program from before them has not.
"""

from __future__ import annotations

import sys

PROGRAM = "mini_opencl_raytracer_tpu_torch"
# The replay's host work around the graph's launch; the three do not overlap.
HOST = ("mrt.jit.key", "mrt.jit.copy_in", "mrt.jit.outputs")
# A key's first call and a call run without a graph: none in a steady window.
FIRST = ("mrt.jit.warmup", "mrt.jit.capture", "mrt.jit.eager")


def counts():
    """The program's ``jit.COUNTS``, or None."""
    found = getattr(sys.modules.get(PROGRAM + ".jit"), "COUNTS", None)
    return found if isinstance(found, dict) else None


def host_idle_ms(ctx):
    """Per call: ms in which the device is idle while the host is inside
    the replay's key, copy-in or outputs spans, with the split by span and
    the count of first-call and eager spans in the window as a note; None
    without the spans or without device work."""
    tr = ctx.trace
    if tr is None or tr.calls == 0 or tr.busy_s <= 0:
        return None
    if not any(n.startswith("mrt.jit.") for n, _, _ in tr.host):
        return None
    split = {n.rsplit(".", 1)[1] + "_ms": tr.idle_inside(n) / tr.calls * 1e3 for n in HOST}
    first = sum(1 for n, _, _ in tr.host if n in FIRST)
    return sum(split.values()), {**split, "first_call_and_eager_spans": first}


def copy_in_mib(ctx):
    """MiB copied into a graph's static inputs per replay, over every
    replay of the run, with the tensors per replay as a note."""
    c = counts()
    if c is None or not c.get("replays"):
        return None
    n = c["replays"]
    return c["copy_in_bytes"] / n / 2**20, {"leaves_per_replay": c["copy_in_leaves"] / n,
                                            "replays": n}


def first_call_s(kind: str):
    """A reader of ``COUNTS[kind + "_s"]``, the host seconds of the keys'
    warm-ups or captures, with their number as a note."""
    def read(ctx):
        c = counts()
        if c is None or not c.get(kind + "s"):
            return None
        return c[kind + "_s"], {kind + "s": c[kind + "s"]}
    return read
