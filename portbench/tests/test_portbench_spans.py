"""The readers of the compiled-program layer's spans and counts
(harness/spans.py) on synthetic traces and counts: the idle inside the
replay's key, copy-in and outputs spans, and nothing else; None on a
trace without the spans and where the program keeps no ``COUNTS``, as a
program from before them does."""

import sys
import types
from pathlib import Path

import pytest

from portbench.harness import cell as cells
from portbench.harness import spans
from portbench.harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
JIT = spans.PROGRAM + ".jit"

# Two calls of 100 ns. In each: the compiled call 0-60 (key 2-10, copy-in
# 10-20 holding an aten::copy_ 12-18, launch 20-30 holding cudaGraphLaunch,
# outputs 30-40), then the loss read and the update 60-100.
HOST = [(name, a + off, b + off) for off in (0, 100) for name, a, b in (
    ("portbench.call", 0, 100), ("mrt.jit.call", 0, 60), ("mrt.jit.key", 2, 10),
    ("mrt.jit.copy_in", 10, 20), ("aten::copy_", 12, 18), ("mrt.jit.launch", 20, 30),
    ("cudaGraphLaunch", 21, 29), ("mrt.jit.outputs", 30, 40), ("aten::item", 60, 100))]
# The device: busy 5-8 (inside the key), 14-16 (inside the copy), 25-50
# (the graph, past the outputs' end) and 80-90; idle everywhere else.
DEVICE = [(k, a + off, b + off) for off in (0, 100) for k, a, b in (
    ("fill", 5, 8), ("copy", 14, 16), ("void bounce_fwd_kernel<128>(P)", 25, 50),
    ("sum", 80, 90))]


def _ctx(trace):
    return types.SimpleNamespace(trace=trace)


def test_host_idle_sums_the_three_spans_alone():
    """Idle inside key (2-5, 8-10), copy-in (10-14, 16-20) and outputs
    (none: the graph runs past it): 13 ns a call; the launch's idle
    (20-25) and the host's after the call are not counted."""
    tr = Trace(DEVICE, HOST, calls=2)
    value, note = spans.host_idle_ms(_ctx(tr))
    assert value == pytest.approx(13e-6)
    assert note["key_ms"] == pytest.approx(5e-6)
    assert note["copy_in_ms"] == pytest.approx(8e-6)
    assert note["outputs_ms"] == 0
    assert note["first_call_and_eager_spans"] == 0
    # The launch's idle (graph_launch_idle_ms reads it) is there, and left out.
    assert tr.idle_inside("mrt.jit.launch") * 1e9 == pytest.approx(2 * 5)
    warm = HOST + [("mrt.jit.warmup", 41, 42), ("mrt.jit.capture", 42, 43)]
    assert spans.host_idle_ms(_ctx(Trace(DEVICE, warm, calls=2)))[1][
        "first_call_and_eager_spans"] == 2


def test_host_idle_is_none_without_the_spans_or_the_device():
    parent = [r for r in HOST if not r[0].startswith("mrt.jit.")]
    assert spans.host_idle_ms(_ctx(Trace(DEVICE, parent, calls=2))) is None
    assert spans.host_idle_ms(_ctx(Trace([], HOST, calls=2))) is None
    assert spans.host_idle_ms(_ctx(None)) is None


COUNTS = {"replays": 4, "copy_in_bytes": 4 * 3 * 2**20, "copy_in_leaves": 4 * 7,
          "warmups": 1, "warmup_s": 2.5, "captures": 1, "capture_s": 0.75, "eager": 0}


@pytest.mark.parametrize("program", ["counts", "no_counts", "not_loaded", "no_replay"])
def test_counter_readers(monkeypatch, program):
    """COUNTS read from the program's loaded jit module; None where the
    module keeps none (the parent), is not loaded, or nothing replayed."""
    if program == "not_loaded":
        monkeypatch.delitem(sys.modules, JIT, raising=False)
    else:
        jit = types.ModuleType(JIT)
        if program == "counts":
            jit.COUNTS = dict(COUNTS)
        elif program == "no_replay":
            jit.COUNTS = dict.fromkeys(COUNTS, 0) | {"eager": 5}
        monkeypatch.setitem(sys.modules, JIT, jit)
    ctx = _ctx(None)
    readers = {n: cells.load_module(ROOT / "portbench" / "metrics" / f"{n}.py").read
               for n in ("jit_copy_in_mib.train", "jit_copy_in_mib.render", "jit_warmup_s",
                         "jit_capture_s")}
    got = {n: r(ctx) for n, r in readers.items()}
    if program != "counts":
        assert got == dict.fromkeys(readers)
        return
    for n in ("jit_copy_in_mib.train", "jit_copy_in_mib.render"):
        assert got[n] == (3.0, {"leaves_per_replay": 7.0, "replays": 4})
    assert got["jit_warmup_s"] == (2.5, {"warmups": 1})
    assert got["jit_capture_s"] == (0.75, {"captures": 1})
