"""The reader of K6's device time per ray (metrics/k6_ns_per_ray.render.py)
on a synthetic trace and the program's counts: the kernel's time per call
over the rays a replay hands it; None where the program keeps no K6 ray
count (the parent), is not loaded, or nothing replayed."""

import sys
import types
from pathlib import Path

import pytest

from portbench.harness import cell as cells
from portbench.harness import spans
from portbench.harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
JIT = spans.PROGRAM + ".jit"

# Two calls of 100 ns; in each, K6's closest-hit launch 10-40 and an
# any-hit launch 50-60 (30 + 10 ns of K6 a call), and another kernel.
HOST = [("portbench.call", off, off + 100) for off in (0, 100)]
DEVICE = [(k, a + off, b + off) for off in (0, 100) for k, a, b in (
    ("void (anonymous namespace)::clustered_kernel<false>(P)", 10, 40),
    ("void (anonymous namespace)::clustered_kernel<true>(P)", 50, 60),
    ("void at::native::elementwise_kernel<128, 2>(F)", 60, 90))]
COUNTS = {"replays": 4, "copy_in_bytes": 0, "copy_in_leaves": 0, "warmups": 1,
          "warmup_s": 1.0, "captures": 1, "capture_s": 0.5, "eager": 0,
          "clustered_closest_rays": 4 * 1500, "clustered_any_rays": 4 * 500}


@pytest.mark.parametrize("program", ["counts", "no_counts", "not_loaded", "no_replay",
                                     "no_ray_counts"])
def test_k6_ns_per_ray_reader(monkeypatch, program):
    if program == "not_loaded":
        monkeypatch.delitem(sys.modules, JIT, raising=False)
    else:
        jit = types.ModuleType(JIT)
        if program == "counts":
            jit.COUNTS = dict(COUNTS)
        elif program == "no_replay":
            jit.COUNTS = dict.fromkeys(COUNTS, 0) | {"eager": 5}
        elif program == "no_ray_counts":   # a program from before the count
            jit.COUNTS = {k: v for k, v in COUNTS.items() if not k.endswith("_rays")}
        monkeypatch.setitem(sys.modules, JIT, jit)
    read = cells.load_module(ROOT / "portbench" / "metrics" / "k6_ns_per_ray.render.py").read
    ctx = types.SimpleNamespace(trace=Trace(DEVICE, HOST, calls=2))
    got = read(ctx)
    if program != "counts":
        assert got is None
        return
    value, note = got
    # 40 ns of K6 a call over 2000 rays a replay, in ns.
    assert value == pytest.approx(40 / 2000)
    assert note == {"clustered_closest_rays_per_call": 1500.0,
                    "clustered_any_rays_per_call": 500.0}
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(types.SimpleNamespace(trace=Trace([], HOST, calls=2))) is None
