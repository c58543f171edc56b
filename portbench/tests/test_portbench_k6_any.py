"""The files that bunny-1080p-b2-shadows.render adds: the cell resolves to
its configuration, mix, limits and metrics (K6's any-hit metrics, and not
the two K6 metrics that set closest-hit work against every K6 launch);
K6's any-hit work count (work/k6_any.py) gives a hand-counted small case
exactly; K6's launches are told apart by mode from the trace's names; the
any-hit roofline share reads at or under 100% at the cell's counts with
the card's any-hit time; the any-hit time per ray
(metrics/k6_any_ns_per_ray.render.py) reads the program's counts, gives
the light loop's slots where the program keeps them, and is None without
the any-hit rays; and the closest-hit time per ray
(metrics/k6_closest_ns_per_ray.render.py) reads the closest-hit launches
alone."""

import sys
import types
from pathlib import Path

import pytest

from portbench.harness import cell as cells
from portbench.harness import spans
from portbench.harness.trace import Trace
from portbench.reference import tracer

ROOT = Path(__file__).resolve().parents[2]
CELL = "bunny-1080p-b2-shadows.render"
JIT = spans.PROGRAM + ".jit"
ANY = "void (anonymous namespace)::clustered_kernel<true>((anonymous namespace)::P, int*)"
CLOSEST = "void (anonymous namespace)::clustered_kernel<false>((anonymous namespace)::P, int*)"
# The any-hit launches' device time an image of the cell on one H100 80GB
# HBM3 at 700 W (a traced run of the cell: 16 launches of 2,073,600 rays,
# 0.337 ns a ray).
ANY_SECONDS_PER_IMAGE = 11.18e-3


def _work():
    return cells.load_cell(ROOT, CELL).work("k6_any")


def test_new_cell_resolves_to_its_files():
    c = cells.load_cell(ROOT, CELL)
    assert c.workload["config"] == c.config["name"] == "bunny-1080p-b2-shadows"
    assert c.workload["chips"] == 1 and c.config["path"] == "pallas"
    assert c.traffic["kind"] == "render" and c.traffic["frames"] == 4
    assert set(c.limits["limits"]) == {"img_mean_abs", "img_frac_off"}
    assert c.limits["px_tol"] == 0.01
    assert {m["name"] for m in c.end_to_end} == {"image_rays_per_s", "peak_mem_mib", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "graph_launch_idle_ms.render", "torch_ops_ms.render", "device_idle_pct.render",
        "jit_host_idle_ms.render", "jit_copy_in_mib.render", "accel_build_s",
        "jit_warmup_s", "jit_capture_s", "k6_any_ns_per_ray.render", "k6_any_roofline_pct",
        "k6_closest_ns_per_ray.render"}
    for m in c.end_to_end + c.per_layer:
        assert callable(c.metric_reader(m["name"]).read), m["name"]
    assert callable(c.work("k6_any").count)


def _ctx(counts, frames: int, lights: int, triangles: int, images: int = 1,
         shadow_rays: bool = True, bounces: int = 2):
    s = tracer.Settings(bounces=bounces, shadow_rays=shadow_rays)
    cell = types.SimpleNamespace(traffic={"frames": frames},
                                 config={"scene": {"lights": ["point"] * lights}},
                                 work=cells.load_cell(ROOT, CELL).work)
    return types.SimpleNamespace(counts=counts, settings=s, numbers={"_images": images},
                                 cell=cell, triangles=triangles, power_limit_w=None)


def test_k6_any_work_hand_counted():
    """Two bounces, two lights, two frames, one image of 10 triangles:
    bounce 0 has 100 rays going on, 150 of their 200 shadow rays see their
    light; bounce 1 40 and 50 of 80. A launch a light and frame: bounce 0
    50 rays x 32 B + 10 x 36 B, 25 blocked rays shared by two lights x 45;
    bounce 1 20 x 32 + 360, 15 / 2 x 45."""
    c = tracer.Counts.zeros(2)
    c.on, c.seen = [100, 40], [{"point": 150}, {"point": 50}]
    c.rays, c.dead = [1000, 1000], [0, 600]     # not read: the lanes handed over
    got = _work().count(_ctx(c, frames=2, lights=2, triangles=10))
    assert got == [(1960.0, 562.5)] * 4 + [(1000.0, 337.5)] * 4
    assert _work().count(_ctx(c, frames=2, lights=2, triangles=10, shadow_rays=False)) == []


@pytest.mark.parametrize("name, mode", [
    (ANY, True), (CLOSEST, False), ("clustered_kernel<true>", True),
    ("void (anonymous namespace)::shade_kernel<true>(P)", None),
    ("void at::native::elementwise_kernel<128, 2>(F)", None)])
def test_k6_mode_from_the_trace_name(name, mode):
    assert _work().mode(name) is mode


def _trace(any_s: float, closest_s: float, calls: int = 2) -> Trace:
    """``calls`` calls, each with an any-hit and a closest-hit launch of K6
    of those seconds, and another kernel."""
    a, c = int(any_s * 1e9), int(closest_s * 1e9)
    span = a + c + 1000
    host = [("portbench.call", i * span, (i + 1) * span) for i in range(calls)]
    device = []
    for i in range(calls):
        off = i * span
        device += [(CLOSEST, off + 10, off + 10 + c), (ANY, off + 20 + c, off + 20 + c + a),
                   ("void at::native::elementwise_kernel<128, 2>(F)", off + 30 + c + a,
                    off + 40 + c + a)]
    return Trace(device, host, calls=calls)


def test_k6_any_roofline_at_or_under_100_at_the_cell_counts():
    """At the cell's shapes (2,073,600 rays a frame, 4 frames, 2 lights, 2
    bounces, 69,732 triangles, 2 images checked) with the most work the
    counts can show (every ray goes on, every shadow ray blocked), the
    share over the card's any-hit time is at most 100%."""
    R, frames, images, L = 1920 * 1080, 4, 2, 2
    n = R * frames * images
    c = tracer.Counts.zeros(2)
    c.on, c.seen = [n, n], [{}, {}]
    ctx = _ctx(c, frames=frames, lights=L, triangles=69_732, images=images)
    ctx.trace = _trace(ANY_SECONDS_PER_IMAGE, 0.01)
    read = cells.load_module(ROOT / "portbench" / "metrics" / "k6_any_roofline_pct.py").read
    value, note = read(ctx)
    assert 0.0 < value <= 100.0, (value, note)
    assert note["bound_by"] == "bytes"
    assert note["kernel_ms"] == pytest.approx(ANY_SECONDS_PER_IMAGE * 1e3, rel=1e-6)
    assert read(types.SimpleNamespace(trace=None)) is None
    ctx.trace = Trace([], ctx.trace.host, calls=2)
    assert read(ctx) is None


COUNTS = {"replays": 4, "copy_in_bytes": 0, "copy_in_leaves": 0, "warmups": 1,
          "warmup_s": 1.0, "captures": 1, "capture_s": 0.5, "eager": 0,
          "clustered_closest_rays": 4 * 2000, "clustered_any_rays": 4 * 4000,
          "wave_shadow_rays": 4 * 4000}


@pytest.mark.parametrize("program", ["counts", "no_wave_counter", "not_loaded", "no_replay",
                                     "no_any_rays"])
def test_k6_any_ns_per_ray_reader(monkeypatch, program):
    if program == "not_loaded":
        monkeypatch.delitem(sys.modules, JIT, raising=False)
    else:
        jit = types.ModuleType(JIT)
        jit.COUNTS = dict(COUNTS)
        if program == "no_wave_counter":     # a program from before the count
            del jit.COUNTS["wave_shadow_rays"]
        elif program == "no_replay":
            jit.COUNTS = dict.fromkeys(COUNTS, 0) | {"eager": 5}
        elif program == "no_any_rays":       # a cell without shadow rays
            jit.COUNTS |= {"clustered_any_rays": 0, "wave_shadow_rays": 0}
        monkeypatch.setitem(sys.modules, JIT, jit)
    read = cells.load_module(ROOT / "portbench" / "metrics" / "k6_any_ns_per_ray.render.py").read
    ctx = types.SimpleNamespace(trace=_trace(400e-9, 300e-9), cell=cells.load_cell(ROOT, CELL))
    got = read(ctx)
    if program not in ("counts", "no_wave_counter"):
        assert got is None
        return
    value, note = got
    # 400 ns of any-hit launches a call over 4000 rays.
    assert value == pytest.approx(400 / 4000, rel=1e-2)
    want = {"clustered_any_rays_per_call": 4000.0}
    if program == "counts":
        want["wave_shadow_rays_per_call"] = 4000.0
    assert note == want
    assert read(types.SimpleNamespace(trace=None, cell=ctx.cell)) is None
    ctx.trace = Trace([(CLOSEST, 10, 310)], ctx.trace.host, calls=2)
    assert read(ctx) is None


@pytest.mark.parametrize("program", ["counts", "not_loaded", "no_replay", "no_closest_rays"])
def test_k6_closest_ns_per_ray_reader(monkeypatch, program):
    """The closest-hit launches' device time over the closest-hit rays a
    replay, the any-hit launches left out; None without those rays."""
    if program == "not_loaded":
        monkeypatch.delitem(sys.modules, JIT, raising=False)
    else:
        jit = types.ModuleType(JIT)
        jit.COUNTS = dict(COUNTS)
        if program == "no_replay":
            jit.COUNTS = dict.fromkeys(COUNTS, 0) | {"eager": 5}
        elif program == "no_closest_rays":   # a cell on the mega path
            jit.COUNTS |= {"clustered_closest_rays": 0}
        monkeypatch.setitem(sys.modules, JIT, jit)
    read = cells.load_module(
        ROOT / "portbench" / "metrics" / "k6_closest_ns_per_ray.render.py").read
    ctx = types.SimpleNamespace(trace=_trace(400e-9, 300e-9), cell=cells.load_cell(ROOT, CELL))
    got = read(ctx)
    if program != "counts":
        assert got is None
        return
    # 300 ns of closest-hit launches a call over 2000 rays.
    value, note = got
    assert value == pytest.approx(300 / 2000, rel=1e-2)
    assert note == {"clustered_closest_rays_per_call": 2000.0}
    assert read(types.SimpleNamespace(trace=None, cell=ctx.cell)) is None
    ctx.trace = Trace([(ANY, 10, 410)], ctx.trace.host, calls=2)
    assert read(ctx) is None
