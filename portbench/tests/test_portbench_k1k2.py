"""The files that cornell-1080p-b2-shadows.render adds: the cell resolves to
its configuration, mix and limits; K1 / K2's work count (work/k1k2.py)
repeats exactly on config 2's light path at a test's size; their
roofline share reads between 0 and 100% on a synthetic trace whose K1 /
K2 time per ray is the card's (0.11 ns a ray: 1.83 ms of K1 + K2 an
image of 16.6 M rays, one H100's traced run of this configuration); and
their time per ray (metrics/k1k2_ns_per_ray.render.py) is None without
the program's K1 / K2 ray counts, as the parent has none."""

import sys
import types
from pathlib import Path

import pytest
import torch

from portbench.harness import cell as cells
from portbench.harness import spans
from portbench.harness.trace import Trace
from portbench.reference import scenes, tracer
from portbench.tests.config2 import CONFIG2, CONFIG2_LIGHTS

ROOT = Path(__file__).resolve().parents[2]
CELL = "cornell-1080p-b2-shadows.render"
JIT = spans.PROGRAM + ".jit"
NS_PER_RAY = 0.11


def test_new_cell_resolves_to_its_files():
    c = cells.load_cell(ROOT, CELL)
    assert c.workload["config"] == c.config["name"] == "cornell-1080p-b2-shadows"
    assert c.workload["chips"] == 1 and c.config["path"] == "mega"
    assert c.config["scene"]["lights"] == CONFIG2_LIGHTS
    assert all(c.config["render"][k] is v for k, v in CONFIG2.items())
    assert (c.config["render"]["width"], c.config["render"]["height"],
            c.config["render"]["bounces"]) == (1920, 1080, 2)
    assert c.traffic["kind"] == "render" and c.traffic["frames"] == 4
    assert set(c.limits["limits"]) == {"img_mean_abs", "img_frac_off"}
    assert c.limits["images"] == 2 and c.limits["px_tol"] == 0.01
    assert {m["name"] for m in c.end_to_end} == {"image_rays_per_s", "peak_mem_mib", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "graph_launch_idle_ms.render", "torch_ops_ms.render", "device_idle_pct.render",
        "jit_host_idle_ms.render", "jit_copy_in_mib.render", "accel_build_s",
        "jit_warmup_s", "jit_capture_s", "k1k2_ns_per_ray.render", "k1k2_roofline_pct"}
    assert CELL in next(m for m in c.bench["per_layer"]
                        if m["name"] == "k1k2_roofline_pct")["workloads"]
    for m in c.end_to_end + c.per_layer:
        assert callable(c.metric_reader(m["name"]).read), m["name"]
    assert callable(c.work("k1k2").count)


def _ctx(frames: int = 2):
    """A run's context at 48 x 32 x 2 on config 2's light path: the
    reference's counts of one image of ``frames`` frames."""
    c = cells.load_cell(ROOT, CELL)
    s = tracer.Settings.from_render({**c.config["render"], "width": 48, "height": 32})
    arrays = scenes.make_scene(c.config["scene"])
    scene = {k: torch.from_numpy(v) for k, v in arrays.items()}
    cam = {k: torch.from_numpy(v) for k, v in scenes.make_camera(c.config["camera"]).items()}
    counts = tracer.Counts.zeros(s.bounces)
    tracer.image(scene, cam, s, frames, counts=counts)
    cell = types.SimpleNamespace(traffic={"frames": frames}, config=c.config,
                                 work=c.work)
    return types.SimpleNamespace(counts=counts, settings=s, numbers={"_images": 1},
                                 cell=cell, triangles=int(arrays["geometry.v0"].shape[0]),
                                 power_limit_w=None)


def test_k1k2_work_repeats_exactly():
    ctx1, ctx2 = _ctx(), _ctx()
    w1, w2 = ctx1.cell.work("k1k2").count(ctx1), ctx2.cell.work("k1k2").count(ctx2)
    assert ctx1.counts == ctx2.counts and w1 == w2
    # One launch a bounce and frame, each with bytes and operations.
    assert len(w1) == 2 * 2 and all(b > 0 and f > 0 for b, f in w1)
    c = ctx1.counts
    # Some shadow rays are blocked and some reach their light.
    seen = sum(c.seen[0].values())
    assert 0 < seen < 2 * c.on[0]


def _trace(seconds_per_call: float, calls: int = 2):
    """Two calls, each with a K1 and a K2 launch that split
    ``seconds_per_call`` of device time, and another kernel."""
    ns = seconds_per_call * 1e9
    span = int(3 * ns) + 100
    host = [("portbench.call", i * span, (i + 1) * span) for i in range(calls)]
    device = []
    for i in range(calls):
        off = i * span
        device += [("bounce0_fwd_kernel(MegaParams, P)", off + 10, off + 10 + int(ns / 3)),
                   ("void bounce_fwd_kernel<128, false>(MegaParams, P)", off + 20 + int(ns / 3),
                    off + 20 + int(ns)),
                   ("void at::native::elementwise_kernel<128, 2>(F)", off + 30 + int(ns),
                    off + 40 + int(ns))]
    return Trace(device, host, calls=calls)


def test_k1k2_roofline_reads_between_0_and_100():
    ctx = _ctx()
    rays = 48 * 32 * 2 * 2
    ctx.trace = _trace(rays * NS_PER_RAY * 1e-9)
    read = cells.load_module(ROOT / "portbench" / "metrics" / "k1k2_roofline_pct.py").read
    value, note = read(ctx)
    assert 0.0 < value < 100.0, (value, note)
    assert note["bound_by"] == "bytes"
    assert read(types.SimpleNamespace(trace=None)) is None
    ctx.trace = Trace([], ctx.trace.host, calls=2)
    assert read(ctx) is None


COUNTS = {"replays": 4, "copy_in_bytes": 0, "copy_in_leaves": 0, "warmups": 1,
          "warmup_s": 1.0, "captures": 1, "capture_s": 0.5, "eager": 0,
          "mega_fwd_rays": 4 * 3000, "mega_shadow_rays": 4 * 6000}


@pytest.mark.parametrize("program", ["counts", "no_counts", "not_loaded", "no_replay",
                                     "no_ray_counts"])
def test_k1k2_ns_per_ray_reader(monkeypatch, program):
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
    read = cells.load_module(ROOT / "portbench" / "metrics" / "k1k2_ns_per_ray.render.py").read
    ctx = types.SimpleNamespace(trace=_trace(300e-9))
    got = read(ctx)
    if program != "counts":
        assert got is None
        return
    value, note = got
    # 300 ns of K1 + K2 a call (to within the trace's whole ns) over 3000 rays.
    assert value == pytest.approx(300 / 3000, rel=1e-2)
    assert note == {"mega_fwd_rays_per_call": 3000.0, "mega_shadow_rays_per_call": 6000.0}
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(types.SimpleNamespace(trace=Trace([], ctx.trace.host, calls=2))) is None
