"""The harness is driven by data: every cell of BENCHMARK.json resolves to
its files; a configuration, a traffic mix, a kind of mix, a metric and a
cell added as new files (and entries) in a copy are found by name with no
file there edited, and the new cell runs whole; the kernels' work counts
repeat exactly on a tiny scene."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import cell as cells
from portbench.harness import traffic
from portbench.reference import scenes, tracer
from portbench.tests.config2 import CONFIG2, CONFIG2_LIGHTS

ROOT = Path(__file__).resolve().parents[2]
PROGRAM = "mini_opencl_raytracer_tpu_torch"

# A new kind of mix, added as a file: every request renders the
# configuration's own camera (the render kind's loop with the pan left out).
STILL = """
from pathlib import Path
from portbench.harness import cell
_render = cell.load_module(Path(__file__).with_name("render.py"))
numbers, control_evidence = _render.numbers, _render.control_evidence


class Mix(_render.Mix):
    def call(self):
        self._render(self.camera)
        self.count += 1

    def evidence(self):
        pos = self.camera.position.detach().cpu().numpy()
        return {"images": [(i, pos, img.numpy()) for i, img in self.kept]}
"""

_RUN = r"""
import sys
sys.path.insert(0, {bench!r})
import run
raise SystemExit(run.main({argv!r}, device="cpu"))
"""


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_to_its_files():
    bench = _bench()
    names = [w["name"] for w in bench["workloads"]]
    assert names
    for name in names:
        c = cells.load_cell(ROOT, name)
        assert c.config["name"] == c.workload["config"]
        kind = c.kind()
        assert issubclass(kind.Mix, traffic.BaseMix)
        assert callable(kind.numbers) and callable(kind.control_evidence)
        assert set(c.limits["limits"])
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(c.metric_reader(m["name"]).read), m["name"]
        scenes.make_scene(c.config["scene"])
        scenes.make_camera(c.config["camera"])
    for conf in bench["configs"]:
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    for kernel in ("k4", "k6"):
        assert callable(cells.load_module(ROOT / "portbench" / "work" / f"{kernel}.py").count)


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("lights,flags", [
    (["point"], {}),
    (CONFIG2_LIGHTS, CONFIG2)],
    ids=["point", "config2-lights"])
def test_new_files_are_found_by_name(tmp_path, lights, flags):
    """The new configuration is cornell-1080p-b9's at 48x32 x 2, with the
    reference renderer's light, or with BASELINE.json config 2's two light
    records, shadow rays and the direct specular term."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=ignore)
    for folder in (PROGRAM, "native"):
        shutil.copytree(ROOT / folder, tmp_path / folder, ignore=ignore)
    before = _digest(tmp_path / "portbench")
    here = tmp_path / "portbench"
    conf = json.loads((here / "configs" / "cornell-1080p-b9.json").read_text())
    conf.update(name="cornell-48x32-b2", render={**conf["render"], "width": 48,
                                                 "height": 32, "bounces": 2, **flags},
                scene={**conf["scene"], "lights": lights})
    (here / "configs" / "cornell-48x32-b2.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic" / "render.json").read_text())
    (here / "traffic" / "still.json").write_text(json.dumps({**mix, "kind": "still",
                                                             "frames": 2}))
    (here / "traffic" / "still.py").write_text(STILL)
    (here / "limits" / "cornell-48x32-b2.still.json").write_text(json.dumps(
        {"limits": {"img_mean_abs": 1e-5, "img_frac_off": 1e-4}, "px_tol": 0.01,
         "images": 1}))
    (here / "metrics" / "frames_per_s.py").write_text(
        "def read(ctx):\n    return ctx.calls * 2 / ctx.window_s\n")
    bench = _bench()
    bench["configs"].append({"name": "cornell-48x32-b2", "source": "a test",
                             "file": "portbench/configs/cornell-48x32-b2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "cornell-48x32-b2.still", "config": "cornell-48x32-b2",
                               "traffic": "still", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "image_rays_per_s":
            m["workloads"].append("cornell-48x32-b2.still")
    bench["per_layer"].append({"name": "frames_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "Entry",
                               "moves": "image_rays_per_s",
                               "workloads": ["cornell-48x32-b2.still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.load_cell(tmp_path, "cornell-48x32-b2.still")
    assert c.config["render"]["width"] == 48 and c.traffic["frames"] == 2
    assert c.config["scene"]["lights"] == lights
    assert all(c.config["render"][k] is v for k, v in flags.items())
    assert c.kind().Mix.call is not c.kind().Mix.__mro__[1].call
    assert {m["name"] for m in c.end_to_end} == {"image_rays_per_s", "peak_mem_mib", "setup_s"}
    assert [m["name"] for m in c.per_layer if m["name"] == "frames_per_s"]
    ctx = type("Ctx", (), {"calls": 10, "window_s": 2.0})()
    assert c.metric_reader("frames_per_s").read(ctx) == 10.0
    # The new cell runs whole (on the CPU, the look for a card skipped).
    argv = ["--workload", "cornell-48x32-b2.still", "--seed", "3000000019", "--seconds",
            "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "-c", _RUN.format(bench=str(here), argv=argv)],
                         capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    # No device memory is read on the CPU, so peak_mem_mib's reader is silent.
    assert set(result["metrics"]) == {"image_rays_per_s", "setup_s"}
    assert {k: v for k, v in _digest(here).items() if k in before} == before


def _tiny(device="cpu"):
    spec = {"room": "cornell", "lights": ["point"],
            "objects": [{"kind": "noisy_sphere", "center": [0.0, 12.0, 5.0], "radius": 4.0,
                         "n_theta": 12, "n_phi": 24, "bump": 0.03, "seed": 1,
                         "material": "Material"}]}
    arrays = scenes.make_scene(spec)
    cam = {k: torch.from_numpy(v) for k, v in scenes.make_camera(
        {"position": [0.0, -25.0, 8.5], "front": [0.0, 1.0, 0.0], "up": [0.0, 0.0, 1.0]}).items()}
    scene = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return scene, cam


def _counts_and_work(kind: str):
    scene, cam = _tiny()
    s = tracer.Settings(width=24, height=16, bounces=3)
    counts = tracer.Counts.zeros(s.bounces)
    if kind == "k4":
        target = torch.zeros((s.height, s.width, 3))
        tracer.loss_and_grads(scene, cam, s, target, counts=counts)
    else:
        tracer.image(scene, cam, s, 2, counts=counts)
    ctx = type("Ctx", (), {})()
    ctx.counts, ctx.settings, ctx.triangles = counts, s, int(scene["geometry.v0"].shape[0])
    ctx.numbers = {"_images": 1}
    ctx.cell = type("Cell", (), {"traffic": {"frames": 2}})()
    work = cells.load_module(ROOT / "portbench" / "work" / f"{kind}.py").count(ctx)
    return counts, work


def test_run_caches_bytecode_in_the_checkout(tmp_path):
    """Started as a script, with bytecode beside the sources forbidden, a
    run keeps the bytecode of what it imports, PyTorch among it, in
    build/pycache in its checkout, writes no __pycache__ beside the
    harness, and reads the cache again in the next run. (Here a run ends
    at the look for a card, or, on a machine with one, at the look for the
    program, which this copy lacks: both after PyTorch's import.)"""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    argv = [sys.executable, "portbench/run.py", "--workload", "cornell-1080p-b9.render",
            "--seed", "3000000019", "--seconds", "1", "--trace", "0"]
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1"}
    torch_dir = Path(torch.__file__).resolve().parent
    pyc = (tmp_path / "build" / "pycache" / torch_dir.relative_to(torch_dir.anchor)
           / f"__init__.{sys.implementation.cache_tag}.pyc")
    stamps = []
    for _ in range(2):
        out = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                             cwd=str(tmp_path), env=env)
        assert out.returncode in (3, 4), out.stderr[-4000:]
        assert pyc.is_file()
        stamps.append(pyc.stat().st_mtime_ns)
    assert stamps[0] == stamps[1]
    assert not list((tmp_path / "portbench").rglob("__pycache__"))

def test_work_counts_repeat_exactly():
    for kind in ("k4", "k6"):
        c1, w1 = _counts_and_work(kind)
        c2, w2 = _counts_and_work(kind)
        assert c1 == c2 and w1 == w2, kind
        assert all(b > 0 for b, _ in w1) and any(f > 0 for _, f in w1), (kind, w1)
    counts, _ = _counts_and_work("k6")
    # Every live ray's winner is an accepted pair, and the live rays only shrink.
    assert all(p >= l for p, l in zip(counts.accepted_pairs, counts.live))
    alive = [r - d for r, d in zip(counts.rays, counts.dead)]
    assert alive == sorted(alive, reverse=True)


def test_trace_reduction():
    """Busy time is the union of device intervals inside the window; idle
    time inside a host event counts only where the device has nothing."""
    from portbench.harness.trace import Trace
    host = [("portbench.call", 0, 100), ("cudaGraphLaunch", 5, 30),
            ("cudaGraphLaunch", 50, 60), ("aten::copy_", 0, 100)]
    device = [("void k<1>(float*)", 10, 20), ("copy", 15, 25), ("finish_kernel", 25, 30),
              ("void k<1>(float*)", 40, 55), ("fill", 70, 90), ("late", 95, 120)]
    tr = Trace(device, host, calls=2)
    assert tr.window_s * 1e9 == 100
    assert round(tr.busy_s * 1e9) == 20 + 15 + 20 + 5
    # Idle: 0-10, 30-40, 55-70, 90-95; inside the launches: 5-10, 55-60.
    assert round(tr.idle_inside("cudaGraphLaunch") * 1e9) == 10
    assert round(tr.idle_inside("aten::copy_") * 1e9) == 40
    assert tr.idle_inside("cudaLaunchKernel") == 0
    assert round(tr.kernel_seconds(["k"]) * 1e9) == 25
    assert round(tr.other_seconds(["k", "finish_kernel"]) * 1e9) == 10 + 20 + 5
