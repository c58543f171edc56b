"""A whole run with the timed path broken underneath: ``correct`` comes
out false. And with it sound: ``correct`` comes out true.

Each case runs ``run.main`` in a fresh interpreter, on the CPU (the run's
look for a card is skipped by passing the device; the program runs its
kernels' plain versions), from a copy of the checkout whose
configurations are cut to a test's size. The fault is planted in the
program by replacing one of its functions:

* ``unchanged``: training, the step's gradient of the updated leaf is
  zero, so the step leaves the state as it was; rendering, every request
  gets the first request's image;
* ``half_batch``: training, the loss is the mean over the first half of
  the image's rows; rendering, the image is the mean of half its frames;
* ``altered``: training, the loss is 5% high where it is produced;
  rendering, an 8 x 8 block of each image is black;
* ``stale``: training, every step after the first returns the first
  step's gradients of every leaf but the updated one (an output of the
  compiled step left stale), so only the comparison of a later step's
  gradients can see it.

One chip and no exchange between chips: the fault of a left-out exchange
does not arise in these cells.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PROGRAM = "mini_opencl_raytracer_tpu_torch"

_PLANT = r"""
import dataclasses, json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/portbench")
import torch
import run
import {program} as mrt
from {program} import grad
fault = {fault!r}
loss_and_grads, render = grad.loss_and_grads, mrt.render
first_grads = []

def broken_step(scene, camera, cfg, loss_fn, frames=1, accel=None):
    if fault == "half_batch":
        h = cfg.height // 2
        fn = lambda img: torch.mean((img[:h] - loss_fn.target[:h]) ** 2)
        return loss_and_grads(scene, camera, cfg, fn, frames, accel)
    loss, gs, gc = loss_and_grads(scene, camera, cfg, loss_fn, frames, accel)
    if fault == "stale":
        if not first_grads:
            first_grads.append((gs, gc))
        else:
            s0, gc = first_grads[0]
            gs = dataclasses.replace(s0, materials=dataclasses.replace(
                s0.materials, diffuse=gs.materials.diffuse))
    if fault == "unchanged":
        gs = dataclasses.replace(gs, materials=dataclasses.replace(
            gs.materials, diffuse=torch.zeros_like(gs.materials.diffuse)))
    if fault == "altered":
        loss = loss * 1.05
    return loss, gs, gc

first = []
def broken_render(scene, camera, cfg, frames=1, accel=None, device=None):
    if fault == "half_batch":
        frames = frames // 2
    img = render(scene, camera, cfg, frames=frames, accel=accel, device=device)
    if fault == "altered":
        img = img.clone()
        img[:8, :8] = 0.0
    if fault == "unchanged":
        first.append(img.clone()) if not first else None
        img = first[0]
    return img

if fault is not None:
    grad.loss_and_grads = broken_step
    mrt.render = broken_render
raise SystemExit(run.main({argv!r}, device="cpu"))
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the checkout with its configurations cut to a test's size."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    ignore = shutil.ignore_patterns("__pycache__")
    for folder in ("portbench", PROGRAM, "native"):
        shutil.copytree(ROOT / folder, root / folder, ignore=ignore)
    for path in (root / "portbench" / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        conf["render"].update(width=32, height=24, bounces=min(conf["render"]["bounces"], 3))
        for obj in conf["scene"].get("objects", []):
            obj.update(n_theta=24, n_phi=48)      # above 2048 triangles: still K6's path
        path.write_text(json.dumps(conf))
    return root


def _run(checkout: Path, workload: str, fault):
    argv = ["--workload", workload, "--seed", "4000000007", "--seconds", "1", "--trace", "0"]
    script = _PLANT.format(root=str(checkout), program=PROGRAM, fault=fault, argv=argv)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=str(checkout))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


CASES = [(w, f) for w in ("cornell-1080p-b9.train", "bunny-512-b2.train",
                          "cornell-1080p-b9.render", "bunny-512-b2.render")
         for f in (None, "unchanged", "half_batch", "altered")
         + (("stale",) if w.endswith(".train") else ())]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f or 'sound'}" for w, f in CASES])
def test_run_judges_the_timed_path(checkout, workload, fault):
    result = _run(checkout, workload, fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1
