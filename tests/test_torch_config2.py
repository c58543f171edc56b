"""BASELINE.json config 2 (benchmarks/run_all.py config_2: the Cornell box,
two point lights, shadow rays and the direct specular term) on the port's
normal path, against the benchmark's plain reference under the limits of
its cell, cornell-1080p-b2-shadows.render, at 48 x 32 x 2 and 2 frames.

The port renders through ``render`` at ``backend="auto"``, which resolves
to the mega path: on the CPU the plain versions of K1 / K2, on a card the
kernels themselves (the ``cuda`` case). The scene's float leaves that the
light path reads are perturbed from a seed, so that the comparison is not
of the stock scene alone. And the mechanism is not optional: the
reference with shadow rays off, with direct specular off, or with the
second light dropped fails the same limits against the whole reference.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from portbench.harness import cell as cells
from portbench.harness import check, control
from portbench.reference import scenes
from portbench.tests import config2_ablations as ablations

ROOT = Path(__file__).resolve().parents[1]
W, H, FRAMES = 48, 32, 2
SEEDS = (2147483659, 5000000029, 9007199254740881)


def _cell():
    return ablations.resized(cells.load_cell(ROOT, ablations.CELL), W, H, FRAMES)


def _perturbed(arrays: dict, seed: int) -> dict:
    """The scene's arrays with the light path's float leaves moved, from
    ``seed``: the lights' positions and intensities, the materials'
    diffuse and specular colours and Phong exponents."""
    r = np.random.default_rng(seed)
    out = dict(arrays)
    f32 = lambda x: np.asarray(x, np.float32)
    out["lights.position"] = f32(arrays["lights.position"]
                                 + r.normal(0.0, 1.0, arrays["lights.position"].shape))
    out["lights.intensity"] = f32(arrays["lights.intensity"]
                                  * r.uniform(0.5, 1.5, arrays["lights.intensity"].shape))
    for key in ("materials.diffuse", "materials.specular"):
        out[key] = f32(np.clip(arrays[key] + r.normal(0.0, 0.1, arrays[key].shape), 0.0, 1.0))
    out["materials.roughness"] = f32(arrays["materials.roughness"]
                                     * r.uniform(0.5, 2.0, arrays["materials.roughness"].shape))
    return out


@pytest.mark.parametrize("device, seed", [("cpu", s) for s in SEEDS]
                         + [pytest.param("cuda", SEEDS[0], marks=pytest.mark.cuda)],
                         ids=[f"cpu-{s}" for s in SEEDS] + ["cuda"])
def test_port_meets_the_reference(device, seed):
    """The port's image is within the cell's limits of the reference's at
    the same camera; on the CPU it counts no K1 / K2 launch and no ray."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 / K2 have no CPU mode")
    cell = _cell()
    arrays = _perturbed(scenes.make_scene(cell.config["scene"]), seed)
    camera = scenes.make_camera(cell.config["camera"])
    cfg = P.RenderConfig(**cell.config["render"])
    scene = P.scene_from_numpy(arrays, device=device)
    assert P.resolve_backend(scene, cfg) == "mega"
    before = dict(build.LAUNCHES), dict(build.RAYS)
    img = P.render(scene, P.camera_from_numpy(camera, device=device), cfg, frames=FRAMES)
    moved = {k for k, v in build.LAUNCHES.items() if v != before[0][k]}
    moved |= {k for k, v in build.RAYS.items() if v != before[1][k]}
    if device == "cpu":
        assert moved == set()
    else:
        assert {"bounce0_fwd", "bounce_fwd", "mega_fwd", "mega_shadow"} <= moved
    ev = {"images": [(0, camera["position"], img.float().cpu().numpy())]}
    numbers = cell.kind().numbers(cell, arrays, camera, ev, torch.device("cpu"))
    correct, checks = check.judge(numbers, cell.limits["limits"])
    assert correct, checks


@pytest.mark.parametrize("ablation", sorted(ablations.ABLATIONS))
def test_each_part_of_the_light_path_shows(ablation):
    """The reference without one part of config 2's light path fails the
    cell's limits against the whole reference, on two seeds' cameras."""
    cell = _cell()
    for seed in SEEDS[:2]:
        r = ablations.readings(cell, ablation, seed, torch.device("cpu"))
        assert control.fails(r, cell), (ablation, seed, r)


def test_ablations_take_away_one_part_each():
    """Each ablation changes only the part it names."""
    conf = _cell().config
    for name, fn in ablations.ABLATIONS.items():
        got = fn(conf)
        changed = {k for k in conf["render"] if got["render"][k] != conf["render"][k]}
        lights = got["scene"]["lights"]
        assert {k: v for k, v in got.items() if k not in ("render", "scene")} == {
            k: v for k, v in conf.items() if k not in ("render", "scene")}, name
        if name == "second_light_dropped":
            assert changed == set() and lights == conf["scene"]["lights"][:1], name
        else:
            key = name[:-len("_off")]
            assert changed == {key} and got["render"][key] is False, name
            assert lights == conf["scene"]["lights"], name
    assert conf["render"]["shadow_rays"] and conf["render"]["direct_specular"]
    assert len(conf["scene"]["lights"]) == 2
