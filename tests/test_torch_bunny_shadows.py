"""BASELINE.json config 3's mesh lit as config 2 (benchmarks/run_all.py
config_2: two point lights, shadow rays and the direct specular term) on
the port's normal path, against the benchmark's plain reference under the
limits of its cell, bunny-1080p-b2-shadows.render, at 64 x 48 x 2 and 2
frames.

The port renders through ``render`` at ``backend="auto"``, which resolves
to the wavefront on the cluster-traversal intersector K6 (the scene has
2,152 triangles: the room's 36 and a seeded noisy sphere of 2 x 23 x 46,
over the 2048 above which K6 runs and the rays are sorted between
bounces). With shadow rays every bounce shades in PyTorch and casts one
any-hit call a light. On the CPU K6 runs as its plain version; on a card
as the kernel (the ``cuda`` case). The lights' positions and intensities
are moved from the seed, so that the comparison is not of the stock
lights alone. And the mechanism is not optional: the reference with
shadow rays off, with direct specular off, or with the second light
dropped fails the same limits against the whole reference.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.convert import scene_to_numpy
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from portbench.harness import cell as cells
from portbench.harness import check, control
from portbench.reference import scenes
from portbench.tests import config2_ablations as ablations
from portbench.tests.config2 import CONFIG2, CONFIG2_LIGHTS

ROOT = Path(__file__).resolve().parents[1]
CELL = "bunny-1080p-b2-shadows.render"
W, H, FRAMES = 64, 48, 2
# 2 x 23 x 46 = 2,116 triangles of the sphere.
N_THETA, N_PHI = 23, 46
SEEDS = (2147483659, 5000000029, 9007199254740881)


def _cell(seed: int = 1):
    """The cell at the test's size, its sphere cut to N_THETA x N_PHI with
    its noise drawn from ``seed``."""
    c = ablations.resized(cells.load_cell(ROOT, CELL), W, H, FRAMES)
    scene = dict(c.config["scene"])
    scene["objects"] = [{**scene["objects"][0], "n_theta": N_THETA, "n_phi": N_PHI,
                         "seed": seed}]
    return dataclasses.replace(c, config={**c.config, "scene": scene})


def _lights_moved(arrays: dict, seed: int) -> dict:
    """The scene's arrays with the lights' positions and intensities moved
    from ``seed``."""
    r = np.random.default_rng(seed)
    out = dict(arrays)
    pos, inten = arrays["lights.position"], arrays["lights.intensity"]
    out["lights.position"] = np.asarray(pos + r.normal(0.0, 1.0, pos.shape), np.float32)
    out["lights.intensity"] = np.asarray(inten * r.uniform(0.5, 1.5, inten.shape), np.float32)
    return out


@pytest.mark.parametrize("device, seed", [("cpu", s) for s in SEEDS]
                         + [pytest.param("cuda", SEEDS[0], marks=pytest.mark.cuda)],
                         ids=[f"cpu-{s}" for s in SEEDS] + ["cuda"])
def test_port_meets_the_reference(device, seed):
    """The port's image is within the cell's limits of the reference's at
    the same camera. On the CPU it counts no launch and no ray; on a card
    K6 runs in both modes, the bounces shade in PyTorch (no launch of the
    fused shading) and the light loop's shadow-ray slots are counted."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    cell = _cell(seed)
    arrays = _lights_moved(scenes.make_scene(cell.config["scene"]), seed)
    camera = scenes.make_camera(cell.config["camera"])
    cfg = P.RenderConfig(**cell.config["render"])
    scene = P.scene_from_numpy(arrays, device=device)
    assert scene.num_triangles == 36 + 2 * N_THETA * N_PHI > 2048
    assert P.resolve_backend(scene, cfg) == "pallas"
    accel = P.build_accel(scene, cfg)
    before = dict(build.LAUNCHES), dict(build.RAYS)
    img = P.render(scene, P.camera_from_numpy(camera, device=device), cfg, frames=FRAMES,
                   accel=accel)
    launches = {k: v - before[0][k] for k, v in build.LAUNCHES.items() if v != before[0][k]}
    rays = {k: v - before[1][k] for k, v in build.RAYS.items() if v != before[1][k]}
    if device == "cpu":
        assert launches == rays == {}
    else:
        R, L, n = W * H, 2, cfg.bounces * FRAMES
        assert launches == {"clustered_closest": n, "clustered_any": L * n, "raygen": FRAMES}
        assert rays == {"clustered_closest": R * n, "clustered_any": R * L * n,
                        "shade_plain": R * n, "wave_shadow": R * L * n,
                        "raygen_fused": R * FRAMES}
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


def test_configuration_is_config3_lit_as_config2():
    """The configuration's scene block builds the program's bunny_scene
    (69,732 triangles) with config 2's two lights, bit for bit: config 3's
    objects as bunny-512-b2 writes them, config 2's light records and
    render flags, at 1920 x 1080 x 2 on the wavefront path."""
    c = cells.load_cell(ROOT, CELL)
    conf = c.config
    bunny = json.loads((ROOT / "portbench/configs/bunny-512-b2.json").read_text())
    assert conf["scene"]["objects"] == bunny["scene"]["objects"]
    assert conf["scene"]["lights"] == CONFIG2_LIGHTS
    assert all(conf["render"][k] is v for k, v in CONFIG2.items())
    assert {k: conf["render"][k] for k in ("width", "height", "bounces", "spp")} == {
        "width": 1920, "height": 1080, "bounces": 2, "spp": 1}
    assert conf["reduced"] == [] and conf["path"] == "pallas"
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    rec = lambda k: [l[k] for l in CONFIG2_LIGHTS]
    lights = P.Lights(position=t(rec("position")), direction=t(rec("direction")),
                      light_type=t([P.LIGHT_POINT] * 2, torch.int32),
                      intensity=t(rec("intensity")), attenuation=t(rec("attenuation")),
                      cos_cutoff=t(rec("cos_cutoff")))
    want = scene_to_numpy(P.bunny_scene(lights=lights, device="cpu"))
    got = scenes.make_scene(conf["scene"])
    assert got["geometry.v0"].shape[0] == 69_732
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
