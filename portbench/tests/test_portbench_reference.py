"""The benchmark's plain reference against the JAX package on the CPU, at
32 x 32 with at most 4 bounces: the radiance of a frame and the gradient
of an L2 image loss with respect to every float leaf. And the control: the
reference in bfloat16 fails the cells' comparison at a CPU test's size
(test_portbench_control.py reads it at each cell's own size on the card).

The JAX package runs its all-pairs oracle (``backend="bruteforce"``),
which tests every triangle as the reference does. Tolerances: radiance
|reference - JAX| <= 1e-4 of the largest JAX value on 99.9% of pixel
channels (a ray whose closest hit changes under another rounding goes
another way); gradients |reference - JAX| <= 1e-3 of the leaf's largest
JAX entry, on the entries where JAX's gradient is finite (its d/dNs is
NaN where sin(theta_h) rounds to 0; the reference's is 0 there, as the
program's).

The light path (shadow rays, the direct specular term, more than one
light, each type of light) is compared in radiance as the harness runs
the reference, and in gradient with denormals flushed to zero in torch,
as XLA's CPU code flushes them: pow(n.h, Ns) of a grazing light
underflows, JAX then has an exact 0 where torch has a denormal, and the
final clamp's tie (half the gradient at exactly 0) falls on other pixels
(tests/test_torch_grad.py compares the program so for the same reason).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import grad as jgrad

from portbench.harness import cell as cells
from portbench.harness import control
from portbench.reference import scenes, tracer
from portbench.tests.config2 import CONFIG2, CONFIG2_LIGHTS

ROOT = Path(__file__).resolve().parents[2]
CAMERA = {"position": [0.0, -25.0, 8.5], "front": [0.0, 1.0, 0.0], "up": [0.0, 0.0, 1.0]}
SPHERE = {"kind": "noisy_sphere", "center": [0.0, 12.0, 5.0], "radius": 4.0,
          "n_theta": 8, "n_phi": 16, "bump": 0.03, "seed": 1, "material": "Material"}

jax.config.update("jax_platforms", "cpu")


def _scenes(objects, lights=("point",)):
    arrays = scenes.make_scene({"room": "cornell", "lights": list(lights), "objects": objects})
    cam = scenes.make_camera(CAMERA)
    g = lambda grp, cls: cls(**{k.split(".")[1]: jnp.asarray(v) for k, v in arrays.items()
                                if k.startswith(grp + ".")})
    jscene = J.Scene(geometry=g("geometry", J.Geometry), materials=g("materials", J.Materials),
                     lights=g("lights", J.Lights))
    jcam = J.Camera(**{k: jnp.asarray(v) for k, v in cam.items()})
    tscene = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tcam = {k: torch.from_numpy(v) for k, v in cam.items()}
    return jscene, jcam, tscene, tcam


def _jcfg(**kw):
    return J.RenderConfig(width=32, height=32, backend="bruteforce", **kw)


def test_image_is_gamma_of_the_frame_mean():
    _, _, tscene, tcam = _scenes([])
    s = tracer.Settings(width=32, height=32, bounces=2)
    r = (tracer.radiance(tscene, tcam, s, 0) + tracer.radiance(tscene, tcam, s, 1)) / 2
    img = tracer.image(tscene, tcam, s, 2)
    assert torch.allclose(img, torch.pow(torch.clamp(r, min=0.0), 1 / 2.2))


def _assert_grads_match(objects, bounces, lights=("point",), counts=None, **flags):
    """The reference's loss and every float leaf's gradient against JAX's;
    returns the leaves compared (a leaf whose JAX gradient is all 0 has to
    be all 0 in the reference too, and is not counted)."""
    jscene, jcam, tscene, tcam = _scenes(objects, lights)
    cfg = _jcfg(bounces=bounces, **flags)
    target = np.random.default_rng(5).uniform(0.0, 1.0, (32, 32, 3)).astype(np.float32)
    jt = jnp.asarray(target)
    loss_fn = lambda img: jnp.mean((img - jt) ** 2)
    jg = jgrad.scene_grad(jscene, jcam, cfg, loss_fn)
    jc = jgrad.camera_grad(jscene, jcam, cfg, loss_fn)
    s = tracer.Settings(width=32, height=32, bounces=bounces, **flags)
    loss, g = tracer.loss_and_grads(tscene, tcam, s, torch.from_numpy(target), counts=counts)
    want_loss = float(jgrad.render_loss(jscene, jcam, cfg, loss_fn))
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss
    checked = []
    for name, got in g.items():
        group, leaf = name.split(".")
        src = jc if group == "camera" else getattr(jg, group)
        want = np.asarray(getattr(src, leaf), np.float64)
        got = got.double().numpy()
        fin = np.isfinite(want)
        if not fin.all():
            assert name == "materials.roughness", name
        assert np.isfinite(got).all(), name
        scale = np.abs(want[fin]).max() if fin.any() else 0.0
        if scale == 0.0:
            assert np.abs(got).max() == 0.0, name
            continue
        assert np.abs(got - want)[fin].max() <= 1e-3 * scale, name
        checked.append(name)
    return checked


@pytest.mark.parametrize("objects,bounces", [([], 3), ([SPHERE], 2)],
                         ids=["cornell-b3", "sphere-b2"])
def test_gradients_match_jax(objects, bounces):
    assert len(_assert_grads_match(objects, bounces)) >= 10


# One light of each type with shadow rays, over the sphere: a directional
# light leaving through the room's open side (y = 0), a point light under
# the ceiling, and a spot light above the sphere, aimed down.
THREE_KINDS = [
    {"type": "directional", "position": [0.0, 0.0, 0.0], "direction": [0.3, 1.0, -0.4],
     "intensity": 1.5, "attenuation": 0.8, "cos_cutoff": 0.9},
    {"type": "point", "position": [4.0, 2.0, 14.0], "direction": [0.0, 0.5, -1.0],
     "intensity": 40.0, "attenuation": 0.8, "cos_cutoff": 0.9},
    {"type": "spot", "position": [0.0, 12.0, 15.0], "direction": [0.0, 0.0, -1.0],
     "intensity": 100.0, "attenuation": 0.8, "cos_cutoff": 0.8},
]


@pytest.fixture
def flush_denormals():
    """Flush denormals like XLA's CPU code (module docstring)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _assert_each_light_lit_and_blocked(tscene, run):
    """For each light alone: of the rays that go on, some see it and some
    are blocked from it (tracer.Counts), over the same rays as ``run``."""
    L = tscene["lights.position"].shape[0]
    for li in range(L):
        one = {k: (v[li:li + 1] if k.startswith("lights.") else v) for k, v in tscene.items()}
        counts = run(one)
        seen = sum(sum(b.values()) for b in counts.seen)
        on = sum(counts.on)
        assert 0 < seen < on, (li, seen, on)


@pytest.mark.parametrize("objects,bounces,frame,lights,flags", [
    ([], 4, 0, ["point"], {}), ([], 4, 7, ["point"], {}), ([SPHERE], 2, 3, ["point"], {}),
    ([], 2, 0, CONFIG2_LIGHTS, CONFIG2), ([], 2, 5, CONFIG2_LIGHTS, CONFIG2),
    ([SPHERE], 2, 3, THREE_KINDS, {"shadow_rays": True})],
    ids=["cornell-b4-f0", "cornell-b4-f7", "sphere-b2-f3", "config2-cornell-b2-f0",
         "config2-cornell-b2-f5", "three-kinds-sphere-b2-f3"])
def test_radiance_matches_jax(objects, bounces, frame, lights, flags):
    jscene, jcam, tscene, tcam = _scenes(objects, lights)
    cfg = _jcfg(bounces=bounces, **flags)
    want = np.asarray(J.render_sample(jscene, jcam, cfg, frame=frame), np.float64)
    s = tracer.Settings(width=32, height=32, bounces=bounces, **flags)
    got = tracer.radiance(tscene, tcam, s, frame).double().numpy()
    assert np.isfinite(got).all()
    tol = 1e-4 * np.abs(want).max()
    off = np.abs(got - want) > tol
    assert off.mean() <= 1e-3, off.mean()
    assert want.mean() > 0.05
    if not s.shadow_rays:
        return
    # The branch ran: shadows change the image beyond the tolerance, and
    # every light is seen by some rays and blocked from others.
    plain = dataclasses.replace(s, shadow_rays=False)
    unshadowed = tracer.radiance(tscene, tcam, plain, frame).double().numpy()
    assert (np.abs(unshadowed - got) > tol).mean() > 1e-3

    def run(scene):
        counts = tracer.Counts.zeros(s.bounces)
        tracer.radiance(scene, tcam, s, frame, counts=counts)
        return counts
    _assert_each_light_lit_and_blocked(tscene, run)


def test_light_path_gradients_match_jax(flush_denormals):
    """Config 2's light path: the gradient of an L2 loss in every float
    leaf, the lights' included."""
    counts = tracer.Counts.zeros(2)
    checked = _assert_grads_match([], 2, CONFIG2_LIGHTS, counts=counts, **CONFIG2)
    assert len(checked) >= 10
    assert {"lights.position", "lights.intensity", "lights.attenuation"} <= set(checked)
    seen, on = sum(sum(b.values()) for b in counts.seen), sum(counts.on)
    assert 0 < seen < len(CONFIG2_LIGHTS) * on, (seen, on)


def _tiny_cell(name: str):
    """A cell of BENCHMARK.json with its configuration cut to a CPU test's
    size (the sizes of the cell itself run on the card)."""
    c = cells.load_cell(ROOT, name)
    c.config = json.loads(json.dumps(c.config))
    c.config["render"].update(width=32, height=24)
    for obj in c.config["scene"].get("objects", []):
        obj.update(n_theta=8, n_phi=16)
    return c


@pytest.mark.parametrize("name", [
    "cornell-1080p-b9.train", "bunny-512-b2.train", "bunny-512-b2.render",
    "cornell-1080p-b9.render"])
def test_bfloat16_fails_the_comparison(name):
    c = _tiny_cell(name)
    arrays = scenes.make_scene(c.config["scene"])
    camera = scenes.make_camera(c.config["camera"])
    sound = control.readings(c, arrays, camera, 1234567891011, "cpu")
    assert not control.fails(sound, c), sound
    low = control.readings(c, arrays, camera, 1234567891011, "cpu", torch.bfloat16)
    assert control.fails(low, c), low


def test_bfloat16_fails_config2_comparison():
    """BASELINE.json config 2 (two light records, shadow rays, the direct
    specular term, 2 bounces) on cornell-1080p-b9.render's files, cut to
    32x24: the float32 reading passes the render comparison and the
    bfloat16 control fails it."""
    c = _tiny_cell("cornell-1080p-b9.render")
    c.config["render"].update(bounces=2, **CONFIG2)
    c.config["scene"]["lights"] = json.loads(json.dumps(CONFIG2_LIGHTS))
    arrays = scenes.make_scene(c.config["scene"])
    assert arrays["lights.intensity"].tolist() == [16.0, 8.0]
    camera = scenes.make_camera(c.config["camera"])
    sound = control.readings(c, arrays, camera, 1234567891011, "cpu")
    assert not control.fails(sound, c), sound
    low = control.readings(c, arrays, camera, 1234567891011, "cpu", torch.bfloat16)
    assert control.fails(low, c), low


def test_search_equals_exact_all_pairs():
    """The grouped, matrix-product search gives the exact all-pairs closest
    hit: the same t and the same winner (ties to the lowest index), on
    camera rays and on rays from points inside the room, over more than
    one group of triangles."""
    sphere = {**SPHERE, "n_theta": 24, "n_phi": 48}
    arrays = scenes.make_scene({"room": "cornell", "lights": ["point"], "objects": [sphere]})
    geo = {k[9:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("geometry.")}
    tri = tracer.triangles(geo, torch.float32)
    assert tri.lo.shape[0] >= 2
    s = tracer.Settings(width=48, height=48)
    ids = torch.arange(48 * 48)
    cam = {k: torch.from_numpy(v) for k, v in scenes.make_camera(CAMERA).items()}
    o1, d1 = tracer.camera_rays(cam, s, ids, tracer.pixel_seeds(ids, 3), torch.float32)
    g = torch.Generator().manual_seed(11)
    o2 = torch.rand((3000, 3), generator=g) * torch.tensor([16.0, 20.0, 17.0]) \
        - torch.tensor([8.0, 0.0, 0.0])
    d2 = tracer.normalize(torch.randn((3000, 3), generator=g))
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    limit = torch.full((o.shape[0],), 1e5)
    t, i, hit, _ = tracer.closest_hit(o, d, limit, tri, False)
    xt, xi = tracer._exact_all(o, d, limit, tri.v0, tri.e1, tri.e2, False)
    assert hit.float().mean() > 0.5
    assert torch.equal(t, xt)
    assert torch.equal(i[hit], xi[hit])
