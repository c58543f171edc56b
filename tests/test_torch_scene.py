"""The port's scene, tables and backend dispatch against the JAX package.

Scene leaves and the megakernel tables are exact copies (same float32
values, same integers): the port builds them by the same arithmetic.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu.render import resolve_backend as jresolve_backend
from mini_opencl_raytracer_tpu.ops.pallas import megakernel as jmk
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch.convert import scene_to_numpy
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk

torch.set_num_threads(1)


def _arrays(jscene):
    """JAX scene -> {"geometry.v0": np.ndarray, ...}."""
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def _two_lights_jax():
    return J.Lights(
        position=jnp.array([[0.0, -10.0, 16.0], [0.0, 10.0, 16.0]]),
        direction=jnp.array([[-0.5, 0.4, -0.1], [0.0, 0.1, -1.0]]),
        light_type=jnp.array([J.LIGHT_POINT, J.LIGHT_SPOT], jnp.int32),
        intensity=jnp.array([16.0, 12.0]),
        attenuation=jnp.array([0.8, 0.05]),
        cos_cutoff=jnp.array([0.9, 0.7]))


@pytest.mark.parametrize("group", ["geometry", "materials", "lights"])
def test_cornell_leaves_exact(group):
    ref = _arrays(J.cornell_scene())
    got = scene_to_numpy(P.cornell_scene(device="cpu"))
    keys = [k for k in ref if k.startswith(group + ".")]
    assert keys
    for k in keys:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_default_camera_and_lights_exact():
    jc, pc = J.Camera.default(), P.Camera.default(device="cpu")
    for name in ("position", "front", "up"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    jl, pl = J.Lights.default_directional(), P.Lights.default_directional(device="cpu")
    for f in dataclasses.fields(jl):
        np.testing.assert_array_equal(getattr(pl, f.name).numpy(),
                                      np.asarray(getattr(jl, f.name)))


def test_scene_from_numpy_round_trips():
    arrays = _arrays(J.cornell_scene(lights=_two_lights_jax()))
    scene = P.scene_from_numpy(arrays, device="cpu")
    assert scene.num_triangles == 36 and scene.lights.count == 2
    back = scene_to_numpy(scene)
    assert back.keys() == arrays.keys()
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    cam = P.camera_from_numpy({"position": np.array([1.0, 2.0, 3.0], np.float32),
                               "front": np.array([0.0, 1.0, 0.0], np.float32),
                               "up": np.array([0.0, 0.0, 1.0], np.float32)},
                              device="cpu")
    np.testing.assert_array_equal(cam.position.numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(cam.up.numpy(), [0.0, 0.0, 1.0])


@pytest.mark.parametrize("two_lights", [False, True])
def test_mega_table_and_lights_exact(two_lights):
    js = J.cornell_scene(lights=_two_lights_jax() if two_lights else None)
    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    ref_tab = np.asarray(jmk.build_mega_table(js.geometry, js.materials))
    got_tab = pmk.build_mega_table(ps.geometry, ps.materials).numpy()
    assert got_tab.shape == ref_tab.shape == (32, 40)
    np.testing.assert_array_equal(got_tab, ref_tab)
    np.testing.assert_array_equal(pmk.pack_lights(ps.lights).numpy(),
                                  np.asarray(jmk.pack_lights(js.lights)))
    # The accel holds (v0, e1, e2), the same values as the table's rows 0-8.
    tris = pmk.build_accel(ps.geometry).numpy()
    np.testing.assert_array_equal(tris, ref_tab[:9, :36].T)
    # unpack_lights inverts pack_lights.
    lv = pmk.pack_lights(ps.lights)
    np.testing.assert_array_equal(pmk.pack_lights(pmk.unpack_lights(lv)).numpy(),
                                  lv.numpy())


def _big_scene_arrays(n_tris, n_lights):
    """Zero-filled leaves with the given counts (dispatch only looks at
    counts and dtype)."""
    a = {}
    for name, cols in (("v0", 3), ("v1", 3), ("v2", 3), ("n0", 3), ("n1", 3),
                       ("n2", 3), ("uv0", 2), ("uv1", 2), ("uv2", 2)):
        a[f"geometry.{name}"] = np.zeros((n_tris, cols), np.float32)
    a["geometry.mat_idx"] = np.zeros((n_tris,), np.int32)
    for name, shape in (("diffuse", (1, 3)), ("specular", (1, 3)),
                        ("emission", (1, 3)), ("roughness", (1,)), ("ior", (1,))):
        a[f"materials.{name}"] = np.zeros(shape, np.float32)
    for name, shape in (("position", (n_lights, 3)), ("direction", (n_lights, 3)),
                        ("intensity", (n_lights,)), ("attenuation", (n_lights,)),
                        ("cos_cutoff", (n_lights,))):
        a[f"lights.{name}"] = np.zeros(shape, np.float32)
    a["lights.light_type"] = np.ones((n_lights,), np.int32)
    return a


def _jax_scene(arrays):
    g = {k.split(".")[1]: jnp.asarray(v) for k, v in arrays.items() if k.startswith("geometry.")}
    m = {k.split(".")[1]: jnp.asarray(v) for k, v in arrays.items() if k.startswith("materials.")}
    lt = {k.split(".")[1]: jnp.asarray(v) for k, v in arrays.items() if k.startswith("lights.")}
    return J.Scene(geometry=J.Geometry(**g), materials=J.Materials(**m), lights=J.Lights(**lt))


@pytest.mark.parametrize("n_tris,n_lights", [(36, 1), (2048, 30), (2049, 1), (36, 31)])
def test_eligible_and_resolve_backend_match(n_tris, n_lights):
    arrays = _big_scene_arrays(n_tris, n_lights)
    js, ps = _jax_scene(arrays), P.scene_from_numpy(arrays, device="cpu")
    for backend in ("auto", "mega", "bruteforce", "bvh", "pallas"):
        for dtype in ("float32", "bfloat16"):
            jc = J.RenderConfig(backend=backend, dtype=dtype)
            pc = P.RenderConfig(backend=backend, dtype=dtype)
            assert pmk.eligible(ps, pc) == jmk.eligible(js, jc)
            assert P.resolve_backend(ps, pc) == jresolve_backend(js, jc)


@pytest.mark.parametrize("backend", ["bvh"])
def test_unported_backends_raise(backend):
    scene, cam = P.cornell_scene(device="cpu"), P.Camera.default(device="cpu")
    cfg = P.RenderConfig(width=16, height=8, bounces=1, backend=backend)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.render_sample(scene, cam, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.build_accel(scene, cfg)


def test_pallas_backend_renders_on_cpu_when_asked():
    """backend="pallas" is ported: Cornell through the panel's plain
    version on the CPU, asked for with device="cpu"."""
    scene, cam = P.cornell_scene(device="cpu"), P.Camera.default(device="cpu")
    cfg = P.RenderConfig(width=16, height=8, bounces=2, backend="pallas")
    assert P.build_accel(scene, cfg) is None        # the panel needs none
    img = P.render(scene, cam, cfg, frames=2)
    assert img.device.type == "cpu" and img.shape == (8, 16, 3)
    assert torch.isfinite(img).all() and (img.amax(-1) > 0).float().mean() > 0.5


def test_entry_points_default_to_the_card():
    """Every constructor takes its default device from
    config.DEFAULT_DEVICE, "cuda"; without a CUDA device the default
    raises instead of building on the CPU."""
    assert P.DEFAULT_DEVICE == "cuda"
    makers = [P.cornell_scene, P.cornell_geometry, P.cornell_materials,
              P.Camera.default, P.Lights.default_point, P.Lights.default_directional,
              lambda: P.bunny_scene(target_tris=400),
              lambda: P.sponza_scene(target_tris=4000, n_objects=2),
              lambda: P.scene_from_numpy(_arrays(J.cornell_scene())),
              lambda: P.camera_from_numpy({k: np.zeros(3, np.float32)
                                           for k in ("position", "front", "up")})]
    for make in makers:
        if torch.cuda.is_available():
            out = make()
            leaf = next(v for _, v in pgrad._leaves(out))
            assert leaf.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
