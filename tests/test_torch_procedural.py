"""The port's procedural scenes, Morton codes and native SAH build against
the JAX package's.

Scene leaves are exact copies (same numpy seeds, same float32 math), the
Morton codes equal bit for bit, and the native library (the same C++
sources built with the same flags) gives the same SAH order.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mini_opencl_raytracer_tpu import native as jnative
from mini_opencl_raytracer_tpu.models import procedural as jproc
from mini_opencl_raytracer_tpu.ops import bvh as jbvh
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import native as pnative
from mini_opencl_raytracer_tpu_torch.convert import scene_to_numpy
from mini_opencl_raytracer_tpu_torch.ops import bvh as pbvh
from portbench.reference import scenes as bench_scenes

torch.set_num_threads(1)


def _arrays(jscene):
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def _assert_same_scene(js, ps):
    _assert_same_arrays(_arrays(js), scene_to_numpy(ps))


def _assert_same_arrays(ref, got):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_bunny_scene_bit_identical():
    js = jproc.bunny_scene(target_tris=4000)
    ps = P.bunny_scene(target_tris=4000, device="cpu")
    assert ps.num_triangles == js.num_triangles == 36 + 2 * 31 * 62
    _assert_same_scene(js, ps)


def test_sponza_scene_bit_identical():
    js = jproc.sponza_scene(target_tris=12_000, n_objects=5)
    ps = P.sponza_scene(target_tris=12_000, n_objects=5, device="cpu")
    assert ps.num_triangles == js.num_triangles
    _assert_same_scene(js, ps)


def test_sponza_configuration_is_the_program_scene():
    """The benchmark's frozen configuration sponza-4k-b1 (its scene block
    through the benchmark's own generator) is the program's sponza_scene
    at full size, bit for bit: every geometry leaf, the materials and the
    light."""
    path = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "sponza-4k-b1.json"
    ref = bench_scenes.make_scene(json.loads(path.read_text())["scene"])
    assert ref["geometry.v0"].shape[0] == 259_620
    _assert_same_arrays(ref, scene_to_numpy(P.sponza_scene(device="cpu")))


def test_config2_configuration_is_the_program_scene():
    """The benchmark's configuration cornell-1080p-b2-shadows is BASELINE.json
    config 2 as benchmarks/run_all.py:111-130 sets it: its scene block,
    through the benchmark's own generator, is the program's cornell_scene
    with config 2's two point lights, bit for bit; its render block gives
    the RenderConfig of run_all.py:121-123; and the program serves it on
    the mega path (K1 / K2)."""
    path = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
            / "cornell-1080p-b2-shadows.json")
    conf = json.loads(path.read_text())
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    lights = P.Lights(position=t([[0.0, -10.0, 16.0], [4.0, 2.0, 14.0]]),
                      direction=t([[-0.5, 0.4, -0.1], [0.0, 0.5, -1.0]]),
                      light_type=t([P.LIGHT_POINT, P.LIGHT_POINT], torch.int32),
                      intensity=t([16.0, 8.0]), attenuation=t([0.8, 0.8]),
                      cos_cutoff=t([0.9, 0.9]))
    scene = P.cornell_scene(lights=lights, device="cpu")
    _assert_same_arrays(bench_scenes.make_scene(conf["scene"]), scene_to_numpy(scene))
    cfg = P.RenderConfig(**conf["render"])
    assert cfg == P.RenderConfig(width=1920, height=1080, bounces=2, shadow_rays=True,
                                 direct_specular=True)
    assert P.resolve_backend(scene, cfg) == "mega" == conf["path"]


def test_full_size_scene_counts():
    """The BASELINE.json config 3 and 5 scenes at their published sizes."""
    assert P.bunny_scene(device="cpu").num_triangles == 69_732
    assert P.sponza_scene(device="cpu").num_triangles == 259_620


def test_morton3d_matches_jax():
    pts = np.random.default_rng(4).uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1.0], [1023 / 1024] * 3]
    ref = np.asarray(jbvh.morton3d(jnp.asarray(pts))).astype(np.int64)
    got = pbvh.morton3d(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.max() < 2 ** 30


def _soup(n, seed):
    r = np.random.default_rng(seed)
    base = r.uniform([-8, 0, 0], [8, 20, 17], size=(n, 3)).astype(np.float32)
    e1 = r.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    e2 = r.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    return base, base + e1, base + e2


def test_native_sah_order_matches_jax():
    """The port's ctypes loader builds native/ into build/native/ and
    gives the JAX package's SAH layout on a 3000-triangle soup."""
    if not jnative.available():
        pytest.skip("no C++ compiler: neither package has the native SAH library")
    assert pnative.available()
    assert pnative.library_path().parent == pnative.BUILD_DIR
    assert pnative.BUILD_DIR.parent.name == "build"
    v0, v1, v2 = _soup(3000, seed=9)
    ref = jnative.sah_order(v0, v1, v2, leaf_size=128)
    got = pnative.sah_order(v0, v1, v2, leaf_size=128)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    order, starts, counts = got
    assert sorted(order.tolist()) == list(range(3000))
    assert counts.max() <= 128 and counts.sum() == 3000


def test_native_library_is_keyed_by_host_cpu(monkeypatch):
    """The library is built with -march=native: one built for another
    CPU's target options lives under another name and is never loaded."""
    here = pnative.library_path()
    monkeypatch.setattr(pnative, "_target", lambda: "-mavx512f [enabled]")
    assert pnative.library_path() != here
    assert pnative.library_path().parent == here.parent
