"""The port's OBJ/MTL loader, ``write_cornell_obj`` and
``Camera.from_angles`` against the JAX package's on the CPU.

The eight cases of tests/test_objloader.py run on the port; then, for the
same files, the port's ``load_obj`` leaves equal JAX's bitwise on both
parsers (native C++ and pure Python), ``write_cornell_obj`` writes the
same bytes, and ``Camera.from_angles`` the same float32 vectors.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu as J
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import native as pnative
from mini_opencl_raytracer_tpu_torch.models import objloader as pobj

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell_files(tmp_path_factory):
    return P.write_cornell_obj(str(tmp_path_factory.mktemp("cornell_obj")))


def _leaves(geo, mats):
    out = {}
    for group, obj in (("geometry", geo), ("materials", mats)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f"{group}.{f.name}"] = (v.numpy() if isinstance(v, torch.Tensor)
                                        else np.asarray(v))
    return out


def _needs_native():
    if not pnative.available():
        pytest.skip("native library unavailable (no g++)")


def test_mtl_parse(cornell_files):
    _, mtl_path = cornell_files
    names, mats = P.load_mtl(mtl_path)
    assert names == P.CORNELL_MATERIAL_NAMES
    assert len(names) == 6
    np.testing.assert_allclose(mats["BloodyRed"]["diffuse"], [0.445, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(mats["Light"]["emission"], [1.0, 1.0, 1.0], atol=1e-6)
    assert mats["LargerBox"]["roughness"] == pytest.approx(9999.0)
    assert mats["Material"]["ior"] == pytest.approx(1.0)


def test_obj_roundtrip_matches_procedural(cornell_files):
    obj_path, _ = cornell_files
    geo, mats, names = P.load_obj(obj_path, device="cpu")
    ref = P.cornell_geometry(device="cpu")
    assert geo.num_triangles == ref.num_triangles
    for name in ("v0", "v1", "v2", "n0"):
        np.testing.assert_allclose(getattr(geo, name).numpy(), getattr(ref, name).numpy(),
                                   atol=1e-5)
    np.testing.assert_array_equal(geo.mat_idx.numpy(), ref.mat_idx.numpy())
    assert geo.device.type == "cpu" and mats.diffuse.device.type == "cpu"


def test_fan_triangulation(tmp_path):
    """A pentagon fans into 3 triangles sharing corner 0
    (CLOBJloader.cpp:101-126)."""
    obj = tmp_path / "pent.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\nf 1 2 3 4 5\n")
    geo, _, _ = P.load_obj(str(obj), device="cpu")
    assert geo.num_triangles == 3
    np.testing.assert_allclose(geo.v0.numpy(), np.zeros((3, 3)), atol=1e-6)


def test_missing_normals_get_face_normal(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    geo, mats, names = P.load_obj(str(obj), device="cpu")
    np.testing.assert_allclose(geo.n0.numpy(), [[0, 0, 1]], atol=1e-6)
    # No MTL file: the grey default material.
    assert names == ["default"]
    np.testing.assert_allclose(mats.diffuse.numpy(), [[0.7, 0.7, 0.7]], atol=1e-7)


def test_negative_indices(tmp_path):
    obj = tmp_path / "neg.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    geo, _, _ = P.load_obj(str(obj), device="cpu")
    assert geo.num_triangles == 1
    np.testing.assert_allclose(geo.v1.numpy(), [[1, 0, 0]], atol=1e-6)


def test_native_parser_matches_python(cornell_files):
    """The C++ parser gives the Python parser's buffers; its material slots
    (order of first usemtl) remap to MTL order by name."""
    _needs_native()
    obj_path, _ = cornell_files
    res = pnative.parse_obj_native(obj_path)
    assert res is not None
    v, n, uv, mat, names = res
    geo, _, pynames = P.load_obj(obj_path, use_native=False, device="cpu")
    assert v.shape[1] == geo.num_triangles
    np.testing.assert_allclose(v[0], geo.v0.numpy(), atol=1e-5)
    np.testing.assert_allclose(v[1], geo.v1.numpy(), atol=1e-5)
    np.testing.assert_allclose(v[2], geo.v2.numpy(), atol=1e-5)
    np.testing.assert_allclose(n[0], geo.n0.numpy(), atol=1e-5)
    np.testing.assert_allclose(uv[2], geo.uv2.numpy(), atol=1e-5)
    remap = np.array([pynames.index(nm) for nm in names], np.int32)
    np.testing.assert_array_equal(remap[mat], geo.mat_idx.numpy())


def test_load_obj_native_path_matches_python(cornell_files):
    """load_obj takes the native path when it builds, and it gives the
    Python path's buffers."""
    _needs_native()
    obj_path, _ = cornell_files
    name_to_idx = {n: i for i, n in enumerate(P.load_mtl(obj_path[:-4] + ".mtl")[0])}
    assert pobj._native_triangles(obj_path, name_to_idx) is not None
    geo_n, mats_n, names_n = P.load_obj(obj_path, use_native=True, device="cpu")
    geo_p, mats_p, names_p = P.load_obj(obj_path, use_native=False, device="cpu")
    assert names_n == names_p
    ln, lp = _leaves(geo_n, mats_n), _leaves(geo_p, mats_p)
    for k in ln:
        np.testing.assert_allclose(ln[k], lp[k], atol=1e-6, err_msg=k)


def test_native_pre_usemtl_faces_get_material_zero(tmp_path):
    """Faces before any usemtl get material 0 on the native path (the C++
    parser gives them slot -1)."""
    _needs_native()
    obj = tmp_path / "pre.obj"
    obj.write_text("mtllib pre.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\nusemtl B\nf 1 2 3\n")
    (tmp_path / "pre.mtl").write_text("newmtl A\nKd 1 0 0\nnewmtl B\nKd 0 1 0\n")
    geo_n, _, _ = P.load_obj(str(obj), use_native=True, device="cpu")
    geo_p, _, _ = P.load_obj(str(obj), use_native=False, device="cpu")
    np.testing.assert_array_equal(geo_n.mat_idx.numpy(), [0, 1])
    np.testing.assert_array_equal(geo_p.mat_idx.numpy(), geo_n.mat_idx.numpy())


# The port against the JAX package on the same files.

_FILES = {
    "pent": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\nf 1 2 3 4 5\n", None),
    "tri": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", None),
    "neg": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 -1\nf -3//-1 -2//-1 -1//-1\n", None),
    "pre": ("mtllib pre.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.25 0.5\nf 1/1 2/1 3/1\n"
            "usemtl B\nf 3 2 1\nusemtl nosuch\nf 1 3 2\n",
            "newmtl A\nKd 1 0 0\nNs 7\nnewmtl B\nKd 0 1 0\nKe 2 2 2\nNi 1.5\n"),
}


@pytest.fixture(scope="module")
def obj_files(tmp_path_factory, cornell_files):
    d = tmp_path_factory.mktemp("objs")
    paths = {"cornell": cornell_files[0]}
    for name, (obj, mtl) in _FILES.items():
        (d / f"{name}.obj").write_text(obj)
        if mtl is not None:
            (d / f"{name}.mtl").write_text(mtl)
        paths[name] = str(d / f"{name}.obj")
    return paths


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name", ["cornell", "pent", "tri", "neg", "pre"])
def test_load_obj_matches_jax_bitwise(obj_files, name, use_native):
    if use_native:
        _needs_native()
    jg, jm, jn = J.load_obj(obj_files[name], use_native=use_native)
    pg, pm, pn = P.load_obj(obj_files[name], use_native=use_native, device="cpu")
    assert pn == jn
    ref, got = _leaves(jg, jm), _leaves(pg, pm)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_load_scene_matches_jax(obj_files):
    js = J.load_scene(obj_files["cornell"])
    ps = P.load_scene(obj_files["cornell"], device="cpu")
    for f in dataclasses.fields(ps.lights):
        np.testing.assert_array_equal(getattr(ps.lights, f.name).numpy(),
                                      np.asarray(getattr(js.lights, f.name)))
    assert ps.num_triangles == js.num_triangles == 36


def test_write_cornell_obj_same_bytes(tmp_path):
    jo, jm = J.write_cornell_obj(str(tmp_path / "jax"), stem="box")
    po, pm = P.write_cornell_obj(str(tmp_path / "port"), stem="box")
    for a, b in ((jo, po), (jm, pm)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b


@pytest.mark.parametrize("pitch,yaw", [(1.571, 1.571), (0.3, -2.0), (2.9, 0.7),
                                       (1.0e-3, 3.14159), (1.2345678, 5.4321)])
def test_camera_from_angles_matches_jax(pitch, yaw):
    """Bitwise: both take cos and sin of the float32 angles (ulp tolerance
    0 on this CPU)."""
    pos = [1.5, -20.0, 7.25]
    jc = J.Camera.from_angles(pos, pitch, yaw)
    pc = P.Camera.from_angles(pos, pitch, yaw, device="cpu")
    for name in ("position", "front", "up"):
        got, ref = getattr(pc, name).numpy(), np.asarray(getattr(jc, name))
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=name)
