"""Wavefront OBJ/MTL loader producing SoA tensor scenes (the JAX package's
``models/objloader.py``).

Feature parity with the reference's fscanf parser (CLOBJloader.cpp:10-176):

* ``v`` / ``vt`` / ``vn`` records (CLOBJloader.cpp:47-64);
* ``usemtl`` selects a material by name (CLOBJloader.cpp:65-78);
* ``f`` faces are fan-triangulated into the standard n-2 fan
  (CLOBJloader.cpp:101-126 emits one duplicate triangle more);
* indices are 1-based; the ``.mtl`` path is derived from the ``.obj`` name
  (CLOBJloader.cpp:18-23);
* MTL records ``newmtl``/``Kd``/``Ks``/``Ke``/``Ns``/``Ni``
  (CLOBJloader.cpp:140-175); ``Ns`` lands in ``roughness``, ``Ni`` in
  ``ior``.

Beyond the reference: negative (relative) indices, ``v//vn`` and bare
``v`` faces, face normals for faces without normals, zero texcoords when
there are none, and a grey default material when there is no MTL file.
Parsing stays in numpy; the result becomes tensors on ``device`` once.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..config import default_device
from .scene import Geometry, Lights, Materials, Scene


def _parse_index(token: str, count: int) -> Optional[int]:
    """1-based OBJ index -> 0-based; negatives are relative to end."""
    if not token:
        return None
    i = int(token)
    return i - 1 if i > 0 else count + i


def _material(diffuse) -> dict:
    return {"diffuse": np.asarray(diffuse, np.float32),
            "specular": np.zeros(3, np.float32),
            "emission": np.zeros(3, np.float32),
            "roughness": np.float32(1.0),
            "ior": np.float32(1.0)}


def load_mtl(path: str) -> Tuple[List[str], dict]:
    """Parse an MTL file -> (ordered material names, name -> fields dict).

    As CLOBJloader::LoadMaterials (CLOBJloader.cpp:131-176): only
    newmtl/Kd/Ks/Ke/Ns/Ni are read; unknown keys are skipped.
    """
    names: List[str] = []
    mats: dict = {}
    cur = None
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = parts[1]
                names.append(cur)
                mats[cur] = _material(np.zeros(3, np.float32))
            elif cur is None:
                continue
            elif key == "Kd":
                mats[cur]["diffuse"] = np.array(parts[1:4], np.float32)
            elif key == "Ks":
                mats[cur]["specular"] = np.array(parts[1:4], np.float32)
            elif key == "Ke":
                mats[cur]["emission"] = np.array(parts[1:4], np.float32)
            elif key == "Ns":
                mats[cur]["roughness"] = np.float32(parts[1])
            elif key == "Ni":
                mats[cur]["ior"] = np.float32(parts[1])
    return names, mats


def _native_triangles(path: str, name_to_idx: dict):
    """Triangles from the C++ parser (native/objparse.cpp), its material
    slots (in order of first ``usemtl``) remapped to MTL declaration order
    by *name*. Returns (v, n, uv, mat_idx) numpy arrays, or None when the
    native library is unavailable or a ``usemtl`` name is not in the MTL
    table (the Python parser's keep-the-previous-material rule cannot be
    rebuilt afterwards, so the Python parser runs instead)."""
    res = native.parse_obj_native(path)
    if res is None:
        return None
    v, n, uv, mat, nat_names = res
    if not all(nm in name_to_idx for nm in nat_names):
        return None
    # Slot -1 = a face before any usemtl -> material 0 (the Python default).
    remap = np.zeros((len(nat_names) + 1,), np.int32)
    for i, nm in enumerate(nat_names):
        remap[i] = name_to_idx[nm]
    return v, n, uv, remap[mat]  # mat == -1 indexes the trailing 0


def _python_triangles(path: str, name_to_idx: dict, dtype):
    """The pure-Python parser: (v [3, T, 3], n, uv [3, T, 2], mat_idx [T])."""
    positions: List[np.ndarray] = []
    normals: List[np.ndarray] = []
    texcoords: List[np.ndarray] = []
    # Per-triangle corners: (pos idx, uv idx or None, normal idx or None).
    tri_corners: List[tuple] = []
    tri_mats: List[int] = []
    cur_mat = 0
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append(np.array(parts[1:4], dtype))
            elif key == "vn":
                normals.append(np.array(parts[1:4], dtype))
            elif key == "vt":
                texcoords.append(np.array(parts[1:3], dtype))
            elif key == "usemtl":
                cur_mat = name_to_idx.get(parts[1], cur_mat)
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = _parse_index(sub[0], len(positions))
                    ti = _parse_index(sub[1], len(texcoords)) if len(sub) > 1 else None
                    ni = _parse_index(sub[2], len(normals)) if len(sub) > 2 else None
                    corners.append((vi, ti, ni))
                for i in range(1, len(corners) - 1):
                    tri_corners.append((corners[0], corners[i], corners[i + 1]))
                    tri_mats.append(cur_mat)

    T = len(tri_corners)
    P = np.asarray(positions, dtype) if positions else np.zeros((0, 3), dtype)
    N = np.asarray(normals, dtype) if normals else np.zeros((0, 3), dtype)
    UV = np.asarray(texcoords, dtype) if texcoords else np.zeros((0, 2), dtype)
    v = np.zeros((3, T, 3), dtype)
    n = np.zeros((3, T, 3), dtype)
    uv = np.zeros((3, T, 2), dtype)
    for t, tri in enumerate(tri_corners):
        for c, (vi, ti, ni) in enumerate(tri):
            v[c, t] = P[vi]
            if ti is not None and ti < len(UV):
                uv[c, t] = UV[ti]
            if ni is not None and ni < len(N):
                n[c, t] = N[ni]
        # Faces without normals take the geometric plane normal.
        if tri[0][2] is None or not np.any(n[:, t]):
            gn = np.cross(v[1, t] - v[0, t], v[2, t] - v[0, t])
            norm = np.linalg.norm(gn)
            gn = gn / norm if norm > 0 else np.array([0.0, 0.0, 1.0], dtype)
            n[0, t] = n[1, t] = n[2, t] = gn
    return v, n, uv, np.asarray(tri_mats, np.int32)


def load_obj(path: str, mtl_path: Optional[str] = None, dtype=np.float32,
             use_native: bool = True, device=None
             ) -> Tuple[Geometry, Materials, List[str]]:
    """Parse an OBJ file into SoA triangle tensors on ``device`` (default
    ``config.DEFAULT_DEVICE``).

    Returns (geometry, materials, material_names). Without an MTL file a
    single grey default material is used (the reference would crash,
    CLOBJloader.cpp:133-138). Geometry goes through the native C++ parser
    (native/objparse.cpp) for float32 when it builds, else through the
    Python parser; materials always parse in Python.
    """
    device = default_device(device)
    if mtl_path is None:
        guess = os.path.splitext(path)[0] + ".mtl"
        mtl_path = guess if os.path.exists(guess) else None
    if mtl_path is not None:
        names, mat_table = load_mtl(mtl_path)
    else:
        names, mat_table = ["default"], {"default": _material([0.7, 0.7, 0.7])}
    name_to_idx = {nm: i for i, nm in enumerate(names)}

    tris = (_native_triangles(path, name_to_idx)
            if use_native and dtype == np.float32 else None)
    if tris is None:
        tris = _python_triangles(path, name_to_idx, dtype)
    return (_build_geometry(*tris, device), _build_materials(mat_table, names, device),
            names)


def _build_geometry(v, n, uv, mat_idx, device) -> Geometry:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Geometry(v0=t(v[0]), v1=t(v[1]), v2=t(v[2]),
                    n0=t(n[0]), n1=t(n[1]), n2=t(n[2]),
                    uv0=t(uv[0]), uv1=t(uv[1]), uv2=t(uv[2]),
                    mat_idx=t(np.asarray(mat_idx, np.int32)))


def _build_materials(mat_table: dict, names: List[str], device) -> Materials:
    col = lambda key: torch.from_numpy(
        np.stack([mat_table[m][key] for m in names])).to(device)
    return Materials(diffuse=col("diffuse"), specular=col("specular"),
                     emission=col("emission"), roughness=col("roughness"),
                     ior=col("ior"))


def load_scene(path: str, lights: Optional[Lights] = None, device=None) -> Scene:
    """OBJ file -> Scene on ``device``; the default light is the reference's
    effective point light (kernel_bvh.cl:322-336)."""
    device = default_device(device)
    geometry, materials, _ = load_obj(path, device=device)
    if lights is None:
        lights = Lights.default_point(device=device)
    return Scene(geometry=geometry, materials=materials, lights=lights.to(device))
