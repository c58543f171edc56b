"""The benchmark's scenes as plain numpy arrays, made from a configuration's
``scene`` block and nothing else.

A frozen copy of the generators of the system under test (the Cornell
room of the reference renderer's ``cornell.obj`` and the noisy UV sphere
that stands in for a bunny-scale mesh): the same triangles in the same
order, built in numpy float32 with fixed numpy seeds, so every run of a
cell gets the same scene. The arrays are keyed by leaf path
(``"geometry.v0"``, ``"materials.diffuse"``, ...), the form both the
program (``scene_from_numpy``) and the plain reference take.

A scene block's ``lights`` is a list of at least one light, in order.
Each entry is one of two forms:

* the string ``"point"``: the reference renderer's point light,
  ``POINT_LIGHT``;
* a record with exactly the keys ``type`` (``"directional"``,
  ``"point"`` or ``"spot"``, stored as 0 / 1 / 2, the program's
  ``LIGHT_*``), ``position`` and ``direction`` (3 numbers each), and
  ``intensity``, ``attenuation`` and ``cos_cutoff`` (one number each).
  Every key is required, none is added, and each number is finite in
  float32; no default stands in for a value the record leaves out.

The two forms may be mixed. A bad entry raises ``ValueError`` naming the
light's index and the key. The values go into ``lights.position``,
``lights.direction`` (float32, ``[L, 3]``), ``lights.light_type`` (int32),
``lights.intensity``, ``lights.attenuation`` and ``lights.cos_cutoff``
(float32, ``[L]``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# name -> (Kd, Ks, Ke, Ns, Ni), in the order of the material table.
CORNELL_MATERIALS = {
    "BloodyRed": ((0.445, 0.0, 0.0), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 92.0, 1.0),
    "DarkGreen": ((0.0, 0.32, 0.0), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 92.0, 1.0),
    "LargerBox": ((0.8, 0.65, 0.43), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 9999.0, 1.0),
    "Light": ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 1.0, 1.0),
    "Material": ((0.64, 0.64, 0.64), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 96.0, 1.0),
    "SmallerBox": ((0.8, 0.65, 0.43), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 9999.0, 1.0),
}
MATERIAL_NAMES = list(CORNELL_MATERIALS)

# The reference renderer's point light (kernel_bvh.cl:322-336).
POINT_LIGHT = {"position": [0.0, -10.0, 16.0], "direction": [-0.5, 0.4, -0.1],
               "type": 1, "intensity": 16.0, "attenuation": 0.8, "cos_cutoff": 0.9}

# A light record's keys, and its type names as the program's LIGHT_*.
LIGHT_KEYS = ("type", "position", "direction", "intensity", "attenuation", "cos_cutoff")
LIGHT_TYPES = {"directional": 0, "point": 1, "spot": 2}

GEOMETRY_KEYS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_idx")


class _Mesh:
    def __init__(self) -> None:
        self.v: List[list] = [[], [], []]
        self.n: List[list] = [[], [], []]
        self.uv: List[list] = [[], [], []]
        self.mat: List[int] = []

    def tri(self, p0, p1, p2, normal, mat, uv0=(0, 0), uv1=(1, 0), uv2=(1, 1)):
        for i, (p, t) in enumerate(((p0, uv0), (p1, uv1), (p2, uv2))):
            self.v[i].append(np.asarray(p, np.float32))
            self.n[i].append(np.asarray(normal, np.float32))
            self.uv[i].append(np.asarray(t, np.float32))
        self.mat.append(mat)

    def quad(self, p0, p1, p2, p3, normal, mat):
        self.tri(p0, p1, p2, normal, mat, (0, 0), (1, 0), (1, 1))
        self.tri(p0, p2, p3, normal, mat, (0, 0), (1, 1), (0, 1))

    def box(self, center, size, mat, yaw):
        cx, cy, cz = center
        sx, sy, sz = size[0] / 2.0, size[1] / 2.0, size[2] / 2.0
        c, s = math.cos(yaw), math.sin(yaw)
        rot = lambda x, y, z: (cx + c * x - s * y, cy + s * x + c * y, cz + z)
        rotn = lambda x, y, z: (c * x - s * y, s * x + c * y, z)
        P = {(ix, iy, iz): rot(x, y, z)
             for ix, x in enumerate((-sx, sx)) for iy, y in enumerate((-sy, sy))
             for iz, z in enumerate((-sz, sz))}
        faces = [
            (((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)), (-1, 0, 0)),
            (((1, 1, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)), (1, 0, 0)),
            (((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)), (0, -1, 0)),
            (((1, 1, 0), (1, 1, 1), (0, 1, 1), (0, 1, 0)), (0, 1, 0)),
            (((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)), (0, 0, -1)),
            (((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)), (0, 0, 1)),
        ]
        for keys, nv in faces:
            self.quad(*(P[k] for k in keys), rotn(*nv), mat)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {}
        for i in range(3):
            out[f"v{i}"] = np.stack(self.v[i])
            out[f"n{i}"] = np.stack(self.n[i])
            out[f"uv{i}"] = np.stack(self.uv[i])
        out["mat_idx"] = np.asarray(self.mat, np.int32)
        return out


def cornell_room() -> Dict[str, np.ndarray]:
    """The 36-triangle Cornell room: x in [-8, 8], y in [0, 20], z in [0,
    17], open at y = 0, two boxes, an emissive ceiling quad."""
    m = {n: i for i, n in enumerate(MATERIAL_NAMES)}
    b = _Mesh()
    X, Y0, Y1, Z0, Z1 = 8.0, 0.0, 20.0, 0.0, 17.0
    b.quad((-X, Y0, Z0), (-X, Y1, Z0), (-X, Y1, Z1), (-X, Y0, Z1), (1, 0, 0), m["BloodyRed"])
    b.quad((X, Y1, Z0), (X, Y0, Z0), (X, Y0, Z1), (X, Y1, Z1), (-1, 0, 0), m["DarkGreen"])
    b.quad((-X, Y1, Z0), (X, Y1, Z0), (X, Y1, Z1), (-X, Y1, Z1), (0, -1, 0), m["Material"])
    b.quad((-X, Y0, Z0), (X, Y0, Z0), (X, Y1, Z0), (-X, Y1, Z0), (0, 0, 1), m["Material"])
    b.quad((-X, Y1, Z1), (X, Y1, Z1), (X, Y0, Z1), (-X, Y0, Z1), (0, 0, -1), m["Material"])
    b.quad((-3.0, 13.0, Z1 - 0.05), (3.0, 13.0, Z1 - 0.05),
           (3.0, 7.0, Z1 - 0.05), (-3.0, 7.0, Z1 - 0.05), (0, 0, -1), m["Light"])
    b.box((-3.5, 14.0, 4.0), (5.0, 5.0, 8.0), m["LargerBox"], 0.3)
    b.box((3.5, 8.0, 2.0), (4.0, 4.0, 4.0), m["SmallerBox"], -0.25)
    return b.arrays()


def noisy_sphere(center, radius: float, n_theta: int, n_phi: int, material: str,
                 bump: float, seed: int) -> Dict[str, np.ndarray]:
    """UV sphere with radial noise, 2 * n_theta * n_phi triangles: first
    (p00, p10, p11) of every grid quad in row-major order, then (p00, p11,
    p01)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, math.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = radius * (1.0 + bump * rng.standard_normal((n_theta + 1, n_phi + 1))
                  .astype(np.float32))
    r[:, -1] = r[:, 0]
    P = np.stack([(r * np.sin(tt) * np.cos(pp) + center[0]).astype(np.float32),
                  (r * np.sin(tt) * np.sin(pp) + center[1]).astype(np.float32),
                  (r * np.cos(tt) + center[2]).astype(np.float32)], axis=-1)
    n_out = P - np.asarray(center, np.float32)
    n_out /= np.maximum(np.linalg.norm(n_out, axis=-1, keepdims=True), 1e-9)

    def corner(a, di, dj):
        return a[di:di + n_theta, dj:dj + n_phi].reshape(-1, 3)

    def tris(a):
        return (np.concatenate([corner(a, 0, 0), corner(a, 0, 0)]),
                np.concatenate([corner(a, 1, 0), corner(a, 1, 1)]),
                np.concatenate([corner(a, 1, 1), corner(a, 0, 1)]))

    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    v, n = tris(P), tris(n_out)
    T = v[0].shape[0]
    uv = np.zeros((T, 2), np.float32)
    out = {f"v{i}": f32(v[i]) for i in range(3)}
    out.update({f"n{i}": f32(n[i]) for i in range(3)})
    out.update({f"uv{i}": uv.copy() for i in range(3)})
    out["mat_idx"] = np.full((T,), MATERIAL_NAMES.index(material), np.int32)
    return out


def make_scene(spec: dict) -> Dict[str, np.ndarray]:
    """A configuration's ``scene`` block -> leaf-path arrays: the room,
    then each object of ``objects`` in order, the material table and the
    lights."""
    if spec.get("room") != "cornell":
        raise ValueError(f"unknown room {spec.get('room')!r}")
    parts = [cornell_room()]
    for obj in spec.get("objects", []):
        kind = obj.get("kind")
        if kind != "noisy_sphere":
            raise ValueError(f"unknown object kind {kind!r}")
        parts.append(noisy_sphere(obj["center"], obj["radius"], obj["n_theta"],
                                  obj["n_phi"], obj["material"], obj["bump"], obj["seed"]))
    out = {f"geometry.{k}": np.concatenate([p[k] for p in parts]) for k in GEOMETRY_KEYS}
    vals = [CORNELL_MATERIALS[n] for n in MATERIAL_NAMES]
    for i, key in enumerate(("diffuse", "specular", "emission", "roughness", "ior")):
        out[f"materials.{key}"] = np.array([v[i] for v in vals], np.float32)
    lights = spec.get("lights", ["point"])
    if not isinstance(lights, list) or not lights:
        raise ValueError(f"scene.lights: a list of at least one light, not {lights!r}")
    L = [_light(i, entry) for i, entry in enumerate(lights)]
    out["lights.position"] = np.array([l["position"] for l in L], np.float32)
    out["lights.direction"] = np.array([l["direction"] for l in L], np.float32)
    out["lights.light_type"] = np.array([l["type"] for l in L], np.int32)
    out["lights.intensity"] = np.array([l["intensity"] for l in L], np.float32)
    out["lights.attenuation"] = np.array([l["attenuation"] for l in L], np.float32)
    out["lights.cos_cutoff"] = np.array([l["cos_cutoff"] for l in L], np.float32)
    return out


def _light(index: int, entry) -> dict:
    """One entry of a scene block's ``lights`` -> its values, keyed as
    ``POINT_LIGHT`` (``type`` as its number)."""
    where = f"scene.lights[{index}]"
    if isinstance(entry, str):
        if entry != "point":
            raise ValueError(f"{where}: unknown light {entry!r} (a light is \"point\" "
                             f"or a record of the keys {', '.join(LIGHT_KEYS)})")
        return POINT_LIGHT
    if not isinstance(entry, dict):
        raise ValueError(f"{where}: a light is \"point\" or a record, not {entry!r}")
    for key in LIGHT_KEYS:
        if key not in entry:
            raise ValueError(f"{where}: key {key!r} is missing")
    for key in entry:
        if key not in LIGHT_KEYS:
            raise ValueError(f"{where}: key {key!r} is not a light's key "
                             f"({', '.join(LIGHT_KEYS)})")
    kind = entry["type"]
    if not isinstance(kind, str) or kind not in LIGHT_TYPES:
        raise ValueError(f"{where}: key 'type' is {kind!r}, not one of "
                         f"{', '.join(LIGHT_TYPES)}")
    out = {"type": LIGHT_TYPES[kind]}
    for key in LIGHT_KEYS[1:]:
        value = entry[key]
        vector = key in ("position", "direction")
        if vector and (not isinstance(value, list) or len(value) != 3):
            raise ValueError(f"{where}: key {key!r} is {value!r}, not a list of 3 numbers")
        if not all(_finite32(x) for x in (value if vector else [value])):
            raise ValueError(f"{where}: key {key!r} is {value!r}, not "
                             f"{'3 numbers' if vector else 'a number'} finite in float32")
        out[key] = value
    return out


def _finite32(x) -> bool:
    """A JSON number (not a bool) that float32 holds as a finite value."""
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return False
    try:
        with np.errstate(over="ignore"):
            return bool(np.isfinite(np.float32(x)))
    except OverflowError:
        return False


def make_camera(spec: dict) -> Dict[str, np.ndarray]:
    """A configuration's ``camera`` block -> {"position", "front", "up"}."""
    return {k: np.asarray(spec[k], np.float32) for k in ("position", "front", "up")}
