"""Procedural Cornell-box scene generator.

The same generator as the JAX package's ``models/cornell.py`` (same
materials, same triangles in the same order, built in numpy float32), so
every leaf is bit-identical to the reference's. The ``.obj`` writer waits
for the port of the OBJ loader.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..config import default_device
from .scene import Geometry, Lights, Materials, Scene

# Material table: name -> (Kd, Ks, Ke, Ns, Ni); the six names of the
# reference's cornell.mtl.
CORNELL_MATERIALS = {
    "BloodyRed": ((0.445, 0.0, 0.0), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 92.0, 1.0),
    "DarkGreen": ((0.0, 0.32, 0.0), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 92.0, 1.0),
    "LargerBox": ((0.8, 0.65, 0.43), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 9999.0, 1.0),
    "Light": ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 1.0, 1.0),
    "Material": ((0.64, 0.64, 0.64), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 96.0, 1.0),
    "SmallerBox": ((0.8, 0.65, 0.43), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 9999.0, 1.0),
}
CORNELL_MATERIAL_NAMES = list(CORNELL_MATERIALS.keys())


class _MeshBuilder:
    """Accumulates triangles with per-corner normals/uvs and material ids."""

    def __init__(self) -> None:
        self.v: List[list] = [[], [], []]
        self.n: List[list] = [[], [], []]
        self.uv: List[list] = [[], [], []]
        self.mat: List[int] = []

    def tri(self, p0, p1, p2, normal, mat: int,
            uv0=(0, 0), uv1=(1, 0), uv2=(1, 1)) -> None:
        for i, (p, t) in enumerate(((p0, uv0), (p1, uv1), (p2, uv2))):
            self.v[i].append(np.asarray(p, np.float32))
            self.n[i].append(np.asarray(normal, np.float32))
            self.uv[i].append(np.asarray(t, np.float32))
        self.mat.append(mat)

    def quad(self, p0, p1, p2, p3, normal, mat: int) -> None:
        """Two triangles covering the quad p0-p1-p2-p3 in fan order
        (CLOBJloader.cpp:101-126)."""
        self.tri(p0, p1, p2, normal, mat, (0, 0), (1, 0), (1, 1))
        self.tri(p0, p2, p3, normal, mat, (0, 0), (1, 1), (0, 1))

    def box(self, center, size, mat: int, yaw: float = 0.0) -> None:
        """Axis-aligned box rotated by ``yaw`` around +Z, outward normals."""
        cx, cy, cz = center
        sx, sy, sz = size[0] / 2.0, size[1] / 2.0, size[2] / 2.0
        c, s = math.cos(yaw), math.sin(yaw)

        def rot(p):
            x, y, z = p
            return (cx + c * x - s * y, cy + s * x + c * y, cz + z)

        def rotn(nv):
            x, y, z = nv
            return (c * x - s * y, s * x + c * y, z)

        lo, hi = (-sx, -sy, -sz), (sx, sy, sz)
        P = {}
        for ix, x in enumerate((lo[0], hi[0])):
            for iy, y in enumerate((lo[1], hi[1])):
                for iz, z in enumerate((lo[2], hi[2])):
                    P[(ix, iy, iz)] = rot((x, y, z))
        faces = [
            (((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)), (-1, 0, 0)),
            (((1, 1, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)), (1, 0, 0)),
            (((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)), (0, -1, 0)),
            (((1, 1, 0), (1, 1, 1), (0, 1, 1), (0, 1, 0)), (0, 1, 0)),
            (((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)), (0, 0, -1)),
            (((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)), (0, 0, 1)),
        ]
        for keys, nv in faces:
            a, b, cc, d = (P[k] for k in keys)
            self.quad(a, b, cc, d, rotn(nv), mat)

    def geometry(self, device) -> Geometry:
        def stack(lst, d):
            arr = np.stack(lst) if lst else np.zeros((0, d), np.float32)
            return torch.from_numpy(arr).to(device)
        return Geometry(
            v0=stack(self.v[0], 3), v1=stack(self.v[1], 3), v2=stack(self.v[2], 3),
            n0=stack(self.n[0], 3), n1=stack(self.n[1], 3), n2=stack(self.n[2], 3),
            uv0=stack(self.uv[0], 2), uv1=stack(self.uv[1], 2), uv2=stack(self.uv[2], 2),
            mat_idx=torch.from_numpy(np.asarray(self.mat, np.int32)).to(device),
        )


def cornell_materials(dtype=torch.float32, device=None) -> Materials:
    device = default_device(device)
    vals = [CORNELL_MATERIALS[n] for n in CORNELL_MATERIAL_NAMES]

    def col(i):
        arr = np.array([v[i] for v in vals], np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return Materials(diffuse=col(0), specular=col(1), emission=col(2),
                     roughness=col(3), ior=col(4))


def cornell_geometry(device=None) -> Geometry:
    """Cornell room: interior x in [-8,8], y in [0,20], z in [0,17], open
    front at y=0; red left wall, green right wall, grey floor/ceiling/back;
    two boxes; emissive ceiling quad. Normals face the room interior."""
    device = default_device(device)
    m = {n: i for i, n in enumerate(CORNELL_MATERIAL_NAMES)}
    b = _MeshBuilder()
    X, Y0, Y1, Z0, Z1 = 8.0, 0.0, 20.0, 0.0, 17.0

    b.quad((-X, Y0, Z0), (-X, Y1, Z0), (-X, Y1, Z1), (-X, Y0, Z1), (1, 0, 0), m["BloodyRed"])
    b.quad((X, Y1, Z0), (X, Y0, Z0), (X, Y0, Z1), (X, Y1, Z1), (-1, 0, 0), m["DarkGreen"])
    b.quad((-X, Y1, Z0), (X, Y1, Z0), (X, Y1, Z1), (-X, Y1, Z1), (0, -1, 0), m["Material"])
    b.quad((-X, Y0, Z0), (X, Y0, Z0), (X, Y1, Z0), (-X, Y1, Z0), (0, 0, 1), m["Material"])
    b.quad((-X, Y1, Z1), (X, Y1, Z1), (X, Y0, Z1), (-X, Y0, Z1), (0, 0, -1), m["Material"])
    b.quad((-3.0, 13.0, Z1 - 0.05), (3.0, 13.0, Z1 - 0.05),
           (3.0, 7.0, Z1 - 0.05), (-3.0, 7.0, Z1 - 0.05), (0, 0, -1), m["Light"])
    b.box(center=(-3.5, 14.0, 4.0), size=(5.0, 5.0, 8.0), mat=m["LargerBox"], yaw=0.3)
    b.box(center=(3.5, 8.0, 2.0), size=(4.0, 4.0, 4.0), mat=m["SmallerBox"], yaw=-0.25)
    return b.geometry(device)


def cornell_scene(lights: Optional[Lights] = None, device=None) -> Scene:
    device = default_device(device)
    if lights is None:
        lights = Lights.default_point(device=device)
    return Scene(geometry=cornell_geometry(device),
                 materials=cornell_materials(device=device),
                 lights=lights.to(device))
