"""Procedural benchmark scenes at bunny and sponza scale.

The JAX package's generators (``models/procedural.py``): a ~70k-triangle
noisy sphere ('bunny-scale', BASELINE.json config 3) and ~260k triangles
of noisy spheres scattered through the room ('sponza-scale', config 5),
inside the Cornell room so the lighting and camera defaults keep
working. The same numpy seeds and float32 arithmetic give bit-identical
leaves; the triangles are laid out with array slicing instead of the
JAX package's Python loop, in the same order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import default_device
from .cornell import CORNELL_MATERIAL_NAMES, cornell_geometry, cornell_materials
from .scene import Geometry, Lights, Scene


def _concat_geometry(a: Geometry, b: Geometry) -> Geometry:
    cat = lambda x, y: torch.cat([x, y], dim=0)
    return Geometry(
        v0=cat(a.v0, b.v0), v1=cat(a.v1, b.v1), v2=cat(a.v2, b.v2),
        n0=cat(a.n0, b.n0), n1=cat(a.n1, b.n1), n2=cat(a.n2, b.n2),
        uv0=cat(a.uv0, b.uv0), uv1=cat(a.uv1, b.uv1), uv2=cat(a.uv2, b.uv2),
        mat_idx=cat(a.mat_idx, b.mat_idx),
    )


def _sphere_mesh(center, radius: float, n_theta: int, n_phi: int,
                 mat: int, bump: float = 0.0, seed: int = 0,
                 device=None) -> Geometry:
    """UV-sphere triangle mesh with optional radial noise ('bunny-like'
    surface detail). 2 * n_theta * n_phi triangles: first (p00, p10, p11)
    of every grid quad in row-major order, then (p00, p11, p01)."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, math.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * math.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")  # [n_theta+1, n_phi+1]
    r = radius * (1.0 + bump * rng.standard_normal((n_theta + 1, n_phi + 1))
                  .astype(np.float32))
    # Seam + poles keep consistent radius.
    r[:, -1] = r[:, 0]
    x = (r * np.sin(tt) * np.cos(pp) + center[0]).astype(np.float32)
    y = (r * np.sin(tt) * np.sin(pp) + center[1]).astype(np.float32)
    z = (r * np.cos(tt) + center[2]).astype(np.float32)
    P = np.stack([x, y, z], axis=-1)  # [T+1, P+1, 3]
    n_out = P - np.asarray(center, np.float32)
    n_out /= np.maximum(np.linalg.norm(n_out, axis=-1, keepdims=True), 1e-9)

    def corner(a, di, dj):
        return a[di:di + n_theta, dj:dj + n_phi].reshape(-1, 3)

    def tris(a):
        return (np.concatenate([corner(a, 0, 0), corner(a, 0, 0)]),
                np.concatenate([corner(a, 1, 0), corner(a, 1, 1)]),
                np.concatenate([corner(a, 1, 1), corner(a, 0, 1)]))

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    v = [t(a) for a in tris(P)]
    n = [t(a) for a in tris(n_out)]
    T = v[0].shape[0]
    uv = torch.zeros((T, 2), dtype=torch.float32, device=device)
    return Geometry(
        v0=v[0], v1=v[1], v2=v[2], n0=n[0], n1=n[1], n2=n[2],
        uv0=uv, uv1=uv.clone(), uv2=uv.clone(),
        mat_idx=torch.full((T,), mat, dtype=torch.int32, device=device),
    )


def bunny_scene(target_tris: int = 70_000, lights: Optional[Lights] = None,
                device=None) -> Scene:
    """~70k-triangle organic blob ('bunny-scale') inside the Cornell room
    (BASELINE.json config 3)."""
    device = default_device(device)
    room = cornell_geometry(device)
    nt = int(math.sqrt(target_tris / 4.0))
    npphi = max(2 * nt, 4)
    blob = _sphere_mesh(center=(0.0, 12.0, 5.0), radius=4.0,
                        n_theta=nt, n_phi=npphi,
                        mat=CORNELL_MATERIAL_NAMES.index("Material"),
                        bump=0.03, seed=1, device=device)
    lights = lights if lights is not None else Lights.default_point(device=device)
    return Scene(geometry=_concat_geometry(room, blob),
                 materials=cornell_materials(device=device),
                 lights=lights.to(device))


def sponza_scene(target_tris: int = 260_000, n_objects: int = 24,
                 lights: Optional[Lights] = None, device=None) -> Scene:
    """~260k-triangle multi-object hall ('Sponza-scale'): many detailed
    blobs scattered through the room (BASELINE.json config 5)."""
    device = default_device(device)
    rng = np.random.default_rng(3)
    per_obj = target_tris // n_objects
    nt = int(math.sqrt(per_obj / 4.0))
    npphi = max(2 * nt, 4)
    parts = [cornell_geometry(device)]
    mats = [CORNELL_MATERIAL_NAMES.index(nm)
            for nm in ("Material", "BloodyRed", "DarkGreen", "LargerBox")]
    for k in range(n_objects):
        c = (float(rng.uniform(-6.5, 6.5)),
             float(rng.uniform(2.0, 18.5)),
             float(rng.uniform(1.5, 15.0)))
        parts.append(_sphere_mesh(center=c, radius=float(rng.uniform(0.7, 1.6)),
                                  n_theta=nt, n_phi=npphi,
                                  mat=mats[k % len(mats)],
                                  bump=0.05, seed=10 + k, device=device))
    geo = Geometry(**{f: torch.cat([getattr(p, f) for p in parts], dim=0)
                      for f in Geometry.__dataclass_fields__})
    lights = lights if lights is not None else Lights.default_point(device=device)
    return Scene(geometry=geo, materials=cornell_materials(device=device),
                 lights=lights.to(device))
