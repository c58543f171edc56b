"""Scene data model: structure-of-arrays tensor dataclasses.

The same containers and leaf names as the JAX package's
``models/scene.py`` (geometry, materials, camera, lights), holding torch
tensors instead of JAX arrays. Every constructor takes a ``device``,
by default ``config.DEFAULT_DEVICE``; ``to(device)`` moves a whole
container.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import default_device


def _to(obj, device):
    """Copy of dataclass ``obj`` with every tensor leaf on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class Materials:
    """SoA material table (reference: CLMaterial, CLshared_structs.hpp:13-26).
    ``roughness`` holds the raw MTL ``Ns`` exponent; ``ior`` is unused by
    shading, as in the reference."""

    diffuse: torch.Tensor    # [M, 3] Kd
    specular: torch.Tensor   # [M, 3] Ks
    emission: torch.Tensor   # [M, 3] Ke
    roughness: torch.Tensor  # [M] Ns
    ior: torch.Tensor        # [M] Ni

    @property
    def count(self) -> int:
        return self.diffuse.shape[0]

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclasses.dataclass
class Geometry:
    """SoA triangle soup with per-corner vertices, normals and uvs
    (reference: CLTriangle, CLshared_structs.hpp:44-74)."""

    v0: torch.Tensor   # [T, 3] corner positions
    v1: torch.Tensor   # [T, 3]
    v2: torch.Tensor   # [T, 3]
    n0: torch.Tensor   # [T, 3] per-corner shading normals
    n1: torch.Tensor   # [T, 3]
    n2: torch.Tensor   # [T, 3]
    uv0: torch.Tensor  # [T, 2]
    uv1: torch.Tensor  # [T, 2]
    uv2: torch.Tensor  # [T, 2]
    mat_idx: torch.Tensor  # [T] int32 material index per triangle

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "Geometry":
        return _to(self, device)


@dataclasses.dataclass
class Camera:
    """Pinhole camera (reference: CLCamera, CLcamera.h:6-23): position
    (0,-25,8.5) looking along +Y with +Z up; right = cross(front, up)."""

    position: torch.Tensor  # [3]
    front: torch.Tensor     # [3]
    up: torch.Tensor        # [3]

    @staticmethod
    def default(dtype=torch.float32, device=None) -> "Camera":
        device = default_device(device)
        return Camera(
            position=torch.tensor([0.0, -25.0, 8.5], dtype=dtype, device=device),
            front=torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device),
            up=torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device),
        )

    def to(self, device) -> "Camera":
        return _to(self, device)


# Light types (CLLight.h:10: 0 == directional, 1 == point, 2 == spot).
LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


@dataclasses.dataclass
class Lights:
    """SoA analytic light set (directional / point / spot, several at once)."""

    position: torch.Tensor     # [L, 3]
    direction: torch.Tensor    # [L, 3]
    light_type: torch.Tensor   # [L] int32
    intensity: torch.Tensor    # [L]
    attenuation: torch.Tensor  # [L] quadratic falloff coefficient
    cos_cutoff: torch.Tensor   # [L] spot cosine cutoff

    @property
    def count(self) -> int:
        return self.position.shape[0]

    def to(self, device) -> "Lights":
        return _to(self, device)

    @staticmethod
    def default_point(dtype=torch.float32, device=None) -> "Lights":
        """The reference's effective point light: pos (0,-10,16),
        intensity 16, quadratic falloff 0.8 (kernel_bvh.cl:322-336)."""
        device = default_device(device)
        t = lambda v, dt=dtype: torch.tensor(v, dtype=dt, device=device)
        return Lights(
            position=t([[0.0, -10.0, 16.0]]),
            direction=t([[-0.5, 0.4, -0.1]]),
            light_type=t([LIGHT_POINT], torch.int32),
            intensity=t([16.0]),
            attenuation=t([0.8]),
            cos_cutoff=t([0.9]),
        )

    @staticmethod
    def default_directional(dtype=torch.float32, device=None) -> "Lights":
        """The reference's directional light: dir (-0.5,0.4,-0.1),
        intensity 1 (kernel_bvh.cl:307-321)."""
        device = default_device(device)
        t = lambda v, dt=dtype: torch.tensor(v, dtype=dt, device=device)
        return Lights(
            position=t([[0.0, -10.0, 16.0]]),
            direction=t([[-0.5, 0.4, -0.1]]),
            light_type=t([LIGHT_DIRECTIONAL], torch.int32),
            intensity=t([1.0]),
            attenuation=t([0.8]),
            cos_cutoff=t([0.9]),
        )


@dataclasses.dataclass
class Scene:
    """Geometry + materials + lights; the camera is passed separately."""

    geometry: Geometry
    materials: Materials
    lights: Lights

    @property
    def num_triangles(self) -> int:
        return self.geometry.num_triangles

    @property
    def device(self) -> torch.device:
        return self.geometry.device

    def to(self, device) -> "Scene":
        return Scene(geometry=self.geometry.to(device),
                     materials=self.materials.to(device),
                     lights=self.lights.to(device))
