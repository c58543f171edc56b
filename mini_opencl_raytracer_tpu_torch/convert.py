"""Scene and camera state to and from numpy arrays keyed by leaf path.

The keys are the JAX package's leaf paths (``"geometry.v0"``,
``"materials.diffuse"``, ``"lights.light_type"``, ...), so a scene made
by either package crosses into the other as a plain dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import default_device
from .models.scene import Camera, Geometry, Lights, Materials, Scene

_GROUPS = (("geometry", Geometry), ("materials", Materials), ("lights", Lights))


def scene_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> Scene:
    """Build a Scene from ``{"geometry.v0": array, ...}`` (every leaf of
    every group is required) on ``device`` (default
    ``config.DEFAULT_DEVICE``). Arrays keep their dtypes."""
    device = default_device(device)
    parts = {}
    for group, cls in _GROUPS:
        parts[group] = cls(**{
            f.name: torch.from_numpy(np.array(arrays[f"{group}.{f.name}"]))
            .to(device)
            for f in dataclasses.fields(cls)})
    return Scene(**parts)


def scene_to_numpy(scene: Scene) -> Dict[str, np.ndarray]:
    """Inverse of scene_from_numpy."""
    return {f"{group}.{f.name}":
            getattr(getattr(scene, group), f.name).detach().cpu().numpy()
            for group, cls in _GROUPS for f in dataclasses.fields(cls)}


def camera_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> Camera:
    """Build a Camera from ``{"position": ..., "front": ..., "up": ...}``."""
    device = default_device(device)
    return Camera(**{
        f.name: torch.from_numpy(np.array(arrays[f.name])).to(device)
        for f in dataclasses.fields(Camera)})
