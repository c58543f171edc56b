"""Dispatch of the wavefront ``pallas`` backend (the JAX package's
``ops/pallas/intersect.py``): the panel kernel for small scenes, the
cluster-traversal kernel for large ones."""

from __future__ import annotations

from typing import Optional

from ...config import RenderConfig
from ...models.scene import Geometry, Materials
from . import clustered, panel

# Scenes above this triangle count go to the cluster traversal (the JAX
# package's threshold, ops/pallas/intersect.py:12).
FLAT_PANEL_MAX_TRIS = panel.MAX_TRIS


def make_intersectors(geometry: Geometry, cfg: RenderConfig, accel=None,
                      materials: Optional[Materials] = None):
    """(closest, any_hit) for ops/integrator.trace_paths."""
    if geometry.num_triangles <= FLAT_PANEL_MAX_TRIS:
        return panel.make_intersectors(geometry, cfg)
    return clustered.make_intersectors(geometry, cfg, accel=accel,
                                       materials=materials)


def build_accel(geometry: Geometry, cfg: RenderConfig,
                materials: Optional[Materials] = None):
    """The accel of the backend: None for panel scenes, the clustered
    slot layout (native SAH when available) above
    FLAT_PANEL_MAX_TRIS; with ``materials`` it carries shading rows."""
    if geometry.num_triangles <= FLAT_PANEL_MAX_TRIS:
        return None
    return clustered.build_accel(geometry, materials=materials)
