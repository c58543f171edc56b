"""mini_opencl_raytracer_tpu_torch — the PyTorch and CUDA port of the
differentiable path tracer, beside the JAX package it is held against.

Ported so far: the mega path's forward render and its gradient (camera
raygen, the counter-based RNG, the bounce recurrence, ``grad.py``), on
four fused bounce kernels written in CUDA for Hopper (csrc/megakernel.cu
forward, csrc/megakernel_bwd.cu backward), each with a plain PyTorch
version that runs on the CPU, and the brute-force oracle. Importing the
package needs neither CUDA nor nvcc; the kernels build at first use on a
CUDA device.

Public API::

    import mini_opencl_raytracer_tpu_torch as mrt

    scene  = mrt.cornell_scene(device="cuda")
    camera = mrt.Camera.default(device="cuda")
    cfg    = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    image  = mrt.render(scene, camera, cfg, frames=4)   # [H, W, 3]

    from mini_opencl_raytracer_tpu_torch import grad
    g = grad.scene_grad(scene, camera, cfg, lambda img: img.mean())
"""

from .config import BVHConfig, MeshConfig, RenderConfig
from .convert import camera_from_numpy, scene_from_numpy, scene_to_numpy
from .models.cornell import (CORNELL_MATERIAL_NAMES, cornell_geometry,
                             cornell_materials, cornell_scene)
from .models.scene import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT, Camera,
                           Geometry, Lights, Materials, Scene)
from .ops.intersect import Hit, intersect_brute, occluded_brute, ray_triangle
from .render import (RenderState, accumulate, build_accel, render,
                     render_radiance, render_sample, resolve_backend, to_image)

__version__ = "0.1.0"

__all__ = [
    "BVHConfig", "Camera", "CORNELL_MATERIAL_NAMES", "Geometry", "Hit",
    "LIGHT_DIRECTIONAL", "LIGHT_POINT", "LIGHT_SPOT", "Lights", "Materials",
    "MeshConfig", "RenderConfig", "RenderState", "Scene", "accumulate",
    "build_accel", "camera_from_numpy", "cornell_geometry",
    "cornell_materials", "cornell_scene", "intersect_brute", "occluded_brute",
    "ray_triangle", "render", "render_radiance", "render_sample",
    "resolve_backend", "scene_from_numpy", "scene_to_numpy", "to_image",
]
