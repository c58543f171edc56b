"""mini_opencl_raytracer_tpu_torch — the PyTorch and CUDA port of the
differentiable path tracer, beside the JAX package it is held against.

Ported so far: the mega path's forward render and its gradient (camera
raygen, the counter-based RNG, the bounce recurrence, ``grad.py``), on
four fused bounce kernels written in CUDA for Hopper (csrc/megakernel.cu
forward, csrc/megakernel_bwd.cu backward); the wavefront ``pallas``
backend on the panel kernel (csrc/panel.cu, small scenes) and the
cluster-traversal kernel (csrc/clustered.cu, large scenes, laid out by
the native SAH build); the LBVH ``bvh`` backend (plain PyTorch, as the
JAX package's is jnp); the brute-force oracle; scene ingest (OBJ/MTL,
the procedural Cornell, bunny- and sponza-scale scenes); and the shell:
``cli.py`` (render / benchmark / optimize, checkpoint and resume) and
``utils/`` (images, checkpoints, metrics, error decoding); and the
multi-device paths of ``parallel/`` on ``torch.distributed`` (one process
per rank: pixel-sharded render and training step, geometry-sharded ring
and all-to-all traversal, the bounce pipeline, expert material routing);
and the JAX package's compiled programs (``jit.py``: ``render``, the
frame scan and the CLI's loops as captured CUDA graphs). Every kernel
has a plain PyTorch version that runs on the CPU. Importing the package
needs neither CUDA nor nvcc; the kernels build at first use on a CUDA
device.

Entry points put their tensors on ``config.DEFAULT_DEVICE`` ("cuda")
unless given ``device=``; without a CUDA device the default raises.

Public API::

    import mini_opencl_raytracer_tpu_torch as mrt

    scene  = mrt.cornell_scene()                         # on the card
    # or mrt.load_scene("model.obj"), with model.mtl beside it
    camera = mrt.Camera.default()
    cfg    = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    image  = mrt.render(scene, camera, cfg, frames=4)   # [H, W, 3]

    big    = mrt.bunny_scene()                           # 69,732 triangles
    cfg3   = mrt.RenderConfig(width=512, height=512, bounces=2)
    accel  = mrt.build_accel(big, cfg3)                  # SAH clusters
    image  = mrt.render(big, camera, cfg3, frames=4, accel=accel)

    from mini_opencl_raytracer_tpu_torch import grad
    g = grad.scene_grad(scene, camera, cfg, lambda img: img.mean())
"""

from .config import DEFAULT_DEVICE, BVHConfig, MeshConfig, RenderConfig
from .convert import camera_from_numpy, scene_from_numpy, scene_to_numpy
from .models.cornell import (CORNELL_MATERIAL_NAMES, cornell_geometry,
                             cornell_materials, cornell_scene, write_cornell_obj)
from .models.objloader import load_mtl, load_obj, load_scene
from .models.procedural import bunny_scene, sponza_scene
from .models.scene import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT, Camera,
                           Geometry, Lights, Materials, Scene)
from .ops.bvh import BVH, build_bvh, intersect_bvh, occluded_bvh
from .ops.intersect import Hit, intersect_brute, occluded_brute, ray_triangle
from .render import (RenderState, accumulate, build_accel, make_intersectors,
                     render, render_radiance, render_sample, resolve_backend,
                     to_image)

__version__ = "0.1.0"

__all__ = [
    "BVH", "BVHConfig", "Camera", "CORNELL_MATERIAL_NAMES", "DEFAULT_DEVICE",
    "Geometry", "Hit",
    "LIGHT_DIRECTIONAL", "LIGHT_POINT", "LIGHT_SPOT", "Lights", "Materials",
    "MeshConfig", "RenderConfig", "RenderState", "Scene", "accumulate",
    "build_accel", "build_bvh", "bunny_scene", "camera_from_numpy",
    "cornell_geometry", "cornell_materials", "cornell_scene", "intersect_brute",
    "intersect_bvh", "load_mtl", "load_obj", "load_scene", "make_intersectors",
    "occluded_brute", "occluded_bvh", "ray_triangle", "render",
    "render_radiance", "render_sample", "resolve_backend", "scene_from_numpy",
    "scene_to_numpy", "sponza_scene", "to_image", "write_cornell_obj",
]
