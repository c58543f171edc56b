"""Configuration for the PyTorch/CUDA port of the raytracer.

Same fields and defaults as ``mini_opencl_raytracer_tpu/config.py``: every
constant the reference hardcoded (scene file, FOV, light parameters,
bounces, sky) is an explicit frozen-dataclass field, so a render is a pure
function of (scene, camera, config, frame). ``dtype`` names a float type
and maps to a torch dtype through ``torch_dtype()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Where the entry points (scene and camera constructors, convert.py) put
# their tensors when the caller names no device. The port runs on the
# card; a caller who wants the CPU says ``device="cpu"``.
DEFAULT_DEVICE = "cuda"


def default_device(device=None) -> torch.device:
    """``device``, or ``DEFAULT_DEVICE`` when it is None. Raises when the
    device names CUDA and there is no CUDA device, so that nothing runs on
    the CPU unasked (utils/errors.py decodes the message)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the device is {str(dev)!r} and there is no CUDA device here; "
            "pass device='cpu' to build on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the reference's ImGui widgets,
    CLui.cpp:204-266, plus its hardcoded kernel constants)."""

    width: int = 512
    height: int = 512
    # Path-trace depth; reference default 9 (CLRaytracer.h:32).
    bounces: int = 9
    # Samples accumulated per call to ``render_sample``.
    spp: int = 1
    # Vertical field of view in degrees (hardcoded 45 at kernel_bvh.cl:392).
    fov_deg: float = 45.0
    # Constant-grey sky multiplier (kernel_bvh.cl:92-96, CLRaytracer.h:34).
    skybox_intensity: float = 1.0
    sky_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # Emission boost applied in the integrator (kernel_bvh.cl:365: `* 50`).
    emission_scale: float = 50.0
    # Self-intersection offset along the scattered direction
    # (kernel_bvh.cl:380: `isect.pos + wi * 0.01`).
    ray_epsilon: float = 1e-2
    # Max ray distance (kernel_bvh.cl:7 MAX_RENDER_DIST).
    t_max: float = 1.0e5
    # Cull back-facing triangles in intersection (default off, like the
    # reference's CULL_BACKFACE constant).
    backface_cull: bool = False
    # Cast occlusion (shadow) rays for the direct-light term.
    shadow_rays: bool = False
    # Add a Blinn-Phong specular direct-light term.
    direct_specular: bool = False
    # Probability of choosing the specular lobe per bounce
    # (kernel_bvh.cl:294-302).
    specular_prob: float = 0.5
    # Specular microfacet distribution: "blinn" or "ggx" (ops/brdf.py).
    specular_model: str = "blinn"
    # Soft-visibility relaxation bandwidth in barycentric units; 0 means
    # hard visibility, the reference's semantics (ops/shading.py).
    soft_edge_sigma: float = 0.0
    # Gamma for output encoding (kernel_bvh.cl:405-413).
    gamma: float = 2.2
    # Rays per intersection chunk on the brute-force path; bounds the
    # [rays x tris] intermediates.
    ray_chunk: int = 4096
    # Intersection backend: "auto" | "bruteforce" | "bvh" | "pallas" |
    # "mega". "auto" and "mega" resolve to "mega" for eligible scenes
    # (render.resolve_backend), as in the JAX package.
    backend: str = "auto"
    # Rematerialise the wavefront backward (ops/integrator._remat, JAX's
    # jax.checkpoint): where a gradient is taken, each bounce keeps only
    # its input carry and recomputes the rest, the intersection included.
    # The gradients are bitwise those of remat=False. The mega path keeps
    # only its own per-bounce state either way.
    remat: bool = True
    # Generate camera rays and seeds inside the first bounce kernel.
    fused_raygen: bool = True
    # Mega path backward: the bounce kernel K2 also writes the known-value
    # residual rows of its shading (ops/known.py, 17 a ray on Cornell) and
    # K4 reads them instead of recomputing the transcendentals and the RNG
    # draws. False recomputes. The gradients agree within float rounding.
    bwd_residuals: bool = False
    # Coherence-sort the wavefront between bounces (ops/integrator.py);
    # None = on above SORT_RAYS_MIN_TRIS triangles. Per-pixel values do
    # not depend on it.
    sort_rays: Optional[bool] = None
    # float dtype for the compute path.
    dtype: str = "float32"

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def num_pixels(self) -> int:
        return self.height * self.width

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    """LBVH build settings (ops/bvh.build_bvh reads ``leaf_size``; the other
    two fields are kept for parity with the JAX config)."""

    leaf_size: int = 8
    morton_bits: int = 21
    max_depth: int = 64


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh settings of parallel/: ``dp`` ranks over pixels (None:
    the world size // tp) and ``tp`` over geometry, and the mesh
    dimensions' names (parallel/mesh.make_mesh)."""

    dp: Optional[int] = None
    tp: int = 1
    dp_axis: str = "dp"
    tp_axis: str = "tp"


DEFAULT_RENDER = RenderConfig()
DEFAULT_BVH = BVHConfig()
DEFAULT_MESH = MeshConfig()
