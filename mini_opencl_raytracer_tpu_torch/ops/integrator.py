"""Path-trace integrator: the bounce loop over a ray wavefront.

The per-bounce recurrence of ``Render`` (kernel_bvh.cl:349-384), with
every ray advancing in lockstep under an ``alive`` mask:

  miss      -> radiance += beta * sky                 (kernel_bvh.cl:358-362)
  hit       -> radiance += beta * Ke * emission_scale (kernel_bvh.cl:365)
  sample    -> f, wi, pdf = SampleBrdf(...)           (kernel_bvh.cl:370)
  dead      -> pdf <= 0 or NaN ends the path          (kernel_bvh.cl:371-372)
  beta     *= f * (wi.n) / pdf                        (kernel_bvh.cl:374-375)
  direct    -> radiance += lightPixel * Kd * beta     (kernel_bvh.cl:378)
  respawn   -> ray = (pos + wi * eps, wi)             (kernel_bvh.cl:380)
  clamp     -> radiance = max(radiance, 0)            (kernel_bvh.cl:383)

``shade_hit`` is everything after the closest hit. It is shared by the
wavefront integrator here and by the plain versions of the CUDA bounce
kernels (ops/cuda/megakernel.py), so both run the same arithmetic.

Above SORT_RAYS_MIN_TRIS triangles (or as ``cfg.sort_rays`` says) the
wavefront is coherence-sorted between bounces (``_trace_paths_sorted``)
so that neighbouring rays of the cluster-traversal kernel take similar
paths; each ray's values do not depend on where it sits in the wavefront,
so the sort changes no pixel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..config import RenderConfig
from ..models.scene import Lights, Scene
from .brdf import sample_brdf
from .bvh import morton3d
from .intersect import Hit
from .lights import direct_light
from .linalg import dot, vmax
from .shading import HitAttributes, build_shading_table, hit_attributes

# Scenes above this size run the cluster-traversal kernel, whose warps
# stay coherent only if neighbouring rays start near each other and head
# the same way: the default threshold of cfg.sort_rays (equal to
# ops/cuda/intersect.FLAT_PANEL_MAX_TRIS).
SORT_RAYS_MIN_TRIS = 2048
# Sort key of dead lanes: above every live key (a live key's top octant
# bits reach at most 0xEFFFFFFF).
DEAD_KEY = 0xFFFFFFFF


def _ray_sort_keys(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """Coherence key (int64 holding a uint32): the 3-bit direction octant
    in the high bits, then the top 27 bits of the origin's 30-bit Morton
    code in the scene box [lo, hi]."""
    octant = ((d[:, 0] > 0).to(torch.int64) * 4
              + (d[:, 1] > 0).to(torch.int64) * 2
              + (d[:, 2] > 0).to(torch.int64))
    m = morton3d((o - lo) / torch.clamp(hi - lo, min=1e-12))
    return (octant << 29) | (m >> 3)


def park_point(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Where dead lanes park: outside every scene AABB, so their rays
    reject at the top-level slab test."""
    return hi + (hi - lo) + 1.0


def shade_hit(at: HitAttributes, hit: torch.Tensor, o, d, beta, radiance,
              alive, seeds, bounce: int, lights: Lights, cfg: RenderConfig,
              occluder_fn: Optional[Callable] = None,
              occ_bits: Optional[torch.Tensor] = None):
    """One bounce of the recurrence after the closest hit.

    Returns (o_next, d_next, beta_new, radiance, alive_next, occ_bits):
    ``radiance`` is the input plus this bounce's contributions, and
    ``occ_bits`` the per-light shadow-ray bitmask (0 without shadow rays).
    With shadow rays on, ``occ_bits`` given as an input replays that
    recorded visibility instead of calling ``occluder_fn`` (the backward
    bounce's frozen occlusion).
    """
    sky = (torch.tensor(cfg.sky_color, dtype=cfg.torch_dtype(), device=o.device)
           * cfg.skybox_intensity)
    cov = at.coverage[:, None]
    zero3 = torch.zeros_like(beta)

    miss = alive & ~hit
    radiance = radiance + torch.where(miss[:, None], beta * sky[None, :], zero3)

    live = alive & hit
    if cfg.soft_edge_sigma > 0.0:
        radiance = radiance + torch.where(
            live[:, None], (1.0 - cov) * beta * sky[None, :], zero3)
    radiance = radiance + torch.where(
        live[:, None], cov * beta * at.ke * cfg.emission_scale, zero3)

    wo = -d
    sample = sample_brdf(wo, at.normal, at.kd, at.ks, at.ns, seeds, bounce,
                         specular_prob=cfg.specular_prob,
                         specular_model=cfg.specular_model)
    cos_i = dot(sample.wi, at.normal)
    pdf_safe = torch.where(sample.pdf > 0.0, sample.pdf,
                           torch.ones_like(sample.pdf))
    mul = sample.f * (cos_i / pdf_safe)[:, None]
    ok = (sample.valid & (sample.pdf > 0.0)
          & torch.isfinite(mul).all(dim=-1))
    lo = live & ok
    beta_new = torch.where(lo[:, None], beta * mul, beta)

    # Direct analytic light, weighted by Kd and the *updated* beta
    # (kernel_bvh.cl:374-378 order).
    dl = direct_light(lights, at.pos, at.normal, wo, at.ns,
                      occluder_fn=occluder_fn if cfg.shadow_rays else None,
                      direct_specular=cfg.direct_specular,
                      shadow_eps=cfg.ray_epsilon,
                      occ_bits=occ_bits if cfg.shadow_rays else None)
    direct = dl.diffuse_weight[:, None] * at.kd
    if cfg.direct_specular:
        direct = direct + dl.specular_weight[:, None] * at.ks
    radiance = radiance + torch.where(lo[:, None], cov * direct * beta_new,
                                      zero3)

    o_next = torch.where(lo[:, None], at.pos + sample.wi * cfg.ray_epsilon, o)
    d_next = torch.where(lo[:, None], sample.wi, d)
    return o_next, d_next, beta_new, radiance, lo, dl.occ_bits


def make_bounce_core(scene: Scene, cfg: RenderConfig,
                     intersect_fn: Callable[[torch.Tensor, torch.Tensor], Hit],
                     occluder_fn: Optional[Callable] = None):
    """The per-bounce transition: carry = (o, d, beta, radiance, alive,
    seeds), ``bounce`` = global bounce index. Returns the next carry."""
    st = build_shading_table(scene.geometry, scene.materials)

    def bounce_step(carry, bounce: int):
        o, d, beta, radiance, alive, seeds = carry
        hit = intersect_fn(o, d)
        at = hit_attributes(o, d, hit, st, backface_cull=cfg.backface_cull,
                            soft_sigma=cfg.soft_edge_sigma)
        o, d, beta, radiance, alive, _ = shade_hit(
            at, hit.hit, o, d, beta, radiance, alive, seeds, bounce,
            scene.lights, cfg, occluder_fn)
        return o, d, beta, radiance, alive, seeds

    return bounce_step


def trace_paths(scene: Scene, cfg: RenderConfig, origins: torch.Tensor,
                directions: torch.Tensor, seeds: torch.Tensor,
                intersect_fn: Callable[[torch.Tensor, torch.Tensor], Hit],
                occluder_fn: Optional[Callable] = None) -> torch.Tensor:
    """Trace one wavefront for ``cfg.bounces`` bounces -> radiance [R, 3]."""
    sort_on = (cfg.sort_rays if cfg.sort_rays is not None
               else scene.num_triangles > SORT_RAYS_MIN_TRIS)
    if sort_on and cfg.bounces > 1:
        return _trace_paths_sorted(scene, cfg, origins, directions, seeds,
                                   intersect_fn, occluder_fn)
    R = origins.shape[0]
    dtype = cfg.torch_dtype()
    dev = origins.device
    step = make_bounce_core(scene, cfg, intersect_fn, occluder_fn)
    carry = (origins, directions,
             torch.ones((R, 3), dtype=dtype, device=dev),
             torch.zeros((R, 3), dtype=dtype, device=dev),
             torch.ones((R,), dtype=torch.bool, device=dev),
             seeds)
    for bounce in range(cfg.bounces):
        carry = step(carry, bounce)
    # Final clamp (kernel_bvh.cl:383).
    return vmax(carry[3], 0.0)


def _trace_paths_sorted(scene: Scene, cfg: RenderConfig, origins, directions,
                        seeds, intersect_fn, occluder_fn) -> torch.Tensor:
    """The wavefront with a permuted carry: bounce 0 runs in the caller's
    (tile-ordered, already coherent) ray order; before each later bounce
    the carry is re-sorted (stable) by the coherence key of its live rays,
    dead lanes go to the tail and park outside the scene box, and the
    whole bounce runs in the sorted order. ``ridx`` follows each lane's
    original ray; the radiance returns to ray order once, at the end.
    A stable ``torch.sort`` of the keys and index gathers are the plain
    form on the GPU (the JAX package sorted payload columns instead,
    because XLA's TPU gather is slow)."""
    R = origins.shape[0]
    dtype = cfg.torch_dtype()
    dev = origins.device
    g = scene.geometry
    pts = torch.cat([g.v0, g.v1, g.v2], dim=0).detach()
    lo, hi = torch.amin(pts, dim=0), torch.amax(pts, dim=0)
    park_o = park_point(lo, hi).to(dtype)
    park_d = torch.full((3,), 1.0 / math.sqrt(3.0), dtype=dtype, device=dev)
    step = make_bounce_core(scene, cfg, intersect_fn, occluder_fn)
    carry = step((origins, directions,
                  torch.ones((R, 3), dtype=dtype, device=dev),
                  torch.zeros((R, 3), dtype=dtype, device=dev),
                  torch.ones((R,), dtype=torch.bool, device=dev),
                  seeds), 0)
    ridx = torch.arange(R, device=dev)
    for bounce in range(1, cfg.bounces):
        o, d, beta, radiance, alive, seeds_ = carry
        keys = _ray_sort_keys(o.detach(), d.detach(), lo, hi)
        keys = torch.where(alive, keys, torch.full_like(keys, DEAD_KEY))
        perm = torch.sort(keys, stable=True).indices
        o, d, beta, radiance, alive, seeds_, ridx = (
            x[perm] for x in (o, d, beta, radiance, alive, seeds_, ridx))
        am = alive[:, None]
        o = torch.where(am, o, park_o)
        d = torch.where(am, d, park_d)
        carry = step((o, d, beta, radiance, alive, seeds_), bounce)
    inverse = torch.empty_like(ridx)
    inverse[ridx] = torch.arange(R, device=dev)
    # Final clamp (kernel_bvh.cl:383).
    return vmax(carry[3][inverse], 0.0)
