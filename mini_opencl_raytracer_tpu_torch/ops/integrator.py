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
brute-force integrator here and by the plain versions of the CUDA bounce
kernels (ops/cuda/megakernel.py), so both run the same arithmetic.

Only the unsorted wavefront is ported: the JAX package's coherence sort
permutes rays for its cluster-culling kernels and leaves every per-ray
value unchanged, so ``cfg.sort_rays`` does not change what this returns.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import RenderConfig
from ..models.scene import Lights, Scene
from .brdf import sample_brdf
from .intersect import Hit
from .lights import direct_light
from .linalg import dot, vmax
from .shading import HitAttributes, build_shading_table, hit_attributes


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
