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
kernels (ops/cuda/megakernel.py), so both run the same arithmetic. A
bounce shades by one of three routes (``shading_route``), chosen by what
its input shows: on a CUDA device, in float32 and without shadow rays,
``hit_attributes`` and ``shade_hit`` run as one kernel (ops/cuda/shade.py,
csrc/shade.cu), whose outputs are theirs bit for bit: alone where no
gradient is taken ("fused"), and where one is, with at most
``megakernel.MAX_LIGHTS`` lights, as an autograd Function whose backward is the
kernel of csrc/shade_bwd.cu ("adjoint"); anything else runs them in
PyTorch ("plain").

Above SORT_RAYS_MIN_TRIS triangles (or as ``cfg.sort_rays`` says) the
wavefront is coherence-sorted between bounces (``_trace_paths_sorted``)
so that neighbouring rays of the cluster-traversal kernel take similar
paths; each ray's values do not depend on where it sits in the wavefront,
so the sort changes no pixel. ``make_bounce_step`` is the per-bounce
transition in scan form for callers that run bounces apart (the pipeline
stages of parallel/pipeline.py); it keeps the ray order.

With ``cfg.remat`` (the default) each bounce runs under a checkpoint
where a gradient is taken (``_remat``, the JAX package's
``jax.checkpoint``): the backward keeps each bounce's input carry and
recomputes the rest of the bounce, the intersection included, instead of
holding every bounce's autograd graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

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
              occ_bits: Optional[torch.Tensor] = None, kn=None):
    """One bounce of the recurrence after the closest hit.

    Returns (o_next, d_next, beta_new, radiance, alive_next, occ_bits):
    ``radiance`` is the input plus this bounce's contributions, and
    ``occ_bits`` the per-light shadow-ray bitmask (0 without shadow rays).
    With shadow rays on, ``occ_bits`` given as an input replays that
    recorded visibility instead of calling ``occluder_fn`` (the backward
    bounce's frozen occlusion). ``kn`` records or replays the known-value
    rows of the BRDF sample and the lights (ops/known.py).
    """
    # Filled in on the device (no copy from host memory), rounded as
    # float32(c) * intensity like the kernels' sky.
    sky = torch.stack([o.new_full((), c, dtype=cfg.torch_dtype())
                       for c in cfg.sky_color]) * cfg.skybox_intensity
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
                         specular_model=cfg.specular_model, kn=kn)
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
                      occ_bits=occ_bits if cfg.shadow_rays else None, kn=kn)
    direct = dl.diffuse_weight[:, None] * at.kd
    if cfg.direct_specular:
        direct = direct + dl.specular_weight[:, None] * at.ks
    radiance = radiance + torch.where(lo[:, None], cov * direct * beta_new,
                                      zero3)

    o_next = torch.where(lo[:, None], at.pos + sample.wi * cfg.ray_epsilon, o)
    d_next = torch.where(lo[:, None], sample.wi, d)
    return o_next, d_next, beta_new, radiance, lo, dl.occ_bits


def shading_route(cfg: RenderConfig, o: torch.Tensor, grad: bool, num_lights: int) -> str:
    """How a bounce shades (ops/cuda/shade.py): "fused" (``shade_rows``, one
    kernel) for rays on a CUDA device, in float32, without shadow rays (the
    any-hit call sits inside the light loop) and with no gradient taken
    (``grad``, ``_grad_taken``); "adjoint" (``shade_grad``: that kernel
    forward, its adjoint kernel backward) where the same holds but a
    gradient is taken, with at most ``megakernel.MAX_LIGHTS`` lights (the
    adjoint's shared staging); else "plain" (``hit_attributes`` +
    ``shade_hit``)."""
    from .cuda.megakernel import MAX_LIGHTS
    if not (o.is_cuda and cfg.torch_dtype() == torch.float32 and not cfg.shadow_rays):
        return "plain"
    if not grad:
        return "fused"
    return "adjoint" if num_lights <= MAX_LIGHTS else "plain"


def make_bounce_core(scene: Scene, cfg: RenderConfig,
                     intersect_fn: Callable[[torch.Tensor, torch.Tensor], Hit],
                     occluder_fn: Optional[Callable] = None):
    """The per-bounce transition: carry = (o, d, beta, radiance, alive,
    seeds), ``bounce`` = global bounce index. Returns the next carry."""
    # Imported here: ops/cuda/shade imports this module.
    from .cuda import build, megakernel, shade
    st = build_shading_table(scene.geometry, scene.materials)
    scene_grad = _scene_grad(scene)
    # The [L, 16] lights of the kernels, packed here, outside any bounce's
    # checkpoint, as the table is: their gradient reaches the light leaves.
    lights = megakernel.pack_lights(scene.lights)

    def bounce_step(carry, bounce: int):
        o, d, beta, radiance, alive, seeds = carry
        hit = intersect_fn(o, d)
        route = shading_route(cfg, o, _grad_taken(scene_grad, carry), scene.lights.count)
        if route != "plain":
            shade_fn = shade.shade_rows if route == "fused" else shade.shade_grad
            return shade_fn(hit, st.table, o, d, beta, radiance, alive, seeds, bounce, lights,
                            cfg) + (seeds,)
        if o.is_cuda:
            build.RAYS["shade_plain"] += o.shape[0]
            if cfg.shadow_rays and occluder_fn is not None:
                build.RAYS["wave_shadow"] += o.shape[0] * scene.lights.count
        at = hit_attributes(o, d, hit, st, backface_cull=cfg.backface_cull,
                            soft_sigma=cfg.soft_edge_sigma)
        o, d, beta, radiance, alive, _ = shade_hit(
            at, hit.hit, o, d, beta, radiance, alive, seeds, bounce,
            scene.lights, cfg, occluder_fn)
        return o, d, beta, radiance, alive, seeds

    return bounce_step


def _tensor_leaves(obj):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _tensor_leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


def _scene_grad(scene: Scene) -> bool:
    return any(t.requires_grad for t in _tensor_leaves(scene))


def _grad_taken(scene_grad: bool, carry) -> bool:
    """Whether a bounce takes a gradient: grad mode on, and a leaf of the
    scene (``scene_grad``) or a tensor of the carry requires grad."""
    return torch.is_grad_enabled() and (scene_grad or any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in carry))


def _remat(scene: Scene, cfg: RenderConfig, fn):
    """``fn(carry, bounce)`` under a per-bounce checkpoint when
    ``cfg.remat`` and a gradient is being taken (grad mode on, and a leaf
    of the scene or a tensor of the carry requires grad); else ``fn``
    itself, so a forward without a gradient runs as it would without
    remat. The port's RNG is counter-based and draws nothing from torch's
    generators, so no RNG state is saved (saving it would also touch the
    CUDA generator inside a graph capture). The recompute runs the same
    deterministic kernels on the same inputs, so the gradients equal those
    of ``remat=False`` bit for bit."""
    if not cfg.remat:
        return fn
    scene_grad = _scene_grad(scene)

    def step(carry, bounce: int):
        if _grad_taken(scene_grad, carry):
            return checkpoint(fn, carry, bounce, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(carry, bounce)

    return step


def _sorted_wavefront(scene: Scene, intersect_fn, occluder_fn):
    """Wrap the intersectors to run on a coherence-sorted permutation of
    the rays and restore ray order on the way out (a stable ``torch.sort``
    of the keys and index gathers). Each ray's result depends only on
    that ray, so the values do not change."""
    g = scene.geometry
    pts = torch.cat([g.v0, g.v1, g.v2], dim=0).detach()
    lo, hi = torch.amin(pts, dim=0), torch.amax(pts, dim=0)

    def order(o, d):
        keys = _ray_sort_keys(o.detach(), d.detach(), lo, hi)
        perm = torch.sort(keys, stable=True).indices
        inverse = torch.empty_like(perm)
        inverse[perm] = torch.arange(perm.shape[0], device=perm.device)
        return perm, inverse

    def closest(o, d):
        perm, inverse = order(o, d)
        h = intersect_fn(o[perm], d[perm])
        return Hit(t=h.t[inverse], tri_idx=h.tri_idx[inverse], hit=h.hit[inverse],
                   rows=None if h.rows is None else h.rows[inverse])

    if occluder_fn is None:
        return closest, None

    def any_hit(o, d, t_limit):
        perm, inverse = order(o, d)
        return occluder_fn(o[perm], d[perm], t_limit[perm])[inverse]

    return closest, any_hit


def make_bounce_step(scene: Scene, cfg: RenderConfig, intersect_fn,
                     occluder_fn: Optional[Callable] = None, with_stats: bool = False):
    """The per-bounce transition in ``lax.scan`` form: ``step(carry,
    bounce) -> (carry, stat)`` with carry = (o, d, beta, radiance, alive,
    seeds) and ``bounce`` the global bounce index; ``stat`` is the
    fraction of rays alive after it with ``with_stats``, else None. Each
    step keeps the ray order (coherence sorting, where on, happens inside
    it through ``_sorted_wavefront``), so bounce segments can run as
    pipeline stages (parallel/pipeline.py); ``trace_paths`` keeps its
    wavefront permuted instead. Applies ``cfg.remat``."""
    occ = occluder_fn if cfg.shadow_rays else None
    sort_on = (cfg.sort_rays if cfg.sort_rays is not None
               else scene.num_triangles > SORT_RAYS_MIN_TRIS)
    if sort_on:
        intersect_fn, occ = _sorted_wavefront(scene, intersect_fn, occ)
    core = _remat(scene, cfg, make_bounce_core(scene, cfg, intersect_fn, occ))

    def step(carry, bounce: int):
        carry = core(carry, bounce)
        stat = carry[4].to(cfg.torch_dtype()).mean() if with_stats else None
        return carry, stat

    return step


def trace_paths(scene: Scene, cfg: RenderConfig, origins: torch.Tensor,
                directions: torch.Tensor, seeds: torch.Tensor,
                intersect_fn: Callable[[torch.Tensor, torch.Tensor], Hit],
                occluder_fn: Optional[Callable] = None, with_stats: bool = False):
    """Trace one wavefront for ``cfg.bounces`` bounces -> radiance [R, 3].

    ``with_stats=True`` also returns the fraction of rays alive after each
    bounce, [bounces] (utils/metrics.bounce_occupancy)."""
    sort_on = (cfg.sort_rays if cfg.sort_rays is not None
               else scene.num_triangles > SORT_RAYS_MIN_TRIS)
    if sort_on and cfg.bounces > 1:
        return _trace_paths_sorted(scene, cfg, origins, directions, seeds,
                                   intersect_fn, occluder_fn, with_stats)
    R = origins.shape[0]
    dtype = cfg.torch_dtype()
    dev = origins.device
    step = _remat(scene, cfg, make_bounce_core(scene, cfg, intersect_fn, occluder_fn))
    carry = (origins, directions,
             torch.ones((R, 3), dtype=dtype, device=dev),
             torch.zeros((R, 3), dtype=dtype, device=dev),
             torch.ones((R,), dtype=torch.bool, device=dev),
             seeds)
    stats = []
    for bounce in range(cfg.bounces):
        carry = step(carry, bounce)
        if with_stats:
            stats.append(carry[4].to(dtype).mean())
    # Final clamp (kernel_bvh.cl:383).
    return _result(vmax(carry[3], 0.0), stats, with_stats, dtype)


def _result(radiance, stats, with_stats: bool, dtype):
    if not with_stats:
        return radiance
    return radiance, (torch.stack(stats) if stats
                      else torch.zeros((0,), dtype=dtype, device=radiance.device))


def sort_carry(carry, lo, hi, park_o, park_d):
    """The sorted wavefront's step before a bounce: the carry (o, d, beta,
    radiance, alive, seeds, ridx) permuted (a stable sort) by the coherence
    key of its live rays in the scene box [lo, hi], dead lanes last, parked
    at ``park_o`` along ``park_d``."""
    o, d, alive = carry[0], carry[1], carry[4]
    keys = _ray_sort_keys(o.detach(), d.detach(), lo, hi)
    keys = torch.where(alive, keys, torch.full_like(keys, DEAD_KEY))
    perm = torch.sort(keys, stable=True).indices
    o, d, beta, radiance, alive, seeds, ridx = (x[perm] for x in carry)
    am = alive[:, None]
    return (torch.where(am, o, park_o), torch.where(am, d, park_d), beta, radiance, alive,
            seeds, ridx)


def _trace_paths_sorted(scene: Scene, cfg: RenderConfig, origins, directions,
                        seeds, intersect_fn, occluder_fn, with_stats: bool = False):
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
    core = make_bounce_core(scene, cfg, intersect_fn, occluder_fn)

    def sorted_step(carry, bounce: int):
        carry = sort_carry(carry, lo, hi, park_o, park_d)
        return core(carry[:6], bounce) + (carry[6],)

    # With remat the sort and the park run inside the checkpoint (as in the
    # JAX package), so a bounce keeps only its permuted carry.
    step0, sorted_step = _remat(scene, cfg, core), _remat(scene, cfg, sorted_step)
    carry = step0((origins, directions,
                   torch.ones((R, 3), dtype=dtype, device=dev),
                   torch.zeros((R, 3), dtype=dtype, device=dev),
                   torch.ones((R,), dtype=torch.bool, device=dev),
                   seeds), 0)
    stats = [carry[4].to(dtype).mean()] if with_stats else []
    carry = carry + (torch.arange(R, device=dev),)
    for bounce in range(1, cfg.bounces):
        carry = sorted_step(carry, bounce)
        if with_stats:
            stats.append(carry[4].to(dtype).mean())
    ridx = carry[6]
    inverse = torch.empty_like(ridx)
    inverse[ridx] = torch.arange(R, device=dev)
    # Final clamp (kernel_bvh.cl:383).
    return _result(vmax(carry[3][inverse], 0.0), stats, with_stats, dtype)
