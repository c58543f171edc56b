"""BRDF sampling: cosine-hemisphere diffuse + Blinn or GGX specular
(kernel_bvh.cl:221-302, spec-cleaned as the JAX package's ``ops/brdf.py``
describes), vectorized over rays. Lobe selection is the reference's 50/50
roulette without division by the lobe probability."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import known, rng
from .linalg import build_onb, dot, reflect, vclip, vmax

_TWO_PI = 2.0 * math.pi
_INV_PI = 1.0 / math.pi


class BrdfSample(NamedTuple):
    wi: torch.Tensor     # [R, 3] sampled incident direction
    f: torch.Tensor      # [R, 3] BRDF value
    pdf: torch.Tensor    # [R] sampling pdf
    valid: torch.Tensor  # [R] bool — sample admissible


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x >= 0 whose gradient at x == 0 is 0, not inf.

    sin(theta_h) = sqrt(max(1 - cos^2, 0)) is exactly 0 whenever cos(theta_h)
    rounds to 1: for GGX on the Ns = 9999 Cornell boxes, most draws; for
    Blinn there, about 3e-4 of them. Plain sqrt then gives an inf or NaN
    gradient (0 * inf where the cotangent is zero, as it is on the lobe
    that was not picked), which reaches d/dNs. So does the JAX package's.
    The value is unchanged."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _direction(kn, name: str, s, t, n, cp, sp, ct) -> torch.Tensor:
    """Direction from local spherical angles in the (s, t, n) frame
    (kernel_bvh.cl:89, 238): normalize(s cp + t sp + n ct) with the
    azimuth terms cp = cos(phi) sin(theta), sp = sin(phi) sin(theta)."""
    return known.normalize(kn, name, s * cp[..., None] + t * sp[..., None]
                           + n * ct[..., None])


def sample_diffuse(normal, diffuse, u1, u2, kn=None) -> BrdfSample:
    """Lambert lobe (kernel_bvh.cl:264-269): a cosine-weighted hemisphere
    direction (kernel_bvh.cl:79-90), f = Kd/pi, pdf = cos/pi. The azimuth
    and elevation terms depend on the draws alone (known-value
    constants)."""
    cp = known.const(kn, "d_cp", lambda: torch.cos(_TWO_PI * u1) * torch.sqrt(u2))
    sp = known.const(kn, "d_sp", lambda: torch.sin(_TWO_PI * u1) * torch.sqrt(u2))
    ct = known.const(kn, "d_ct", lambda: torch.sqrt(torch.clamp(1.0 - u2, min=0.0)))
    s, t = build_onb(normal, kn)
    wi = _direction(kn, "d_wi", s, t, normal, cp, sp, ct)
    pdf = dot(wi, normal) * _INV_PI
    f = diffuse * _INV_PI
    return BrdfSample(wi=wi, f=f, pdf=pdf, valid=pdf > 0.0)


def _smith_g(n, v, l, perceptual_roughness):
    """Smith geometry term, Schlick-GGX k mapping (kernel_bvh.cl:241-257)."""
    def g1(ndotx):
        r = perceptual_roughness + 1.0
        k = (r * r) / 8.0
        return ndotx / (ndotx * (1.0 - k) + k)
    ndotv = vmax(dot(n, v), 0.0)
    ndotl = vmax(dot(n, l), 0.0)
    return g1(ndotv) * g1(ndotl)


def fresnel_schlick(f0: float, cos_i):
    """FresnelSchlick (kernel_bvh.cl:259-262), x^5 as three multiplies."""
    x = vmax(1.0 - cos_i, 0.0)
    x2 = x * x
    return f0 + (1.0 - f0) * (x2 * x2 * x)


def _specular_tail(wo, normal, specular, wh, d_ndf, pdf_h, roughness):
    """Shared end of both specular lobes: reflect, pdf, D G F / denom."""
    wi = reflect(wo, wh)
    cos_i = dot(wi, normal)
    cos_o = dot(wo, normal)
    same_hemi = (cos_i * cos_o) >= 1e-6
    wo_dot_wh = vmax(dot(wo, wh), 0.0)
    pdf = pdf_h / vmax(4.0 * wo_dot_wh, 1e-8)
    g = _smith_g(normal, wo, wi, roughness)
    fr = fresnel_schlick(0.04, wo_dot_wh)
    denom = 4.0 * vmax(cos_i, 0.0) * vmax(cos_o, 0.0) + 1e-3
    f = specular * (d_ndf * g * fr / denom)[..., None]
    valid = same_hemi & (pdf > 0.0) & (wo_dot_wh > 0.0)
    f = torch.where(valid[..., None], f, torch.zeros_like(f))
    return BrdfSample(wi=wi, f=f, pdf=pdf, valid=valid)


def sample_specular(wo, normal, specular, ns, u1, u2, kn=None) -> BrdfSample:
    """Blinn half-vector lobe with exponent alpha = Ns
    (kernel_bvh.cl:227-239, 271-292, spec-cleaned)."""
    alpha = vmax(ns, 0.0)
    log_u2 = known.const(kn, "log_u2", lambda: torch.log(torch.clamp(u2, 1e-12, 1.0)))
    cos_h = known.exp(kn, "cos_h", log_u2 / (alpha + 1.0))
    sin_h = known.sqrt0(kn, "sin_h", vmax(1.0 - cos_h * cos_h, 0.0))
    cphi = known.const(kn, "s_cp", lambda: torch.cos(_TWO_PI * u1))
    sphi = known.const(kn, "s_sp", lambda: torch.sin(_TWO_PI * u1))
    s, t = build_onb(normal, kn)
    wh = _direction(kn, "wh", s, t, normal, cphi * sin_h, sphi * sin_h, cos_h)
    # cos^alpha(theta_h) reuses the sampling log.
    cosn = known.exp(kn, "cosn", log_u2 * (alpha / (alpha + 1.0)))
    d_ndf = (alpha + 2.0) * (0.5 * _INV_PI) * cosn
    pdf_h = (alpha + 1.0) * (0.5 * _INV_PI) * cosn
    return _specular_tail(wo, normal, specular, wh, d_ndf, pdf_h,
                          known.sqrt(kn, "rough", 2.0 / (alpha + 2.0)))


def sample_specular_ggx(wo, normal, specular, ns, u1, u2, kn=None) -> BrdfSample:
    """GGX lobe: DistributionGGX (kernel_bvh.cl:221-225) with matching
    half-vector sampling; Ns maps to roughness r = sqrt(2/(Ns+2))."""
    r = known.sqrt(kn, "rough", 2.0 / (vmax(ns, 0.0) + 2.0))
    a = r * r
    a2 = vmax(a * a, 1e-12)
    u2c = known.const(kn, "u2c", lambda: torch.clamp(u2, 0.0, 1.0 - 1e-7))
    cos_h2 = (1.0 - u2c) / (1.0 + (a2 - 1.0) * u2c)
    cos_h = known.sqrt(kn, "cos_h", vclip(cos_h2, 0.0, 1.0))
    sin_h = known.sqrt0(kn, "sin_h", vmax(1.0 - cos_h2, 0.0))
    cphi = known.const(kn, "s_cp", lambda: torch.cos(_TWO_PI * u1))
    sphi = known.const(kn, "s_sp", lambda: torch.sin(_TWO_PI * u1))
    s, t = build_onb(normal, kn)
    wh = _direction(kn, "wh", s, t, normal, cphi * sin_h, sphi * sin_h, cos_h)
    dd = cos_h2 * (a2 - 1.0) + 1.0
    d_ndf = a2 * _INV_PI / vmax(dd * dd, 1e-12)
    pdf_h = d_ndf * cos_h
    return _specular_tail(wo, normal, specular, wh, d_ndf, pdf_h, r)


def sample_brdf(wo, normal, diffuse, specular, ns, seeds, bounce: int,
                specular_prob: float = 0.5,
                specular_model: str = "blinn", kn=None) -> BrdfSample:
    """50/50 lobe roulette (kernel_bvh.cl:294-302), branch-free. A
    reading ``kn`` (ops/known.py) replays the recorded pick and draws:
    ``seeds`` is not read."""
    if kn is not None and not kn.writing:
        pick_spec = kn.take("pick") > 0.5
        du1 = du2 = su1 = su2 = None
    else:
        u_lobe = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_LOBE))
        pick_spec = u_lobe > (1.0 - specular_prob)
        if kn is not None:
            kn.emit("pick", pick_spec.to(u_lobe.dtype))
        du1 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_DIFF_PHI))
        du2 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_DIFF_R2))
        su1 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_SPEC_PHI))
        su2 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_SPEC_COS))

    diff = sample_diffuse(normal, diffuse, du1, du2, kn)
    if specular_model == "ggx":
        spec = sample_specular_ggx(wo, normal, specular, ns, su1, su2, kn)
    else:
        spec = sample_specular(wo, normal, specular, ns, su1, su2, kn)

    sel = pick_spec[..., None]
    return BrdfSample(
        wi=torch.where(sel, spec.wi, diff.wi),
        f=torch.where(sel, spec.f, diff.f),
        pdf=torch.where(pick_spec, spec.pdf, diff.pdf),
        valid=torch.where(pick_spec, spec.valid, diff.valid),
    )
