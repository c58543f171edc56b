"""Analytic direct lighting: directional / point / spot, several lights,
optional shadow rays and a Blinn-Phong direct specular term
(``lightPixel``, kernel_bvh.cl:304-347, spec-cleaned as the JAX package's
``ops/lights.py`` describes)."""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..models.scene import LIGHT_DIRECTIONAL, LIGHT_SPOT, Lights
from . import known
from .linalg import dot, normalize, vclip, vmax


# Host copies of light-type tensors: id -> (weak reference, version, types).
_TYPES = {}


def light_types(lights: Lights) -> Tuple[int, ...]:
    """The light types as Python ints. Read from the device once per
    tensor (and again after an in-place change): a later call with the
    same tensor makes no host read, so a bounce, and a captured program
    (jit.py, which keys its graphs by these types), reads none."""
    t = lights.light_type
    hit = _TYPES.get(id(t))
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    types = tuple(int(x) for x in t.tolist())
    remember_light_types(t, types)
    return types


def remember_light_types(t: torch.Tensor, types: Tuple[int, ...]) -> None:
    """Record ``types`` as the values of the light-type tensor ``t`` (a
    copy whose values the caller knows, such as a captured program's
    input)."""
    key = id(t)
    _TYPES[key] = (weakref.ref(t, lambda _, k=key: _TYPES.pop(k, None)), t._version,
                   tuple(types))


class DirectLight(NamedTuple):
    diffuse_weight: torch.Tensor   # [R] attn * intensity * NdotL summed over lights
    specular_weight: torch.Tensor  # [R] Blinn-Phong weight (0 unless direct_specular)
    occ_bits: torch.Tensor         # [R] int32, bit li set where light li is blocked


def direct_light(
    lights: Lights,
    position: torch.Tensor,   # [R, 3] shading points
    normal: torch.Tensor,     # [R, 3] unit shading normals
    wo: torch.Tensor,         # [R, 3] unit direction toward the viewer
    shininess: torch.Tensor,  # [R] Blinn-Phong exponent (material Ns)
    occluder_fn: Optional[Callable] = None,  # (o, d, t_limit) -> bool [R]
    direct_specular: bool = False,
    shadow_eps: float = 1e-2,
    occ_bits: Optional[torch.Tensor] = None,  # [R] int32 recorded occlusion
    kn=None,                  # known-value rows (ops/known.py)
) -> DirectLight:
    """Sum the analytic direct-light weights over all lights.
    ``occluder_fn`` enables shadow rays; the per-light occlusion is also
    returned as a bitmask. ``occ_bits`` (bit li set = light li blocked)
    replays a recorded occlusion instead of casting shadow rays, as the
    backward bounce freezes visibility like the winner indices."""
    R = position.shape[0]
    zero = torch.zeros((R,), dtype=position.dtype, device=position.device)
    diff_total, spec_total = zero, zero
    occ_out = torch.zeros((R,), dtype=torch.int32, device=position.device)
    shadowed = occluder_fn is not None or occ_bits is not None

    # Lights are few and their types are read on the host once a scene.
    types = light_types(lights)
    for li in range(lights.count):
        ltype = types[li]
        lpos = lights.position[li]
        ldir = normalize(lights.direction[li])
        intensity = lights.intensity[li]
        falloff = lights.attenuation[li]
        cos_cut = lights.cos_cutoff[li]

        to_light = lpos[None, :] - position
        dist = known.sqrt(kn, f"dist{li}", vmax(dot(to_light, to_light), 1e-12))
        l_point = to_light / dist[..., None]
        is_dir = ltype <= LIGHT_DIRECTIONAL
        l_unit = (-ldir[None, :]).expand_as(l_point) if is_dir else l_point
        ndotl = vmax(dot(normal, l_unit), 0.0)

        # Quadratic attenuation for point/spot (kernel_bvh.cl:335, cleaned
        # to the true distance).
        if is_dir:
            attn = torch.ones_like(dist)
        else:
            attn = 1.0 / vmax(falloff * dist * dist, 1e-6)
        if ltype >= LIGHT_SPOT:
            cos_angle = dot(-l_unit, ldir[None, :])
            spot_w = vclip((cos_angle - cos_cut) / vmax(1.0 - cos_cut, 1e-6),
                           0.0, 1.0)
            attn = attn * spot_w

        weight = attn * intensity * ndotl

        if occ_bits is not None:
            blocked = ((occ_bits >> li) & 1) > 0
        elif occluder_fn is not None:
            origins = position + l_unit * shadow_eps
            # Directional lights: occlusion along the full ray.
            t_limit = (torch.full_like(dist, float("inf")) if is_dir
                       else dist - 2.0 * shadow_eps)
            blocked = occluder_fn(origins, l_unit, t_limit)
        if shadowed:
            weight = torch.where(blocked, zero, weight)
            occ_out = occ_out | (blocked.to(torch.int32) << li)

        diff_total = diff_total + weight

        if direct_specular:
            h = known.normalize(kn, f"h{li}", l_unit + wo)
            ndoth = vmax(dot(normal, h), 0.0)
            spec = known.power(kn, f"pow{li}", f"logb{li}", vmax(ndoth, 1e-6),
                               vmax(shininess, 1.0))
            spec = torch.where(ndotl > 0.0, spec, zero)
            spec_w = attn * intensity * spec
            if shadowed:
                spec_w = torch.where(blocked, zero, spec_w)
            spec_total = spec_total + spec_w

    return DirectLight(diffuse_weight=diff_total, specular_weight=spec_total,
                       occ_bits=occ_out)
