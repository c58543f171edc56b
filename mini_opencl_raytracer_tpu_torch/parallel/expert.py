"""Expert-parallel (EP) material routing: rays sent to the owner of their
material by an all-to-all, as a mixture of experts sends tokens (the JAX
package's ``parallel/expert.py``).

Materials are partitioned over the ``ep`` mesh dimension (material m
lives on rank m % ep); each rank's rays are binned by their hit
material's owner, sent to that owner with a fixed capacity per peer (the
standard MoE dispatch), shaded there against the owner's own material
slice only, and sent back. The analog of the reference's per-ray BRDF
lobe switch (SampleBrdf, kernel_bvh.cl:294-302), for material systems
whose per-class shading is too heavy or too divergent to evaluate
everywhere. Capacity overflow follows MoE: rows the dispatch drops
report ``routed=False``, and the callers here shade them locally.

Every rank must call these functions (and the backward) together; the
routed values are differentiable through both all-to-alls.
``render_sample_ep`` runs as a compiled program (jit.py; parallel/shard.py
has the rule): a CUDA graph under NCCL, eager on the CPU and under gloo.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import RenderConfig
from ..jit import jit
from ..models.scene import Camera, Scene
from ..ops import rng
from ..ops.brdf import sample_brdf
from ..ops.cuda.raygen import camera_rays
from ..ops.lights import direct_light
from ..ops.linalg import dot, vmax
from ..ops.shading import build_shading_table, hit_attributes
from ..render import make_intersectors, resolve_backend
from . import comm
from .shard import _pixel_ids, replicated


class EpResult(NamedTuple):
    values: torch.Tensor   # [R_local, F_out] routed computation results
    routed: torch.Tensor   # [R_local] bool: False where capacity dropped


def ep_route(payload: torch.Tensor, owner: torch.Tensor, axis: comm.Axis,
             capacity: int, eval_fn: Callable[[torch.Tensor], torch.Tensor],
             out_features: int) -> EpResult:
    """Send each row of ``payload`` [R, F] to rank ``owner[r]`` of
    ``axis`` (capacity-padded all-to-all), apply ``eval_fn`` ([ep *
    capacity, F] -> [ep * capacity, F_out]) on the owner, and return the
    results to the rows' home rank."""
    ep = axis.size
    R, F = payload.shape
    dev = payload.device
    owner = owner.to(torch.int64)
    order = torch.sort(owner, stable=True).indices
    sorted_owner = owner[order]
    group_start = torch.searchsorted(sorted_owner,
                                     torch.arange(ep, dtype=torch.int64, device=dev))
    pos = torch.arange(R, device=dev) - group_start[sorted_owner]
    ok = pos < capacity
    # Flat dispatch buffer with one trash slot for overflow rows.
    slot = torch.where(ok, sorted_owner * capacity + pos,
                       torch.full_like(pos, ep * capacity))
    send = payload.new_zeros((ep * capacity + 1, F)).index_copy(0, slot, payload[order])
    recv = comm.all_to_all(send[:-1].reshape(ep, capacity, F), axis)
    out = eval_fn(recv.reshape(ep * capacity, F)).reshape(ep, capacity, out_features)
    back = comm.all_to_all(out, axis)
    flat = torch.cat([back.reshape(ep * capacity, out_features),
                      back.new_zeros((1, out_features))], dim=0)
    values = back.new_zeros((R, out_features)).index_copy(0, order, flat[slot])
    routed = torch.zeros((R,), dtype=torch.bool, device=dev).index_copy(0, order, ok)
    return EpResult(values=values, routed=routed)


def _lambert(kd, p, n, light_pos):
    to_l = light_pos[None, :] - p
    dist2 = torch.clamp((to_l * to_l).sum(1), min=1e-12)
    l_unit = to_l / torch.sqrt(dist2)[:, None]
    ndotl = torch.clamp((n * l_unit).sum(1), min=0.0)
    return kd * (ndotl / dist2)[:, None]


def ep_shade_demo(positions: torch.Tensor, normals: torch.Tensor, mat_idx: torch.Tensor,
                  materials_diffuse: torch.Tensor, light_pos: torch.Tensor, mesh,
                  ep_axis: str = "ep", capacity: int = None) -> torch.Tensor:
    """Reference EP pipeline: Lambert direct shading where material m's
    diffuse row lives only on rank m % ep; rays are routed to their
    material's owner, shaded against its slice, and routed home.

    Inputs are full (unsharded) tensors, the same on every rank; the rays
    are sharded over the axis. Returns the [R, 3] colours on every rank,
    equal to the local computation."""
    axis = comm.Axis(mesh, ep_axis)
    ep, my = axis.size, axis.index
    R = positions.shape[0]
    if R % ep:
        raise ValueError(f"rays {R} not divisible by ep={ep}")
    M = materials_diffuse.shape[0]
    M_per = -(-M // ep)
    if capacity is None:
        capacity = -(-R // ep)  # ample for the demo
    n = R // ep
    pos_s, n_s, mi_s = (x[my * n:(my + 1) * n] for x in (positions, normals, mat_idx))
    mi_s = mi_s.to(torch.int64)
    dev = positions.device
    local_ids = my + ep * torch.arange(M_per, device=dev)
    local_kd = materials_diffuse[torch.clamp(local_ids, max=M - 1)]
    payload = torch.cat([pos_s, n_s, (mi_s // ep).to(torch.float32)[:, None]], dim=1)

    def shade_local(rows):
        kd = local_kd[torch.clamp(rows[:, 6].to(torch.int64), 0, M_per - 1)]
        return _lambert(kd, rows[:, 0:3], rows[:, 3:6], light_pos)

    res = ep_route(payload, mi_s % ep, axis, capacity, shade_local, 3)
    # Capacity overflow (module docstring): rows the dispatch dropped are
    # shaded locally against the replicated table.
    local = _lambert(materials_diffuse[torch.clamp(mi_s, 0, M - 1)], pos_s, n_s, light_pos)
    out = torch.where(res.routed[:, None], res.values, local)
    return comm.all_gather(out, axis)


@jit(static_argnames=("cfg", "mesh", "ep_axis", "capacity"))
def render_sample_ep(scene: Scene, camera: Camera, cfg: RenderConfig, mesh, frame=0,
                     ep_axis: str = "dp", capacity: int = None) -> torch.Tensor:
    """One progressive sample with pixels sharded over ``ep_axis`` and
    the material table logically sharded over it: material m is owned by
    rank m % ep, and every bounce's material-dependent shading (the BRDF
    lobe sampling of SampleBrdf, kernel_bvh.cl:294-302, and the Kd / Ks /
    Ke / Ns fetch) runs on the owner after a capacity-padded all-to-all of
    the hit wavefront. Geometry stays replicated; intersection, the
    throughput and radiance updates and the direct light stay local.

    The values equal ``render.render_sample``'s: the routed shading uses
    the same counter-based RNG sites (the seeds travel bit-cast in a float
    column), and overflow rays are shaded locally against the replicated
    table. Eager calls are differentiable w.r.t. the scene and the
    camera."""
    axis = comm.Axis(mesh, ep_axis)
    ep, my = axis.size, axis.index
    ids = _pixel_ids(cfg, axis, scene.device)
    M = scene.materials.count
    M_per = -(-M // ep)
    cap = capacity if capacity is not None else cfg.num_pixels // ep
    backend = resolve_backend(scene, cfg)
    if backend == "mega":
        backend = "pallas"
    dev = scene.device
    dtype = cfg.torch_dtype()
    sky = torch.stack([torch.full((), c, dtype=dtype, device=dev)
                       for c in cfg.sky_color]) * cfg.skybox_intensity

    scene, camera = replicated(scene, camera, axis)
    mats = scene.materials
    # This rank's material slice (m owned by m % ep): the 18-feature
    # record the owner returns per routed ray.
    local_ids = torch.clamp(my + ep * torch.arange(M_per, device=dev), max=M - 1)
    loc_kd, loc_ks = mats.diffuse[local_ids], mats.specular[local_ids]
    loc_ke, loc_ns = mats.emission[local_ids], mats.roughness[local_ids]
    closest, any_hit = make_intersectors(scene, cfg, backend=backend)
    occ = any_hit if cfg.shadow_rays else None
    st = build_shading_table(scene.geometry, scene.materials)
    tri_mat = scene.geometry.mat_idx.to(torch.int64)

    def brdf_record(s, kd, ks, ke, ns):
        return torch.cat([s.wi, s.f, s.pdf[:, None], s.valid.to(dtype)[:, None],
                          kd, ks, ke, ns[:, None]], dim=1)

    def bounce_step(carry, bounce: int):
        o, d, beta, radiance, alive, seeds = carry
        hit = closest(o, d)
        at = hit_attributes(o, d, hit, st, backface_cull=cfg.backface_cull,
                            soft_sigma=cfg.soft_edge_sigma)
        cov = at.coverage[:, None]
        mi = tri_mat[hit.tri_idx]
        wo = -d
        zero3 = torch.zeros_like(beta)

        # Routed material shading.
        seeds_f = rng.to_i32_bits(seeds).view(torch.float32)
        payload = torch.cat([at.normal, wo, seeds_f[:, None],
                             (mi // ep).to(dtype)[:, None]], dim=1)

        def shade_remote(rows):
            seeds_r = rng.from_i32_bits(rows[:, 6].detach().contiguous().view(torch.int32))
            mrow = torch.clamp(rows[:, 7].detach().to(torch.int64), 0, M_per - 1)
            kd, ks, ke, ns = loc_kd[mrow], loc_ks[mrow], loc_ke[mrow], loc_ns[mrow]
            s = sample_brdf(rows[:, 3:6], rows[:, 0:3], kd, ks, ns, seeds_r, bounce,
                            specular_prob=cfg.specular_prob,
                            specular_model=cfg.specular_model)
            return brdf_record(s, kd, ks, ke, ns)

        res = ep_route(payload, mi % ep, axis, cap, shade_remote, 18)
        # Overflow: local shading against the replicated table (module
        # docstring).
        s_loc = sample_brdf(wo, at.normal, at.kd, at.ks, at.ns, seeds, bounce,
                            specular_prob=cfg.specular_prob,
                            specular_model=cfg.specular_model)
        vals = torch.where(res.routed[:, None], res.values,
                           brdf_record(s_loc, at.kd, at.ks, at.ke, at.ns))
        wi, f, pdf = vals[:, 0:3], vals[:, 3:6], vals[:, 6]
        valid = vals[:, 7] > 0.5
        kd, ks, ke, ns = vals[:, 8:11], vals[:, 11:14], vals[:, 14:17], vals[:, 17]

        # The local bounce recurrence (integrator.shade_hit with the routed
        # material record).
        miss = alive & ~hit.hit
        radiance = radiance + torch.where(miss[:, None], beta * sky[None, :], zero3)
        live = alive & hit.hit
        if cfg.soft_edge_sigma > 0.0:
            radiance = radiance + torch.where(
                live[:, None], (1.0 - cov) * beta * sky[None, :], zero3)
        radiance = radiance + torch.where(live[:, None],
                                          cov * beta * ke * cfg.emission_scale, zero3)
        cos_i = dot(wi, at.normal)
        pdf_safe = torch.where(pdf > 0.0, pdf, torch.ones_like(pdf))
        mul = f * (cos_i / pdf_safe)[:, None]
        ok = valid & (pdf > 0.0) & torch.isfinite(mul).all(dim=-1)
        lo = live & ok
        beta_new = torch.where(lo[:, None], beta * mul, beta)
        dl = direct_light(scene.lights, at.pos, at.normal, wo, ns, occluder_fn=occ,
                          direct_specular=cfg.direct_specular,
                          shadow_eps=cfg.ray_epsilon)
        direct = dl.diffuse_weight[:, None] * kd
        if cfg.direct_specular:
            direct = direct + dl.specular_weight[:, None] * ks
        radiance = radiance + torch.where(lo[:, None], cov * direct * beta_new, zero3)
        o_next = torch.where(lo[:, None], at.pos + wi * cfg.ray_epsilon, o)
        d_next = torch.where(lo[:, None], wi, d)
        return o_next, d_next, beta_new, radiance, lo, seeds

    total = torch.zeros((ids.shape[0], 3), dtype=dtype, device=dev)
    for s in range(cfg.spp):
        o, d, seeds = camera_rays(camera, cfg, ids, rng.sample_frame(frame, cfg.spp, s))
        carry = (o, d, torch.ones_like(o), torch.zeros_like(o),
                 torch.ones((ids.shape[0],), dtype=torch.bool, device=dev), seeds)
        for b in range(cfg.bounces):
            carry = bounce_step(carry, b)
        total = total + vmax(carry[3], 0.0)
    return comm.all_gather(total / cfg.spp, axis).reshape(cfg.height, cfg.width, 3)
