"""The fused bounce megakernel: one CUDA kernel per bounce, the whole
bounce fused (closest hit, winner fetch, BRDF sampling, direct light with
shadow rays, throughput update).

Two kernels, written by hand in ``csrc/megakernel.cu``:

* ``bounce0_fwd`` generates the jittered camera rays and per-pixel seeds
  in-kernel and runs the first bounce (replaces the JAX package's
  ``ops/pallas/megakernel.py:_bounce0_fwd_kernel``);
* ``bounce_fwd`` runs one bounce from the carried ray state, for bounces
  1..B-1 (replaces ``_bounce_fwd_kernel``).

Each has a plain PyTorch version here, composed from ops/camera,
ops/intersect, ops/shading, ops/brdf, ops/lights and ops/integrator. The
wrappers run the plain version for tensors on the CPU and launch the
kernel for tensors on a CUDA device; there is no fallback between the two.
``LAUNCHES`` counts kernel launches (plain runs are not counted).

Ray state is structure-of-arrays: o, d, beta and radiance as [3, R] f32,
alive as [R] f32 (1.0 / 0.0), winner index and per-light occlusion bits
as [R] int32, seeds as [R] int32 holding the u32 bits. Rays that are not
alive report winner -1; occlusion bits are reported only for rays that
stay alive (the only rays whose direct light counts).

Only the forward pass is ported: inputs that require grad are refused
(the backward kernels come with the port of ``grad.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...config import RenderConfig
from ...models.scene import Camera, Geometry, Lights, Materials, Scene
from .. import rng
from ..camera import rays_from_basis, tan_half_fov
from ..integrator import shade_hit
from ..intersect import closest_hit_edges, occluded_edges
from ..linalg import cross
from ..shading import winner_attributes
from . import build

LAUNCHES = {"bounce0_fwd": 0, "bounce_fwd": 0}

# Scene limit of the mega path, kept equal to the JAX package's for
# dispatch parity (there a TPU VMEM bound; re-deriving it from Hopper's
# shared memory is queued in ROADMAP.md).
_MAX_TRIS = 2048
# The per-light occlusion bitmask is an int32.
_MAX_LIGHTS = 30
_TRI_BLOCK = 64

# Shading-table row layout ([C_PAD, T_pad] attribute rows x triangles, the
# JAX megakernel's layout); the kernels read its transpose [T_pad, C_PAD].
_V0, _E1, _E2 = 0, 3, 6
_N0, _N1, _N2 = 9, 12, 15
_KD, _KS, _KE = 18, 21, 24
_NS = 27
_C = 28
_C_PAD = 32
# Lights vector column layout ([L, 16]).
_LPOS, _LDIR, _LTYPE, _LINT, _LATT, _LCUT = 0, 3, 6, 7, 8, 9
_LCOLS = 16
# Triangle record of the accel: v0, e1, e2.
_TRI_COLS = 9
# Camera vector: position, right, up, front, 4 pad.
_CAM_POS, _CAM_RIGHT, _CAM_UP, _CAM_FRONT = 0, 3, 6, 9
_CAM_COLS = 16
_NUM_SITES = 5

# Flag bits of _Params.flags (csrc/megakernel.cu).
_F_SHADOW, _F_DSPEC, _F_CULL, _F_GGX, _F_SOFT = 1, 2, 4, 8, 16

# Rays per chunk in the plain versions' [rays x tris] panels.
_PLAIN_CHUNK = 1 << 16


class _Params(ctypes.Structure):
    """Mirror of ``MegaParams`` in csrc/megakernel.cu (4-byte fields only,
    same order)."""

    _fields_ = [
        ("num_rays", ctypes.c_int), ("num_tris", ctypes.c_int),
        ("num_lights", ctypes.c_int), ("flags", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("t_max", ctypes.c_float), ("ray_eps", ctypes.c_float),
        ("emission_scale", ctypes.c_float), ("spec_threshold", ctypes.c_float),
        ("inv_soft_sigma", ctypes.c_float), ("sky", ctypes.c_float * 3),
        ("tan_half_fov", ctypes.c_float), ("inv_w", ctypes.c_float),
        ("inv_h", ctypes.c_float), ("aspect", ctypes.c_float),
        ("cms", ctypes.c_uint32 * _NUM_SITES),
        ("rg_jx", ctypes.c_uint32), ("rg_jy", ctypes.c_uint32),
        ("rg_frame", ctypes.c_uint32),
    ]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _tri_pad(T: int) -> int:
    if T <= _TRI_BLOCK:
        return _ceil_to(max(T, 8), 8)
    return _ceil_to(T, _TRI_BLOCK)


# ---------------------------------------------------------------------------
# Scene tables.

def build_mega_table(geometry: Geometry, materials: Materials) -> torch.Tensor:
    """[C_PAD, T_pad] shading table: (v0, e1, e2), per-corner normals and
    the triangle's material, one attribute per row, zero padded."""
    g, m = geometry, materials
    T = g.num_triangles
    mi = g.mat_idx.to(torch.int64)
    rows = torch.cat([
        g.v0.T, (g.v1 - g.v0).T, (g.v2 - g.v0).T,
        g.n0.T, g.n1.T, g.n2.T,
        m.diffuse[mi].T, m.specular[mi].T, m.emission[mi].T,
        m.roughness[mi][None, :],
    ], dim=0).to(torch.float32)
    return torch.nn.functional.pad(rows, (0, _tri_pad(T) - T, 0, _C_PAD - _C))


def pack_lights(lights: Lights) -> torch.Tensor:
    """[L, 16] lights vector (see the _L* column layout)."""
    cols = [lights.position, lights.direction,
            lights.light_type.to(torch.float32)[:, None],
            lights.intensity[:, None], lights.attenuation[:, None],
            lights.cos_cutoff[:, None]]
    lv = torch.cat([c.to(torch.float32) for c in cols], dim=1)
    return torch.nn.functional.pad(lv, (0, _LCOLS - lv.shape[1]))


def unpack_lights(lv: torch.Tensor) -> Lights:
    """Inverse of pack_lights."""
    return Lights(position=lv[:, _LPOS:_LPOS + 3],
                  direction=lv[:, _LDIR:_LDIR + 3],
                  light_type=torch.round(lv[:, _LTYPE]).to(torch.int32),
                  intensity=lv[:, _LINT], attenuation=lv[:, _LATT],
                  cos_cutoff=lv[:, _LCUT])


def eligible(scene: Scene, cfg: RenderConfig) -> bool:
    """The mega path serves scenes up to _MAX_TRIS triangles and
    _MAX_LIGHTS lights in float32, as in the JAX package."""
    return (scene.num_triangles <= _MAX_TRIS
            and scene.lights.count <= _MAX_LIGHTS
            and cfg.torch_dtype() == torch.float32)


def build_accel(geometry: Geometry) -> torch.Tensor:
    """[T, 9] float32 triangle records (v0, e1, e2) that the kernels'
    closest-hit and any-hit loops read. Rebuild after vertex changes."""
    g = geometry
    return torch.cat([g.v0, g.v1 - g.v0, g.v2 - g.v0],
                     dim=1).to(torch.float32).contiguous()


def camera_vector(camera: Camera) -> torch.Tensor:
    """[16] float32: position, right = cross(front, up), up, front, pad."""
    pad = torch.zeros(4, dtype=torch.float32, device=camera.position.device)
    return torch.cat([camera.position, cross(camera.front, camera.up),
                      camera.up, camera.front, pad]).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions of the two kernels.

def _bounce_plain(table_rows, tris, lights, o, d, beta, alive, seeds,
                  bounce: int, cfg: RenderConfig):
    """One bounce on [R, 3] ray state with the mega tables; returns the
    kernel's outputs in its [3, R] / [R] layout."""
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    best_t, best_idx = closest_hit_edges(o, d, v0, e1, e2, cfg.t_max,
                                         cfg.backface_cull, _PLAIN_CHUNK)
    hit = torch.isfinite(best_t)
    rows = table_rows[torch.where(hit, best_idx, torch.zeros_like(best_idx))]

    def c3(off):
        return rows[:, off:off + 3]

    at = winner_attributes(o, d, hit, c3(_V0), c3(_E1), c3(_E2), c3(_N0),
                           c3(_N1), c3(_N2), c3(_KD), c3(_KS), c3(_KE),
                           rows[:, _NS], backface_cull=cfg.backface_cull,
                           soft_sigma=cfg.soft_edge_sigma)

    def occluder(so, sd, t_limit):
        return occluded_edges(so, sd, t_limit, v0, e1, e2,
                              cfg.backface_cull, _PLAIN_CHUNK)

    o_n, d_n, b_n, rad, alive_n, occ = shade_hit(
        at, hit, o, d, beta, torch.zeros_like(beta), alive, seeds, bounce,
        unpack_lights(lights), cfg, occluder)
    winner = torch.where(alive & hit, best_idx, torch.full_like(best_idx, -1))
    occ = torch.where(alive_n, occ, torch.zeros_like(occ))
    return (o_n.T.contiguous(), d_n.T.contiguous(), b_n.T.contiguous(),
            alive_n.to(torch.float32), rad.T.contiguous(),
            winner.to(torch.int32), occ.to(torch.int32))


def bounce0_fwd_plain(table_rows, tris, lights, camv, pixel_ids, frame: int,
                      cfg: RenderConfig):
    """Plain version of the raygen-fused first bounce: seeds and jittered
    camera rays (ops/rng, ops/camera), then bounce 0."""
    seeds = rng.pixel_seeds(pixel_ids, frame)
    o, d = rays_from_basis(camv[_CAM_POS:_CAM_POS + 3],
                           camv[_CAM_RIGHT:_CAM_RIGHT + 3],
                           camv[_CAM_UP:_CAM_UP + 3],
                           camv[_CAM_FRONT:_CAM_FRONT + 3],
                           cfg, pixel_ids, seeds)
    R = pixel_ids.shape[0]
    ones = torch.ones((R, 3), dtype=torch.float32, device=o.device)
    alive = torch.ones((R,), dtype=torch.bool, device=o.device)
    out = _bounce_plain(table_rows, tris, lights, o, d, ones, alive, seeds,
                        0, cfg)
    return out + (rng.to_i32_bits(seeds),)


def bounce_fwd_plain(table_rows, tris, lights, o, d, beta, alive, seeds,
                     bounce: int, cfg: RenderConfig):
    """Plain version of one bounce from the carried [3, R] ray state."""
    return _bounce_plain(table_rows, tris, lights, o.T, d.T, beta.T,
                         alive > 0.0, rng.from_i32_bits(seeds), bounce, cfg)


# ---------------------------------------------------------------------------
# Kernel wrappers.

def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(table_rows, tris, lights, cfg, device, tensors):
    for name, t in tensors.items():
        if t.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: the megakernel backward kernels are "
                "not ported yet (ROADMAP.md Queue 1 item 4); render under "
                "torch.no_grad() or detach the inputs")
    if cfg.torch_dtype() != torch.float32:
        raise TypeError(f"the mega path renders in float32, not {cfg.dtype}")
    T, L = tris.shape[0], lights.shape[0]
    if not 0 < T <= _MAX_TRIS:
        raise ValueError(f"mega path takes 1..{_MAX_TRIS} triangles, got {T}")
    if L > _MAX_LIGHTS:
        raise ValueError(f"mega path takes at most {_MAX_LIGHTS} lights, got {L}")
    _check(table_rows, "table_rows", torch.float32, (_tri_pad(T), _C_PAD), device)
    _check(tris, "tris", torch.float32, (T, _TRI_COLS), device)
    _check(lights, "lights", torch.float32, (L, _LCOLS), device)


def _params(cfg: RenderConfig, R: int, T: int, L: int, bounce: int,
            frame: int = 0) -> _Params:
    p = _Params()
    p.num_rays, p.num_tris, p.num_lights = R, T, L
    p.flags = ((_F_SHADOW if cfg.shadow_rays else 0)
               | (_F_DSPEC if cfg.direct_specular else 0)
               | (_F_CULL if cfg.backface_cull else 0)
               | (_F_GGX if cfg.specular_model == "ggx" else 0)
               | (_F_SOFT if cfg.soft_edge_sigma > 0.0 else 0))
    p.width, p.height = cfg.width, cfg.height
    f32 = np.float32
    p.t_max = f32(min(cfg.t_max, 3.0e38))
    p.ray_eps = f32(cfg.ray_epsilon)
    p.emission_scale = f32(cfg.emission_scale)
    p.spec_threshold = f32(1.0 - cfg.specular_prob)
    if cfg.soft_edge_sigma > 0.0:
        p.inv_soft_sigma = f32(1.0 / cfg.soft_edge_sigma)
    for i, c in enumerate(cfg.sky_color):
        p.sky[i] = f32(c) * f32(cfg.skybox_intensity)
    p.tan_half_fov = tan_half_fov(cfg)
    p.inv_w = f32(1.0 / cfg.width)
    p.inv_h = f32(1.0 / cfg.height)
    p.aspect = f32(cfg.width / cfg.height)
    for s in range(_NUM_SITES):
        p.cms[s] = rng.premix(rng.bounce_site(bounce, s))
    p.rg_jx = rng.premix(rng.SITE_JITTER_X)
    p.rg_jy = rng.premix(rng.SITE_JITTER_Y)
    p.rg_frame = rng.premix(frame)
    return p


def _launch(name: str, fn, device, params, tensors):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(params), *[t.data_ptr() for t in tensors],
                 stream)
    build.check(err, name)
    LAUNCHES[name] += 1


def _empty_state(R: int, device):
    vec = lambda: torch.empty((3, R), dtype=torch.float32, device=device)
    return (vec(), vec(), vec(),
            torch.empty((R,), dtype=torch.float32, device=device), vec(),
            torch.empty((R,), dtype=torch.int32, device=device),
            torch.empty((R,), dtype=torch.int32, device=device))


def bounce0_fwd(table_rows, tris, lights, camv, pixel_ids, frame: int,
                cfg: RenderConfig):
    """Raygen-fused first bounce over ``pixel_ids`` [R] int32.

    Returns (o, d, beta, alive, radiance, winner, occ_bits, seeds)."""
    device = pixel_ids.device
    R = pixel_ids.shape[0]
    _check_common(table_rows, tris, lights, cfg, device,
                  {"table_rows": table_rows, "tris": tris, "lights": lights,
                   "camv": camv})
    _check(camv, "camv", torch.float32, (_CAM_COLS,), device)
    _check(pixel_ids, "pixel_ids", torch.int32, (R,), device)
    if device.type == "cpu":
        return bounce0_fwd_plain(table_rows, tris, lights, camv, pixel_ids,
                                 frame, cfg)
    if device.type != "cuda":
        raise ValueError(f"bounce0_fwd runs on cpu or cuda, not {device}")
    out = _empty_state(R, device) + (
        torch.empty((R,), dtype=torch.int32, device=device),)
    if R:
        params = _params(cfg, R, tris.shape[0], lights.shape[0], 0, frame)
        _launch("bounce0_fwd", build.library().mrt_bounce0_fwd, device,
                params, (table_rows, tris, lights, camv, pixel_ids) + out)
    return out


def bounce_fwd(table_rows, tris, lights, o, d, beta, alive, seeds,
               bounce: int, cfg: RenderConfig):
    """One fused bounce from the carried state; ``bounce`` selects the
    RNG draw sites. Returns (o, d, beta, alive, radiance, winner,
    occ_bits); the radiance is this bounce's contribution alone."""
    device = o.device
    R = alive.shape[0]
    _check_common(table_rows, tris, lights, cfg, device,
                  {"table_rows": table_rows, "tris": tris, "lights": lights,
                   "o": o, "d": d, "beta": beta})
    for name, t in (("o", o), ("d", d), ("beta", beta)):
        _check(t, name, torch.float32, (3, R), device)
    _check(alive, "alive", torch.float32, (R,), device)
    _check(seeds, "seeds", torch.int32, (R,), device)
    if device.type == "cpu":
        return bounce_fwd_plain(table_rows, tris, lights, o, d, beta, alive,
                                seeds, bounce, cfg)
    if device.type != "cuda":
        raise ValueError(f"bounce_fwd runs on cpu or cuda, not {device}")
    out = _empty_state(R, device)
    if R:
        params = _params(cfg, R, tris.shape[0], lights.shape[0], bounce)
        _launch("bounce_fwd", build.library().mrt_bounce_fwd, device, params,
                (table_rows, tris, lights, o, d, beta, alive, seeds) + out)
    return out


# ---------------------------------------------------------------------------
# Path tracing on the kernels.

def _check_accel(tris: torch.Tensor, geometry: Geometry) -> torch.Tensor:
    if tuple(tris.shape) != (geometry.num_triangles, _TRI_COLS):
        raise ValueError(
            f"mega accel shape {tuple(tris.shape)} does not match this scene "
            f"({geometry.num_triangles} triangles); rebuild it with "
            "megakernel.build_accel")
    return tris


def _tables(scene: Scene, cfg: RenderConfig, accel):
    if not eligible(scene, cfg):
        raise ValueError(
            "megakernel backend requires <= %d triangles, <= %d lights and "
            "float32 (got T=%d, L=%d, dtype=%s)"
            % (_MAX_TRIS, _MAX_LIGHTS, scene.num_triangles,
               scene.lights.count, cfg.dtype))
    table_rows = build_mega_table(scene.geometry, scene.materials).T.contiguous()
    lv = pack_lights(scene.lights).contiguous()
    tris = (build_accel(scene.geometry) if accel is None
            else _check_accel(accel, scene.geometry))
    return table_rows, tris, lv


def trace_paths_mega_cam(scene: Scene, cfg: RenderConfig, camera: Camera,
                         pixel_ids: torch.Tensor, frame: int,
                         accel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(camera, pixel ids, frame) -> radiance [R, 3]: the raygen-fused
    first bounce, then ``bounce_fwd`` for bounces 1..B-1. Zero bounces
    render black."""
    table_rows, tris, lv = _tables(scene, cfg, accel)
    R = pixel_ids.shape[0]
    if cfg.bounces == 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=pixel_ids.device)
    o, d, beta, alive, rad, _, _, seeds = bounce0_fwd(
        table_rows, tris, lv, camera_vector(camera),
        pixel_ids.to(torch.int32).contiguous(), frame, cfg)
    for b in range(1, cfg.bounces):
        o, d, beta, alive, rad_b, _, _ = bounce_fwd(
            table_rows, tris, lv, o, d, beta, alive, seeds, b, cfg)
        rad = rad + rad_b
    # Final clamp (kernel_bvh.cl:383).
    return torch.clamp(rad, min=0.0).T


def trace_paths_mega(scene: Scene, cfg: RenderConfig, origins: torch.Tensor,
                     directions: torch.Tensor, seeds: torch.Tensor,
                     accel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ops/integrator.trace_paths on the bounce kernel:
    origins/directions [R, 3], seeds [R] int64 u32 -> radiance [R, 3]."""
    table_rows, tris, lv = _tables(scene, cfg, accel)
    R = origins.shape[0]
    dev = origins.device
    o = origins.T.to(torch.float32).contiguous()
    d = directions.T.to(torch.float32).contiguous()
    beta = torch.ones((3, R), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.float32, device=dev)
    rad = torch.zeros((3, R), dtype=torch.float32, device=dev)
    seeds32 = rng.to_i32_bits(seeds.to(torch.int64)).contiguous()
    for b in range(cfg.bounces):
        o, d, beta, alive, rad_b, _, _ = bounce_fwd(
            table_rows, tris, lv, o, d, beta, alive, seeds32, b, cfg)
        rad = rad + rad_b
    return torch.clamp(rad, min=0.0).T
