"""The fused bounce megakernel: one CUDA kernel per bounce, the whole
bounce fused (closest hit, winner fetch, BRDF sampling, direct light with
shadow rays, throughput update), and its backward.

Four kernels, written by hand in ``csrc/``:

* ``bounce0_fwd`` generates the jittered camera rays and per-pixel seeds
  in-kernel and runs the first bounce (replaces the JAX package's
  ``ops/pallas/megakernel.py:_bounce0_fwd_kernel``);
* ``bounce_fwd`` runs one bounce from the carried ray state, for bounces
  1..B-1 (replaces ``_bounce_fwd_kernel``);
* ``bounce0_bwd`` and ``bounce_bwd`` are their vector-Jacobian products
  with the winner indices and occlusion bits of the forward held fixed
  (replace ``_bounce0_bwd_kernel`` and ``_bounce_bwd_kernel``).

Each has a plain PyTorch version here: the forward ones composed from
ops/camera, ops/intersect, ops/shading, ops/brdf, ops/lights and
ops/integrator, the backward ones ``torch.autograd.grad`` of a replay of
the bounce that runs no intersection. The wrappers run the plain version
for tensors on the CPU and launch the kernel for tensors on a CUDA
device; there is no fallback between the two. ``LAUNCHES`` counts kernel
launches (plain runs are not counted).

Ray state is structure-of-arrays: o, d, beta and radiance as [3, R] f32,
alive as [R] f32 (1.0 / 0.0), winner index and per-light occlusion bits
as [R] int32, seeds as [R] int32 holding the u32 bits. Rays that are not
alive report winner -1; occlusion bits are reported only for rays that
stay alive (the only rays whose direct light counts). Both are all the
backward needs.

Gradients: ``_Bounce0`` and ``_Bounce`` are the ``torch.autograd.Function``
counterparts of the JAX ``custom_vjp`` ``_bounce0`` / ``_bounce``;
``trace_paths_mega_cam`` and ``trace_paths_mega`` go through them when an
input requires grad, and call the forward wrappers alone otherwise. The
triangle records (the accel) get no gradient: selection is discrete, and
gradients reach the vertices through the winner's table row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...config import RenderConfig
from ...models.scene import Camera, Geometry, Lights, Materials, Scene
from .. import rng
from ..camera import rays_from_basis, tan_half_fov
from ..integrator import shade_hit
from ..intersect import closest_hit_edges, occluded_edges
from ..linalg import cross, vmax
from ..shading import winner_attributes
from . import build

LAUNCHES = {"bounce0_fwd": 0, "bounce_fwd": 0, "bounce0_bwd": 0, "bounce_bwd": 0}

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

# Backward kernels (csrc/megakernel_bwd.cu): rays per block (kBlock),
# resident blocks per SM (__launch_bounds__(kBlock, 2)), and the largest
# T_pad whose table partial a block keeps in shared memory (kSmemRows).
_BLOCK = 256
_BLOCKS_PER_SM = 2
_SMEM_ROWS = 512


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

def _shade_rows(table_rows, lights, o, d, beta, alive, seeds, idx, hit,
                bounce: int, cfg: RenderConfig, occluder=None, occ=None):
    """Everything after the closest hit, on the winners' table rows: the
    (t, u, v) recompute on (v0, e1, e2), then ops/integrator.shade_hit.
    ``occ`` replays recorded occlusion bits instead of ``occluder``."""
    rows = table_rows[torch.where(hit, idx, torch.zeros_like(idx))]

    def c3(off):
        return rows[:, off:off + 3]

    at = winner_attributes(o, d, hit, c3(_V0), c3(_E1), c3(_E2), c3(_N0),
                           c3(_N1), c3(_N2), c3(_KD), c3(_KS), c3(_KE),
                           rows[:, _NS], backface_cull=cfg.backface_cull,
                           soft_sigma=cfg.soft_edge_sigma)
    return shade_hit(at, hit, o, d, beta, torch.zeros_like(beta), alive,
                     seeds, bounce, unpack_lights(lights), cfg, occluder,
                     occ_bits=occ)


def _bounce_plain(table_rows, tris, lights, o, d, beta, alive, seeds,
                  bounce: int, cfg: RenderConfig):
    """One bounce on [R, 3] ray state with the mega tables; returns the
    kernel's outputs in its [3, R] / [R] layout."""
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    best_t, best_idx = closest_hit_edges(o, d, v0, e1, e2, cfg.t_max,
                                         cfg.backface_cull, _PLAIN_CHUNK)
    hit = torch.isfinite(best_t)

    def occluder(so, sd, t_limit):
        return occluded_edges(so, sd, t_limit, v0, e1, e2,
                              cfg.backface_cull, _PLAIN_CHUNK)

    o_n, d_n, b_n, rad, alive_n, occ = _shade_rows(
        table_rows, lights, o, d, beta, alive, seeds, best_idx, hit, bounce,
        cfg, occluder)
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


def _replay(table_rows, lights, o, d, beta, alive, seeds, winner, occ,
            bounce: int, cfg: RenderConfig):
    """One bounce with the forward's winners and occlusion bits frozen:
    no intersection, [R, 3] state in, (o', d', beta', radiance) out."""
    idx = winner.to(torch.int64)
    o_n, d_n, b_n, rad, _, _ = _shade_rows(table_rows, lights, o, d, beta,
                                           alive, seeds, idx, idx >= 0,
                                           bounce, cfg, occ=occ)
    return o_n, d_n, b_n, rad


def _vjp(outs, inputs, cot):
    """Cotangents [3, R] of the [R, 3] ``outs`` -> grads of ``inputs``."""
    grads = torch.autograd.grad(outs, inputs,
                                grad_outputs=[c.T for c in cot],
                                allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads))


def bounce0_bwd_plain(table_rows, lights, camv, pixel_ids, frame: int,
                      winner, occ, cot, cfg: RenderConfig):
    """Plain version of the first bounce's VJP: autograd of raygen and the
    replayed bounce. ``cot`` = cotangents of (o', d', beta', radiance),
    each [3, R]. Returns (d_table [T_pad, 32], d_lights [L, 16],
    d_camv [16])."""
    with torch.enable_grad():
        tab, lv, cv = (x.detach().requires_grad_()
                       for x in (table_rows, lights, camv))
        seeds = rng.pixel_seeds(pixel_ids, frame)
        o, d = rays_from_basis(cv[_CAM_POS:_CAM_POS + 3],
                               cv[_CAM_RIGHT:_CAM_RIGHT + 3],
                               cv[_CAM_UP:_CAM_UP + 3],
                               cv[_CAM_FRONT:_CAM_FRONT + 3],
                               cfg, pixel_ids, seeds)
        ones = torch.ones_like(d)
        alive = torch.ones(ones.shape[:1], dtype=torch.bool, device=d.device)
        outs = _replay(tab, lv, o, d, ones, alive, seeds, winner, occ, 0, cfg)
        return _vjp(outs, (tab, lv, cv), cot)


def bounce_bwd_plain(table_rows, lights, o, d, beta, alive, seeds, winner,
                     occ, cot, bounce: int, cfg: RenderConfig):
    """Plain version of one bounce's VJP from the carried [3, R] state.
    Returns (d_o, d_d, d_beta [3, R], d_table [T_pad, 32],
    d_lights [L, 16]); the alive mask and the seeds carry no gradient."""
    with torch.enable_grad():
        tab, lv, oi, di, bi = (x.detach().requires_grad_()
                               for x in (table_rows, lights, o, d, beta))
        outs = _replay(tab, lv, oi.T, di.T, bi.T, alive > 0.0,
                       rng.from_i32_bits(seeds), winner, occ, bounce, cfg)
        g_tab, g_lv, g_o, g_d, g_b = _vjp(outs, (tab, lv, oi, di, bi), cot)
    return g_o, g_d, g_b, g_tab, g_lv


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


def _check_tables(table_rows, lights, cfg, device, T_pad, tensors):
    for name, t in tensors.items():
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                f"{name} requires grad: a bounce wrapper alone is not "
                "differentiable; go through trace_paths_mega_cam / "
                "trace_paths_mega (the autograd Functions _Bounce0 and "
                "_Bounce), or detach the inputs")
    if cfg.torch_dtype() != torch.float32:
        raise TypeError(f"the mega path renders in float32, not {cfg.dtype}")
    L = lights.shape[0]
    if L > _MAX_LIGHTS:
        raise ValueError(f"mega path takes at most {_MAX_LIGHTS} lights, got {L}")
    _check(table_rows, "table_rows", torch.float32, (T_pad, _C_PAD), device)
    _check(lights, "lights", torch.float32, (L, _LCOLS), device)


def _check_common(table_rows, tris, lights, cfg, device, tensors):
    T = tris.shape[0]
    if not 0 < T <= _MAX_TRIS:
        raise ValueError(f"mega path takes 1..{_MAX_TRIS} triangles, got {T}")
    _check_tables(table_rows, lights, cfg, device, _tri_pad(T), tensors)
    _check(tris, "tris", torch.float32, (T, _TRI_COLS), device)


def _check_bwd(table_rows, lights, cfg, device, R, winner, occ, cot, tensors):
    """Checks of a backward wrapper's inputs; returns T_pad."""
    T_pad = table_rows.shape[0] if table_rows.dim() == 2 else -1
    if not 0 < T_pad <= _tri_pad(_MAX_TRIS):
        raise ValueError(f"table_rows has shape {tuple(table_rows.shape)}, "
                         f"expected [T_pad <= {_tri_pad(_MAX_TRIS)}, {_C_PAD}]")
    cot = tuple(cot)
    if len(cot) != 4:
        raise ValueError("cot holds the cotangents of (o, d, beta, radiance)")
    named = dict(tensors, **{f"cot[{i}]": c for i, c in enumerate(cot)})
    _check_tables(table_rows, lights, cfg, device, T_pad, named)
    _check(winner, "winner", torch.int32, (R,), device)
    _check(occ, "occ", torch.int32, (R,), device)
    for i, c in enumerate(cot):
        _check(c, f"cot[{i}]", torch.float32, (3, R), device)
    return T_pad


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


def _launch(name: str, fn, device, params, tensors, *ints, ptrs=()):
    """Launch entry point ``fn``: (params, *ints, *tensor pointers, *ptrs,
    stream); ``ptrs`` are raw pointers that may be None (null)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(params), *ints,
                 *[t.data_ptr() for t in tensors], *ptrs, stream)
    build.check(err, name)
    LAUNCHES[name] += 1


def _empty_state(R: int, device):
    vec = lambda: torch.empty((3, R), dtype=torch.float32, device=device)
    return (vec(), vec(), vec(),
            torch.empty((R,), dtype=torch.float32, device=device), vec(),
            torch.empty((R,), dtype=torch.int32, device=device),
            torch.empty((R,), dtype=torch.int32, device=device))


def bounce0_fwd(table_rows, tris, lights, camv, pixel_ids, frame: int,
                cfg: RenderConfig, stats=None):
    """Raygen-fused first bounce over ``pixel_ids`` [R] int32.

    Returns (o, d, beta, alive, radiance, winner, occ_bits, seeds).
    ``stats`` (int32 [R], CUDA only) receives each ray's count of exact
    Möller–Trumbore tests, closest hit and shadow rays: the kernel runs
    them behind a per-warp cull (csrc/bundle.cuh, modelled by
    ops/cuda/bundle_cull.py)."""
    device = pixel_ids.device
    R = pixel_ids.shape[0]
    _check_common(table_rows, tris, lights, cfg, device,
                  {"table_rows": table_rows, "tris": tris, "lights": lights,
                   "camv": camv})
    _check(camv, "camv", torch.float32, (_CAM_COLS,), device)
    _check(pixel_ids, "pixel_ids", torch.int32, (R,), device)
    if device.type == "cpu":
        if stats is not None:
            raise ValueError("bounce0_fwd: stats are counted by the kernel only")
        return bounce0_fwd_plain(table_rows, tris, lights, camv, pixel_ids,
                                 frame, cfg)
    if device.type != "cuda":
        raise ValueError(f"bounce0_fwd runs on cpu or cuda, not {device}")
    if stats is not None:
        _check(stats, "stats", torch.int32, (R,), device)
    out = _empty_state(R, device) + (
        torch.empty((R,), dtype=torch.int32, device=device),)
    if R:
        params = _params(cfg, R, tris.shape[0], lights.shape[0], 0, frame)
        _launch("bounce0_fwd", build.library().mrt_bounce0_fwd, device,
                params, (table_rows, tris, lights, camv, pixel_ids) + out,
                ptrs=(None if stats is None else stats.data_ptr(),))
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


class BwdPlan(NamedTuple):
    """Launch plan of a backward wrapper: the persistent grid, the floats
    of one block's partial row ([T_pad * 32 + L * 16 (+ 16 camera)]), and
    where a block keeps its table partial."""

    grid: int
    part_cols: int
    smem_table: bool


def bwd_plan(R: int, T_pad: int, L: int, sms: int, first: bool) -> BwdPlan:
    """A fixed number of blocks, ``_BLOCKS_PER_SM`` per SM but no more than
    there are tiles of ``_BLOCK`` rays; the scratch is ``grid`` partial
    rows, a function of T_pad, L and the grid only."""
    grid = max(1, min(-(-R // _BLOCK), _BLOCKS_PER_SM * sms))
    cols = T_pad * _C_PAD + L * _LCOLS + (_CAM_COLS if first else 0)
    return BwdPlan(grid, cols, T_pad <= _SMEM_ROWS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_launch(name: str, fn, device, params, plan: BwdPlan, tensors) -> None:
    """Launch a backward entry point with its plan and its partials."""
    part = torch.empty((plan.grid, plan.part_cols), dtype=torch.float32,
                       device=device)
    _launch(name, fn, device, params, tensors[:-1] + (part,) + tensors[-1],
            plan.grid, int(plan.smem_table))


def _device_index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def bounce0_bwd(table_rows, lights, camv, pixel_ids, frame: int, winner, occ,
                cot, cfg: RenderConfig):
    """VJP of ``bounce0_fwd`` with its winners and occlusion bits frozen.
    ``cot`` = cotangents of (o', d', beta', radiance), each [3, R].
    Returns (d_table [T_pad, 32], d_lights [L, 16], d_camv [16])."""
    device = pixel_ids.device
    R = pixel_ids.shape[0]
    T_pad = _check_bwd(table_rows, lights, cfg, device, R, winner, occ, cot,
                       {"table_rows": table_rows, "lights": lights,
                        "camv": camv})
    _check(camv, "camv", torch.float32, (_CAM_COLS,), device)
    _check(pixel_ids, "pixel_ids", torch.int32, (R,), device)
    if device.type == "cpu":
        return bounce0_bwd_plain(table_rows, lights, camv, pixel_ids, frame,
                                 winner, occ, cot, cfg)
    if device.type != "cuda":
        raise ValueError(f"bounce0_bwd runs on cpu or cuda, not {device}")
    L = lights.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    new = torch.empty if R else torch.zeros   # the kernels write every entry
    out = (new((T_pad, _C_PAD), **f32), new((L, _LCOLS), **f32),
           new((_CAM_COLS,), **f32))
    if R:
        plan = bwd_plan(R, T_pad, L, _sm_count(_device_index(device)), True)
        _bwd_launch("bounce0_bwd", build.library().mrt_bounce0_bwd, device,
                    _params(cfg, R, T_pad, L, 0, frame), plan,
                    (table_rows, lights, camv, pixel_ids, winner, occ)
                    + tuple(cot) + (out,))
    return out


def bounce_bwd(table_rows, lights, o, d, beta, alive, seeds, winner, occ, cot,
               bounce: int, cfg: RenderConfig):
    """VJP of ``bounce_fwd`` with its winners and occlusion bits frozen.
    Returns (d_o, d_d, d_beta [3, R], d_table [T_pad, 32],
    d_lights [L, 16]); the alive mask and the seeds carry no gradient."""
    device = o.device
    R = alive.shape[0]
    T_pad = _check_bwd(table_rows, lights, cfg, device, R, winner, occ, cot,
                       {"table_rows": table_rows, "lights": lights, "o": o,
                        "d": d, "beta": beta})
    for name, t in (("o", o), ("d", d), ("beta", beta)):
        _check(t, name, torch.float32, (3, R), device)
    _check(alive, "alive", torch.float32, (R,), device)
    _check(seeds, "seeds", torch.int32, (R,), device)
    if device.type == "cpu":
        return bounce_bwd_plain(table_rows, lights, o, d, beta, alive, seeds,
                                winner, occ, cot, bounce, cfg)
    if device.type != "cuda":
        raise ValueError(f"bounce_bwd runs on cpu or cuda, not {device}")
    L = lights.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    new = torch.empty if R else torch.zeros   # the kernels write every entry
    out = (new((3, R), **f32), new((3, R), **f32), new((3, R), **f32),
           new((T_pad, _C_PAD), **f32), new((L, _LCOLS), **f32))
    if R:
        plan = bwd_plan(R, T_pad, L, _sm_count(_device_index(device)), False)
        _bwd_launch("bounce_bwd", build.library().mrt_bounce_bwd, device,
                    _params(cfg, R, T_pad, L, bounce), plan,
                    (table_rows, lights, o, d, beta, alive, seeds, winner, occ)
                    + tuple(cot) + (out,))
    return out


# ---------------------------------------------------------------------------
# Autograd: one Function per bounce (the JAX custom_vjp _bounce0 / _bounce,
# megakernel.py:1288-1318, 1511-1550).

def _cot(grads):
    return tuple(g.contiguous() for g in grads)


class _Bounce0(torch.autograd.Function):
    """(table, lights, camera vector) -> bounce0_fwd's outputs; the
    backward is bounce0_bwd."""

    @staticmethod
    def forward(ctx, table_rows, lights, camv, tris, pixel_ids, frame, cfg):
        out = bounce0_fwd(table_rows.detach(), tris.detach(), lights.detach(),
                          camv.detach(), pixel_ids, frame, cfg)
        _, _, _, alive, _, winner, occ, seeds = out
        ctx.save_for_backward(table_rows, lights, camv, pixel_ids, winner, occ)
        ctx.frame, ctx.cfg = frame, cfg
        ctx.mark_non_differentiable(alive, winner, occ, seeds)
        return out

    @staticmethod
    def backward(ctx, g_o, g_d, g_beta, _g_alive, g_rad, _g_w, _g_occ, _g_s):
        table_rows, lights, camv, pixel_ids, winner, occ = ctx.saved_tensors
        d_tab, d_lv, d_cam = bounce0_bwd(
            table_rows.detach(), lights.detach(), camv.detach(), pixel_ids,
            ctx.frame, winner, occ, _cot((g_o, g_d, g_beta, g_rad)), ctx.cfg)
        return d_tab, d_lv, d_cam, None, None, None, None


class _Bounce(torch.autograd.Function):
    """(table, lights, o, d, beta) -> bounce_fwd's outputs; the backward is
    bounce_bwd."""

    @staticmethod
    def forward(ctx, table_rows, lights, o, d, beta, tris, alive, seeds,
                bounce, cfg):
        out = bounce_fwd(table_rows.detach(), tris.detach(), lights.detach(),
                         o.detach(), d.detach(), beta.detach(), alive, seeds,
                         bounce, cfg)
        _, _, _, alive_n, _, winner, occ = out
        ctx.save_for_backward(table_rows, lights, o, d, beta, alive, seeds,
                              winner, occ)
        ctx.bounce, ctx.cfg = bounce, cfg
        ctx.mark_non_differentiable(alive_n, winner, occ)
        return out

    @staticmethod
    def backward(ctx, g_o, g_d, g_beta, _g_alive, g_rad, _g_w, _g_occ):
        table_rows, lights, o, d, beta, alive, seeds, winner, occ = \
            ctx.saved_tensors
        d_o, d_d, d_beta, d_tab, d_lv = bounce_bwd(
            table_rows.detach(), lights.detach(), o.detach(), d.detach(),
            beta.detach(), alive, seeds, winner, occ,
            _cot((g_o, g_d, g_beta, g_rad)), ctx.bounce, ctx.cfg)
        return d_tab, d_lv, d_o, d_d, d_beta, None, None, None, None, None


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
    return table_rows, tris.detach(), lv


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _bounce(grad: bool, table_rows, tris, lv, o, d, beta, alive, seeds,
            b: int, cfg: RenderConfig):
    if grad:
        return _Bounce.apply(table_rows, lv, o, d, beta, tris, alive, seeds,
                             b, cfg)
    return bounce_fwd(table_rows, tris, lv, o, d, beta, alive, seeds, b, cfg)


def trace_paths_mega_cam(scene: Scene, cfg: RenderConfig, camera: Camera,
                         pixel_ids: torch.Tensor, frame: int,
                         accel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(camera, pixel ids, frame) -> radiance [R, 3]: the raygen-fused
    first bounce, then ``bounce_fwd`` for bounces 1..B-1. Zero bounces
    render black. Differentiable w.r.t. the scene and the camera."""
    table_rows, tris, lv = _tables(scene, cfg, accel)
    R = pixel_ids.shape[0]
    if cfg.bounces == 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=pixel_ids.device)
    camv = camera_vector(camera)
    pid = pixel_ids.to(torch.int32).contiguous()
    grad = _needs_grad(table_rows, lv, camv)
    if grad:
        out = _Bounce0.apply(table_rows, lv, camv, tris, pid, frame, cfg)
    else:
        out = bounce0_fwd(table_rows, tris, lv, camv, pid, frame, cfg)
    o, d, beta, alive, rad, _, _, seeds = out
    for b in range(1, cfg.bounces):
        o, d, beta, alive, rad_b, _, _ = _bounce(
            grad, table_rows, tris, lv, o, d, beta, alive, seeds, b, cfg)
        rad = rad + rad_b
    # Final clamp (kernel_bvh.cl:383).
    return vmax(rad, 0.0).T


def trace_paths_mega(scene: Scene, cfg: RenderConfig, origins: torch.Tensor,
                     directions: torch.Tensor, seeds: torch.Tensor,
                     accel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ops/integrator.trace_paths on the bounce kernel:
    origins/directions [R, 3], seeds [R] int64 u32 -> radiance [R, 3].
    Differentiable w.r.t. the scene, the origins and the directions."""
    table_rows, tris, lv = _tables(scene, cfg, accel)
    R = origins.shape[0]
    dev = origins.device
    o = origins.T.to(torch.float32).contiguous()
    d = directions.T.to(torch.float32).contiguous()
    beta = torch.ones((3, R), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.float32, device=dev)
    rad = torch.zeros((3, R), dtype=torch.float32, device=dev)
    seeds32 = rng.to_i32_bits(seeds.to(torch.int64)).contiguous()
    grad = _needs_grad(table_rows, lv, o, d)
    for b in range(cfg.bounces):
        o, d, beta, alive, rad_b, _, _ = _bounce(
            grad, table_rows, tris, lv, o, d, beta, alive, seeds32, b, cfg)
        rad = rad + rad_b
    return vmax(rad, 0.0).T
