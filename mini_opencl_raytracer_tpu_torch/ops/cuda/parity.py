"""The gate that holds a kernel's outputs against its plain version's on
the same inputs (chip_smoke.py and tests/test_torch_cuda.py).

Forward: seeds bit-exact; winner indices equal on >= 99.99% of rays;
every float output with mean |diff| <= 1e-4 and frac(|diff| > 1e-3) <=
1e-4 (the forward gate of benchmarks/VERIFY_TPU.md); the intersection
kernels' any-hit occlusion exactly equal. Knife-edge decisions
(a ray on a shared edge, a sample on a validity threshold) may flip under
different float rounding; those flips are the gate's only allowed error.

Residual variants (cfg.bwd_residuals): K2 ranks the plain version's rays
(its ranks 0 .. count - 1, in its own order of tiles), and its
known-value rows, read back through its rank array, against the plain
version's read through theirs, on the rows K4 reads
(megakernel.rows_read) and the rays they belong to (the other rows and
columns are undefined), under the forward gate, with whether they are
bitwise equal; K2's other outputs
bitwise equal to those of K2 without rows; K4 with rows bitwise equal to
K4 without, except with direct specular, where the power's derivative is
taken from its row (csrc/megakernel_bwd.cu) and the two are held in the
gradient gate.

Gradients: per-ray outputs (d_o, d_d, d_beta) take the forward gate
scaled by s = max |plain|: mean |diff| <= 1e-4 s and frac(|diff| >
1e-3 s) <= 1e-4. Sums over rays (d_table, d_lights, d_camv) and scene or
camera gradients per leaf: max |diff| <= 2e-3 max |reference| (the
gradient gate of benchmarks/VERIFY_TPU.md). Against central finite
differences: relative error <= 5e-2. Every value must be finite.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...models.cornell import cornell_scene
from ...render import _swizzled_ids
from ...models.scene import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
                             Camera, Geometry, Lights, Scene)
from .. import integrator, known, rng
from ..camera import generate_rays
from ..shading import build_shading_table, hit_attributes

MEAN_TOL, ERR_TOL, FRAC_TOL, WINNER_AGREE = 1e-4, 1e-3, 1e-4, 0.9999
GRAD_TOL, FD_TOL = 2e-3, 5e-2
BOUNCE_FLOATS = ("o", "d", "beta", "alive", "radiance")
# Outputs of the backward wrappers, and which are per ray.
BOUNCE0_GRADS = ("d_table", "d_lights", "d_camv")
BOUNCE_GRADS = ("d_o", "d_d", "d_beta", "d_table", "d_lights")
# The wavefront shading's adjoint (ops/cuda/shade.shade_adjoint).
SHADE_GRADS = ("d_o", "d_d", "d_beta", "d_rows", "d_lights")
PER_RAY = ("d_o", "d_d", "d_beta", "d_rows")


def check_float(label: str, kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    """Mean / tail gate on one float output; returns its max, mean and
    tail fraction of |diff|, and raises AssertionError outside the gate."""
    err = (kernel.float() - plain.float()).abs()
    stats = {"max": err.max().item(), "mean": err.mean().item(),
             "frac": (err > ERR_TOL).float().mean().item()}
    if not (stats["mean"] <= MEAN_TOL and stats["frac"] <= FRAC_TOL
            and bool(torch.isfinite(err).all())):
        raise AssertionError(f"{label}: kernel disagrees with its plain version "
                             f"{stats}")
    return stats


def check_bounce(label: str, k_out, p_out) -> dict:
    """Gate one bounce's outputs (o, d, beta, alive, radiance, winner,
    occ_bits[, seeds]) as the wrappers return them; returns the stats of
    each float output, the winner and occlusion-bit agreement, and
    ``max_abs_err`` over all float outputs."""
    stats = {n: check_float(f"{label}.{n}", k, p)
             for n, k, p in zip(BOUNCE_FLOATS, k_out, p_out)}
    stats["winner_agree"] = (k_out[5] == p_out[5]).float().mean().item()
    stats["occ_agree"] = (k_out[6] == p_out[6]).float().mean().item()
    if stats["winner_agree"] < WINNER_AGREE:
        raise AssertionError(f"{label}: winners agree on "
                             f"{stats['winner_agree']:.6f} < {WINNER_AGREE}")
    if len(k_out) > 7 and not torch.equal(k_out[7], p_out[7]):
        raise AssertionError(f"{label}: seeds are not bit-exact")
    stats["max_abs_err"] = max(stats[n]["max"] for n in BOUNCE_FLOATS)
    return stats


def check_bitwise(label: str, k_out, p_out) -> float:
    """A kernel that must equal its plain version: every output (floats,
    winners, occlusion bits) equal entry by entry (``torch.equal``: max
    |diff| 0). Raises naming each output that differs and on how many
    entries; returns max |diff| over the float outputs (0.0)."""
    bad, err = [], 0.0
    for n, k, p in zip(BOUNCE_FLOATS + ("winner", "occ_bits", "seeds"), k_out, p_out):
        if k.is_floating_point():
            err = max(err, (k - p).abs().max().item() if k.numel() else 0.0)
        if not torch.equal(k, p):
            bad.append(f"{n} on {int((k != p).sum().item())}")
    if bad:
        raise AssertionError(f"{label}: not bitwise the plain version's: {', '.join(bad)}")
    return err


def check_hits(label: str, k_out, p_out) -> dict:
    """Gate a closest-hit kernel's (t, winner[, rows]) against its plain
    version's: winners equal on >= 99.99% of rays, t and rows under the
    forward gate. Returns the stats and ``max_abs_err``."""
    same = k_out[1] == p_out[1]
    stats = {"t": check_float(f"{label}.t", k_out[0], p_out[0])}
    if len(k_out) > 2 and k_out[2] is not None:
        # A row belongs to its winner: compare the rows of equal winners.
        stats["rows"] = check_float(f"{label}.rows", k_out[2][same], p_out[2][same])
    stats["winner_agree"] = same.float().mean().item()
    stats["hit_frac"] = (p_out[1] >= 0).float().mean().item()
    if stats["winner_agree"] < WINNER_AGREE:
        raise AssertionError(f"{label}: winners agree on "
                             f"{stats['winner_agree']:.6f} < {WINNER_AGREE}")
    stats["max_abs_err"] = max(v["max"] for v in stats.values() if isinstance(v, dict))
    return stats


def check_any(label: str, k_blocked: torch.Tensor, p_blocked: torch.Tensor) -> dict:
    """An any-hit kernel's occlusion must equal its plain version's."""
    if not torch.equal(k_blocked, p_blocked):
        n = (k_blocked != p_blocked).sum().item()
        raise AssertionError(f"{label}: occlusion differs on {n} of "
                             f"{k_blocked.numel()} rays")
    return {"blocked_frac": p_blocked.float().mean().item()}


def cotangents(next_beta: torch.Tensor, gen: torch.Generator):
    """Seeded standard-normal cotangents of (o', d', beta', radiance), each
    shaped like ``next_beta`` ([3, R]), on its device."""
    return tuple(torch.randn(next_beta.shape, generator=gen,
                             device=next_beta.device) for _ in range(4))


def _finite(label: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite values")


def check_grad_sum(label: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |diff| <= 2e-3 max |ref| for a sum over rays or a gradient
    leaf; returns max |diff| and its ratio to max |ref|."""
    _finite(label, got, ref)
    err = (got.double() - ref.double()).abs().max().item() if got.numel() else 0.0
    scale = ref.abs().max().item() if ref.numel() else 0.0
    stats = {"max": err, "scale": scale, "rel": err / scale if scale else err}
    if err > GRAD_TOL * scale:
        raise AssertionError(f"{label}: gradient outside the gate {stats}")
    return stats


def check_grad_rays(label: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The forward gate scaled by s = max |ref| on a per-ray gradient."""
    _finite(label, got, ref)
    s = ref.abs().max().item()
    err = (got.double() - ref.double()).abs()
    stats = {"max": err.max().item(), "mean": err.mean().item(),
             "frac": (err > ERR_TOL * s).double().mean().item(), "scale": s}
    if not (stats["mean"] <= MEAN_TOL * s and stats["frac"] <= FRAC_TOL):
        raise AssertionError(f"{label}: kernel disagrees with its plain version "
                             f"{stats}")
    return stats


def check_grads(label: str, k_out, p_out, names) -> dict:
    """Gate a backward wrapper's outputs ``names`` against the plain
    version's; returns per-output stats and ``max_abs_err``."""
    stats = {}
    for n, k, p in zip(names, k_out, p_out):
        check = check_grad_rays if n in PER_RAY else check_grad_sum
        stats[n] = check(f"{label}.{n}", k, p)
    stats["max_abs_err"] = max(v["max"] for v in stats.values())
    return stats


def check_fd(label: str, ad: float, fd: float) -> float:
    """|ad - fd| <= 5e-2 |fd|; returns the relative error."""
    rel = abs(ad - fd) / max(abs(fd), 1e-12)
    if not (rel <= FD_TOL and abs(fd) > 0):
        raise AssertionError(f"{label}: autodiff {ad} vs finite difference {fd} "
                             f"(relative error {rel})")
    return rel


# ---------------------------------------------------------------------------
# Inputs the backward gate runs on beside Cornell's defaults (chip_smoke.py
# phase 3b, tests/test_torch_cuda.py).

def shuffled_ids(num_pixels: int, seed: int, device) -> torch.Tensor:
    """A seeded permutation of the pixel ids: neighbouring rays start from
    pixels far apart, so a warp's rays see many winners."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(num_pixels, generator=gen).to(torch.int32).to(device)


def _t(a, device, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def two_light_scene(device) -> Scene:
    """Cornell with a point light and a spot light."""
    lights = Lights(
        position=_t([[0.0, -10.0, 16.0], [0.0, 10.0, 16.0]], device),
        direction=_t([[-0.5, 0.4, -0.1], [0.0, 0.1, -1.0]], device),
        light_type=_t([LIGHT_POINT, LIGHT_SPOT], device, torch.int32),
        intensity=_t([16.0, 12.0], device), attenuation=_t([0.8, 0.05], device),
        cos_cutoff=_t([0.9, 0.7], device))
    return cornell_scene(lights=lights, device=device)


def many_light_scene(device, n: int = 30, seed: int = 4) -> Scene:
    """Cornell with ``n`` seeded lights (30 is the mega path's limit), point,
    spot and directional in turn, placed in and around the box."""
    rs = np.random.default_rng(seed)
    kinds = np.array([LIGHT_POINT, LIGHT_SPOT, LIGHT_DIRECTIONAL])[np.arange(n) % 3]
    lights = Lights(
        position=_t(rs.uniform([-8.0, -12.0, 2.0], [8.0, 8.0, 16.0], (n, 3)), device),
        direction=_t(rs.normal(0.0, 1.0, (n, 3)), device),
        light_type=_t(kinds, device, torch.int32),
        intensity=_t(rs.uniform(2.0, 16.0, n), device),
        attenuation=_t(rs.uniform(0.05, 0.8, n), device),
        cos_cutoff=_t(rs.uniform(0.5, 0.95, n), device))
    return cornell_scene(lights=lights, device=device)


def soup_scene(device, n: int = 2048, seed: int = 3) -> Scene:
    """A seeded soup of ``n`` triangles in front of the camera, with the
    Cornell materials and light."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform([-10.0, -5.0, -2.0], [10.0, 10.0, 18.0], (n, 3))
    corners = [centers + rs.normal(0.0, 1.0, (n, 3)) for _ in range(3)]
    return _soup(corners, rs, device)


def quad_soup_scene(device, n: int = 4096, seed: int = 6) -> Scene:
    """A seeded soup of ``n // 2`` planar quads in front of the camera,
    each split into two triangles along the diagonal they share (so that
    rays at that diagonal meet both), with the Cornell materials and
    light."""
    rs = np.random.default_rng(seed)
    q = n // 2
    p0 = rs.uniform([-10.0, -5.0, -2.0], [10.0, 10.0, 18.0], (q, 3))
    a, b = rs.normal(0.0, 1.0, (q, 3)), rs.normal(0.0, 1.0, (q, 3))
    pair = lambda x, y: np.stack([x, y], 1).reshape(2 * q, 3)
    return _soup([pair(p0, p0), pair(p0 + a, p0 + a + b), pair(p0 + a + b, p0 + b)], rs,
                 device)


def _soup(corners, rs, device) -> Scene:
    n = corners[0].shape[0]
    normal = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-12
    zeros2 = _t(np.zeros((n, 2)), device)
    geo = Geometry(v0=_t(corners[0], device), v1=_t(corners[1], device),
                   v2=_t(corners[2], device), n0=_t(normal, device),
                   n1=_t(normal, device), n2=_t(normal, device),
                   uv0=zeros2, uv1=zeros2, uv2=zeros2,
                   mat_idx=_t(rs.integers(0, 6, n), device, torch.int32))
    base = cornell_scene(device=device)
    return Scene(geometry=geo, materials=base.materials, lights=base.lights)


def shared_edge_rays(geometry: Geometry, n: int = 4096, seed: int = 7):
    """``n`` rays (o, d float32 [n, 3] on the geometry's device) aimed from
    seeded points in the geometry's bounding box at points 1/3, 1/2 and
    2/3 along edges that two triangles share (the same two corners),
    where both triangles meet the ray at nearly or exactly the same t: the
    cases of a closest hit's tie rule."""
    rs = np.random.default_rng(seed)
    V = np.stack([geometry.v0.detach().cpu().numpy(), geometry.v1.detach().cpu().numpy(),
                  geometry.v2.detach().cpu().numpy()], 1).astype(np.float64)
    seen, shared = {}, []
    for t in range(V.shape[0]):
        for k in range(3):
            a, b = tuple(V[t, k]), tuple(V[t, (k + 1) % 3])
            key = (min(a, b), max(a, b))
            if seen.setdefault(key, t) != t:
                shared.append(key)
    if not shared:
        raise ValueError("the geometry has no shared edge")
    edge = np.asarray(shared)[rs.integers(0, len(shared), n)]
    f = rs.choice([1.0 / 3.0, 0.5, 2.0 / 3.0], n)[:, None]
    targets = edge[:, 0] + f * (edge[:, 1] - edge[:, 0])
    lo, hi = V.reshape(-1, 3).min(0), V.reshape(-1, 3).max(0)
    o = rs.uniform(lo, hi, (n, 3))
    d = _unit(targets - o)
    dev = geometry.v0.device
    return _t(o, dev), _t(d, dev)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _warps(origins, targets, rs, jitter: float):
    """32 rays per (origin, target) pair: origins jittered by ``jitter``,
    each aimed exactly at its target (a tight, coherent warp)."""
    o = np.repeat(origins, 32, axis=0) + rs.normal(0.0, jitter, (32 * len(origins), 3))
    d = _unit(np.repeat(targets, 32, axis=0) - o)
    return o, d


def cull_ray_sets(device, seed: int = 0) -> dict:
    """Adversarial rays for the per-warp cull of the panel and first-bounce
    kernels (csrc/bundle.cuh), in warps of 32 coherent rays: name ->
    (scene geometry, o [R, 3], d [R, 3], limit [R]), all float32 on
    ``device``. On Cornell: rays aimed at every vertex and at points on
    every edge; at the floor where the boxes' bottoms lie on it (coplanar
    pairs, a tie decided by the last ulp of t); grazing the walls and box
    faces at cos 1e-2 ... 1e-4; directions with components of exactly +0
    and -0; limits inf and 3e38. Then a scene of 3 triangles (padding rows
    past them) and a seeded soup of 2048 triangles (four tiles of the panel
    kernel) under camera-like and random rays."""
    rs = np.random.default_rng(seed)
    cornell = cornell_scene(device="cpu").geometry
    V = np.stack([cornell.v0.numpy(), cornell.v1.numpy(), cornell.v2.numpy()], 1).astype(np.float64)
    room_lo, room_hi = np.array([-7.5, 0.5, 0.5]), np.array([7.5, 19.5, 16.5])
    room = lambda n: rs.uniform(room_lo, room_hi, (n, 3))
    sets = {}
    # Vertices and edge points (at 0, 1/3, 1/2 of each edge).
    targets = [V[:, k] + f * (V[:, (k + 1) % 3] - V[:, k])
               for k in range(3) for f in (0.0, 1.0 / 3.0, 0.5)]
    targets = np.concatenate(targets)
    sets["vertices_edges"] = (cornell,) + _warps(room(len(targets)), targets, rs, 1e-4)
    # The floor (triangles 6, 7) under the boxes' bottoms (20, 21, 32, 33).
    w = rs.dirichlet([1.0, 1.0, 1.0], 96)
    tri = rs.choice([20, 21, 32, 33], 96)
    targets = np.einsum("nk,nkc->nc", w, V[tri])
    above = room(96)
    above[:, 2] = rs.uniform(0.5, 16.5, 96)
    below = above.copy()
    below[:, 2] = -rs.uniform(0.5, 10.0, 96)
    sets["coplanar"] = (cornell,) + _warps(np.concatenate([above, below]),
                                           np.concatenate([targets, targets]), rs, 1e-3)
    # Grazing: per triangle and cosine, a warp of rays meeting it at a point
    # near an edge, at that cosine to its plane.
    nrm = _unit(np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]))
    os_, ds = [], []
    for cos in (1e-2, 1e-3, 1e-4):
        for k in range(V.shape[0]):
            p = V[k, 0] + rs.uniform(0.0, 0.02) * (V[k, 1] - V[k, 0]) + rs.uniform(0.0, 1.0) * (
                V[k, 2] - V[k, 0]) * 0.5
            r = _unit(np.cross(nrm[k], rs.normal(size=3)))
            d = _unit(r * np.sqrt(1.0 - cos * cos) - cos * nrm[k])
            d = np.repeat(d[None], 32, 0)
            L = rs.uniform(1.0, 20.0, (32, 1))
            os_.append(p - L * d)
            ds.append(d)
    sets["grazing"] = (cornell, np.concatenate(os_), np.concatenate(ds))
    # Directions with exact +0 / -0 components, in warps of one direction.
    dirs = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            for zsign in (1.0, -1.0):
                d = np.full(3, 0.0 * zsign)
                d[axis] = sign
                dirs.append(d)
    dirs += [np.array([0.6, 0.8, -0.0]), np.array([-0.0, 0.6, -0.8]), np.array([0.8, 0.0, 0.6])]
    d = np.repeat(np.array(dirs), 32, 0)
    o = np.repeat(room(len(dirs)), 32, 0) + rs.normal(0.0, 0.5, (32 * len(dirs), 3))
    sets["signed_zeros"] = (cornell, o, d)
    # Open limits: inf and 3e38 (set below), camera-like rays into the room.
    sets["open_limits"] = (cornell,) + _warps(np.tile([[0.0, -25.0, 8.5]], (64, 1)),
                                              room(64), rs, 1e-3)
    # Three triangles: the panel pads them to eight rows.
    small = Geometry(**{k: getattr(cornell, k)[[6, 20, 24]] for k in (
        "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_idx")})
    sets["padding"] = (small,) + _warps(room(48), np.einsum(
        "nk,nkc->nc", rs.dirichlet([1.0, 1.0, 1.0], 48), V[rs.choice([6, 20, 24], 48)]), rs, 1e-3)
    soup = soup_scene("cpu").geometry
    cam = np.tile([[0.0, -25.0, 8.5]], (64, 1))
    far = rs.uniform([-10.0, 10.0, -2.0], [10.0, 10.0, 18.0], (64, 3))
    o1, d1 = _warps(cam, far, rs, 1e-3)
    o2, d2 = _warps(room(32), room(32), rs, 0.3)
    sets["soup2048"] = (soup, np.concatenate([o1, o2]), np.concatenate([d1, d2]))
    out = {}
    for name, (geo, o, d) in sets.items():
        R = o.shape[0]
        limit = np.full((R,), 1e5)
        if name == "open_limits":
            limit[: R // 2] = np.inf
            limit[R // 2:] = 3e38
            limit[R // 2 - 16: R // 2 + 16] = rs.uniform(5.0, 30.0, 32)   # a mixed warp
        elif name in ("coplanar", "grazing"):
            limit[::3] = rs.uniform(1.0, 30.0, len(limit[::3]))
        geo = Geometry(**{f: getattr(geo, f).to(device) for f in (
            "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_idx")})
        out[name] = (geo, _t(o, device), _t(d, device), _t(limit, device))
    return out


def grazing_camera(device) -> Camera:
    """A camera in the Cornell box 2 cm above the floor, looking along it
    and down by 0.002: its rays meet the floor and the boxes' bottoms
    (coplanar with it) at cos down to ~1e-3."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    front = t([0.0, 1.0, -0.002])
    return Camera(position=t([0.5, 0.5, 0.02]), front=front / torch.linalg.norm(front),
                  up=t([0.0, 0.0, 1.0]))


def k1_cull_cases(device):
    """(label, scene, camera, cfg) cases of the first-bounce kernel's cull
    beyond the smoke run's Cornell cases: a 2048-triangle soup, and a
    grazing camera with and without backface culling and shadow rays."""
    from ...config import RenderConfig
    cornell = cornell_scene(device=device)
    cam = Camera.default(device=device)
    graze = grazing_camera(device)
    return (("soup of 2048 triangles", soup_scene(device), cam, RenderConfig(width=256, height=256)),
            ("grazing camera", cornell, graze, RenderConfig()),
            ("grazing camera, backface_cull + shadow rays", cornell, graze,
             RenderConfig(backface_cull=True, shadow_rays=True)))


# The bounce kernel K2's edge cases beside the main path (chip_smoke.py
# phase 3, tests/test_torch_cuda.py): which rays are alive, how many, in
# which order, and the options that change its loops.
K2_CASES = ("every ray dead", "every ray alive", "10% alive", "R=1", "R=255", "R=257",
            "shuffled ids", "30 lights + shadow rays", "backface_cull + soft_edge")


def k2_case(name: str, device, width: int = 128, height: int = 72, seed: int = 9):
    """(scene, cfg, state, bounce) of one of K2_CASES: ``state`` = (o, d,
    beta, alive, seeds) [3, R] / [R], bounce 0's output by the plain first
    bounce at ``width`` x ``height`` (frame 1, the default camera), with
    its alive mask replaced where the case says. "R=n" takes the first n
    rays of the shuffled-id state with ray 0 alive; "10% alive" a seeded
    10% of the rays."""
    from ...config import RenderConfig
    from . import megakernel as mk
    cfg = RenderConfig(width=width, height=height)
    scene = cornell_scene(device=device)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int32, device=device)
    if name == "30 lights + shadow rays":
        scene, cfg = many_light_scene(device), RenderConfig(width=width, height=height,
                                                            shadow_rays=True)
    elif name == "backface_cull + soft_edge":
        cfg = RenderConfig(width=width, height=height, backface_cull=True,
                           soft_edge_sigma=0.05)
    elif name == "shuffled ids" or name.startswith("R="):
        pid = shuffled_ids(cfg.num_pixels, seed, device)
    table, tris, lv = mk._tables(scene, cfg, None)
    camv = mk.camera_vector(Camera.default(device=device))
    f0 = mk.bounce0_fwd_plain(table, tris, lv, camv, pid, 1, cfg)
    o, d, beta, alive, seeds = f0[0], f0[1], f0[2], f0[3], f0[7]
    if name == "every ray dead":
        alive = torch.zeros_like(alive)
    elif name == "every ray alive":
        alive = torch.ones_like(alive)
    elif name == "10% alive":
        gen = torch.Generator().manual_seed(seed)
        alive = (torch.rand(alive.shape, generator=gen) < 0.1).to(alive)
    elif name.startswith("R="):
        n = int(name[2:])
        o, d, beta = (x[:, :n].contiguous() for x in (o, d, beta))
        alive, seeds = alive[:n].clone(), seeds[:n].contiguous()
        alive[0] = 1.0
    return scene, cfg, (o, d, beta, alive, seeds), 1


# The options that change the residual rows (ops/known.layout), the
# residual variants of K2 / K4 run in each on K2_CASES' states (chip_smoke
# phase 17, tests/test_torch_cuda.py): (config fields, rows on Cornell's
# one light).
RESID_OPTIONS = {"blinn": ({}, 17), "ggx": (dict(specular_model="ggx"), 16),
                 "shadow rays": (dict(shadow_rays=True), 17),
                 "direct specular": (dict(direct_specular=True), 20),
                 "soft edge": (dict(soft_edge_sigma=0.05), 18)}


# The states the residual variants run on: K2_CASES ("every ray dead"
# ranks no ray) and one where every ray is ranked.
ALL_RANKED = "every ray alive with a winner"
RESID_CASES = K2_CASES + (ALL_RANKED,)


def resid_case(name: str, option: str, device, width: int = 128, height: int = 72):
    """(scene, cfg, state, bounce) of RESID_CASES' ``name`` with the
    residual option ``option`` (RESID_OPTIONS) added to its config.
    ALL_RANKED is "every ray alive"'s state cut to the rays that have a
    winner at its bounce (by the plain version)."""
    from . import megakernel as mk
    scene, cfg, state, bounce = k2_case("every ray alive" if name == ALL_RANKED else name,
                                        device, width, height)
    cfg = dataclasses.replace(cfg, bwd_residuals=True, **RESID_OPTIONS[option][0])
    if name == ALL_RANKED:
        table, tris, lv = mk._tables(scene, cfg, None)
        keep = (mk.bounce_fwd_plain(table, tris, lv, *state, bounce, cfg)[5] >= 0).nonzero()[:, 0]
        state = (tuple(x[:, keep].contiguous() for x in state[:3])
                 + tuple(x[keep].contiguous() for x in state[3:]))
    return scene, cfg, state, bounce


def live_rays(alive: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """The rays whose residual rows K2 writes: alive with a winner."""
    return (alive > 0.0) & (winner >= 0)


def check_resid_rows(label: str, k: "known.Resid", p: "known.Resid", alive_next: torch.Tensor,
                     cfg, num_lights: int) -> dict:
    """K2's rows (a known.Resid) against the plain version's: the same
    rays ranked (alive with a winner), the same count, the kernel's ranks
    0 .. count - 1 each once (its tiles may take their columns in another
    order than the plain version's ray order); then under the forward gate
    row by row, read back through each one's rank array, the rows the
    kernels write (megakernel.rows_read): the shared rows on the ranked
    rays, each lobe's on those whose plain pick is that lobe, the lights'
    on those whose path goes on (``alive_next``). Returns the worst row's
    stats, ``bitwise`` (every compared value equal), ``live`` and
    ``max_abs_err``."""
    from .megakernel import rows_read
    if k.rows.shape != p.rows.shape:
        raise AssertionError(f"{label}: rows {tuple(k.rows.shape)} vs {tuple(p.rows.shape)}")
    live = p.rank >= 0
    n = int(p.count.item())
    if int(live.sum().item()) != n:
        raise AssertionError(f"{label}: {int(live.sum().item())} ranked rays, count {n}")
    ranks = torch.sort(k.rank[live].long()).values
    if not (torch.equal(k.rank >= 0, live) and int(k.count.item()) == n
            and torch.equal(ranks, torch.arange(n, device=ranks.device))):
        bad = int(((k.rank >= 0) != live).sum().item())
        raise AssertionError(f"{label}: the kernel ranks {bad} other rays, count "
                             f"{k.count.item()} vs {n}, or its ranks are not 0 .. count - 1")
    read = rows_read(cfg, num_lights)
    col = lambda r: torch.where(live, r, torch.zeros_like(r)).long()
    kc, pc = col(k.rank), col(p.rank)
    spec = p.rows[known.layout(cfg, num_lights)["pick"]][pc] > 0.5
    rays = {"all": live, "diffuse": live & ~spec, "specular": live & spec,
            "lights": live & (alive_next > 0.0)}
    worst = {"max": 0.0, "mean": 0.0, "frac": 0.0}
    bitwise = True
    for part, idx in read.items():
        for r in idx:
            a, b = k.rows[r][kc][rays[part]], p.rows[r][pc][rays[part]]
            if a.numel():
                st = check_float(f"{label}.row{r}", a, b)
                worst = {n: max(worst[n], st[n]) for n in worst}
                bitwise = bitwise and bool(torch.equal(a, b))
    return dict(worst, bitwise=bitwise, live=int(live.sum().item()), max_abs_err=worst["max"])


def check_resid_bwd(label: str, with_rows, without, cfg) -> dict:
    """K4 with rows against K4 without on the same inputs: bitwise, but
    in the gradient gate with direct specular (module docstring)."""
    if not cfg.direct_specular:
        bad = [n for n, a, b in zip(BOUNCE_GRADS, with_rows, without) if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{label}: K4 with rows is not bitwise K4 without: {bad}")
        return {"bitwise": True}
    stats = check_grads(label, with_rows, without, BOUNCE_GRADS)
    stats["bitwise"] = all(torch.equal(a, b) for a, b in zip(with_rows, without))
    return stats


def k2_ray_set_cases(device, t_max: float = 3.0e38):
    """K2 on the adversarial rays of cull_ray_sets (vertices and edges,
    coplanar ties, grazing incidence, signed zeros, open limits, padding, a
    2048-triangle soup): (label, scene, cfg, state, bounce) with every ray
    alive, unit throughput and seeds 0 .. R - 1, the scene's materials and
    light Cornell's, the limit ``t_max`` (3e38: the kernels' largest), with
    and without backface culling."""
    from ...config import RenderConfig
    base = cornell_scene(device=device)
    cases = []
    for name, (geo, o, d, _) in cull_ray_sets(device).items():
        R = o.shape[0]
        scene = Scene(geometry=geo.to(device), materials=base.materials, lights=base.lights)
        state = (o.T.contiguous(), d.T.contiguous(),
                 torch.ones((3, R), dtype=torch.float32, device=device),
                 torch.ones((R,), dtype=torch.float32, device=device),
                 torch.arange(R, dtype=torch.int32, device=device))
        for cull in (False, True):
            cfg = RenderConfig(t_max=t_max, backface_cull=cull)
            cases.append((f"{name}{', backface_cull' if cull else ''}", scene, cfg, state, 1))
    return cases


def grazing_surface(seed: int = 3, n: int = 24):
    """A tilted, slightly bumpy surface of 2 n^2 triangles (1152 at n = 24:
    nine clusters) on the CPU, for grazing rays: (geometry, vertices [V, 3],
    triangles [T, 3] as vertex ids, the plane's normal), float64 numpy
    beside the float32 geometry."""
    gen = np.random.default_rng(seed)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = unit(np.array([0.3, 1.0, 0.2]))
    a = unit(np.cross(nrm, [1.0, 0.0, 0.0]))
    b = np.cross(nrm, a)
    ij = np.stack(np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij"),
                  -1).reshape(-1, 2).astype(np.float64)
    pts = ((ij[:, :1] - n / 2) * a + (ij[:, 1:] - n / 2) * b
           + gen.normal(scale=1e-3, size=(len(ij), 1)) * nrm)
    k = lambda i, j: i * (n + 1) + j
    tris = np.array([t for i in range(n) for j in range(n)
                     for t in ((k(i, j), k(i + 1, j), k(i + 1, j + 1)),
                               (k(i, j), k(i + 1, j + 1), k(i, j + 1)))])
    V = torch.tensor(pts[tris], dtype=torch.float32)
    z3, z2 = torch.zeros((len(tris), 3)), torch.zeros((len(tris), 2))
    geo = Geometry(v0=V[:, 0], v1=V[:, 1], v2=V[:, 2], n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2,
                     uv2=z2, mat_idx=torch.zeros((len(tris),), dtype=torch.int32))
    return geo, pts, tris, nrm


def grazing_rays(pts, tris, nrm, cos: float, n: int = 4096, seed: int = 11):
    """n rays (o, d, float32 [n, 3] on the CPU) at ``grazing_surface``:
    each aimed at a point of a triangle's edge (often shared by two
    triangles in two clusters, whose t then differ by a few ulps), from 2
    to 20 away, meeting the surface's plane at ``cos``."""
    gen = np.random.default_rng(seed)
    e = tris[gen.integers(0, len(tris), n)]
    k = gen.integers(0, 3, n)
    p0, p1 = pts[e[np.arange(n), k]], pts[e[np.arange(n), (k + 1) % 3]]
    target = p0 + gen.uniform(0.05, 0.95, (n, 1)) * (p1 - p0)
    r = np.cross(nrm, gen.normal(size=(n, 3)))
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    d = r * np.sqrt(1.0 - cos * cos) - cos * nrm
    o = target - gen.uniform(2.0, 20.0, (n, 1)) * d
    return tuple(torch.tensor(a, dtype=torch.float32) for a in (o, d))


def grazing_decoys(device, cos: float, cases: int = 16, n: int = 20_000, seed: int = 1):
    """Two-triangle scenes in which a cull of the cluster boxes by the best
    t plus a slack would drop the nearest hit. Triangle F (seeded, in
    [-10, 10]^3, slivers among them) is met at ``cos`` near its vertex 0,
    5 to 30 away, where Möller–Trumbore's t falls below the slab entry of
    F's box by more than 0.2% of t; a small decoy facing the ray sits
    between that t and the entry, in another cluster, which a walk
    visits first. Returns up to ``cases`` tuples (accel on
    ``device`` with the decoy in cluster 0 and F in cluster 1, o [1, 3],
    d [1, 3], F's t, the decoy's t along the ray, the entry of F's box)."""
    from ..intersect import ray_triangle_edges
    from .clustered import build_clusters

    gen = np.random.default_rng(seed)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    V = gen.uniform(-10, 10, size=(n, 3, 3))
    nrm = unit(np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]))
    w = gen.uniform(0, 1e-3, size=(n, 2))
    p = V[:, 0] + w[:, :1] * (V[:, 1] - V[:, 0]) + w[:, 1:] * (V[:, 2] - V[:, 0])
    r = unit(np.cross(nrm, gen.normal(size=(n, 3))))
    d = unit(r * np.sqrt(1 - cos * cos) - cos * nrm * np.sign(gen.normal(size=(n, 1))))
    o = p - gen.uniform(5, 30, size=(n, 1)) * d
    v0, v1, v2, o, d = f32(V[:, 0]), f32(V[:, 1]), f32(V[:, 2]), f32(o), f32(d)
    t, _, _, ok = ray_triangle_edges(o, d, v0, v1 - v0, v2 - v0)
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    inv = 1.0 / d
    entry = torch.minimum((lo - o) * inv, (hi - o) * inv).amax(1).clamp(min=0)
    live = ok & (entry - t > 2e-3 * t)
    out = []
    z3, z2 = torch.zeros((2, 3), device=device), torch.zeros((2, 2), device=device)
    for i in torch.nonzero(live)[:, 0][:cases].tolist():
        t_dec = t[i] + 0.3 * (entry[i] - t[i])
        a = torch.linalg.cross(d[i], f32([0.0, 0.0, 1.0]))
        a = a / torch.linalg.norm(a)
        b = torch.linalg.cross(d[i], a)
        c = o[i] + t_dec * d[i]
        corners = [torch.stack([x, y]).to(device) for x, y in
                   zip((v0[i], v1[i], v2[i]), (c + 1e-3 * a, c + 1e-3 * b, c - 1e-3 * (a + b)))]
        geo = Geometry(v0=corners[0], v1=corners[1], v2=corners[2], n0=z3, n1=z3, n2=z3,
                       uv0=z2, uv1=z2, uv2=z2,
                       mat_idx=torch.zeros((2,), dtype=torch.int32, device=device))
        leaves = (np.array([1, 0], np.int32), np.array([0, 1], np.int32),
                  np.array([1, 1], np.int32))
        out.append((build_clusters(geo, leaf_info=leaves), o[i:i + 1].to(device),
                    d[i:i + 1].to(device), t[i].item(), t_dec.item(), entry[i].item()))
    return out


def wavefront_rays(scene: Scene, cam: Camera, cfg, closest, any_hit) -> dict:
    """The rays the wavefront integrator hands its intersector in a
    render_sample of ``cfg`` (frame 0): primary rays in tile order; the
    bounce-1 rays of the live paths in that order and coherence-sorted as
    ops/integrator sorts them; the shadow rays of the primary hits toward
    light 0 (origin, direction, t_limit)."""
    dev = cam.position.device
    pid = _swizzled_ids(cfg, dev)
    seeds = rng.pixel_seeds(pid, 0)
    o, d = generate_rays(cam, cfg, pid, seeds)
    o = o.contiguous()
    R = o.shape[0]
    with torch.no_grad():
        step = integrator.make_bounce_core(scene, cfg, closest, any_hit)
        o1, d1, _, _, alive, _ = step((o, d, torch.ones_like(o), torch.zeros_like(o),
                                       torch.ones((R,), dtype=torch.bool, device=dev),
                                       seeds), 0)
        o1, d1 = o1[alive].contiguous(), d1[alive].contiguous()
        g = scene.geometry
        pts = torch.cat([g.v0, g.v1, g.v2])
        keys = integrator._ray_sort_keys(o1, d1, pts.amin(0), pts.amax(0))
        perm = torch.sort(keys, stable=True).indices
        h = closest(o, d)
        at = hit_attributes(o, d, h, build_shading_table(g, scene.materials))
        pos = at.pos[h.hit]
        to_l = scene.lights.position[0] - pos
        dist = torch.linalg.norm(to_l, dim=1)
        l_unit = (to_l / dist[:, None]).contiguous()
        shadow = ((pos + l_unit * cfg.ray_epsilon).contiguous(), l_unit,
                  (dist - 2.0 * cfg.ray_epsilon).contiguous())
    return {"primary": (o, d.contiguous()), "bounce1": (o1, d1),
            "bounce1_sorted": (o1[perm].contiguous(), d1[perm].contiguous()),
            "shadow": shadow}


# The fused shading (ops/cuda/shade.py, csrc/shade.cu) is held bitwise to
# hit_attributes + shade_hit on the same closest hit (card tests, smoke
# phase 19). Each case: (scene, RenderConfig fields, the bounce shaded,
# whether its carry is coherence-sorted and parked as the sorted wavefront
# does it). The bunny and sponza run K6 (rows from the intersector),
# Cornell K5 (``pallas``) or the LBVH walk (``bvh``), without rows.
SHADE_CASES = {
    "bunny 512x512 bounce 0": ("bunny", dict(width=512, height=512, bounces=2), 0, False),
    "bunny 512x512 bounce 1 sorted": ("bunny", dict(width=512, height=512, bounces=2), 1, True),
    "sponza 384x216 bounce 0": ("sponza", dict(width=384, height=216, bounces=1), 0, False),
    "cornell pallas": ("cornell", dict(width=256, height=144, backend="pallas"), 1, False),
    "cornell bvh": ("cornell", dict(width=256, height=144, backend="bvh"), 1, False),
    "ggx": ("cornell", dict(width=256, height=144, backend="pallas", specular_model="ggx"), 1,
            False),
    "soft edges": ("cornell", dict(width=256, height=144, backend="pallas",
                                   soft_edge_sigma=0.05), 1, False),
    "direct specular": ("cornell", dict(width=256, height=144, backend="pallas",
                                        direct_specular=True), 1, False),
    "backface cull": ("cornell", dict(width=256, height=144, backend="pallas",
                                      backface_cull=True), 1, False),
    "30 lights of three types": ("lights", dict(width=256, height=144, backend="pallas"), 1,
                                 False),
}
SHADE_OUTPUTS = ("o", "d", "beta", "radiance", "alive")


def _plain_bounce(scene: Scene, cfg, closest, carry, bounce: int):
    """One bounce of the wavefront in PyTorch: the closest hit, then
    hit_attributes and shade_hit."""
    o, d, beta, radiance, alive, seeds = carry
    hit = closest(o, d)
    at = hit_attributes(o, d, hit, build_shading_table(scene.geometry, scene.materials),
                        backface_cull=cfg.backface_cull, soft_sigma=cfg.soft_edge_sigma)
    return integrator.shade_hit(at, hit.hit, o, d, beta, radiance, alive, seeds, bounce,
                                scene.lights, cfg)[:5] + (seeds,)


def shade_case(name: str, device, small: bool = False):
    """(scene, cfg, closest, carry, bounce) of one of SHADE_CASES: the
    carry that ``bounce`` shades in a render_sample of ``cfg`` at frame 5
    (tile-ordered ids, the default camera; earlier bounces in PyTorch),
    sorted and parked where the case says, and the scene's closest-hit
    intersector (``render.make_intersectors`` on ``render.build_accel``).
    ``small``: the scene and image cut down for the CPU."""
    from ...config import RenderConfig
    from ...models.procedural import bunny_scene, sponza_scene
    from ...render import build_accel, make_intersectors
    kind, kw, bounce, sort = SHADE_CASES[name]
    if small:
        kw = dict(kw, width=32, height=16)
    cfg = RenderConfig(**kw)
    dev = torch.device(device)
    if kind == "bunny":
        scene = bunny_scene(target_tris=4000 if small else 70_000, device=dev)
    elif kind == "sponza":
        scene = sponza_scene(target_tris=24_000 if small else 260_000, device=dev)
    elif kind == "lights":
        scene = many_light_scene(dev)
    else:
        scene = cornell_scene(device=dev)
    closest, _ = make_intersectors(scene, cfg, accel=build_accel(scene, cfg))
    pid = _swizzled_ids(cfg, dev)
    seeds = rng.pixel_seeds(pid, 5)
    o, d = generate_rays(Camera.default(device=dev), cfg, pid, seeds)
    R = pid.shape[0]
    carry = (o, d, torch.ones((R, 3), device=dev), torch.zeros((R, 3), device=dev),
             torch.ones((R,), dtype=torch.bool, device=dev), seeds)
    with torch.no_grad():
        for b in range(bounce):
            carry = _plain_bounce(scene, cfg, closest, carry, b)
        if sort:
            g = scene.geometry
            pts = torch.cat([g.v0, g.v1, g.v2])
            lo, hi = pts.amin(0), pts.amax(0)
            park_d = torch.full((3,), 3.0 ** -0.5, device=dev)
            carry = integrator.sort_carry(carry + (torch.arange(R, device=dev),), lo, hi,
                                          integrator.park_point(lo, hi), park_d)[:6]
    return scene, cfg, closest, carry, bounce


def shade_pair(scene: Scene, cfg, closest, carry, bounce: int):
    """(fused, plain, hit): the next (o, d, beta, radiance, alive) from
    ``shade.shade_rows`` and from hit_attributes + shade_hit, on one
    closest hit of the carry's rays."""
    from . import shade
    from .megakernel import pack_lights
    o, d, beta, radiance, alive, seeds = carry
    with torch.no_grad():
        hit = closest(o, d)
        st = build_shading_table(scene.geometry, scene.materials)
        fused = shade.shade_rows(hit, st.table, o, d, beta, radiance, alive, seeds, bounce,
                                 pack_lights(scene.lights), cfg)
        at = hit_attributes(o, d, hit, st, backface_cull=cfg.backface_cull,
                            soft_sigma=cfg.soft_edge_sigma)
        plain = integrator.shade_hit(at, hit.hit, o, d, beta, radiance, alive, seeds, bounce,
                                     scene.lights, cfg)[:5]
    return fused, plain, hit


def check_shade(label: str, fused, plain) -> None:
    """The fused shading must equal hit_attributes + shade_hit: every
    output the same bits (floats compared as int32 words, so a NaN or a
    signed zero counts too). Raises naming each output that differs and
    on how many entries."""
    bad = []
    for n, k, p in zip(SHADE_OUTPUTS, fused, plain):
        if k.dtype != p.dtype or k.shape != p.shape:
            bad.append(f"{n} is {k.dtype} {tuple(k.shape)}, not {p.dtype} {tuple(p.shape)}")
            continue
        kb, pb = ((x.contiguous().view(torch.int32) if x.is_floating_point() else x)
                  for x in (k, p))
        if not torch.equal(kb, pb):
            bad.append(f"{n} on {int((kb != pb).sum().item())}")
    if bad:
        raise AssertionError(f"{label}: not bitwise hit_attributes + shade_hit: "
                             f"{', '.join(bad)}")


def adjoint_inputs(scene: Scene, cfg, closest, carry, gen: torch.Generator):
    """(rows, o, d, beta, alive, hit, seeds, lights, cot): the inputs of
    ``shade.shade_adjoint`` on one closest hit of the carry's rays, the
    winners' rows (``shading.winner_rows``), the packed lights and seeded
    standard-normal cotangents of the next (o, d, beta, radiance), [R, 3]
    each, on the carry's device."""
    from ..shading import winner_rows
    from .megakernel import pack_lights
    o, d, beta, _, alive, seeds = carry
    with torch.no_grad():
        hit = closest(o, d)
        rows = winner_rows(build_shading_table(scene.geometry, scene.materials).table, hit)
        cot = tuple(torch.randn(beta.shape, generator=gen, device=beta.device)
                    for _ in range(4))
    return rows, o, d, beta, alive, hit.hit, seeds, pack_lights(scene.lights), cot
