"""The gate that holds a kernel's outputs against its plain version's on
the same inputs (chip_smoke.py and tests/test_torch_cuda.py).

Forward: seeds bit-exact; winner indices equal on >= 99.99% of rays;
every float output with mean |diff| <= 1e-4 and frac(|diff| > 1e-3) <=
1e-4 (the forward gate of benchmarks/VERIFY_TPU.md); the intersection
kernels' any-hit occlusion exactly equal. Knife-edge decisions
(a ray on a shared edge, a sample on a validity threshold) may flip under
different float rounding; those flips are the gate's only allowed error.

Gradients: per-ray outputs (d_o, d_d, d_beta) take the forward gate
scaled by s = max |plain|: mean |diff| <= 1e-4 s and frac(|diff| >
1e-3 s) <= 1e-4. Sums over rays (d_table, d_lights, d_camv) and scene or
camera gradients per leaf: max |diff| <= 2e-3 max |reference| (the
gradient gate of benchmarks/VERIFY_TPU.md). Against central finite
differences: relative error <= 5e-2. Every value must be finite.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.cornell import cornell_scene
from ...models.scene import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
                             Camera, Geometry, Lights, Scene)

MEAN_TOL, ERR_TOL, FRAC_TOL, WINNER_AGREE = 1e-4, 1e-3, 1e-4, 0.9999
GRAD_TOL, FD_TOL = 2e-3, 5e-2
BOUNCE_FLOATS = ("o", "d", "beta", "alive", "radiance")
# Outputs of the backward wrappers, and which are per ray.
BOUNCE0_GRADS = ("d_table", "d_lights", "d_camv")
BOUNCE_GRADS = ("d_o", "d_d", "d_beta", "d_table", "d_lights")
PER_RAY = ("d_o", "d_d", "d_beta")


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
