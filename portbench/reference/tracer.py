"""The plain reference: a brute-force closest-hit path tracer in plain
PyTorch, with autograd for its gradients.

It computes what the system under test is specified to compute (the
reference renderer's ``Render`` loop, kernel_bvh.cl:349-384, as the
project specifies it): jittered pinhole primary rays, a counter-based
hash RNG with a fixed draw-site layout, Möller-Trumbore closest hits
(ties to the lowest triangle index), the winner's attributes recomputed
on its row, a 50/50 diffuse / specular lobe pick, analytic point,
directional and spot lights, the throughput update, the final clamp, and
progressive accumulation with gamma. It imports nothing of the program
and takes only the benchmark's own arrays.

The closest-hit search is brute force: every triangle is tested against
every ray whose segment meets the box of the triangle's group (the
triangles in runs of consecutive index, each run with a padded box; a box
the segment misses holds no pair the test accepts). The four
Möller-Trumbore quantities of every tested (ray, triangle) pair (the
determinant and the numerators of u, v and t) come from one matrix
product of per-ray and per-triangle features, which selects a few
candidates per ray; the exact Möller-Trumbore test, in the order of
operations the specification gives, then decides among them, and a ray
whose candidates leave any doubt is tested exactly against every
triangle of the group. Matrix products run in full float32 (TF32 off).

``dtype`` is the precision of every float computed (float32; bfloat16 is
the control that the comparison has to reject).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional

import torch

# ----------------------------------------------------------------------------
# Settings: the render settings the values depend on, with the program's
# names and defaults.


@dataclasses.dataclass(frozen=True)
class Settings:
    width: int = 512
    height: int = 512
    bounces: int = 9
    spp: int = 1
    fov_deg: float = 45.0
    skybox_intensity: float = 1.0
    sky_color: tuple = (0.5, 0.5, 0.5)
    emission_scale: float = 50.0
    ray_epsilon: float = 1e-2
    t_max: float = 1.0e5
    backface_cull: bool = False
    shadow_rays: bool = False
    direct_specular: bool = False
    specular_prob: float = 0.5
    specular_model: str = "blinn"
    soft_edge_sigma: float = 0.0
    gamma: float = 2.2

    @staticmethod
    def from_render(render: dict) -> "Settings":
        """The keys of a configuration's ``render`` block that set values;
        the others (backend, dtype, memory and ordering options) do not."""
        names = {f.name for f in dataclasses.fields(Settings)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in render.items() if k in names}
        return Settings(**kw)


# ----------------------------------------------------------------------------
# RNG: lowbias32 in counter mode, u32 arithmetic in int64.

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
DRAWS_PER_BOUNCE = 8
RAYGEN_DRAWS = 2
SITE_LOBE, SITE_DIFF_PHI, SITE_DIFF_R2, SITE_SPEC_PHI, SITE_SPEC_COS = 0, 1, 2, 3, 4


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & _MASK
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    return x ^ (x >> 16)


def _premix(counter: int) -> int:
    c = int(counter) & _MASK
    c ^= c >> 16
    c = (c * 0x7FEB352D) & _MASK
    c ^= c >> 15
    c = (c * 0x846CA68B) & _MASK
    c ^= c >> 16
    return (c + _GOLDEN) & _MASK


def _hash(a: torch.Tensor, b: int) -> torch.Tensor:
    return _mix((a.to(torch.int64) & _MASK) ^ _premix(b))


def pixel_seeds(pixel_ids: torch.Tensor, frame: int) -> torch.Tensor:
    return _hash(pixel_ids, frame)


def uniform(seed: torch.Tensor, counter: int) -> torch.Tensor:
    """float32 in [0, 1): the top 24 bits of the hash."""
    return (_hash(seed, counter) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def bounce_site(bounce: int, site: int) -> int:
    return RAYGEN_DRAWS + bounce * DRAWS_PER_BOUNCE + site


# ----------------------------------------------------------------------------
# Vector helpers; max / min split the gradient at a tie.


def dot(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def vmax(x, c):
    return torch.maximum(x, x.new_full((), c))


def vmin(x, c):
    return torch.minimum(x, x.new_full((), c))


def vclip(x, lo, hi):
    return vmin(vmax(x, lo), hi)


def normalize(a, eps=1e-20):
    return a * (1.0 / torch.sqrt(vmax(dot(a, a), eps)))[..., None]


def _sqrt0(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


# ----------------------------------------------------------------------------
# Camera.


def tan_half_fov(s: Settings) -> float:
    import numpy as np
    return float(np.tan(np.float32(0.5 * s.fov_deg * math.pi / 180.0)))


def camera_rays(cam: Dict[str, torch.Tensor], s: Settings, pixel_ids, seeds, dtype):
    """Jittered pinhole rays of flat pixel ids (row 0 at the top)."""
    w, h = s.width, s.height
    angle = tan_half_fov(s)
    pid = pixel_ids.to(torch.int64)
    px = (pid % w).to(dtype)
    py = (pid // w).to(dtype)
    jx = uniform(seeds, 0).to(dtype)
    jy = uniform(seeds, 1).to(dtype)
    x = (2.0 * (px + jx) * (1.0 / float(w)) - 1.0) * angle * (float(w) / float(h))
    y = (1.0 - 2.0 * (py + jy) * (1.0 / float(h))) * angle
    right = cross(cam["front"], cam["up"])
    d = x[:, None] * right[None, :] + y[:, None] * cam["up"][None, :] + cam["front"][None, :]
    d = normalize(d)
    return cam["position"][None, :].expand_as(d), d


# ----------------------------------------------------------------------------
# Intersection.

_DET_EPS = 1e-10
# Slack of the candidate test, in barycentric units and in t.
_SLACK = 1e-3
_T_SLACK = 1e-4
_CANDIDATES = 8
_PAIRS_PER_BLOCK = 1 << 25
# Triangles of consecutive index per group; each group has a box.
_GROUP = 2048


def mt_exact(o, d, v0, e1, e2, cull: bool):
    """Möller-Trumbore on (v0, e1, e2) in the specified order; (t, u, v,
    valid), t = inf where not valid."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    valid = det > _DET_EPS if cull else torch.abs(det) > _DET_EPS
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(valid, t, torch.full_like(t, float("inf"))), u, v, valid


class Triangles(NamedTuple):
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor
    lo: torch.Tensor     # [G, 3] box of each group of _GROUP consecutive triangles
    hi: torch.Tensor


def triangles(geo: Dict[str, torch.Tensor], dtype) -> Triangles:
    v0 = geo["v0"].detach().to(dtype)
    v1, v2 = geo["v1"].detach().to(dtype), geo["v2"].detach().to(dtype)
    e1, e2 = v1 - v0, v2 - v0
    T = v0.shape[0]
    pts = torch.stack([v0, v1, v2], dim=1).float()                       # [T, 3, 3]
    G = max(1, -(-T // _GROUP))
    pad = torch.full((G * _GROUP - T, 3, 3), float("nan"), device=v0.device)
    pts = torch.cat([pts, pad]).view(G, _GROUP * 3, 3)
    lo = torch.nan_to_num(pts, nan=float("inf")).amin(1)
    hi = torch.nan_to_num(pts, nan=float("-inf")).amax(1)
    slack = 1e-4 * ((hi - lo).amax(1, keepdim=True) + lo.abs().amax(1, keepdim=True)
                    + hi.abs().amax(1, keepdim=True) + 1.0)
    return Triangles(v0, e1, e2, cross(e1, e2), lo - slack, hi + slack)


def _touches(o, d, limit, lo, hi) -> torch.Tensor:
    """Rays whose segment [0, limit) meets the box (slab test, float32)."""
    o, d, limit = o.float(), d.float(), limit.float()
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    near = torch.minimum(t1, t2).amax(1)
    far = torch.maximum(t1, t2).amin(1)
    return (far >= torch.clamp(near, min=0.0)) & (near <= limit)


def _exact_all(o, d, limit, v0, e1, e2, cull: bool):
    """Exact closest hit of a few rays against every triangle given."""
    T = v0.shape[0]
    best_t = torch.full((o.shape[0],), float("inf"), dtype=o.dtype, device=o.device)
    best_i = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    step = max(1, _PAIRS_PER_BLOCK // (8 * max(T, 1)))
    for a in range(0, o.shape[0], step):
        t, _, _, _ = mt_exact(o[a:a + step, None], d[a:a + step, None], v0[None],
                              e1[None], e2[None], cull)
        t = torch.where(t < limit[a:a + step, None], t, torch.full_like(t, float("inf")))
        bt, bi = torch.min(t, dim=1)
        best_t[a:a + step], best_i[a:a + step] = bt, bi
    return best_t, best_i


def _search(o, d, lim, v0, e1, e2, n, cull: bool, count_pairs: bool):
    """Closest hit of rays against one group of triangles: (exact t, index
    in the group, accepted pairs or None). The matrix product's four
    quantities pick up to _CANDIDATES candidates a ray; the exact test
    decides among them, and every triangle of the group where one beyond
    them could still win."""
    T = v0.shape[0]
    k = min(_CANDIDATES, T)
    inf = float("inf")
    c = o[0].detach()
    os_ = o - c
    feats = torch.cat([d, cross(os_, d), os_, torch.ones_like(d[:, :1])], dim=1)
    v0c = v0 - c
    z3, z1 = torch.zeros_like(n), torch.zeros_like(n[:, :1])
    w = torch.stack([
        torch.cat([-n, z3, z3, z1], dim=1),                         # det = -d.n
        torch.cat([cross(v0c, e2), e2, z3, z1], dim=1),             # u det
        torch.cat([-cross(v0c, e1), -e1, z3, z1], dim=1),           # v det
        torch.cat([z3, z3, n, -dot(v0c, n)[:, None]], dim=1),       # t det
    ])                                                              # [4, T, 10]
    g = (feats @ w.reshape(4 * T, 10).T).view(-1, 4, T)
    det, un, vn, tn = g.unbind(1)
    ok = det > _DET_EPS if cull else torch.abs(det) > _DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    u, v, t = un * inv, vn * inv, tn * inv
    del g, det, un, vn, tn, inv
    pairs = None
    if count_pairs:
        pairs = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
                 & (t < lim[:, None])).sum(1)
    near = (ok & (u >= -_SLACK) & (v >= -_SLACK) & (u + v <= 1 + _SLACK)
            & (t > -_T_SLACK) & (t < lim[:, None] * (1 + _SLACK)))
    tr = torch.where(near, t, torch.full_like(t, inf))
    del u, v, t, near, ok
    cand_t, cand = torch.topk(tr, k, dim=1, largest=False)          # ascending
    del tr
    te, _, _, _ = mt_exact(o[:, None], d[:, None], v0[cand], e1[cand], e2[cand], cull)
    te = torch.where(te < lim[:, None], te, torch.full_like(te, inf))
    bt = te.min(dim=1).values
    bi = torch.where(te == bt[:, None], cand, torch.full_like(cand, T)).min(dim=1).values
    doubt = torch.isfinite(cand_t[:, -1]) & (
        ~torch.isfinite(bt) | (cand_t[:, -1] <= bt * (1 + _SLACK) + _T_SLACK))
    if bool(doubt.any()):
        rows = doubt.nonzero().squeeze(1)
        xt, xi = _exact_all(o[rows], d[rows], lim[rows], v0, e1, e2, cull)
        bt = bt.index_put((rows,), xt)
        bi = bi.index_put((rows,), xi)
    return bt, bi, pairs


def closest_hit(o, d, limit, tri: Triangles, cull: bool, count_pairs: bool = False):
    """Closest hit below ``limit`` (per ray) over every triangle: (t,
    index, hit, accepted pairs per ray or None). t is the exact
    Möller-Trumbore t of the winner (inf on a miss); ties go to the lowest
    index. A group of triangles is searched for the rays whose segment
    meets the group's box (padded, so that no pair the exact test accepts
    is skipped)."""
    R, T = o.shape[0], tri.v0.shape[0]
    dev, dt = o.device, o.dtype
    best_t = torch.full((R,), float("inf"), dtype=dt, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int64, device=dev)
    pairs = torch.zeros((R,), dtype=torch.int64, device=dev) if count_pairs else None
    tf32, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, False
    try:
        _groups(o, d, limit, tri, cull, best_t, best_i, pairs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    hit = torch.isfinite(best_t)
    return best_t, torch.where(hit, best_i, torch.zeros_like(best_i)), hit, pairs


def _groups(o, d, limit, tri: Triangles, cull: bool, best_t, best_i, pairs) -> None:
    R, T = o.shape[0], tri.v0.shape[0]
    count_pairs = pairs is not None
    for g in range(tri.lo.shape[0] if R and T else 0):
        a, b = g * _GROUP, min(T, (g + 1) * _GROUP)
        rows = _touches(o, d, limit, tri.lo[g], tri.hi[g]).nonzero().squeeze(1)
        step = max(1, _PAIRS_PER_BLOCK // (b - a))
        for s0 in range(0, rows.shape[0], step):
            r = rows[s0:s0 + step]
            t, i, p = _search(o[r], d[r], limit[r], tri.v0[a:b], tri.e1[a:b], tri.e2[a:b],
                              tri.n[a:b], cull, count_pairs)
            i = i + a
            cur_t, cur_i = best_t[r], best_i[r]
            better = (t < cur_t) | ((t == cur_t) & (i < cur_i) & torch.isfinite(t))
            best_t[r] = torch.where(better, t, cur_t)
            best_i[r] = torch.where(better, i, cur_i)
            if count_pairs:
                pairs[r] += p


# ----------------------------------------------------------------------------
# Shading.

_COLS = {"v0": 0, "v1": 3, "v2": 6, "n0": 9, "n1": 12, "n2": 15, "kd": 18, "ks": 21,
         "ke": 24, "ns": 27}


def shading_table(scene: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """[T, 28]: corners, corner normals, the material's Kd, Ks, Ke, Ns."""
    m = scene["geometry.mat_idx"].to(torch.int64)
    g = lambda k: scene[f"geometry.{k}"].to(dtype)
    # index_select: its gradient is a scatter-add (an indexing gradient
    # sorts, which is slow where many rows share an index).
    mat = lambda k: scene[f"materials.{k}"].to(dtype).index_select(0, m)
    return torch.cat([g("v0"), g("v1"), g("v2"), g("n0"), g("n1"), g("n2"),
                      mat("diffuse"), mat("specular"), mat("emission"),
                      mat("roughness")[:, None]], dim=1)


class Hit(NamedTuple):
    pos: torch.Tensor
    normal: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    ke: torch.Tensor
    ns: torch.Tensor
    coverage: torch.Tensor


def winner(o, d, hit, rows, s: Settings) -> Hit:
    c = lambda name: rows[:, _COLS[name]:_COLS[name] + 3]
    v0 = c("v0")
    t, u, v, _ = mt_exact(o, d, v0, c("v1") - v0, c("v2") - v0, s.backface_cull)
    zero = torch.zeros_like(t)
    t, u, v = (torch.where(hit, x, zero) for x in (t, u, v))
    if s.soft_edge_sigma > 0.0:
        margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        cov = torch.sigmoid(margin * (1.0 / s.soft_edge_sigma))
    else:
        cov = torch.ones_like(t)
    uc, vc = u[:, None], v[:, None]
    pos = o + d * t[:, None]
    normal = normalize(uc * c("n1") + vc * c("n2") + (1.0 - uc - vc) * c("n0"))
    return Hit(pos, normal, c("kd"), c("ks"), c("ke"), rows[:, _COLS["ns"]], cov)


# ----------------------------------------------------------------------------
# BRDF.

_TWO_PI = 2.0 * math.pi
_INV_PI = 1.0 / math.pi


class Sample(NamedTuple):
    wi: torch.Tensor
    f: torch.Tensor
    pdf: torch.Tensor
    valid: torch.Tensor


def _onb(n):
    use_y = (torch.abs(n[..., 0]) > 1e-3)[..., None]
    e = torch.eye(3, dtype=n.dtype, device=n.device)
    t = normalize(cross(torch.where(use_y, e[1], e[0]), n))
    return cross(n, t), t


def _dir(s, t, n, cp, sp, ct):
    return normalize(s * cp[..., None] + t * sp[..., None] + n * ct[..., None])


def _diffuse(normal, kd, u1, u2) -> Sample:
    cp = torch.cos(_TWO_PI * u1) * torch.sqrt(u2)
    sp = torch.sin(_TWO_PI * u1) * torch.sqrt(u2)
    ct = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    s, t = _onb(normal)
    wi = _dir(s, t, normal, cp, sp, ct)
    pdf = dot(wi, normal) * _INV_PI
    return Sample(wi, kd * _INV_PI, pdf, pdf > 0.0)


def _smith(n, v, l, rough):
    def g1(x):
        r = rough + 1.0
        k = (r * r) / 8.0
        return x / (x * (1.0 - k) + k)
    return g1(vmax(dot(n, v), 0.0)) * g1(vmax(dot(n, l), 0.0))


def _tail(wo, normal, ks, wh, d_ndf, pdf_h, rough) -> Sample:
    wi = -wo + 2.0 * dot(wo, wh)[..., None] * wh
    cos_i, cos_o = dot(wi, normal), dot(wo, normal)
    same = (cos_i * cos_o) >= 1e-6
    wo_h = vmax(dot(wo, wh), 0.0)
    pdf = pdf_h / vmax(4.0 * wo_h, 1e-8)
    g = _smith(normal, wo, wi, rough)
    x = vmax(1.0 - wo_h, 0.0)
    x2 = x * x
    fr = 0.04 + (1.0 - 0.04) * (x2 * x2 * x)
    denom = 4.0 * vmax(cos_i, 0.0) * vmax(cos_o, 0.0) + 1e-3
    f = ks * (d_ndf * g * fr / denom)[..., None]
    valid = same & (pdf > 0.0) & (wo_h > 0.0)
    return Sample(wi, torch.where(valid[..., None], f, torch.zeros_like(f)), pdf, valid)


def _blinn(wo, normal, ks, ns, u1, u2) -> Sample:
    alpha = vmax(ns, 0.0)
    log_u2 = torch.log(torch.clamp(u2, 1e-12, 1.0))
    cos_h = torch.exp(log_u2 / (alpha + 1.0))
    sin_h = _sqrt0(vmax(1.0 - cos_h * cos_h, 0.0))
    s, t = _onb(normal)
    wh = _dir(s, t, normal, torch.cos(_TWO_PI * u1) * sin_h,
              torch.sin(_TWO_PI * u1) * sin_h, cos_h)
    cosn = torch.exp(log_u2 * (alpha / (alpha + 1.0)))
    return _tail(wo, normal, ks, wh, (alpha + 2.0) * (0.5 * _INV_PI) * cosn,
                 (alpha + 1.0) * (0.5 * _INV_PI) * cosn, torch.sqrt(2.0 / (alpha + 2.0)))


def _ggx(wo, normal, ks, ns, u1, u2) -> Sample:
    r = torch.sqrt(2.0 / (vmax(ns, 0.0) + 2.0))
    a = r * r
    a2 = vmax(a * a, 1e-12)
    u2c = torch.clamp(u2, 0.0, 1.0 - 1e-7)
    cos_h2 = (1.0 - u2c) / (1.0 + (a2 - 1.0) * u2c)
    cos_h = torch.sqrt(vclip(cos_h2, 0.0, 1.0))
    sin_h = _sqrt0(vmax(1.0 - cos_h2, 0.0))
    s, t = _onb(normal)
    wh = _dir(s, t, normal, torch.cos(_TWO_PI * u1) * sin_h,
              torch.sin(_TWO_PI * u1) * sin_h, cos_h)
    dd = cos_h2 * (a2 - 1.0) + 1.0
    d_ndf = a2 * _INV_PI / vmax(dd * dd, 1e-12)
    return _tail(wo, normal, ks, wh, d_ndf, d_ndf * cos_h, r)


def sample_brdf(wo, at: Hit, seeds, bounce: int, s: Settings, dtype):
    """(sample, specular pick) of the 50/50 lobe roulette."""
    draw = lambda site: uniform(seeds, bounce_site(bounce, site)).to(dtype)
    pick = draw(SITE_LOBE) > (1.0 - s.specular_prob)
    diff = _diffuse(at.normal, at.kd, draw(SITE_DIFF_PHI), draw(SITE_DIFF_R2))
    lobe = _ggx if s.specular_model == "ggx" else _blinn
    spec = lobe(wo, at.normal, at.ks, at.ns, draw(SITE_SPEC_PHI), draw(SITE_SPEC_COS))
    sel = pick[..., None]
    return Sample(torch.where(sel, spec.wi, diff.wi), torch.where(sel, spec.f, diff.f),
                  torch.where(pick, spec.pdf, diff.pdf),
                  torch.where(pick, spec.valid, diff.valid)), pick


# ----------------------------------------------------------------------------
# Lights.


def direct_light(lights: Dict[str, torch.Tensor], types: List[int], pos, normal, wo, ns,
                 s: Settings, occluded, dtype):
    """(diffuse weight, specular weight, per-light visibility masks)."""
    R = pos.shape[0]
    zero = torch.zeros((R,), dtype=pos.dtype, device=pos.device)
    diff, spec_total, seen = zero, zero, []
    for li, ltype in enumerate(types):
        lpos = lights["lights.position"][li].to(dtype)
        ldir = normalize(lights["lights.direction"][li].to(dtype))
        to_light = lpos[None, :] - pos
        dist = torch.sqrt(vmax(dot(to_light, to_light), 1e-12))
        l_point = to_light / dist[..., None]
        is_dir = ltype <= 0
        l_unit = (-ldir[None, :]).expand_as(l_point) if is_dir else l_point
        ndotl = vmax(dot(normal, l_unit), 0.0)
        if is_dir:
            attn = torch.ones_like(dist)
        else:
            attn = 1.0 / vmax(lights["lights.attenuation"][li].to(dtype) * dist * dist, 1e-6)
        if ltype >= 2:
            cos_cut = lights["lights.cos_cutoff"][li].to(dtype)
            cos_angle = dot(-l_unit, ldir[None, :])
            attn = attn * vclip((cos_angle - cos_cut) / vmax(1.0 - cos_cut, 1e-6), 0.0, 1.0)
        intensity = lights["lights.intensity"][li].to(dtype)
        weight = attn * intensity * ndotl
        blocked = None
        if s.shadow_rays:
            limit = (torch.full_like(dist, float("inf")) if is_dir
                     else dist - 2.0 * s.ray_epsilon)
            blocked = occluded(pos + l_unit * s.ray_epsilon, l_unit, limit)
            weight = torch.where(blocked, zero, weight)
        seen.append((("directional" if is_dir else "point" if ltype == 1 else "spot"),
                     None if blocked is None else ~blocked))
        diff = diff + weight
        if s.direct_specular:
            h = normalize(l_unit + wo)
            ndoth = vmax(dot(normal, h), 0.0)
            sp = torch.pow(vmax(ndoth, 1e-6), vmax(ns, 1.0))
            sp = torch.where(ndotl > 0.0, sp, zero)
            sw = attn * intensity * sp
            if blocked is not None:
                sw = torch.where(blocked, zero, sw)
            spec_total = spec_total + sw
    return diff, spec_total, seen


# ----------------------------------------------------------------------------
# The path tracer.


@dataclasses.dataclass
class Counts:
    """Ray classes of a trace, summed over the rays traced: per bounce the
    rays, those not alive, those alive with a winner (and of those the
    specular picks), those whose path goes on (and their specular picks),
    per light the rays that go on and see it; and per bounce the
    (ray, triangle) pairs the exact test accepts below the ray's limit."""

    rays: List[int]
    dead: List[int]
    live: List[int]
    live_spec: List[int]
    on: List[int]
    on_spec: List[int]
    seen: List[Dict[str, int]]
    accepted_pairs: List[int]

    @staticmethod
    def zeros(bounces: int) -> "Counts":
        z = lambda: [0] * bounces
        return Counts(z(), z(), z(), z(), z(), z(), [dict() for _ in range(bounces)], z())


def trace(scene: Dict[str, torch.Tensor], cam: Dict[str, torch.Tensor], s: Settings,
          pixel_ids: torch.Tensor, frame: int, dtype=torch.float32,
          counts: Optional[Counts] = None) -> torch.Tensor:
    """Linear radiance [R, 3] of the pixels ``pixel_ids`` at ``frame``:
    the mean of ``s.spp`` samples, each clamped at 0. Differentiable in
    every float leaf of ``scene`` and ``cam``. ``counts`` collects the ray
    classes (integers; no gradient)."""
    dev = pixel_ids.device
    R = pixel_ids.shape[0]
    tri = triangles({k[9:]: v for k, v in scene.items() if k.startswith("geometry.")}, dtype)
    table = shading_table(scene, dtype)
    types = [int(x) for x in scene["lights.light_type"].tolist()]
    sky = torch.tensor(s.sky_color, dtype=torch.float32, device=dev).to(dtype) * s.skybox_intensity
    cam = {k: v.to(dtype) for k, v in cam.items()}
    tmax = torch.full((R,), s.t_max, dtype=dtype, device=dev)

    def occluded(o, d, limit):
        t, _, _, _ = closest_hit(o.detach(), d.detach(), limit.detach(), tri, s.backface_cull)
        return t < limit

    total = torch.zeros((R, 3), dtype=dtype, device=dev)
    for sp in range(s.spp):
        fr = (int(frame) * s.spp + sp) & _MASK
        seeds = pixel_seeds(pixel_ids, fr)
        o, d = camera_rays(cam, s, pixel_ids, seeds, dtype)
        beta = torch.ones((R, 3), dtype=dtype, device=dev)
        rad = torch.zeros((R, 3), dtype=dtype, device=dev)
        alive = torch.ones((R,), dtype=torch.bool, device=dev)
        for b in range(s.bounces):
            t, idx, hit, pairs = closest_hit(o.detach(), d.detach(), tmax, tri, s.backface_cull,
                                             count_pairs=counts is not None)
            at = winner(o, d, hit, table.index_select(0, idx), s)
            cov = at.coverage[:, None]
            zero3 = torch.zeros_like(beta)
            miss = alive & ~hit
            rad = rad + torch.where(miss[:, None], beta * sky[None, :], zero3)
            live = alive & hit
            if s.soft_edge_sigma > 0.0:
                rad = rad + torch.where(live[:, None], (1.0 - cov) * beta * sky[None, :], zero3)
            rad = rad + torch.where(live[:, None], cov * beta * at.ke * s.emission_scale, zero3)
            wo = -d
            smp, pick = sample_brdf(wo, at, seeds, b, s, dtype)
            cos_i = dot(smp.wi, at.normal)
            pdf_safe = torch.where(smp.pdf > 0.0, smp.pdf, torch.ones_like(smp.pdf))
            mul = smp.f * (cos_i / pdf_safe)[:, None]
            lo = live & smp.valid & (smp.pdf > 0.0) & torch.isfinite(mul).all(dim=-1)
            beta = torch.where(lo[:, None], beta * mul, beta)
            dw, sw, seen = direct_light(scene, types, at.pos, at.normal, wo, at.ns, s,
                                        occluded, dtype)
            direct = dw[:, None] * at.kd
            if s.direct_specular:
                direct = direct + sw[:, None] * at.ks
            rad = rad + torch.where(lo[:, None], cov * direct * beta, zero3)
            if counts is not None:
                n = lambda m: int(m.sum().item())
                counts.rays[b] += R
                counts.dead[b] += n(~alive)
                counts.live[b] += n(live)
                counts.live_spec[b] += n(live & pick)
                counts.on[b] += n(lo)
                counts.on_spec[b] += n(lo & pick)
                for kind, vis in seen:
                    m = lo if vis is None else lo & vis
                    counts.seen[b][kind] = counts.seen[b].get(kind, 0) + n(m)
                counts.accepted_pairs[b] += int(torch.where(alive, pairs, 0).sum().item())
            o = torch.where(lo[:, None], at.pos + smp.wi * s.ray_epsilon, o)
            d = torch.where(lo[:, None], smp.wi, d)
            alive = lo
        total = total + vmax(rad, 0.0)
    return total / s.spp


# Rays a block of whole rows holds at most (a 1080p image is one block).
BLOCK_RAYS = 1 << 21


def block_ids(s: Settings, device, rows_per_block: int):
    """Flat pixel ids in blocks of whole image rows, scanline order."""
    for y0 in range(0, s.height, rows_per_block):
        y1 = min(s.height, y0 + rows_per_block)
        yield torch.arange(y0 * s.width, y1 * s.width, dtype=torch.int64, device=device)


def radiance(scene, cam, s: Settings, frame: int, dtype=torch.float32,
             counts: Optional[Counts] = None) -> torch.Tensor:
    """Linear radiance [H, W, 3] of one sample at ``frame``, computed in
    blocks of rows, without a gradient."""
    dev = scene["geometry.v0"].device
    rows = max(1, BLOCK_RAYS // s.width)
    with torch.no_grad():
        out = [trace(scene, cam, s, ids, frame, dtype, counts)
               for ids in block_ids(s, dev, rows)]
    return torch.cat(out).reshape(s.height, s.width, 3)


def image(scene, cam, s: Settings, frames: int, dtype=torch.float32,
          counts: Optional[Counts] = None) -> torch.Tensor:
    """The gamma-encoded mean of ``frames`` samples (frames 0 .. n-1)."""
    acc = None
    for f in range(frames):
        r = radiance(scene, cam, s, f, dtype, counts)
        acc = r if acc is None else acc + r
    lin = acc / max(frames, 1)
    return torch.pow(vmax(lin, 0.0), 1.0 / s.gamma)


def loss_and_grads(scene, cam, s: Settings, target: torch.Tensor, dtype=torch.float32,
                   counts: Optional[Counts] = None, loss_rows: Optional[int] = None):
    """(loss, {leaf: gradient}) of mean((radiance(frame 0) - target)^2)
    over every float leaf of the scene (``geometry.*``, ``materials.*``,
    ``lights.*``) and the camera (``camera.*``). The loss is a sum over
    pixels, so it is taken in blocks of rows, each block's backward run
    before the next block's forward. ``loss_rows`` takes the mean over the
    image's first rows only (a planted fault: half the batch left out)."""
    leaves = {k: v.detach().to(dtype).requires_grad_() for k, v in scene.items()
              if v.is_floating_point()}
    cam_leaves = {k: v.detach().to(dtype).requires_grad_() for k, v in cam.items()}
    sc = {**scene, **leaves}
    grads = {k: torch.zeros_like(v) for k, v in list(leaves.items()) + [
        (f"camera.{k}", v) for k, v in cam_leaves.items()]}
    inputs = list(leaves.values()) + list(cam_leaves.values())
    names = list(leaves) + [f"camera.{k}" for k in cam_leaves]
    dev = target.device
    height = s.height if loss_rows is None else loss_rows
    N = s.width * height * 3
    rows = max(1, BLOCK_RAYS // s.width)
    tflat = target.to(dtype).reshape(-1, 3)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    for ids in block_ids(dataclasses.replace(s, height=height), dev, rows):
        with torch.enable_grad():
            r = trace(sc, cam_leaves, s, ids, 0, dtype, counts)
            part = ((r - tflat[ids]) ** 2).sum() / N
            gs = torch.autograd.grad(part, inputs, allow_unused=True)
        loss += part.detach().to(torch.float64)
        for name, g in zip(names, gs):
            if g is not None:
                grads[name] += g
    return loss, grads
