"""A model of the per-warp ray-bundle cull (``csrc/bundle.cuh``) in
PyTorch, for the tests and the smoke run.

The panel kernel (K5, ``csrc/panel.cu``) and the first-bounce kernel (K1,
``csrc/megakernel.cu``) run the exact Möller–Trumbore (M-T) test only on
the records that a conservative test keeps for the warp's rays as a
whole. ``cull_hits`` repeats that step by step, on rays in launch order
(32 consecutive rays to a warp):

* ``bundles``: each warp's bundle, the boxes of its live rays' origins and
  directions and the largest of their limits, as the kernel's warp reductions
  reduce them (min / max are exact, so the order of the reduction does not
  matter); a warp goes dense when a live ray has a non-finite origin or
  direction, or when its direction box straddles 0 on two or more axes;
* ``keep``: the conservative test of each record against each bundle, in
  float32 with the kernel's margins and operation order, so its keep / drop
  decisions are the kernel's bit for bit;
* the exact loop over the kept records in ascending index order, built
  from ``ops/intersect.ray_triangle_edges`` (the plain versions' M-T), with
  the per-ray counts of the M-T tests the kernel runs.

The margins, and why they keep every record the exact test accepts, are
explained in ``csrc/bundle.cuh``.
"""

from __future__ import annotations

import torch

from ..intersect import ray_triangle_edges

WARP = 32
# Margins (csrc/bundle.cuh, the same float32 values).
EPS = 2.0 ** -23
K_GRAZE = 512 * EPS      # M-T's residual, per (T * D * E1 * E2 / |det|)
K_DET = 128 * EPS        # rounding of det and of its interval, per (D * E1 * E2)
K_ABS = 64 * EPS         # rounding of the corners and of o - v0, per scale
K_LO = 1.0 - 2.0 ** -16  # outward factors on the slab's t bounds
K_HI = 1.0 + 2.0 ** -16
K_TA = 1e-30             # and an absolute term for tiny bounds
DET_EPS = 1e-10
_INF = float("inf")
_PLAIN_ELEMS = 1 << 22


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def bundles(o, d, limit, live):
    """Per warp of 32 consecutive rays: (olo, ohi,
    dlo, dhi [W, 3], thi [W], dense [W] bool, empty [W] bool). Rays past R
    and rays that are not live take no part; a live ray with a non-finite
    origin or direction makes its warp dense."""
    R = o.shape[0]
    W = -(-R // WARP)
    pad = W * WARP - R
    live = torch.nn.functional.pad(live, (0, pad))
    o = torch.nn.functional.pad(o, (0, 0, 0, pad))
    d = torch.nn.functional.pad(d, (0, 0, 0, pad))
    limit = torch.nn.functional.pad(limit, (0, pad))
    finite = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    part = (live & finite)[:, None]

    def red(x, fill, fn):
        return fn(torch.where(part, x, torch.full_like(x, fill)).reshape(W, WARP, 3), dim=1)

    olo, ohi = red(o, _INF, torch.amin), red(o, -_INF, torch.amax)
    dlo, dhi = red(d, _INF, torch.amin), red(d, -_INF, torch.amax)
    use = part[:, 0] & ~torch.isnan(limit)
    thi = torch.where(use, limit, torch.full_like(limit, -_INF)).reshape(W, WARP).amax(1)
    straddle = (~(dlo > 0) & ~(dhi < 0)).sum(1)
    bad = (live & ~finite).reshape(W, WARP).any(1)
    dense = bad | (straddle >= 2)
    empty = ~live.reshape(W, WARP).any(1)
    return olo, ohi, dlo, dhi, thi, dense, empty


def keep(tris, olo, ohi, dlo, dhi, thi):
    """[W, T] keep decisions of the records ``tris`` [T, 9] (v0, e1, e2)
    against the bundles, in csrc/bundle.cuh cull_keep's operation order."""
    f = lambda x: _f32(x, tris)
    v0, e1, e2 = tris[None, :, 0:3], tris[None, :, 3:6], tris[None, :, 6:9]
    c1, c2 = v0 + e1, v0 + e2
    blo = torch.fmin(torch.fmin(v0, c1), c2)
    bhi = torch.fmax(torch.fmax(v0, c1), c2)
    ex, ey, ez = e1.unbind(-1)
    fx, fy, fz = e2.unbind(-1)
    n = torch.stack([ey * fz - ez * fy, ez * fx - ex * fz, ex * fy - ey * fx], dim=-1)
    amax3 = lambda a: torch.fmax(torch.fmax(a[..., 0], a[..., 1]), a[..., 2])
    E1, E2 = amax3(torch.abs(e1)), amax3(torch.abs(e2))
    olo, ohi, dlo, dhi = (x[:, None, :] for x in (olo, ohi, dlo, dhi))
    thi = thi[:, None]
    D = amax3(torch.fmax(torch.abs(dlo), torch.abs(dhi)))
    SO = amax3(torch.fmax(torch.abs(olo), torch.abs(ohi)))
    p, q = n * dlo, n * dhi
    lo, hi = torch.fmin(p, q), torch.fmax(p, q)
    sl = (lo[..., 0] + lo[..., 1]) + lo[..., 2]
    sh = (hi[..., 0] + hi[..., 1]) + hi[..., 2]
    zero = torch.zeros_like(sl)
    g = torch.where(sl > 0, sl, torch.where(sh < 0, -sh, zero))
    e12d = (E1 * E2) * D
    det_lo = torch.fmax(g - f(K_DET) * e12d, f(DET_EPS))
    T = amax3(torch.fmax(ohi - blo, bhi - olo))
    S = torch.fmax(SO, amax3(torch.fmax(torch.abs(blo), torch.abs(bhi))))
    m = ((f(K_GRAZE) * T) * e12d) / det_lo + f(K_ABS) * S
    m = m[..., None]
    lo_, hi_ = blo - m, bhi + m
    pos, neg = dlo > 0, dhi < 0
    ilo, ihi = 1.0 / dlo, 1.0 / dhi
    # Entry and exit of each axis, by the warp's reciprocals; an axis whose
    # direction interval holds 0 is unbounded.
    enter = torch.where(pos, (lo_ - ohi) * ihi,
                        torch.where(neg, (hi_ - olo) * ilo, torch.full_like(lo_, -_INF)))
    exit_ = torch.where(pos, (hi_ - olo) * ilo,
                        torch.where(neg, (lo_ - ohi) * ihi, torch.full_like(lo_, _INF)))
    t_in = torch.fmax(torch.fmax(enter[..., 0], enter[..., 1]), enter[..., 2])
    t_out = torch.fmin(torch.fmin(exit_[..., 0], exit_[..., 1]), exit_[..., 2])
    t_in = torch.where(t_in >= 0, t_in * f(K_LO), t_in * f(K_HI)) - f(K_TA)
    t_out = torch.where(t_out >= 0, t_out * f(K_HI), t_out * f(K_LO)) + f(K_TA)
    drop = (t_out < 0) | (t_in > thi * f(K_HI)) | (t_out < t_in)
    return ~drop


def candidates(tris, o, d, limit, live):
    """[W, T] records each warp tests, and [W] whether
    it culled: every record for a dense warp, none for an empty one, else
    ``keep``."""
    olo, ohi, dlo, dhi, thi, dense, empty = bundles(o, d, limit, live)
    W, T = dense.shape[0], tris.shape[0]
    kept = torch.zeros((W, T), dtype=torch.bool, device=o.device)
    cull = ~dense & ~empty
    idx = cull.nonzero()[:, 0]
    step = max(1, _PLAIN_ELEMS // (4 * max(T, 1)))
    for s in range(0, idx.numel(), step):
        w = idx[s:s + step]
        kept[w] = keep(tris, olo[w], ohi[w], dlo[w], dhi[w], thi[w])
    kept[dense & ~empty] = True
    return kept, cull


def cull_hits(tris, o, d, limit, backface_cull: bool, any_hit: bool = False, live=None):
    """The kernels' hits with the cull: per ray (t [R], idx [R] int32, -1
    and ``limit`` on a miss, tests [R] int32, the M-T tests it ran). Closest
    mode: the smallest t with 0 < t < limit over the warp's kept records,
    lowest index among equal t. Any mode: the first kept record, in index
    order, with 0 < t < limit, and the tests up to it. ``live`` [R] (all
    rays by default) marks the rays that take part; the others test
    nothing and miss."""
    R, T = o.shape[0], tris.shape[0]
    dev = o.device
    if live is None:
        live = torch.ones((R,), dtype=torch.bool, device=dev)
    kept, _ = candidates(tris, o, d, limit, live)
    warp = torch.arange(R, device=dev) // WARP
    v0, e1, e2 = tris[None, :, 0:3], tris[None, :, 3:6], tris[None, :, 6:9]
    chunk = max(WARP, (_PLAIN_ELEMS // max(T, 1)) // WARP * WARP)
    ts, idxs, tests = [], [], []
    for s in range(0, R, chunk):
        sl = slice(s, s + chunk)
        k = kept[warp[sl]] & live[sl, None]
        t_all, _, _, _ = ray_triangle_edges(o[sl, None], d[sl, None], v0, e1, e2,
                                            backface_cull)
        ok = k & (t_all < limit[sl, None])
        if any_hit:
            has = ok.any(1)
            first = ok.to(torch.int32).argmax(1)
            pos = torch.cumsum(k.to(torch.int32), 1)
            n = torch.where(has, pos.gather(1, first[:, None])[:, 0], k.sum(1))
            t_best = torch.where(has, t_all.gather(1, first[:, None])[:, 0], limit[sl])
            idx = torch.where(has, first, torch.full_like(first, -1))
        else:
            tt = torch.where(ok, t_all, torch.full_like(t_all, _INF))
            best, arg = torch.min(tt, dim=1)
            has = torch.isfinite(best)
            t_best = torch.where(has, best, limit[sl])
            idx = torch.where(has, arg, torch.full_like(arg, -1))
            n = k.sum(1)
        ts.append(t_best)
        idxs.append(idx.to(torch.int32))
        tests.append(n.to(torch.int32))
    if not ts:
        z = o.new_zeros((0,))
        return z, z.to(torch.int32), z.to(torch.int32)
    return torch.cat(ts), torch.cat(idxs), torch.cat(tests)
