"""Known-value residual rows of one bounce: the plain versions of the
``bwd_residuals`` mode (the JAX package's ``ops/pallas/megakernel.py``:
``_lin`` :209, ``_Resid`` :213, the ``_k_*`` helpers :245-320 and
``_num_resid_rows`` :1024).

With ``cfg.bwd_residuals`` the forward bounce also stores, per ray, the
value of every transcendental of its shading (sqrt, reciprocal, exp, log,
pow, sigmoid, the inverse length of each normalize) and of every value
that depends on the RNG draws alone. The backward bounce then replays the
shading with those values known: at each site it substitutes

    lin(x, y0, dy0) = y0 + dy0 * (x - x.detach())

whose value is the recorded y0 and whose derivative w.r.t. x is the
closed-form dy0 built from y0, so the replay draws no random numbers and
evaluates no transcendental.

A site is named, and ``layout`` gives each name its row, in the JAX
package's emission order (so the rows are JAX's rows one for one); a name
written twice (the ONB, which both lobes build) holds one value. Each
helper takes ``kn``: None computes the plain expression exactly as before
(the default path's arithmetic is this one), a ``Known`` that is writing
records the value, one that is reading substitutes it.

The rows of a bounce (``Resid``) are kept only for the rays that are alive
and have a winner, the rays whose shading the backward replays: column r
of ``rows`` [n, R] holds the rows of the ray of rank r among them
(``rank`` [R], -1 for the other rays; ``count`` [1] how many, the ranks
0 .. count - 1). ``Known.packed`` ranks the plain version's rays in ray
order. The bounce kernel (csrc/megakernel.cu, K2 with rows) ranks each
tile's rays in ray order and gives its tiles their columns in the order
they finish, so its ranks may be another numbering of the same rays; a
ray's rows, read through its rank, are the same either way.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from .linalg import dot, normalize as _normalize, vmax


def layout(cfg, num_lights: int) -> Dict[str, int]:
    """Row of each site, in the JAX package's emission order
    (``_shade_bounce``): the winner point (inverse determinant, normal),
    the soft-edge coverage, the lobe pick, the ONB, the diffuse lobe, the
    specular lobe (Blinn 8 rows, GGX 7), then per light its distance and,
    with direct specular, its half vector and the Blinn-Phong power."""
    names = ["inv_det", "n_norm"]
    if cfg.soft_edge_sigma > 0.0:
        names.append("cov")
    names += ["pick", "onb", "d_cp", "d_sp", "d_ct", "d_wi"]
    if cfg.specular_model == "ggx":
        names += ["rough", "u2c", "cos_h", "sin_h", "s_cp", "s_sp", "wh"]
    else:
        names += ["log_u2", "cos_h", "sin_h", "s_cp", "s_sp", "wh", "cosn", "rough"]
    for li in range(num_lights):
        names.append(f"dist{li}")
        if cfg.direct_specular:
            names += [f"h{li}", f"pow{li}", f"logb{li}"]
    return {n: i for i, n in enumerate(names)}


def num_rows(cfg, num_lights: int) -> int:
    """Rows per ray (``_num_resid_rows``): 17 on Cornell with the default
    Blinn lobe and one light."""
    return len(layout(cfg, num_lights))


class Resid(NamedTuple):
    """The known-value rows of one bounce, by rank (module docstring):
    ``rows`` [n, R] float32 (columns from ``count`` on undefined), ``rank``
    [R] int32, ``count`` [1] int32, all on the bounce's device."""

    rows: torch.Tensor
    rank: torch.Tensor
    count: torch.Tensor


# What a reader hands the rays without rows (not alive, or no winner): the
# replay masks their shading out, and 1.0 keeps every value it computes for
# them finite (a distance, an inverse length, a pdf), so their gradients
# stay exact zeros.
_NO_ROW = 1.0


class Known:
    """The rows of one bounce: writing (``resid`` None) collects each
    site's value for every ray; reading (a ``Resid``) hands them back by
    name, each ray's from its rank's column."""

    def __init__(self, cfg, num_lights: int, resid: Optional[Resid] = None):
        self.index = layout(cfg, num_lights)
        self.values: Dict[str, torch.Tensor] = {}
        self._resid = resid
        if resid is not None:
            self._ranked = resid.rank >= 0
            self._col = torch.where(self._ranked, resid.rank,
                                    torch.zeros_like(resid.rank)).to(torch.int64)

    @property
    def writing(self) -> bool:
        return self._resid is None

    def emit(self, name: str, v: torch.Tensor) -> torch.Tensor:
        self.values[name] = v.detach()
        return v

    def take(self, name: str) -> torch.Tensor:
        v = self._resid.rows[self.index[name]][self._col]
        return torch.where(self._ranked, v, torch.full_like(v, _NO_ROW))

    def stacked(self) -> torch.Tensor:
        """[n, R] float32: the written rows of every ray, in layout order."""
        missing = set(self.index) - set(self.values)
        if missing:
            raise AssertionError(f"residual rows not written: {sorted(missing)}")
        return torch.stack([self.values[n].to(torch.float32) for n in self.index])

    def packed(self, live: torch.Tensor) -> Resid:
        """The written rows of the rays ``live`` [R] bool, each in the
        column of its rank among them in ray order; the columns from
        ``count`` on are zero. No value goes through the host."""
        rows = self.stacked()
        R = live.shape[0]
        rank = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
        rank = torch.where(live, rank, torch.full_like(rank, -1))
        # Rays without a rank go to a spare last column, which is dropped.
        col = torch.where(live, rank, torch.full_like(rank, R)).to(torch.int64)
        out = rows.new_zeros((rows.shape[0], R + 1)).index_copy_(1, col, rows)
        count = live.sum(dtype=torch.int32).reshape(1)
        return Resid(out[:, :R].contiguous(), rank, count)


def lin(x: torch.Tensor, y0: torch.Tensor, dy0: torch.Tensor) -> torch.Tensor:
    """The known-value node: value y0, derivative dy0 w.r.t. x."""
    return y0 + dy0 * (x - x.detach())


def recip(kn, name: str, x):
    """1 / x (x bounded away from 0 by the caller)."""
    if kn is None:
        return 1.0 / x
    if kn.writing:
        return kn.emit(name, 1.0 / x)
    y0 = kn.take(name)
    return lin(x, y0, -y0 * y0)


def sqrt(kn, name: str, x):
    if kn is None:
        return torch.sqrt(x)
    if kn.writing:
        return kn.emit(name, torch.sqrt(x))
    y0 = kn.take(name)
    return lin(x, y0, 0.5 / vmax(y0, 1e-20))


def sqrt0(kn, name: str, x):
    """sqrt(x) for x >= 0 with zero gradient at 0 (ops/brdf._sqrt0)."""
    from .brdf import _sqrt0
    if kn is None:
        return _sqrt0(x)
    if kn.writing:
        return kn.emit(name, _sqrt0(x))
    y0 = kn.take(name)
    pos = y0 > 0.0
    return lin(x, y0, torch.where(pos, 0.5 / torch.where(pos, y0, torch.ones_like(y0)),
                                  torch.zeros_like(y0)))


def exp(kn, name: str, x):
    if kn is None:
        return torch.exp(x)
    if kn.writing:
        return kn.emit(name, torch.exp(x))
    y0 = kn.take(name)
    return lin(x, y0, y0)


def sigmoid(kn, name: str, x):
    if kn is None:
        return torch.sigmoid(x)
    if kn.writing:
        return kn.emit(name, torch.sigmoid(x))
    y0 = kn.take(name)
    return lin(x, y0, y0 * (1.0 - y0))


def const(kn, name: str, fn: Callable[[], torch.Tensor]):
    """A value of the RNG draws alone (no gradient): a reader returns the
    recorded row without calling ``fn``, so the replay draws nothing."""
    if kn is None:
        return fn()
    if kn.writing:
        return kn.emit(name, fn())
    return kn.take(name)


def normalize(kn, name: str, a, eps: float = 1e-20):
    """ops/linalg.normalize; the row is the inverse length 1 / sqrt(q),
    q = max(a.a, eps), whose derivative w.r.t. q is -y0^3 / 2."""
    if kn is None:
        return _normalize(a, eps)
    q = vmax(dot(a, a), eps)
    if kn.writing:
        inv = kn.emit(name, 1.0 / torch.sqrt(q))
    else:
        y0 = kn.take(name)
        inv = lin(q, y0, -0.5 * y0 * y0 * y0)
    return a * inv[..., None]


def power(kn, name: str, log_name: str, base, e):
    """base ** e, both differentiable (base > 0 by the caller); two rows,
    the value and log(max(base, 1e-20)): d/dbase = e y0 / base and
    d/de = y0 log(base)."""
    if kn is None:
        return torch.pow(base, e)
    if kn.writing:
        y = kn.emit(name, torch.pow(base, e))
        kn.emit(log_name, torch.log(vmax(base, 1e-20)))
        return y
    y0, log_b = kn.take(name), kn.take(log_name)
    d_base = e * y0 / vmax(base, 1e-20)
    return (y0 + d_base * (base - base.detach())
            + (y0 * log_b) * (e - e.detach()))
