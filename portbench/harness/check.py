"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``portbench/reference``) on the same inputs.

Each traffic kind's file (``traffic/<kind>.py``) works out its compared
numbers (``numbers``); what they share is here: the gap of gradient norms,
and the judgement of every number against its limit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def host_leaves(gs, gc) -> Dict[str, np.ndarray]:
    """{leaf path: gradient on the host} of the float leaves of a scene
    gradient and a camera gradient."""
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(gs, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v.is_floating_point():
                out[f"{group}.{f.name}"] = v.detach().float().cpu().numpy()
    for f in dataclasses.fields(gc):
        out[f"camera.{f.name}"] = getattr(gc, f.name).detach().float().cpu().numpy()
    return out


def tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}


def norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))


def grad_gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
             med: Optional[float] = None) -> Tuple[float, str]:
    """(worst leaf's gap of norms, that leaf): each leaf's gap over the
    larger of its reference norm and ``med`` (by default the median leaf's
    reference norm)."""
    norms = {k: norm(v) for k, v in ref.items()}
    if med is None:
        med = float(np.median(list(norms.values())))
    worst, name = 0.0, ""
    for k, r in norms.items():
        p = norm(prog[k]) if k in prog else 0.0
        scale = max(r, med)
        gap = abs(p - r) / scale if scale > 0 else (0.0 if p == 0 else float("inf"))
        if not np.isfinite(p):
            gap = float("inf")
        if gap > worst or not name:
            worst, name = gap, k
    return worst, name


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    shown = {k: v for k, v in numbers.items() if not k.startswith("_")}
    out, ok = {}, set(shown) == set(limits)
    for k in sorted(set(shown) | set(limits)):
        v, lim = shown.get(k, float("nan")), limits.get(k, float("nan"))
        out[k] = {"value": v, "limit": lim}
        ok = ok and bool(np.isfinite(v)) and v <= lim
    return ok, out


def lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
