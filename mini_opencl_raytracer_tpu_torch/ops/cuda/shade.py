"""The wavefront's shading of one bounce as one CUDA kernel, and its
adjoint as another.

After each bounce's closest hit, ``ops/integrator.make_bounce_core`` runs
``ops/shading.hit_attributes`` and ``ops/integrator.shade_hit``: some 520
PyTorch launches a bounce, ~7.1 KB of traffic a ray, and as many again in
autograd's backward. On a CUDA device, in float32 and without shadow rays
(``integrator.shading_route``), it calls instead:

* ``shade_rows`` where no gradient is taken: the kernel written by hand in
  ``csrc/shade.cu``, one thread a ray, which shares the mega path's
  shading body (``csrc/shade.cuh``) and returns what ``shade_hit``
  returns, bit for bit;
* ``shade_grad`` where one is taken (and the scene has at most
  ``MAX_LIGHTS`` lights): ``_Shade``, an autograd Function whose forward is
  that kernel and whose backward is ``shade_adjoint``, the kernel of
  ``csrc/shade_bwd.cu``: the vector-Jacobian product of the bounce with
  its winners, alive and hit masks frozen, one thread a ray, on the mega
  path's adjoint (``csrc/adjoint.cuh``, K3 / K4's). The Function saves its
  inputs only, and its backward replays the bounce, so under ``remat``'s
  checkpoint the recompute is the intersection and one launch.

Neither is the port of a TPU kernel: the JAX package leaves this work to
XLA's fusion. ``shade_plain`` (``hit_attributes`` then ``shade_hit``) is
their plain version, and ``shade_adjoint_plain`` (autograd of
``shade_plain``) the adjoint's; the wrappers run them for tensors on the
CPU.

``build.LAUNCHES`` counts the kernels' launches; ``build.RAYS`` the rays
each path shaded, counted on the host from shapes: ``shade_fused`` the
forward kernel's (with or without a gradient), ``shade_adjoint`` the
adjoint's, ``shade_plain`` those the integrator shaded in PyTorch on a CUDA
device. A captured program's replays add them as they add the launches
(jit.py, ``COUNTS`` ``shade_fused_rays``, ``shade_adjoint_rays``,
``shade_plain_rays``).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import RenderConfig
from ..integrator import shade_hit
from ..intersect import Hit
from ..shading import ShadingTable, hit_attributes, winner_rows
from . import build, megakernel
from .build import check_tensor
from .megakernel import LIGHT_COLS, MAX_LIGHTS, params, unpack_lights


def shade_plain(hit: Hit, table, o, d, beta, radiance, alive, seeds, bounce: int,
                lights, cfg: RenderConfig):
    """``hit_attributes`` then ``shade_hit`` on the packed ``[L, 16]``
    lights: (o, d, beta, radiance, alive) of the next bounce."""
    at = hit_attributes(o, d, hit, ShadingTable(table), backface_cull=cfg.backface_cull,
                        soft_sigma=cfg.soft_edge_sigma)
    return shade_hit(at, hit.hit, o, d, beta, radiance, alive, seeds, bounce,
                     unpack_lights(lights), cfg)[:5]


def _check_rows(t: torch.Tensor, name: str, R: int, device) -> None:
    """o, d, beta and the radiance: [R, 3] float32 whose columns are
    adjacent; any row stride (0 for the camera's broadcast origin, 12 for
    the pipeline stages' packed state)."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (R, 3) \
            or t.stride(1) != 1 or t.stride(0) < 0:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}: expected float32 [{R}, 3] on {device} with "
                         "adjacent columns")


def _check_inputs(what: str, cfg: RenderConfig, state: dict, alive, hit, seeds, lights,
                  rows) -> None:
    """The checks of both wrappers: float32, no shadow rays, the [R, 3]
    ``state`` with adjacent columns, alive and hit bool [R], seeds int64
    [R], lights [L, 16], and the winners' rows float32 [R, 34], 16-byte
    aligned, where given."""
    if cfg.shadow_rays:
        raise ValueError(f"{what} casts no shadow rays: cfg.shadow_rays takes "
                         "hit_attributes and shade_hit")
    if cfg.torch_dtype() != torch.float32:
        raise TypeError(f"{what} runs in float32, not {cfg.dtype}")
    device, R = alive.device, alive.shape[0]
    for name, t in state.items():
        _check_rows(t, name, R, device)
    check_tensor(alive, "alive", torch.bool, (R,), device)
    check_tensor(hit, "hit", torch.bool, (R,), device)
    check_tensor(seeds, "seeds", torch.int64, (R,), device)
    check_tensor(lights, "lights", torch.float32, (lights.shape[0], LIGHT_COLS), device)
    if rows is not None:
        check_tensor(rows, "rows", torch.float32, (R, ShadingTable.COLS), device)
        if rows.data_ptr() % 16:
            raise ValueError("rows must be 16-byte aligned")


def shade_rows(hit: Hit, table: torch.Tensor, o, d, beta, radiance, alive, seeds,
               bounce: int, lights: torch.Tensor, cfg: RenderConfig):
    """One bounce's shading after the closest hit ``hit``: (o, d, beta,
    radiance, alive) of the next bounce, each new, as ``shade_plain``
    returns them. The winner's row is ``hit.rows``' (float32 [R, 34]) or,
    without rows, ``table[hit.tri_idx]`` (float32 [T, 34], int64 [R]).
    o, d, beta, radiance: float32 [R, 3] with adjacent columns (any row
    stride); alive and ``hit.hit`` bool [R]; seeds int64 [R] (u32
    values); ``lights`` [L, 16] (``megakernel.pack_lights``). Float32 and
    no shadow rays; nothing may require grad."""
    state = {"o": o, "d": d, "beta": beta, "radiance": radiance}
    build.refuse_grad(dict(state, table=table, lights=lights, rows=hit.rows),
                      "shade_rows takes no gradient")
    _check_inputs("shade_rows", cfg, state, alive, hit.hit, seeds, lights, hit.rows)
    device, R = alive.device, alive.shape[0]
    if hit.rows is None:
        check_tensor(table, "table", torch.float32, (table.shape[0], ShadingTable.COLS), device)
        check_tensor(hit.tri_idx, "tri_idx", torch.int64, (R,), device)
    if device.type == "cpu":
        return shade_plain(hit, table, o, d, beta, radiance, alive, seeds, bounce, lights, cfg)
    if device.type != "cuda":
        raise ValueError(f"shade_rows runs on cpu or cuda, not {device}")
    f32 = dict(dtype=torch.float32, device=device)
    out = tuple(torch.empty((R, 3), **f32) for _ in range(4)) + (
        torch.empty((R,), dtype=torch.bool, device=device),)
    if R:
        p = params(cfg, R, 0, lights.shape[0], bounce)
        rows = hit.rows
        build.launch("shade", device, lambda _: (
            ctypes.addressof(p), rows, table if rows is None else None,
            hit.tri_idx if rows is None else None, hit.hit, alive, seeds, lights,
            *[v for t in (o, d, beta, radiance) for v in (t, t.stride(0))], *out),
            rays={"shade_fused": R})
    return out


def shade_adjoint_plain(rows, o, d, beta, alive, hit, seeds, lights, cot, bounce: int,
                        cfg: RenderConfig):
    """Plain version of ``shade_adjoint``: autograd of ``shade_plain`` on
    the winners' ``rows``. Returns (d_o, d_d, d_beta, d_rows, d_lights)."""
    with torch.enable_grad():
        leaves = tuple(x.detach().requires_grad_() for x in (o, d, beta, rows, lights))
        oi, di, bi, ri, lv = leaves
        winners = Hit(t=None, tri_idx=None, hit=hit, rows=ri)
        outs = shade_plain(winners, ri.detach(), oi, di, bi, torch.zeros_like(bi), alive, seeds,
                           bounce, lv, cfg)[:4]
        grads = torch.autograd.grad(outs, leaves, grad_outputs=tuple(cot), allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads))


def _check_cot(c: torch.Tensor, name: str, R: int, device) -> torch.Tensor:
    """A cotangent as the kernel reads it: float32 [R, 3] with adjacent
    columns; one that is not (an expanded gradient) is copied."""
    if c.stride(1) != 1 or c.stride(0) < 0:
        c = c.contiguous()
    _check_rows(c, name, R, device)
    return c


def shade_adjoint(rows, o, d, beta, alive, hit, seeds, lights, cot, bounce: int,
                  cfg: RenderConfig):
    """The vector-Jacobian product of ``shade_rows`` on the winners' rows
    ``rows`` (float32 [R, 34], 16-byte aligned; each ray's own row, read
    where it is alive with a winner), with the winners, ``alive`` and
    ``hit`` (bool [R]) frozen. ``cot``: the cotangents of the next (o, d,
    beta, radiance), [R, 3] each. Returns (d_o, d_d, d_beta [R, 3], d_rows
    [R, 34], d_lights [L, 16]); the radiance's
    gradient is its cotangent (each term is one add to it). Inputs as
    ``shade_rows`` takes them, at most ``MAX_LIGHTS`` lights; nothing may
    require grad."""
    cot = tuple(cot)
    if len(cot) != 4:
        raise ValueError("cot holds the cotangents of (o, d, beta, radiance)")
    state = {"o": o, "d": d, "beta": beta}
    build.refuse_grad(dict(state, rows=rows, lights=lights,
                           **{f"cot[{i}]": c for i, c in enumerate(cot)}),
                      "shade_adjoint is a backward; detach its inputs")
    _check_inputs("shade_adjoint", cfg, state, alive, hit, seeds, lights, rows)
    device, R, L = alive.device, alive.shape[0], lights.shape[0]
    if L > MAX_LIGHTS:
        raise ValueError(f"shade_adjoint takes at most {MAX_LIGHTS} lights, got {L}")
    cot = tuple(_check_cot(c, f"cot[{i}]", R, device) for i, c in enumerate(cot))
    if device.type == "cpu":
        return shade_adjoint_plain(rows, o, d, beta, alive, hit, seeds, lights, cot, bounce, cfg)
    if device.type != "cuda":
        raise ValueError(f"shade_adjoint runs on cpu or cuda, not {device}")
    f32 = dict(dtype=torch.float32, device=device)
    new = torch.empty if R else torch.zeros   # the kernels write every entry
    out = (new((R, 3), **f32), new((R, 3), **f32), new((R, 3), **f32),
           new((R, ShadingTable.COLS), **f32), new((L, LIGHT_COLS), **f32))
    if R:
        plan = megakernel.bwd_plan(R, 0, L, megakernel.sm_count(megakernel.device_index(device)),
                                   False)
        part = torch.empty((plan.grid, plan.part_cols), **f32)
        p = params(cfg, R, 0, L, bounce)
        build.launch("shade_adjoint", device, lambda _: (
            ctypes.addressof(p), plan.grid, rows, hit, alive, seeds, lights,
            *[v for t in (o, d, beta) + cot for v in (t, t.stride(0))], part, *out),
            rays={"shade_adjoint": R})
    return out


class _Shade(torch.autograd.Function):
    """(rows, o, d, beta, radiance, lights) -> the next (o, d, beta,
    radiance, alive): ``shade_rows`` forward, ``shade_adjoint`` backward.
    ``rows`` are the winners' (``ops/shading.winner_rows``), so the table's
    gradient reaches the table through the gather that fetched them; the
    lights are ``megakernel.pack_lights``', whose backward reaches the light
    leaves. Saves its inputs only: the adjoint replays the bounce."""

    @staticmethod
    def forward(ctx, rows, o, d, beta, radiance, lights, alive, hit, seeds, bounce, cfg):
        winners = Hit(t=None, tri_idx=None, hit=hit, rows=rows.detach())
        out = shade_rows(winners, winners.rows, o.detach(), d.detach(), beta.detach(),
                         radiance.detach(), alive, seeds, bounce, lights.detach(), cfg)
        ctx.save_for_backward(rows, o, d, beta, lights, alive, hit, seeds)
        ctx.bounce, ctx.cfg = bounce, cfg
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_o, g_d, g_beta, g_rad, _g_alive):
        rows, o, d, beta, lights, alive, hit, seeds = ctx.saved_tensors
        d_o, d_d, d_beta, d_rows, d_lights = shade_adjoint(
            rows, o, d, beta, alive, hit, seeds, lights, (g_o, g_d, g_beta, g_rad),
            ctx.bounce, ctx.cfg)
        return d_rows, d_o, d_d, d_beta, g_rad, d_lights, None, None, None, None, None


def shade_grad(hit: Hit, table: torch.Tensor, o, d, beta, radiance, alive, seeds,
               bounce: int, lights: torch.Tensor, cfg: RenderConfig):
    """``shade_rows`` where a gradient is taken: (o, d, beta, radiance,
    alive) of the next bounce through ``_Shade``, whose backward is the
    adjoint kernel (its plain version on the CPU). The winners' rows come
    from ``winner_rows`` (K6's ``hit.rows`` with the gather's gradient, or
    ``table[hit.tri_idx]``); ``lights`` [L <= MAX_LIGHTS, 16] from
    ``megakernel.pack_lights``."""
    rows = winner_rows(table, hit)
    return _Shade.apply(rows, o, d, beta, radiance, lights, alive, hit.hit, seeds, bounce, cfg)
