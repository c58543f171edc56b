"""Collectives over one named dimension of a device mesh: the port's
counterparts of the ``jax.lax`` collectives that the JAX package's
``parallel/`` uses inside ``shard_map``.

JAX runs one program over the mesh and names an axis; here every rank is
a process, and an ``Axis`` holds the process group of one mesh dimension,
this rank's index on it and its size (``Axis.index`` and ``Axis.size``
are ``axis_index`` and ``axis_size``). ``psum``, ``pmin``, ``pmax``,
``all_gather`` (tiled), ``all_to_all`` and ``ppermute`` follow the JAX
semantics; ``ppermute`` sends to ranks of a permutation and zero-fills
where nothing arrives, as JAX does.

Autograd: JAX differentiates through the collectives by their transposes.
Here each collective that carries a differentiable tensor is a
``torch.autograd.Function``: ``ppermute``'s backward is the inverse
permutation, ``all_to_all``'s the reverse exchange, the tiled
``all_gather``'s this rank's slice, ``psum``'s the cotangent itself (a
replicated output gets the same cotangent on every rank), and
``replicate`` (identity forward, sum over the axis backward) is the
transpose of JAX's replicated ``P()`` input. Every rank must run the same
collectives in the same order, backward included.

Transport: under an NCCL group the tensors stay on the device; gloo is a
host transport, so under a gloo group every collective copies its tensors
to host memory and back. This is decided by the group's backend and
printed once per group. The same backend decides whether a compiled call
(jit.py) can capture the collectives into a CUDA graph:
``Axis.capturable``.
"""

from __future__ import annotations

import sys
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# Bytes this rank handed to each collective since the last reset.
BYTES = {"psum": 0, "pmin": 0, "pmax": 0, "all_gather": 0, "all_to_all": 0,
         "ppermute": 0}
_ANNOUNCED = set()


class Axis:
    """One named dimension of a ``DeviceMesh``: ``group`` (its process
    group), ``index`` (this rank's position on it) and ``size``."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.group = mesh.get_group(name)
        self.index = mesh.get_local_rank(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        backend = self.backend = dist.get_backend(self.group)
        self.staged = backend == "gloo"
        ranks = tuple(dist.get_process_group_ranks(self.group))
        if (backend, ranks) not in _ANNOUNCED:
            _ANNOUNCED.add((backend, ranks))
            how = ("tensors are copied to host memory and back" if self.staged
                   else "tensors stay on their device")
            print(f"[comm] {backend} group of ranks {list(ranks)}: {how}",
                  file=sys.stderr, flush=True)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this axis's collectives: NCCL
        runs them on the device and keeps its tensors there, so jit.py
        captures them; a gloo group (host transport, or a CPU mesh) stages
        them through host memory, so a compiled call over it runs eagerly
        (jit.py's module note has the whole rule)."""
        return self.backend == "nccl"

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``x`` where the transport reads it."""
        if self.staged:
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone().contiguous()

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index)


def _count(name: str, x: torch.Tensor) -> None:
    BYTES[name] += x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, axis: Axis, op, name: str) -> torch.Tensor:
    buf = axis.stage(x)
    _count(name, buf)
    dist.all_reduce(buf, op=op, group=axis.group)
    return buf.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis, dist.ReduceOp.SUM, "psum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis, on every rank of it."""
    return _Psum.apply(x, axis)


class Pending:
    """An in-place all-reduce in flight; ``wait()`` returns once ``x``
    holds the sum."""

    def __init__(self, work, buf: torch.Tensor, x: torch.Tensor):
        self.work, self.buf, self.x = work, buf, x

    def wait(self) -> torch.Tensor:
        self.work.wait()
        if self.buf is not self.x:
            self.x.copy_(self.buf)
        return self.x


def psum_start(x: torch.Tensor, axis: Axis) -> Pending:
    """Start an in-place ``psum`` of ``x`` (not differentiable) and return
    at once. Under NCCL the collective reads and writes ``x`` itself, so
    the caller leaves ``x`` alone until ``wait()``; under gloo it works
    on a host copy that ``wait()`` copies back."""
    buf = x.detach().to("cpu", copy=True) if axis.staged else x
    _count("psum", buf)
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group, async_op=True)
    return Pending(work, buf, x)


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise minimum over the axis (not differentiable)."""
    return _all_reduce(x, axis, dist.ReduceOp.MIN, "pmin")


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise maximum over the axis (not differentiable)."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX, "pmax")


def _gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    buf = axis.stage(x)
    _count("all_gather", buf)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return torch.cat(parts, dim=0).to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[0]
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.axis.index * ctx.n, ctx.n), None


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in axis order (JAX's
    ``all_gather(..., axis=0, tiled=True)``)."""
    return _AllGather.apply(x, axis)


def _exchange(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, the axis has "
                         f"{axis.size} ranks")
    buf = axis.stage(x)
    _count("all_to_all", buf)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=axis.group)
    return out.to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.axis), None


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` [size, ...]: block i goes to rank i, and block j of the
    result came from rank j (JAX's ``all_to_all`` with split_axis =
    concat_axis = 0, untiled)."""
    return _AllToAll.apply(x, axis)


def _permute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me]:
        return x.clone()
    ops = []
    if dst:
        buf = axis.stage(x)
        _count("ppermute", buf)
        ops.append(dist.P2POp(dist.isend, buf, axis.global_rank(dst[0]), axis.group))
    if src:
        recv = torch.empty_like(x, device="cpu" if axis.staged else x.device)
        ops.append(dist.P2POp(dist.irecv, recv, axis.global_rank(src[0]), axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device) if src else torch.zeros_like(x)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g.contiguous(), ctx.axis, inverse), None, None


def ppermute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from axis index s to d for each (s, d) of ``perm``; a
    rank that receives nothing gets zeros. A self-pair is a local copy."""
    return _Ppermute.apply(x, axis, tuple(perm))


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        flat = _all_reduce(flat, ctx.axis, dist.ReduceOp.SUM, "psum")
        out, pos = [], 0
        for g in gs:
            out.append(flat[pos:pos + g.numel()].view_as(g))
            pos += g.numel()
        return (None,) + tuple(out)


def replicate(xs: Sequence[torch.Tensor], axis: Axis):
    """Inputs replicated over the axis: the same tensors forward, their
    gradients summed over the axis backward, in one all-reduce (the
    transpose of JAX's ``P()`` in_spec). Ranks that compute the same
    values on another axis must not be summed over, so name only the
    axis whose ranks compute different parts."""
    if not any(x.requires_grad for x in xs) or not torch.is_grad_enabled():
        return tuple(xs)
    return _Replicate.apply(axis, *xs)
