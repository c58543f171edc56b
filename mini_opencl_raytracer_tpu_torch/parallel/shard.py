"""Sharded rendering on ``torch.distributed``: pixels over ``dp``,
geometry over ``tp`` (the JAX package's ``parallel/shard.py``).

* **dp**: the row-major pixel ids are split contiguously over the ``dp``
  dimension; each rank runs the same body as ``render.render_sample`` on
  its slice (on ``mega``, the bounce kernels on the slice's ids); the
  image is assembled by a tiled all-gather.
* **tp, ring**: each rank of a ``tp`` row holds one slice of the
  triangles and intersects its resident rays against it, then the ray
  state (o, d, best t / index) moves one hop around the ring with
  ``ppermute``, until every ray has met every slice and is home again.
* **tp, all-to-all**: the row's rays are gathered, every rank intersects
  all of them against its slice, and the closest hit is combined with
  ``pmin`` / ``pmax``.
* The JAX package's ``ring_intersect`` / ``a2a_intersect`` build the
  slice's intersector inside each traced call; here
  ``make_ring_intersector`` / ``make_a2a_intersector`` build it once per
  render and return the per-call function.
* ``train_step_dp``: the dp-sharded training step with the gradient
  all-reduce placed by hand, in buckets whose all-reduce overlaps the
  next bucket's forward and backward.

Each entry point runs as a compiled program (jit.py, the JAX package's
``jax.jit`` of each), keyed by ``cfg``, the mesh (and its groups'
backends), ``mesh_cfg`` and ``grad_buckets``: on CUDA under NCCL the
first call runs eagerly (creating the NCCL communicators) and captures,
and later calls replay a CUDA graph; on the CPU, and on CUDA under gloo,
every call runs eagerly (jit.py's module note has the rule). What runs
on the host stays outside the graph and goes in as an argument: the
native SAH build of a slice's accel (ring, all-to-all) and of
``train_step_dp``'s accel. A frame is an int (a constant of its graph) or
a 0-d integer tensor (read from memory at each replay). A compiled call
takes no argument that requires grad (jit.py): the eager calls (CPU,
gloo) are differentiable, and a compiled one takes its gradient inside,
as ``train_step_dp`` does.

One process runs per rank, and every rank of the mesh calls these
functions (and, for gradients, the backward) with the same arguments.
The scene and camera are replicated: their gradients are summed over
``dp`` (comm.replicate), not over ``tp``, whose ranks compute the same
rays. Intersection passes no gradient (the winner's attributes are
recomputed from the replicated scene in shading, as in the JAX package),
so the rotated ray state is detached.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import grad as grad_mod
from ..config import BVHConfig, MeshConfig, RenderConfig
from ..jit import jit
from ..models.scene import Camera, Geometry, Scene
from ..ops import bvh as bvh_mod
from ..ops.cuda import intersect as pallas_mod
from ..ops.intersect import Hit
from ..render import build_accel, make_intersectors, render_ids, resolve_backend
from . import comm

# The static arguments of the compiled entry points.
_STATIC = ("cfg", "mesh", "mesh_cfg")


def _pixel_ids(cfg: RenderConfig, axis: comm.Axis, device) -> torch.Tensor:
    """This rank's contiguous slice of the row-major pixel ids."""
    R = cfg.num_pixels
    if R % axis.size:
        raise ValueError(f"pixels {R} not divisible by {axis.name}={axis.size}")
    n = R // axis.size
    return torch.arange(axis.index * n, (axis.index + 1) * n, dtype=torch.int32,
                        device=device)


def replicated(scene: Scene, camera: Camera, axis: comm.Axis):
    """(scene, camera) whose float leaves that require grad go through
    comm.replicate over ``axis``: the gradient each rank computes from its
    own share is summed over the axis in the backward."""
    tree = grad_mod._SceneCamera(scene, camera)
    leaves = [(k, v) for k, v in grad_mod._leaves(tree)
              if v.is_floating_point() and v.requires_grad]
    out = comm.replicate([v for _, v in leaves], axis)
    tree = grad_mod._rebuild(tree, dict(zip((k for k, _ in leaves), out)))
    return tree.scene, tree.camera


@jit(static_argnames=_STATIC)
def render_sample_dp(scene: Scene, camera: Camera, cfg: RenderConfig, mesh,
                     frame=0, mesh_cfg: MeshConfig = MeshConfig()) -> torch.Tensor:
    """One progressive sample, pixels sharded over ``dp``, geometry
    replicated -> linear radiance [H, W, 3] on every rank, as a compiled
    program (module note). Eager calls are differentiable w.r.t. the
    scene and the camera."""
    dp = comm.Axis(mesh, mesh_cfg.dp_axis)
    ids = _pixel_ids(cfg, dp, scene.device)
    backend = resolve_backend(scene, cfg)
    scene, camera = replicated(scene, camera, dp)
    inter = None if backend == "mega" else make_intersectors(scene, cfg, backend=backend)
    local = render_ids(scene, camera, cfg, ids, frame, backend, inter)
    return comm.all_gather(local, dp).reshape(cfg.height, cfg.width, 3)


def _shard_geometry(geometry: Geometry, tp: int, index: int):
    """Triangles [index * per, (index + 1) * per) of an equal split, and
    ``per``. Padding triangles are all-zero (v0 = v1 = v2 = 0):
    degenerate, so Moller-Trumbore's det == 0 rejects them on every
    backend, and the shard's accel stays finite. Detached: intersection
    passes no gradient."""
    T = geometry.num_triangles
    per = -(-T // tp)
    pad = per * tp - T

    def take(a):
        a = a.detach()
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a[index * per:(index + 1) * per]

    return Geometry(**{f.name: take(getattr(geometry, f.name))
                       for f in dataclasses.fields(Geometry)}), per


def _slice_accel(geo: Geometry, cfg: RenderConfig, backend: str):
    """The accel of a triangle slice: for ``pallas`` None up to 2048
    triangles (the panel kernel) and the cluster kernel's SAH layout above
    (a host build); the LBVH for ``bvh``; None for ``bruteforce``."""
    with torch.no_grad():
        if backend == "pallas":
            return pallas_mod.build_accel(geo, cfg)
        if backend == "bvh":
            return bvh_mod.build_bvh(geo, BVHConfig())
    return None


def _shard_closest(scene: Scene, cfg: RenderConfig, tp: comm.Axis, backend: str,
                   accel=None):
    """(o, d) -> (t, global triangle index, hit), the index and the hit
    flag int32 as they travel (per * tp < 2**31), on this rank's triangle
    slice, through the slice's ``accel`` (``_slice_accel``, built here
    when None)."""
    geo, per = _shard_geometry(scene.geometry, tp.size, tp.index)
    if accel is None:
        accel = _slice_accel(geo, cfg, backend)
    if backend == "pallas":
        closest, _ = pallas_mod.make_intersectors(geo, cfg, accel=accel)
    else:
        closest, _ = make_intersectors(dataclasses.replace(scene, geometry=geo), cfg,
                                       accel=accel, backend=backend)
    offset = tp.index * per

    def local_hit(o, d):
        h = closest(o, d)
        return h.t, h.tri_idx.to(torch.int32) + offset, h.hit.to(torch.int32)

    return local_hit


def make_ring_intersector(scene: Scene, cfg: RenderConfig, tp: comm.Axis,
                          backend: str = "bruteforce", accel=None):
    """closest(o, d) -> Hit with the geometry sharded over ``tp``, by ring
    traversal; the slice's intersector is built once here (on the slice's
    ``accel``, built here when None) and reused for every hop and bounce.

    Each rank intersects its resident rays against its slice, then the
    ray state rotates one hop (rank i to i + 1) and meets the next slice;
    a later slice's hit wins only if strictly nearer (``hit & t < t_``).
    After tp - 1 hops one more rotation brings every ray home."""
    local_hit = _shard_closest(scene, cfg, tp, backend, accel)
    perm = [(i, (i + 1) % tp.size) for i in range(tp.size)]

    def closest(o, d):
        o, d = o.detach(), d.detach()
        t, idx, hit = local_hit(o, d)
        floats = torch.cat([o, d, t[:, None].to(o.dtype)], dim=1)
        ints = torch.stack([idx, hit], dim=1)
        for _ in range(tp.size - 1):
            floats = comm.ppermute(floats, tp, perm)
            ints = comm.ppermute(ints, tp, perm)
            t2, idx2, h2 = local_hit(floats[:, 0:3].contiguous(),
                                     floats[:, 3:6].contiguous())
            better = (h2 > 0) & (t2 < floats[:, 6])
            floats = torch.cat([floats[:, :6],
                                torch.where(better, t2.to(o.dtype), floats[:, 6])[:, None]],
                               dim=1)
            ints = torch.stack([torch.where(better, idx2, ints[:, 0]),
                                torch.maximum(ints[:, 1], h2)], dim=1)
        floats = comm.ppermute(floats, tp, perm)
        ints = comm.ppermute(ints, tp, perm)
        return Hit(t=floats[:, 6].contiguous(), tri_idx=ints[:, 0].to(torch.int64),
                   hit=ints[:, 1] > 0)

    return closest


def make_a2a_intersector(scene: Scene, cfg: RenderConfig, tp: comm.Axis,
                         backend: str = "bruteforce", accel=None):
    """closest(o, d) -> Hit with the geometry sharded over ``tp``, by one
    collective round: the row's rays are gathered, each rank intersects
    all of them against its slice (through its ``accel``, built here when
    None), and the closest hit is combined with ``pmin`` on t; exact-t
    ties go to the smallest global index."""
    local_hit = _shard_closest(scene, cfg, tp, backend, accel)

    def closest(o, d):
        R_l = o.shape[0]
        o_all = comm.all_gather(o.detach(), tp)
        d_all = comm.all_gather(d.detach(), tp)
        t, idx, hit = local_hit(o_all, d_all)
        hit = hit > 0
        t = torch.where(hit, t, torch.full_like(t, cfg.t_max))
        t_min = comm.pmin(t, tp)
        hit_any = comm.pmax(hit.to(torch.int32), tp) > 0
        cand = hit & (t <= t_min)
        big = torch.full_like(idx, 2**31 - 1)
        idx_min = comm.pmin(torch.where(cand, idx, big), tp)
        idx_min = torch.where(hit_any, idx_min, torch.full_like(idx_min, -1))
        sl = slice(tp.index * R_l, (tp.index + 1) * R_l)
        return Hit(t=t_min[sl], tri_idx=torch.clamp(idx_min[sl], min=0).to(torch.int64),
                   hit=hit_any[sl])

    return closest


def _tp_backend(scene: Scene, cfg: RenderConfig) -> str:
    """``auto`` and ``mega`` resolve to ``pallas``: the bounce kernels have
    no intersector entry point."""
    backend = resolve_backend(scene, cfg)
    return "pallas" if backend == "mega" else backend


def _render_tp(make, scene, camera, accel, cfg, mesh, frame, mesh_cfg, spp_loop: bool):
    dp = comm.Axis(mesh, mesh_cfg.dp_axis)
    tp = comm.Axis(mesh, mesh_cfg.tp_axis)
    ids = _pixel_ids(cfg, dp, scene.device)
    backend = _tp_backend(scene, cfg)
    scene, camera = replicated(scene, camera, dp)
    closest = make(scene, cfg, tp, backend, accel)

    def any_hit(o, d, t_limit):
        h = closest(o, d)
        return h.hit & (h.t < t_limit)

    if not spp_loop:
        cfg = dataclasses.replace(cfg, spp=1)
    local = render_ids(scene, camera, cfg, ids, frame, backend, (closest, any_hit))
    return comm.all_gather(local, dp).reshape(cfg.height, cfg.width, 3)


@jit(static_argnames=_STATIC)
def _ring(scene, camera, accel, cfg, mesh, frame, mesh_cfg):
    return _render_tp(make_ring_intersector, scene, camera, accel, cfg, mesh, frame,
                      mesh_cfg, spp_loop=True)


@jit(static_argnames=_STATIC)
def _a2a(scene, camera, accel, cfg, mesh, frame, mesh_cfg):
    return _render_tp(make_a2a_intersector, scene, camera, accel, cfg, mesh, frame,
                      mesh_cfg, spp_loop=False)


def _rank_slice_accel(scene: Scene, cfg: RenderConfig, mesh, mesh_cfg: MeshConfig):
    """This rank's slice accel, built eagerly: the compiled bodies take it
    as an argument (the SAH build runs on the host)."""
    tp = comm.Axis(mesh, mesh_cfg.tp_axis)
    geo, _ = _shard_geometry(scene.geometry, tp.size, tp.index)
    return _slice_accel(geo, cfg, _tp_backend(scene, cfg))


def render_sample_ring(scene: Scene, camera: Camera, cfg: RenderConfig, mesh, frame=0,
                       mesh_cfg: MeshConfig = MeshConfig()) -> torch.Tensor:
    """One progressive sample with pixels sharded over ``dp`` and the
    geometry over ``tp`` (ring traversal) -> [H, W, 3] on every rank.

    Shadow rays use the same ring (occluded = a ring hit below the light's
    distance). ``auto`` and ``mega`` resolve to ``pallas`` (the bounce
    kernels have no intersector entry point), so each slice runs the
    panel kernel up to 2048 triangles and the cluster kernel above. The
    slice's accel is built eagerly, then the body runs as a compiled
    program (module note)."""
    return _ring(scene, camera, _rank_slice_accel(scene, cfg, mesh, mesh_cfg), cfg, mesh,
                 frame, mesh_cfg)


def render_sample_a2a(scene: Scene, camera: Camera, cfg: RenderConfig, mesh, frame=0,
                      mesh_cfg: MeshConfig = MeshConfig()) -> torch.Tensor:
    """render_sample_ring's all-to-all sibling. As in the JAX package it
    traces one sample seeded by ``frame`` (``cfg.spp`` is not read)."""
    return _a2a(scene, camera, _rank_slice_accel(scene, cfg, mesh, mesh_cfg), cfg, mesh,
                frame, mesh_cfg)


def train_step_dp(scene: Scene, camera: Camera, cfg: RenderConfig, mesh, frame=0,
                  mesh_cfg: MeshConfig = MeshConfig(), grad_buckets: int = 1):
    """One dp-sharded differentiable render step -> (loss, Scene of
    gradients) on every rank, with the gradient all-reduce placed by hand.

    Loss = the global mean radiance of one sample at ``frame``; gradients
    cover every float leaf of the scene (integer leaves get zeros).
    The rank's pixels are split into ``grad_buckets`` buckets. Each
    bucket's gradient is flattened into its own row of one buffer, whose
    all-reduce starts (``async_op=True``) as soon as the bucket's backward
    has finished and runs behind the next bucket's forward and backward;
    all are waited on before the rows are summed. With one bucket that is
    one all-reduce after the whole backward. The accel is built once, here
    and eagerly (for a large scene the native SAH build on the host), and
    the step's body, forward, backward and all-reduces, runs as a compiled
    program keyed by ``grad_buckets`` too (module note)."""
    with torch.no_grad():
        accel = build_accel(scene, cfg)
    return _train_step_dp(_detached(scene), _detached(camera), accel, cfg, mesh, frame,
                          mesh_cfg, grad_buckets)


def _detached(tree):
    """A copy of a Scene or Camera whose leaves are detached (a compiled
    call takes no argument that requires grad)."""
    return grad_mod._rebuild(tree, {k: v.detach() for k, v in grad_mod._leaves(tree)})


@jit(static_argnames=_STATIC + ("grad_buckets",))
def _train_step_dp(scene, camera, accel, cfg, mesh, frame, mesh_cfg, grad_buckets):
    dp = comm.Axis(mesh, mesh_cfg.dp_axis)
    ids = _pixel_ids(cfg, dp, scene.device)
    if ids.shape[0] % grad_buckets:
        raise ValueError(f"local pixels {ids.shape[0]} not divisible by {grad_buckets}")
    backend = resolve_backend(scene, cfg)
    one = dataclasses.replace(cfg, spp=1)
    denom = float(cfg.num_pixels * 3)
    leaves = dict(grad_mod._leaves(scene))
    params = {k: v.detach().requires_grad_() for k, v in leaves.items()
              if v.is_floating_point()}
    sc = grad_mod._rebuild(scene, params)
    with torch.no_grad():
        inter = (None if backend == "mega"
                 else make_intersectors(sc, cfg, accel=accel, backend=backend))
    flat = torch.empty((grad_buckets, sum(p.numel() for p in params.values())),
                       dtype=next(iter(params.values())).dtype, device=scene.device)
    loss = torch.zeros((), dtype=cfg.torch_dtype(), device=scene.device)
    pending = []
    for row, chunk in zip(flat, ids.reshape(grad_buckets, -1)):
        with torch.enable_grad():
            loss_b = render_ids(sc, camera, one, chunk, frame, backend, inter,
                                accel=accel).sum() / denom
            gs = torch.autograd.grad(loss_b, list(params.values()), allow_unused=True)
        loss += loss_b.detach()
        torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                   for p, g in zip(params.values(), gs)], out=row)
        pending.append(comm.psum_start(row, dp))
    for handle in pending:
        handle.wait()
    g_sum = flat.sum(0)
    loss = comm.psum(loss, dp)
    grads, pos = {k: torch.zeros_like(v) for k, v in leaves.items()}, 0
    for k, p in params.items():
        grads[k] = g_sum[pos:pos + p.numel()].view_as(p)
        pos += p.numel()
    return loss, grad_mod._rebuild(scene, grads)
