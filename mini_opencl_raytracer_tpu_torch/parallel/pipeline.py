"""Pipeline-parallel rendering: bounce segments as pipeline stages (the
JAX package's ``parallel/pipeline.py``).

The path recurrence (Render, kernel_bvh.cl:349-384) is a chain of
identical per-bounce transitions, so it pipelines as a model's layers do:
stage p owns bounces [p*B/P, (p+1)*B/P) (scene replicated), and
microbatches of the pixel grid flow through the stages in a GPipe
schedule: at step t stage p runs microbatch t - p, then the wavefront
state (o, d, beta, radiance, alive, seeds) hops to stage p + 1 with
``ppermute``. After n_micro + P - 1 steps every microbatch has run every
bounce; the last stage banks the finished radiance.

The values equal the single-device render's: the same make_bounce_step
transition runs with the same global bounce indices and RNG draw sites,
only partitioned in time. Every stage runs the same collectives in the
same order, forward and backward: each step's state goes through one
``ppermute`` (the last step's, which nobody reads, is skipped on every
stage), and every stage banks through a select that is false except on
the last stage, so each step's hop is in every stage's backward.

``render_sample_pp`` runs as a compiled program (jit.py; parallel/shard.py
has the rule): a CUDA graph under NCCL, eager on the CPU and under gloo.
"""

from __future__ import annotations

import torch

from ..models.scene import Camera, Scene
from ..config import RenderConfig
from ..ops import rng
from ..ops.cuda.raygen import camera_rays
from ..ops.integrator import make_bounce_step
from ..ops.linalg import vmax
from ..jit import jit
from ..render import make_intersectors
from . import comm
from .shard import replicated


@jit(static_argnames=("cfg", "mesh", "pp_axis", "n_micro"))
def render_sample_pp(scene: Scene, camera: Camera, cfg: RenderConfig, mesh, frame=0,
                     pp_axis: str = "pp", n_micro: int = None) -> torch.Tensor:
    """One progressive sample with bounces pipelined over the ``pp`` mesh
    dimension -> linear radiance [H, W, 3] on every rank. ``cfg.bounces``
    must divide evenly over the stages; ``n_micro`` microbatches (default
    2 * stages) must divide the pixel count. Eager calls are
    differentiable w.r.t. the scene and the camera."""
    pp = comm.Axis(mesh, pp_axis)
    P = pp.size
    if cfg.bounces % P:
        raise ValueError(f"bounces {cfg.bounces} not divisible by pp={P}")
    bps = cfg.bounces // P
    if n_micro is None:
        n_micro = 2 * P
    R = cfg.num_pixels
    if R % n_micro:
        raise ValueError(f"pixels {R} not divisible by n_micro={n_micro}")
    R_mb = R // n_micro
    dev = scene.device
    dtype = cfg.torch_dtype()

    scene, camera = replicated(scene, camera, pp)
    # All microbatches' primary rays, generated once on every stage.
    pixel_ids = torch.arange(R, dtype=torch.int32, device=dev)
    o, d, seeds = camera_rays(camera, cfg, pixel_ids, rng.sample_frame(frame, 1, 0))
    o_mb, d_mb = o.reshape(n_micro, R_mb, 3), d.reshape(n_micro, R_mb, 3)
    s_mb = rng.to_i32_bits(seeds).reshape(n_micro, R_mb)

    p = pp.index
    first = torch.full((), p == 0, device=dev)
    step = make_bounce_step(scene, cfg, *make_intersectors(scene, cfg))
    perm = [(i, i + 1) for i in range(P - 1)]
    ones3 = torch.ones((R_mb, 3), dtype=dtype, device=dev)
    zeros3 = torch.zeros((R_mb, 3), dtype=dtype, device=dev)
    # Received state: floats (o, d, beta, radiance) [R_mb, 12], and alive
    # and the seeds' u32 bits as int32 [R_mb, 2]; stage 0 replaces it with
    # fresh rays.
    recv_f = torch.cat([zeros3, zeros3, ones3, zeros3], dim=1)
    recv_i = torch.zeros((R_mb, 2), dtype=torch.int32, device=dev)
    outputs = [zeros3] * n_micro
    steps = n_micro + P - 1
    for t in range(steps):
        mb = t - p
        mbc = min(max(mb, 0), n_micro - 1)
        fresh_f = torch.cat([o_mb[mbc], d_mb[mbc], ones3, zeros3], dim=1)
        fresh_i = torch.stack([torch.ones_like(s_mb[mbc]), s_mb[mbc]], dim=1)
        sf = torch.where(first, fresh_f, recv_f)
        si = torch.where(first, fresh_i, recv_i)
        state = (sf[:, 0:3], sf[:, 3:6], sf[:, 6:9], sf[:, 9:12], si[:, 0] > 0,
                 rng.from_i32_bits(si[:, 1]))
        # This stage's bounce segment, with global bounce indices.
        for k in range(bps):
            state, _ = step(state, p * bps + k)
        # Only the last stage banks the finished microbatch (clamp,
        # kernel_bvh.cl:383).
        bank = torch.full((), 0 <= mb < n_micro and p == P - 1, device=dev)
        outputs[mbc] = torch.where(bank, vmax(state[3], 0.0), outputs[mbc])
        if t < steps - 1:
            o_, d_, beta, rad, alive, seeds_ = state
            recv_f = comm.ppermute(torch.cat([o_, d_, beta, rad], dim=1), pp, perm)
            recv_i = comm.ppermute(
                torch.stack([alive.to(torch.int32), rng.to_i32_bits(seeds_)], dim=1), pp, perm)
    # Only the last stage holds real outputs; psum replicates them.
    out = comm.psum(torch.stack(outputs), pp)
    return out.reshape(cfg.height, cfg.width, 3)
