"""One rank of the port's parallel paths on the CPU, for
tests/test_torch_parallel.py and tests/test_torch_parallel_stages.py.

    python tests/_torch_parallel_child.py RANK WORLD STORE INDIR OUTDIR GROUP

Joins a gloo group of WORLD processes through the file store STORE,
reads the scenes and inputs that the test wrote to INDIR as numpy arrays
(``convert.scene_from_numpy``), runs every scenario of GROUP, and writes
each scenario's result of this rank to OUTDIR/<scenario>.r<RANK>.npz.
The tests hold them against the JAX package's functions at the same
mesh. This file imports neither JAX nor the JAX package, and checks that
nothing it imported did.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch.config import MeshConfig
from mini_opencl_raytracer_tpu_torch.parallel import (comm, expert, mesh as mesh_mod,
                                                      multihost, pipeline, shard)

torch.set_num_threads(1)
torch.set_flush_denormal(True)

CFG = P.RenderConfig(width=32, height=32, bounces=2, backend="bruteforce", ray_chunk=256)


def load_scene(indir, name):
    arrays = dict(np.load(os.path.join(indir, f"{name}.npz")))
    return P.scene_from_numpy(arrays, device="cpu")


def camera(indir):
    arrays = dict(np.load(os.path.join(indir, "camera.npz")))
    return P.camera_from_numpy(arrays, device="cpu")


def leaves_grad(fn, tree):
    """{leaf path: gradient} of the scalar fn(tree) over the float leaves."""
    return {k: v.numpy() for k, v in pgrad._leaves(pgrad.grad_float_leaves(fn, tree))}


def mesh2(dp, tp):
    return mesh_mod.make_mesh(MeshConfig(dp=dp, tp=tp), device_type="cpu")


def mesh1(name, n):
    return init_device_mesh("cpu", (n,), mesh_dim_names=(name,))


def shard4(ctx):
    sc, cam = ctx["cornell"], ctx["camera"]
    m41, m22, m14 = mesh2(4, 1), mesh2(2, 2), mesh2(1, 4)
    c22, c14 = MeshConfig(dp=2, tp=2), MeshConfig(dp=1, tp=4)
    yield "dp4", {"img": shard.render_sample_dp(sc, cam, CFG, m41)}
    yield "ring22", {"img": shard.render_sample_ring(sc, cam, CFG, m22, mesh_cfg=c22)}
    yield "ring14", {"img": shard.render_sample_ring(sc, cam, CFG, m14, mesh_cfg=c14)}
    yield "a2a22", {"img": shard.render_sample_a2a(sc, cam, CFG, m22, mesh_cfg=c22)}
    bvh = dataclasses.replace(CFG, backend="bvh")
    yield "ring_bvh22", {"img": shard.render_sample_ring(sc, cam, bvh, m22, mesh_cfg=c22)}
    mega = P.RenderConfig(width=32, height=32, bounces=2, backend="mega")
    yield "dp_mega4", {"img": shard.render_sample_dp(sc, cam, mega, m41)}
    spp = dataclasses.replace(CFG, spp=2)
    yield "dp_spp4", {"img": shard.render_sample_dp(sc, cam, spp, m41)}
    yield "dp_grad4", leaves_grad(
        lambda s: (shard.render_sample_dp(s, cam, CFG, m41) ** 2).mean(), sc)
    for k in (1, 4):
        loss, g = shard.train_step_dp(sc, cam, CFG, m41, grad_buckets=k)
        yield f"train{k}", dict({"loss": loss}, **dict(pgrad._leaves(g)))
    # One SGD step through the ring on the LBVH (the JAX package's
    # __graft_entry__.dryrun_multichip at dp x tp = 2 x 2).
    cfg = P.RenderConfig(width=32, height=16, bounces=2, backend="bvh", ray_chunk=256)
    g = leaves_grad(lambda s: (shard.render_sample_ring(s, cam, cfg, m22, mesh_cfg=c22)
                               ** 2).mean(), sc)
    g["new_diffuse"] = sc.materials.diffuse.numpy() - 0.1 * g["materials.diffuse"]
    yield "dryrun22", g
    big = ctx["bunny6000"]
    cfg = P.RenderConfig(width=32, height=32, bounces=2)
    yield "ring_big22", {"img": shard.render_sample_ring(big, cam, cfg, m22, mesh_cfg=c22),
                         "resolved": np.array(P.resolve_backend(big, cfg))}
    yield "comm", comm_checks(m22)
    # The compiled entry points at a frame given as a 0-d tensor (what a
    # graph reads from memory at each replay).
    f5 = torch.tensor(5, dtype=torch.int64)
    yield "dp4_f5", {"img": shard.render_sample_dp(sc, cam, CFG, m41, frame=f5)}
    yield "ring22_f5", {"img": shard.render_sample_ring(sc, cam, CFG, m22, frame=f5,
                                                        mesh_cfg=c22)}
    yield "a2a22_f5", {"img": shard.render_sample_a2a(sc, cam, CFG, m22, frame=f5,
                                                      mesh_cfg=c22)}
    loss, g = shard.train_step_dp(sc, cam, CFG, m41, frame=f5, grad_buckets=4)
    yield "train4_f5", dict({"loss": loss}, **dict(pgrad._leaves(g)))


def comm_checks(m22):
    """The collectives on a 2 x 2 mesh against what they must give."""
    tp, dp = comm.Axis(m22, "tp"), comm.Axis(m22, "dp")
    rank = torch.distributed.get_rank()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out = {"rank": np.array(rank), "tp_index": np.array(tp.index),
           "dp_index": np.array(dp.index), "sizes": np.array([tp.size, dp.size])}
    out["psum_tp"] = comm.psum(x, tp)
    out["pmin_dp"] = comm.pmin(x.to(torch.int64), dp)
    out["pmax_dp"] = comm.pmax(x, dp)
    out["gather_tp"] = comm.all_gather(x, tp)
    out["a2a_tp"] = comm.all_to_all(x, tp)
    out["ring_tp"] = comm.ppermute(x, tp, [(0, 1), (1, 0)])
    out["shift_tp"] = comm.ppermute(x, tp, [(0, 1)])
    # Gradients through the differentiable collectives.
    xg = x.clone().requires_grad_()
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    (gx,) = torch.autograd.grad((comm.all_gather(xg, tp) * w).sum(), xg)
    out["grad_gather_tp"] = gx
    (gx,) = torch.autograd.grad((comm.ppermute(xg, tp, [(0, 1)]) * w[:2]).sum(), xg)
    out["grad_shift_tp"] = gx
    (gx,) = torch.autograd.grad((comm.all_to_all(xg, tp) * w[:2]).sum(), xg)
    out["grad_a2a_tp"] = gx
    (y,) = comm.replicate([xg], dp)
    (gx,) = torch.autograd.grad((y * (dp.index + 1)).sum(), xg)
    out["grad_replicate_dp"] = gx
    self_mesh = mesh2(4, 1)
    one = comm.Axis(self_mesh, "tp")
    out["self_pair"] = comm.ppermute(x, one, [(0, 0)])
    return out


def shard3(ctx):
    sc, cam = ctx["bunny4000"], ctx["camera"]
    cfg = P.RenderConfig(width=32, height=32, bounces=2)
    yield "ring_tp3", {"img": shard.render_sample_ring(
        sc, cam, cfg, mesh2(1, 3), mesh_cfg=MeshConfig(dp=1, tp=3))}


def stages4(ctx):
    sc, cam, ep_in = ctx["cornell"], ctx["camera"], ctx["ep_demo"]
    ep_mesh = mesh1("ep", 4)
    yield "ep_demo4", {"out": expert.ep_shade_demo(
        *(torch.from_numpy(ep_in[k]) for k in ("pos", "nrm", "mi", "kd", "lpos")), ep_mesh)}
    m41 = mesh2(4, 1)
    yield "ep4", {"img": expert.render_sample_ep(sc, cam, CFG, m41, ep_axis="dp")}
    yield "ep4_cap4", {"img": expert.render_sample_ep(sc, cam, CFG, m41, ep_axis="dp",
                                                      capacity=4)}
    yield "ep_grad4", leaves_grad(
        lambda s: (expert.render_sample_ep(s, cam, CFG, m41, ep_axis="dp") ** 2).mean(), sc)
    yield "ep4_f5", {"img": expert.render_sample_ep(
        sc, cam, CFG, m41, frame=torch.tensor(5, dtype=torch.int64), ep_axis="dp")}


def stages2(ctx):
    sc, cam = ctx["cornell"], ctx["camera"]
    pp = mesh1("pp", 2)
    yield "pp2", {"img": pipeline.render_sample_pp(sc, cam, CFG, pp, n_micro=4)}
    yield "pp_grad2", leaves_grad(
        lambda s: (pipeline.render_sample_pp(s, cam, CFG, pp, n_micro=4) ** 2).mean(), sc)
    yield "pp2_f5", {"img": pipeline.render_sample_pp(
        sc, cam, CFG, pp, frame=torch.tensor(5, dtype=torch.int64), n_micro=4)}


GROUPS = {"shard4": shard4, "shard3": shard3, "stages4": stages4, "stages2": stages2}


def main():
    rank, world, store, indir, outdir, group = sys.argv[1:7]
    rank, world = int(rank), int(world)
    if not multihost.initialize(coordinator_address=f"file://{store}",
                                num_processes=world, process_id=rank, device="cpu"):
        raise AssertionError("initialize() returned False with explicit arguments")
    ctx = {"camera": camera(indir)}
    for name in ("cornell", "bunny4000", "bunny6000"):
        if os.path.exists(os.path.join(indir, f"{name}.npz")):
            ctx[name] = load_scene(indir, name)
    if os.path.exists(os.path.join(indir, "ep_demo.npz")):
        ctx["ep_demo"] = dict(np.load(os.path.join(indir, "ep_demo.npz")))
    for name, result in GROUPS[group](ctx):
        arrays = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
                  for k, v in result.items()}
        np.savez(os.path.join(outdir, f"{name}.r{rank}.npz"), **arrays)
    loaded = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "mini_opencl_raytracer_tpu"))
    if loaded:
        raise AssertionError(f"the child imported {loaded}")
    torch.distributed.destroy_process_group()
    print(f"CHILD_OK rank {rank} group {group}", flush=True)


if __name__ == "__main__":
    main()
