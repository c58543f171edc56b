"""The port's pipeline and expert paths (parallel/pipeline.py,
parallel/expert.py) against the JAX package's on the CPU, at the same mesh
shapes, and ``make_bounce_step`` / ``_sorted_wavefront``
(ops/integrator.py) against JAX's.

As in tests/test_torch_parallel.py: the JAX side on the first W of the 8
virtual CPU devices, the port side in W gloo ranks on the CPU
(tests/_torch_parallel_child.py, no JAX), started once by the module's
fixture, each rank's result equal to rank 0's bitwise. Counterparts of
tests/test_sharding.py's pipeline (2 stages, 4 microbatches), EP routing
(ep=4) and EP render (default capacity and capacity 4, which overflows)
cases, plus a gradient (of the mean squared radiance) through each of
the pipeline and the EP render against jax.grad, and each render at a
frame given as a 0-d tensor (the compiled entry points' replayed form;
on the CPU they run eagerly) against JAX's at that frame.

Tolerances: images atol 2e-5, rtol 1e-4; gradients scale-normalised atol
1e-4; the EP routing demo 1e-6, as tests/test_sharding.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import grad as jgrad
from mini_opencl_raytracer_tpu.config import MeshConfig
from mini_opencl_raytracer_tpu.models import procedural as jproc
from mini_opencl_raytracer_tpu.ops import integrator as jint
from mini_opencl_raytracer_tpu.ops import rng as jrng
from mini_opencl_raytracer_tpu.ops.camera import generate_rays as jgen
from mini_opencl_raytracer_tpu.parallel import mesh as jmesh
from mini_opencl_raytracer_tpu.parallel.expert import ep_shade_demo, render_sample_ep
from mini_opencl_raytracer_tpu.parallel.pipeline import render_sample_pp
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops import integrator as pint
from mini_opencl_raytracer_tpu_torch.ops import rng as prng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays as pgen

import _torch_parallel_run as run

torch.set_num_threads(1)

CFG = J.RenderConfig(width=32, height=32, bounces=2, backend="bruteforce", ray_chunk=256)
CAM = J.Camera.default()


def _ep_inputs():
    r = np.random.default_rng(0)
    R, M = 512, 11
    pos = r.uniform(-5, 5, size=(R, 3)).astype(np.float32)
    nrm = r.normal(size=(R, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return {"pos": pos, "nrm": nrm, "mi": r.integers(0, M, size=(R,)).astype(np.int32),
            "kd": r.uniform(size=(M, 3)).astype(np.float32),
            "lpos": np.array([0.0, -10.0, 16.0], np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel_stages"))
    indir = os.path.join(work, "in")
    os.makedirs(indir)
    np.savez(os.path.join(indir, "cornell.npz"), **run.scene_arrays(J.cornell_scene()))
    np.savez(os.path.join(indir, "camera.npz"), **run.camera_arrays(CAM))
    np.savez(os.path.join(indir, "ep_demo.npz"), **_ep_inputs())
    r = run.Ranks(indir, work, [(4, "stages4"), (2, "stages2")])
    yield r
    r.close()


def _pp_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("pp",))


def _ep_mesh():
    return jmesh.make_mesh(MeshConfig(dp=4, tp=1), jax.devices()[:4])


def test_pipeline_matches_jax(ranks, cornell):
    ref = np.asarray(render_sample_pp(cornell, CAM, CFG, _pp_mesh(), n_micro=4))
    got = ranks.replicated("stages2", "pp2")["img"]
    np.testing.assert_allclose(got, ref, atol=run.ATOL, rtol=run.RTOL)


def test_pipeline_gradients_match_jax(ranks, cornell):
    mesh = _pp_mesh()
    g = jgrad.grad_float_leaves(
        lambda s: jnp.mean(render_sample_pp(s, CAM, CFG, mesh, n_micro=4) ** 2), cornell)
    run.assert_grads_close(ranks.replicated("stages2", "pp_grad2"), run.jax_leaves(g))


def test_ep_material_routing_matches_jax(ranks):
    inp = _ep_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("ep",))
    ref = np.asarray(ep_shade_demo(*(jnp.asarray(inp[k])
                                     for k in ("pos", "nrm", "mi", "kd", "lpos")), mesh))
    got = ranks.replicated("stages4", "ep_demo4")["out"]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,capacity", [("ep4", None), ("ep4_cap4", 4)])
def test_ep_render_matches_jax(ranks, cornell, name, capacity):
    ref = np.asarray(render_sample_ep(cornell, CAM, CFG, _ep_mesh(), ep_axis="dp",
                                      capacity=capacity))
    got = ranks.replicated("stages4", name)["img"]
    np.testing.assert_allclose(got, ref, atol=run.ATOL, rtol=run.RTOL)


def test_ep_gradients_match_jax(ranks, cornell):
    """d mean(render_sample_ep ** 2) at ep=4 against jax.grad of JAX's
    single-device render_sample, the function whose values both EP renders
    equal. Not against jax.grad of JAX's render_sample_ep: under jax.grad
    its seeds, bit-cast into the float payload, do not survive the trip
    for rays whose bits read as a denormal or a NaN (6 of 1024 here, at
    ep=1 as at ep=4), so it differentiates another sample of those rays
    (up to 8.3e-2 of a leaf's largest entry off its own single-device
    gradient). The port moves the payload's bits exactly, and its EP
    gradient equals both packages' single-device gradients within 1e-5
    (ROADMAP.md, Queue 3)."""
    g = jgrad.grad_float_leaves(lambda s: jnp.mean(J.render_sample(s, CAM, CFG) ** 2),
                                cornell)
    run.assert_grads_close(ranks.replicated("stages4", "ep_grad4"), run.jax_leaves(g))


def test_pipeline_tensor_frame_matches_jax(ranks, cornell):
    ref = np.asarray(render_sample_pp(cornell, CAM, CFG, _pp_mesh(), frame=5, n_micro=4))
    got = ranks.replicated("stages2", "pp2_f5")["img"]
    np.testing.assert_allclose(got, ref, atol=run.ATOL, rtol=run.RTOL)


def test_ep_render_tensor_frame_matches_jax(ranks, cornell):
    ref = np.asarray(render_sample_ep(cornell, CAM, CFG, _ep_mesh(), frame=5, ep_axis="dp"))
    got = ranks.replicated("stages4", "ep4_f5")["img"]
    np.testing.assert_allclose(got, ref, atol=run.ATOL, rtol=run.RTOL)


def _carry(jcfg, pcfg):
    """The same primary-ray carry for both packages."""
    R = jcfg.num_pixels
    ids = jnp.arange(R, dtype=jnp.uint32)
    seeds = jrng.pixel_seeds(ids, jnp.uint32(1))
    o, d = jgen(CAM, jcfg, ids, seeds)
    jc = (o, d, jnp.ones_like(o), jnp.zeros_like(o), jnp.ones((R,), bool), seeds)
    pids = torch.arange(R, dtype=torch.int32)
    pseeds = prng.pixel_seeds(pids, 1)
    po, pd = pgen(P.camera_from_numpy(run.camera_arrays(CAM), device="cpu"), pcfg, pids,
                  pseeds)
    pc = (po, pd, torch.ones_like(po), torch.zeros_like(po),
          torch.ones((R,), dtype=torch.bool), pseeds)
    return jc, pc


@pytest.mark.parametrize("sort_rays", [False, True])
def test_make_bounce_step_matches_jax(sort_rays):
    """Two steps of make_bounce_step (the sorted wrapper on and off, with
    shadow rays, remat on) against JAX's: each output of the carry."""
    js = jproc.bunny_scene(target_tris=4000)
    ps = P.scene_from_numpy(run.scene_arrays(js), device="cpu")
    kw = dict(width=16, height=16, bounces=2, backend="bruteforce", shadow_rays=True,
              sort_rays=sort_rays, ray_chunk=256)
    jcfg, pcfg = J.RenderConfig(**kw), P.RenderConfig(**kw)
    jstep = jint.make_bounce_step(js, jcfg, *J.make_intersectors(js, jcfg), with_stats=True)
    pstep = pint.make_bounce_step(ps, pcfg, *P.make_intersectors(ps, pcfg), with_stats=True)
    jc, pc = _carry(jcfg, pcfg)
    for b in range(2):
        jc, jstat = jstep(jc, jnp.int32(b))
        pc, pstat = pstep(pc, b)
        np.testing.assert_allclose(float(pstat), float(jstat), rtol=1e-6)
    for j, p in zip(jc, pc):
        np.testing.assert_allclose(p.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64),
                                   atol=run.ATOL, rtol=run.RTOL)


def test_sorted_wavefront_keeps_ray_order():
    """_sorted_wavefront's intersectors return each ray's own hit: equal
    to the unwrapped intersectors on a shuffled wavefront."""
    scene = P.bunny_scene(target_tris=4000, device="cpu")
    cfg = P.RenderConfig(width=16, height=16, backend="bruteforce", ray_chunk=256)
    closest, any_hit = P.make_intersectors(scene, cfg)
    s_closest, s_any = pint._sorted_wavefront(scene, closest, any_hit)
    ids = torch.randperm(cfg.num_pixels, generator=torch.Generator().manual_seed(0))
    ids = ids.to(torch.int32)
    seeds = prng.pixel_seeds(ids, 0)
    o, d = pgen(P.Camera.default(device="cpu"), cfg, ids, seeds)
    h, hs = closest(o, d), s_closest(o, d)
    assert torch.equal(h.t, hs.t) and torch.equal(h.tri_idx, hs.tri_idx)
    assert torch.equal(h.hit, hs.hit)
    limit = torch.where(h.hit, h.t * 0.5, torch.full_like(h.t, 1e3))
    assert torch.equal(any_hit(o, d, limit), s_any(o, d, limit))
