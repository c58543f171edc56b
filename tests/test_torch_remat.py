"""``cfg.remat`` of the port's wavefront integrator (ops/integrator._remat,
the JAX package's ``jax.checkpoint`` per bounce), on the CPU.

* remat on and off give bitwise equal losses and gradients of every float
  leaf of the scene and the camera: ``loss_and_grads`` on Cornell at 32x32
  x 3 bounces with ``backend`` ``pallas`` (the panel kernel's plain
  version) and ``bvh`` (the plain LBVH walk), the wavefront sorted and
  unsorted; and two steps of ``make_bounce_step`` (the pipeline stages'
  transition), sorted wrapper on and off. The recompute runs the same
  deterministic code on the same inputs, so nothing may differ.
* Under ``torch.no_grad()`` and where no input requires grad no checkpoint
  runs (the forward is the remat=False forward).
* The port's remat=True gradients against JAX's remat=True gradients on
  the brute-force backend at 16x16 x 2, the wavefront sorted and unsorted,
  within the scale-normalised atol 1e-4 of tests/test_torch_grad.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import grad as jgrad
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import grad as pgrad
from mini_opencl_raytracer_tpu_torch.ops import integrator as pint
from mini_opencl_raytracer_tpu_torch.ops import rng as prng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
from test_torch_grad import _compare_trees, flush_denormals  # noqa: F401
from test_torch_megakernel import _arrays

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell():
    return P.cornell_scene(device="cpu")


def _all_leaves(gs, gc):
    return list(pgrad._leaves(gs)) + [("camera." + k, v) for k, v in pgrad._leaves(gc)]


def _assert_bitwise(a, b):
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("backend", ["pallas", "bvh"])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_remat_grads_bitwise(cornell, backend, sort_rays):
    cam = P.Camera.default(device="cpu")
    out = {}
    for remat in (False, True):
        cfg = P.RenderConfig(width=32, height=32, bounces=3, backend=backend,
                             sort_rays=sort_rays, remat=remat)
        loss, gs, gc = pgrad.loss_and_grads(cornell, cam, cfg, lambda im: im.mean())
        out[remat] = (loss, _all_leaves(gs, gc))
    assert torch.equal(out[False][0], out[True][0])
    _assert_bitwise(out[False][1], out[True][1])
    kd = dict(out[True][1])["materials.diffuse"]
    assert torch.isfinite(kd).all() and kd.abs().sum() > 0


@pytest.mark.parametrize("sort_rays", [False, True])
def test_remat_grads_bitwise_adjoint_route(cornell, monkeypatch, sort_rays):
    """remat on and off give bitwise equal losses and gradients where every
    bounce takes the adjoint route (the autograd Function of
    ops/cuda/shade.py, here with its plain versions): the Function saves
    its inputs, and the recompute hands it the same ones."""
    from mini_opencl_raytracer_tpu_torch.ops.cuda import shade
    calls = []
    real = shade.shade_grad
    monkeypatch.setattr(pint, "shading_route",
                        lambda cfg, o, grad, n: "adjoint" if grad else "plain")
    monkeypatch.setattr(shade, "shade_grad", lambda *a, **k: calls.append(a[8]) or real(*a, **k))
    cam = P.Camera.default(device="cpu")
    out = {}
    for remat in (False, True):
        cfg = P.RenderConfig(width=32, height=32, bounces=3, backend="pallas",
                             sort_rays=sort_rays, remat=remat)
        loss, gs, gc = pgrad.loss_and_grads(cornell, cam, cfg, lambda im: im.mean())
        out[remat] = (loss, _all_leaves(gs, gc))
    assert sorted(calls) == sorted(list(range(3)) * 3)   # remat off once, on twice
    assert torch.equal(out[False][0], out[True][0])
    _assert_bitwise(out[False][1], out[True][1])
    kd = dict(out[True][1])["materials.diffuse"]
    assert torch.isfinite(kd).all() and kd.abs().sum() > 0


@pytest.mark.parametrize("sort_rays", [False, True])
def test_make_bounce_step_remat_bitwise(cornell, sort_rays):
    """Two steps of make_bounce_step, differentiated w.r.t. the scene's
    float leaves and the rays, with remat on and off."""
    grads = {}
    for remat in (False, True):
        cfg = P.RenderConfig(width=16, height=16, bounces=2, backend="bruteforce",
                             shadow_rays=True, sort_rays=sort_rays, remat=remat)
        leaves = {k: v.detach().requires_grad_() for k, v in pgrad._leaves(cornell)
                  if v.is_floating_point()}
        scene = pgrad._rebuild(cornell, leaves)
        ids = torch.arange(cfg.num_pixels, dtype=torch.int32)
        seeds = prng.pixel_seeds(ids, 3)
        o, d = generate_rays(P.Camera.default(device="cpu"), cfg, ids, seeds)
        o, d = o.requires_grad_(), d.requires_grad_()
        step = pint.make_bounce_step(scene, cfg, *P.make_intersectors(scene, cfg))
        carry = (o, d, torch.ones_like(o), torch.zeros_like(o),
                 torch.ones((o.shape[0],), dtype=torch.bool), seeds)
        for b in range(2):
            carry, _ = step(carry, b)
        loss = carry[3].sum() + 0.5 * carry[2].sum() + carry[1].sum()
        grads[remat] = torch.autograd.grad(loss, [o, d] + list(leaves.values()),
                                           allow_unused=True)
    for a, b in zip(grads[False], grads[True]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_no_checkpoint_without_a_gradient(cornell, monkeypatch):
    """A forward with no gradient to take runs no checkpoint."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint called where no gradient is taken")

    monkeypatch.setattr(pint, "checkpoint", refuse)
    cam = P.Camera.default(device="cpu")
    cfg = P.RenderConfig(width=16, height=16, bounces=3, backend="pallas", sort_rays=True)
    with torch.no_grad():
        a = P.render_sample(cornell, cam, cfg)
    b = P.render_sample(cornell, cam, cfg)   # grad mode on, nothing requires grad
    c = P.render_sample(cornell, cam, dataclasses.replace(cfg, remat=False))
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(AssertionError, match="checkpoint called"):
        pgrad.loss_and_grads(cornell, cam, cfg, lambda im: im.mean())


@pytest.mark.parametrize("sort_rays", [False, True])
def test_remat_grads_match_jax(sort_rays):
    js = J.cornell_scene()
    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    kw = dict(width=16, height=16, bounces=2, backend="bruteforce", sort_rays=sort_rays,
              remat=True)
    _, g_p, c_p = pgrad.loss_and_grads(ps, P.Camera.default(device="cpu"),
                                       P.RenderConfig(**kw), lambda img: img.mean())
    jcfg = J.RenderConfig(**kw)
    g_j, c_j = jgrad.grad_float_leaves(
        lambda sc: jgrad.render_loss(sc[0], sc[1], jcfg, lambda img: jnp.mean(img)),
        (js, J.Camera.default()))
    _compare_trees(g_p, g_j)
    _compare_trees(c_p, c_j)
    assert np.abs(g_p.materials.diffuse.numpy()).max() > 0
