"""The port's render entry points against the JAX package's on the CPU.

``render_sample``, ``render_radiance`` and ``render`` of Cornell through
the mega path (the plain versions of the two bounce kernels, since the
tensors are on the CPU) against JAX ``backend="mega"`` (Pallas in
interpret mode), at 32x32 with 3 bounces (tile-swizzled pixel order) and
40x30 with 2 bounces (not tile-aligned: scanline order). Tolerance atol
2e-5, rtol 1e-4, as in tests/test_megakernel.py: the same float32 math in
another operation order, with transcendentals from other libraries.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu as J
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk
from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids, _unswizzle_image

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
SIZES = [(32, 32, 3), (40, 30, 2)]


def _arrays(jscene):
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


@pytest.fixture(scope="module")
def scenes():
    js = J.cornell_scene()
    return js, P.scene_from_numpy(_arrays(js), device="cpu")


def _cfgs(size, **kw):
    w, h, b = size
    return (J.RenderConfig(width=w, height=h, bounces=b, backend="mega", **kw),
            P.RenderConfig(width=w, height=h, bounces=b, backend="mega", **kw))


@pytest.mark.parametrize("size", SIZES)
def test_render_sample_matches_jax(scenes, size):
    js, ps = scenes
    jc, pc = _cfgs(size)
    ref = np.asarray(J.render_sample(js, J.Camera.default(), jc, frame=3))
    got = P.render_sample(ps, P.Camera.default(device="cpu"), pc, frame=3)
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("size", SIZES)
def test_render_radiance_matches_jax(scenes, size):
    js, ps = scenes
    jc, pc = _cfgs(size, spp=2)
    ref = np.asarray(J.render_radiance(js, J.Camera.default(), jc, frames=2))
    got = P.render_radiance(ps, P.Camera.default(device="cpu"), pc, frames=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("size", SIZES)
def test_render_gamma_matches_jax(scenes, size):
    js, ps = scenes
    jc, pc = _cfgs(size)
    ref = np.asarray(J.render(js, J.Camera.default(), jc, frames=2))
    got = P.render(ps, P.Camera.default(device="cpu"), pc, frames=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    # Upright Cornell box: red wall left, green wall right.
    img = got.numpy()
    third = size[0] // 3
    left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
    assert left[0] > left[1] and right[1] > right[0]


def test_unfused_raygen_matches_jax(scenes):
    """fused_raygen=False: host raygen + trace_paths_mega (bounce_fwd for
    every bounce), with shadow rays and a prebuilt accel."""
    js, ps = scenes
    jc, pc = _cfgs((32, 16, 2), fused_raygen=False, shadow_rays=True)
    ref = np.asarray(J.render_sample(js, J.Camera.default(), jc, frame=1))
    accel = P.build_accel(ps, pc)
    assert tuple(accel.shape) == (36, 9)
    got = P.render_sample(ps, P.Camera.default(device="cpu"), pc, frame=1, accel=accel)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bruteforce_matches_jax_bruteforce(scenes):
    """The plain integrator (backend="bruteforce") against the JAX oracle,
    with shadow rays and direct specular."""
    js, ps = scenes
    kw = dict(width=16, height=16, bounces=2, backend="bruteforce",
              shadow_rays=True, direct_specular=True)
    ref = np.asarray(J.render_sample(js, J.Camera.default(), J.RenderConfig(**kw)))
    got = P.render_sample(ps, P.Camera.default(device="cpu"), P.RenderConfig(**kw))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bruteforce_renders_on_any_device(scenes):
    """The bruteforce oracle is plain torch and runs on the test's device (a
    CUDA device where there is one): it renders, and agrees with mega."""
    _, ps = scenes
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    kw = dict(width=16, height=16, bounces=2, shadow_rays=True)
    brute = P.render_sample(ps, P.Camera.default(device="cpu"), P.RenderConfig(backend="bruteforce", **kw),
                            device=dev)
    mega = P.render_sample(ps, P.Camera.default(device="cpu"), P.RenderConfig(backend="mega", **kw),
                           device=dev)
    assert brute.device.type == dev.type and brute.shape == (16, 16, 3)
    np.testing.assert_allclose(brute.cpu().numpy(), mega.cpu().numpy(), atol=ATOL, rtol=RTOL)


def test_zero_bounces_black_and_no_launch(scenes):
    _, ps = scenes
    before = dict(pmk.LAUNCHES)
    for backend in ("mega", "bruteforce"):
        cfg = P.RenderConfig(width=16, height=8, bounces=0, backend=backend)
        img = P.render_sample(ps, P.Camera.default(device="cpu"), cfg)
        assert img.shape == (8, 16, 3)
        assert torch.count_nonzero(img) == 0
    assert pmk.LAUNCHES == before


def test_swizzle_roundtrip():
    cfg = P.RenderConfig(width=48, height=32)
    ids = _swizzled_ids(cfg, "cpu")
    fake = torch.stack([ids.to(torch.float32)] * 3, dim=-1)
    img = _unswizzle_image(fake, cfg)
    expect = np.arange(cfg.num_pixels, dtype=np.float32).reshape(32, 48)
    np.testing.assert_array_equal(img[..., 0].numpy(), expect)
    assert sorted(ids.tolist()) == list(range(cfg.num_pixels))
    assert _swizzled_ids(P.RenderConfig(width=50, height=30), "cpu") is None
