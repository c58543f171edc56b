"""The wavefront's ray generation (ops/cuda/raygen.py: csrc/raygen.cu) on
the CPU: the route rule of ``camera_rays``, its plain route bitwise
``rng.pixel_seeds`` + ``generate_rays`` (tile-ordered and scanline ids, int
and tensor frames, no rays), the wrapper's checks, and the kernel's launch
with a stand-in library: its arguments, its counts, and a compiled
program's replays carrying its rays into ``jit.COUNTS``. The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py -k
raygen, chip_smoke.py phase 21).
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import jit as pjit
from mini_opencl_raytracer_tpu_torch.ops import rng
from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
from mini_opencl_raytracer_tpu_torch.ops.cuda import build, megakernel, raygen
from mini_opencl_raytracer_tpu_torch.render import _swizzled_ids

CPU = torch.device("cpu")


def _camera(dtype=torch.float32, grad: bool = False):
    cam = P.Camera.from_angles((0.5, -20.0, 7.0), pitch=1.4, yaw=1.7, dtype=dtype, device=CPU)
    if grad:
        cam = dataclasses.replace(cam, position=cam.position.clone().requires_grad_())
    return cam


@pytest.mark.parametrize("case, route", [
    ("cuda", "fused"), ("cuda, no_grad", "fused"), ("cpu", "plain"),
    ("cuda, camera grad", "plain"), ("cuda, camera grad, no_grad", "fused"),
    ("cuda, float64 cfg", "plain"), ("cuda, float64 camera", "plain"),
    ("cpu, no_grad", "plain")])
def test_route_rule(case, route):
    """Fused for ids on a CUDA device, a float32 configuration and camera,
    and no gradient taken of the camera: grad mode off, or no camera leaf
    that requires grad. Anything else runs in PyTorch."""
    cfg = P.RenderConfig(dtype="float64" if "float64 cfg" in case else "float32")
    cam = _camera(torch.float64 if "float64 camera" in case else torch.float32,
                  grad="camera grad" in case)
    ids = SimpleNamespace(is_cuda="cuda" in case)
    with torch.no_grad() if "no_grad" in case else contextlib.nullcontext():
        assert raygen.raygen_route(cam, cfg, ids) == route


def _ids(order: str, cfg):
    if order == "swizzled":
        return _swizzled_ids(cfg, CPU)
    if order == "scanline":
        return torch.arange(cfg.num_pixels, dtype=torch.int32)
    return torch.zeros((0,), dtype=torch.int32)


@pytest.mark.parametrize("order", ["swizzled", "scanline", "no rays"])
@pytest.mark.parametrize("frame", [0, 7, 2**32 + 3, "tensor"])
def test_camera_rays_are_the_plain_pair(order, frame):
    """On the CPU ``camera_rays`` (and ``raygen_fused``'s plain version) give
    ``pixel_seeds`` + ``generate_rays``' seeds, origins and directions bit
    for bit; a 0-d tensor frame gives its int's bits."""
    cfg = P.RenderConfig(width=32, height=16)
    ids, cam = _ids(order, cfg), _camera()
    fr = torch.tensor(11, dtype=torch.int64) if frame == "tensor" else frame
    seeds = rng.pixel_seeds(ids, fr)
    o, d = generate_rays(cam, cfg, ids, seeds)
    for got in (raygen.camera_rays(cam, cfg, ids, fr), raygen.raygen_fused(cam, cfg, ids, fr)):
        assert all(torch.equal(a, b) for a, b in zip(got, (o, d, seeds)))
        assert got[2].dtype == torch.int64 and got[0].shape == (ids.shape[0], 3)
    if frame == "tensor":
        assert all(torch.equal(a, b) for a, b in zip(raygen.camera_rays(cam, cfg, ids, 11),
                                                      (o, d, seeds)))


def test_camera_rays_take_a_camera_gradient():
    """The plain route is differentiable in the camera: every leaf gets a
    finite gradient from the directions."""
    cfg = P.RenderConfig(width=16, height=8)
    cam = P.Camera.default(device=CPU)
    cam = P.Camera(*(t.clone().requires_grad_() for t in (cam.position, cam.front, cam.up)))
    o, d, _ = raygen.camera_rays(cam, cfg, _ids("swizzled", cfg), 2)
    (o.sum() + (d * torch.linspace(0.0, 1.0, 3)).sum()).backward()
    for t in (cam.position, cam.front, cam.up):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert torch.equal(cam.position.grad, torch.full((3,), float(cfg.num_pixels)))


@pytest.mark.parametrize("case, error", [
    ("camera grad", ValueError), ("float64 cfg", TypeError), ("int64 ids", TypeError),
    ("strided ids", ValueError), ("float64 camera", TypeError)])
def test_fused_wrapper_checks(case, error):
    """``raygen_fused`` takes int32 contiguous ids, a float32 configuration
    and camera, and nothing that requires grad."""
    cfg = P.RenderConfig(width=16, height=8, dtype="float64" if "cfg" in case else "float32")
    cam = _camera(torch.float64 if "camera" in case and "grad" not in case else torch.float32,
                  grad="grad" in case)
    ids = torch.arange(2 * cfg.num_pixels, dtype=torch.int32)[::2]
    if case != "strided ids":
        ids = ids.contiguous().to(torch.int64 if case == "int64 ids" else torch.int32)
    with pytest.raises(error):
        raygen.raygen_fused(cam, cfg, ids, 0)


class _Library:
    """The library's place: ``mrt_raygen`` records the params' ray count and
    width, and its pointers and stream."""

    def __init__(self):
        self.calls = []

    def mrt_raygen(self, p, *args):
        q = megakernel._Params.from_address(p)
        self.calls.append(((q.num_rays, q.width, q.rg_jx), args))
        return 0


STREAM = 42


def _stand_ins(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "_on", lambda device: contextlib.nullcontext(STREAM))
    return lib


def test_launch_passes_its_arguments_and_counts(monkeypatch):
    """The launch hands the entry the params, the frame's word, the camera
    vector, the ids, the seeds and the directions, then the stream, and
    gives the origin as the camera's position expanded; it counts one
    launch and R rays generated by the kernel, and nothing for R = 0."""
    lib = _stand_ins(monkeypatch)
    cfg = P.RenderConfig(width=32, height=16)
    ids, cam = _ids("swizzled", cfg), _camera()
    before = dict(build.LAUNCHES), dict(build.RAYS)
    o, d, seeds = raygen._launch(cam, cfg, ids, 5)
    ((head, args),) = lib.calls
    assert head == (cfg.num_pixels, cfg.width, rng.premix(rng.SITE_JITTER_X))
    assert args[2:] == (ids.data_ptr(), seeds.data_ptr(), d.data_ptr(), STREAM)
    assert (o.shape, d.shape, seeds.shape, seeds.dtype) == (
        (cfg.num_pixels, 3), (cfg.num_pixels, 3), (cfg.num_pixels,), torch.int64)
    assert d.is_contiguous() and o.stride() == (0, 1)
    assert o.data_ptr() == cam.position.data_ptr()
    raygen._launch(cam, cfg, _ids("no rays", cfg), 5)
    assert len(lib.calls) == 1
    assert build.LAUNCHES["raygen"] == before[0]["raygen"] + 1
    assert build.RAYS == before[1] | {"raygen_fused": before[1]["raygen_fused"] + cfg.num_pixels}


class _StandInGraph:
    """torch.cuda.CUDAGraph's place: a replay runs nothing."""

    def replay(self):
        pass


def test_replays_carry_the_kernel_rays(monkeypatch):
    """A compiled program around the launch, captured as if on CUDA: the
    warm-up counts its rays in ``build.RAYS`` alone, each of three replays
    adds its launch and rays to ``RAYS`` and to ``jit.COUNTS`` as
    ``raygen_fused_rays``; ``raygen_plain_rays`` stays 0."""
    _stand_ins(monkeypatch)
    real_key = pjit.Compiled.key

    def key(self, *args, **kwargs):
        k, leaves, types, _ = real_key(self, *args, **kwargs)
        cuda = torch.device("cuda", 0)
        return k[:4] + (cuda,) + k[5:], leaves, types, cuda

    monkeypatch.setattr(pjit.Compiled, "key", key)
    monkeypatch.setattr(pjit, "_capture", lambda graph, device, mode: contextlib.nullcontext())
    monkeypatch.setattr(pjit, "_sync", lambda device: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    cfg = P.RenderConfig(width=32, height=16)
    ids, cam = _ids("swizzled", cfg), _camera()
    prog = pjit.jit(lambda camera, pixel_ids: raygen._launch(camera, cfg, pixel_ids, 1))
    prog(cam, ids)
    before = dict(build.LAUNCHES), dict(build.RAYS), dict(pjit.COUNTS)
    for _ in range(3):
        prog(cam, ids)
    R = cfg.num_pixels
    assert build.LAUNCHES["raygen"] - before[0]["raygen"] == 3
    assert build.RAYS["raygen_fused"] - before[1]["raygen_fused"] == 3 * R
    assert pjit.COUNTS["raygen_fused_rays"] - before[2]["raygen_fused_rays"] == 3 * R
    assert pjit.COUNTS["raygen_plain_rays"] == before[2]["raygen_plain_rays"]


def test_render_on_the_cpu_counts_no_rays():
    """A wavefront render on the CPU runs the plain route and counts
    nothing."""
    scene = P.bunny_scene(target_tris=4000, device=CPU)
    cfg = P.RenderConfig(width=16, height=8, bounces=1)
    before = dict(build.RAYS)
    img = P.render(scene, P.Camera.default(device=CPU), cfg, frames=2,
                   accel=P.build_accel(scene, cfg))
    assert build.RAYS == before and torch.isfinite(img).all()
