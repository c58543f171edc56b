"""The port's shell and utilities (``cli.py``, ``utils/*``,
``ops/intersect.shading_point``, ``trace_paths(with_stats=True)``) on the
CPU, against the JAX package where both compute the same thing.

The eleven cases of tests/test_utils.py, adapted: the CLI case runs in
process through ``cli.main([..., "--device", "cpu"])`` at 32x32 x 2 on
bruteforce. Then: a checkpoint written by JAX's ``save_render_state``
resumes in the port's CLI and one written by the port's CLI resumes in
JAX's render loop (resumed radiance within atol 2e-5, rtol 1e-4, as
tests/test_torch_render.py: the same float32 shading in another
operation order); pytrees cross between the packages by key path;
``shading_point`` and ``bounce_occupancy`` against JAX's on the same
scene and seed.
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu.utils import checkpoint as jckpt
from mini_opencl_raytracer_tpu.utils.metrics import bounce_occupancy as j_occupancy
from mini_opencl_raytracer_tpu_torch import cli
from mini_opencl_raytracer_tpu_torch.ops.intersect import shading_point
from mini_opencl_raytracer_tpu_torch.utils import checkpoint as ckpt
from mini_opencl_raytracer_tpu_torch.utils import errors
from mini_opencl_raytracer_tpu_torch.utils.image import (_write_png_pure, to_uint8, write_npy,
                                                         write_pfm, write_png)
from mini_opencl_raytracer_tpu_torch.utils.metrics import (bounce_occupancy, render_metrics,
                                                           scan_frames, time_fn,
                                                           time_scan_fn, time_scan_slope)

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
# The CLI's render: Cornell, default camera angles, 32x32 x 2, bruteforce.
CLI_ARGS = ["--width", "32", "--height", "32", "--bounces", "2", "--backend", "bruteforce",
            "--device", "cpu"]


def test_to_uint8_clips():
    assert to_uint8(np.array([[[-0.5, 0.5, 2.0]]])).tolist() == [[[0, 128, 255]]]
    assert to_uint8(torch.tensor([[[-0.5, 0.5, 2.0]]])).tolist() == [[[0, 128, 255]]]


def test_write_png_roundtrip(tmp_path):
    from PIL import Image
    img = torch.from_numpy(np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32))
    p = str(tmp_path / "x.png")
    write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), to_uint8(img))


def test_pure_png_writer(tmp_path):
    from PIL import Image
    img = np.random.default_rng(1).uniform(size=(4, 6, 3)).astype(np.float32)
    p = str(tmp_path / "pure.png")
    _write_png_pure(p, to_uint8(img))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), to_uint8(img))


def test_write_pfm(tmp_path):
    img = np.random.default_rng(2).uniform(size=(4, 5, 3)).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    write_pfm(p, torch.from_numpy(img))
    with open(p, "rb") as f:
        assert f.readline() == b"PF\n"
        assert f.readline() == b"5 4\n"
        assert f.readline() == b"-1.0\n"
        data = np.frombuffer(f.read(), "<f4").reshape(4, 5, 3)
    np.testing.assert_array_equal(data, img[::-1])
    q = str(tmp_path / "x.npy")
    write_npy(q, torch.from_numpy(img))
    np.testing.assert_array_equal(np.load(q), img)


def test_checkpoint_roundtrip(tmp_path):
    cfg = P.RenderConfig(width=8, height=8)
    state = P.RenderState(
        radiance_sum=torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3),
        num_samples=7)
    p = str(tmp_path / "state.npz")
    ckpt.save_render_state(p, state)
    with np.load(p) as data:   # the JAX package's format
        assert sorted(data.files) == [".num_samples", ".radiance_sum"]
        assert data[".num_samples"].dtype == np.int32 and data[".num_samples"].shape == ()
        assert data[".radiance_sum"].dtype == np.float32
    back = ckpt.load_render_state(p, P.RenderState.create(cfg, "cpu"))
    assert torch.equal(back.radiance_sum, state.radiance_sum)
    assert back.num_samples == 7 and isinstance(back.num_samples, int)


def test_checkpoint_shape_mismatch(tmp_path):
    p = str(tmp_path / "state.npz")
    ckpt.save_render_state(p, P.RenderState.create(P.RenderConfig(width=8, height=8), "cpu"))
    with pytest.raises(ValueError):
        ckpt.load_render_state(p, P.RenderState.create(P.RenderConfig(width=16, height=16),
                                                       "cpu"))
    with pytest.raises(KeyError):
        ckpt.load_pytree(p, {"other": torch.zeros(())})


def test_render_metrics():
    m = render_metrics(0.5, 100, 100, 4)
    assert m["rays_per_second"] == pytest.approx(100 * 100 * 4 / 0.5)
    assert m["fps"] == pytest.approx(2.0)


def _cli_camera():
    return P.Camera.from_angles([0.0, -25.0, 8.5], 1.571, 1.571, device="cpu")


def _cli_cfg():
    return P.RenderConfig(width=32, height=32, bounces=2, backend="bruteforce")


def _read_pfm(path):
    with open(path, "rb") as f:
        assert f.readline() == b"PF\n"
        w, h = (int(x) for x in f.readline().split())
        assert f.readline() == b"-1.0\n"
        return np.frombuffer(f.read(), "<f4").reshape(h, w, 3)[::-1]


def test_cli_render_and_resume(tmp_path, capsys):
    out, ck = str(tmp_path / "img.png"), str(tmp_path / "st.npz")
    base = ["render"] + CLI_ARGS + ["--frames", "2", "--out", out, "--checkpoint", ck]
    assert cli.main(base) == 0
    assert (tmp_path / "img.png").exists() and (tmp_path / "st.npz").exists()
    assert cli.main(base + ["--resume", ck]) == 0
    assert "resumed at 2 samples" in capsys.readouterr().err
    # The resumed state is the 4-frame render's, bitwise: the same frames
    # added in the same order.
    scene, cam, cfg = P.cornell_scene(device="cpu"), _cli_camera(), _cli_cfg()
    state = ckpt.load_render_state(ck, P.RenderState.create(cfg, "cpu"))
    assert state.num_samples == 4
    four = P.render(scene, cam, cfg, frames=4)
    assert torch.equal(P.to_image(state, cfg.gamma), four)
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(out)), to_uint8(four))
    # Each output format by its suffix: .npy the gamma image, .pfm the
    # linear mean.
    npy, pfm = str(tmp_path / "img.npy"), str(tmp_path / "img.pfm")
    resume = ["render"] + CLI_ARGS + ["--frames", "1", "--resume", ck]
    assert cli.main(resume + ["--out", npy]) == 0
    assert torch.equal(torch.from_numpy(np.load(npy)), P.render(scene, cam, cfg, frames=5))
    assert cli.main(resume + ["--out", pfm]) == 0
    np.testing.assert_array_equal(_read_pfm(pfm),
                                  P.render_radiance(scene, cam, cfg, frames=5).numpy())
    assert capsys.readouterr().err.count("resumed at 4 samples") == 2


def test_cli_refines_until_interrupted(tmp_path, capsys, monkeypatch):
    """--frames 0 refines until Ctrl-C, checkpointing every
    --checkpoint-every frames, and writes the image it has."""
    calls = {"n": 0}
    real = cli.render_sample

    def sample(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:
            raise KeyboardInterrupt
        return real(*a, **kw)

    monkeypatch.setattr(cli, "render_sample", sample)
    ck, out = str(tmp_path / "st.npz"), str(tmp_path / "img.npy")
    assert cli.main(["render"] + CLI_ARGS + ["--frames", "0", "--checkpoint", ck,
                                             "--checkpoint-every", "2", "--out", out]) == 0
    err = capsys.readouterr().err
    assert "2 samples (checkpointed)" in err and "interrupted at 3 samples" in err
    state = ckpt.load_render_state(ck, P.RenderState.create(_cli_cfg(), "cpu"))
    assert state.num_samples == 3 and np.load(out).shape == (32, 32, 3)


def test_cli_benchmark_and_optimize(capsys):
    assert cli.main(["benchmark"] + CLI_ARGS + ["--iters", "1", "--occupancy"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["backend"] == "bruteforce" and m["triangles"] == 36 and m["device"] == "cpu"
    assert m["rays_per_frame"] == 32 * 32 * 2 and m["seconds_per_frame"] > 0
    occ = m["live_ray_fraction_per_bounce"]
    assert len(occ) == 2 and 1 >= occ[0] >= occ[1] >= 0
    assert cli.main(["optimize"] + CLI_ARGS + ["--steps", "2", "--lr", "0.5"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["steps"] == 2 and np.isfinite(res["final_loss"]) and res["max_abs_err"] > 0
    assert "step    0 loss" in out.err and "step    1 loss" in out.err


def test_cli_without_a_card_raises_typed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.NoAcceleratorError, match="--device cpu"):
        cli.main(["render", "--width", "16", "--height", "16", "--device", "cuda"])


def test_decode_error_classes():
    """Failures this stack raises map to typed exceptions; unknown ones
    and non-runtime exception types pass through."""
    cases = [
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 GiB"),
         errors.DeviceOutOfMemoryError),
        (RuntimeError("bounce0_fwd: CUDA error 2 (out of memory)"),
         errors.DeviceOutOfMemoryError),
        (RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the "
                      "CUDA toolkit"), errors.KernelCompileError),
        (RuntimeError("nvcc failed (1):\nnvcc -c megakernel.cu\nerror"),
         errors.KernelCompileError),
        (RuntimeError("panel: CUDA error 209 (no kernel image is available for execution "
                      "on the device)"), errors.KernelCompileError),
        (RuntimeError("the device is 'cuda' and there is no CUDA device here; pass "
                      "device='cpu' to build on the CPU"), errors.NoAcceleratorError),
        (RuntimeError("clustered: CUDA error 100 (no CUDA-capable device is detected)"),
         errors.NoAcceleratorError),
        (ValueError("pixel count 1000 not divisible by the dp axis 8"), errors.ShardingError),
    ]
    for exc, cls in cases:
        e = errors.decode_error(exc)
        assert isinstance(e, cls), (exc, e)
        assert str(exc).splitlines()[0][:40] in str(e)
    assert errors.decode_error(ValueError("plain bug")) is None
    assert errors.decode_error(RuntimeError("panel: CUDA error 700 (an illegal memory "
                                            "access was encountered)")) is None
    assert errors.decode_error(KeyError("out of memory")) is None
    with pytest.raises(errors.DeviceOutOfMemoryError) as info:
        errors.run_decoded(lambda: (_ for _ in ()).throw(
            RuntimeError("CUDA out of memory while trying to allocate")))
    assert isinstance(info.value.__cause__, RuntimeError)
    with pytest.raises(ValueError, match="plain bug"):
        errors.run_decoded(lambda: (_ for _ in ()).throw(ValueError("plain bug")))


def test_bounce_occupancy():
    """Per-bounce live-ray fractions: in [0, 1] and non-increasing (paths
    only die, kernel_bvh.cl:371-372)."""
    cfg = P.RenderConfig(width=16, height=16, bounces=3, backend="bruteforce", ray_chunk=256)
    occ = bounce_occupancy(P.cornell_scene(device="cpu"), P.Camera.default(device="cpu"),
                           cfg).numpy()
    assert occ.shape == (3,)
    assert ((occ >= 0) & (occ <= 1)).all()
    assert (np.diff(occ) <= 1e-6).all()


def test_time_scan_slope_basic():
    """The slope harness returns the marginal per-frame cost of a frame with
    real work; scan_frames sums distinct frames."""
    def heavy(fr, data):
        x = data + float(fr)
        return torch.sum(x @ x)

    data = torch.ones((256, 256))
    sec = time_scan_slope(heavy, inner_lo=2, inner_hi=10, iters=3, data=data)
    assert 0.0 < sec < 1.0
    # 2 frames of sum(1 * fr) from base 3 -> (3 + 4) * 128.
    out = scan_frames(lambda fr, d: torch.sum(d * fr), 2)(3, torch.ones((128,)))
    assert float(out) == 128.0 * 7.0
    assert 0.0 < time_scan_fn(heavy, inner=2, iters=2, data=data) < 1.0
    seen = []
    assert time_fn(lambda i: seen.append(i) or torch.zeros(()), iters=3) >= 0.0
    assert seen == [1_000_000, 0, 1, 2]


# Against the JAX package.

def _jax_cfg():
    return J.RenderConfig(width=32, height=32, bounces=2, backend="bruteforce")


def _jax_frames(state, frames):
    scene, cfg = J.cornell_scene(), _jax_cfg()
    cam = J.Camera.from_angles([0.0, -25.0, 8.5], 1.571, 1.571)
    for f in frames:
        state = J.accumulate(state, J.render_sample(scene, cam, cfg, frame=f))
    return state


def test_jax_checkpoint_resumes_in_the_port_cli(tmp_path, capsys):
    ck, out = str(tmp_path / "jax.npz"), str(tmp_path / "img.pfm")
    jstate = _jax_frames(J.RenderState.create(_jax_cfg()), range(2))
    jckpt.save_render_state(ck, jstate)
    assert cli.main(["render"] + CLI_ARGS + ["--frames", "2", "--resume", ck,
                                             "--out", out]) == 0
    assert "resumed at 2 samples" in capsys.readouterr().err
    ref = np.asarray(_jax_frames(jstate, range(2, 4)).mean())
    np.testing.assert_allclose(_read_pfm(out), ref, atol=ATOL, rtol=RTOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    ck = str(tmp_path / "port.npz")
    assert cli.main(["render"] + CLI_ARGS + ["--frames", "2", "--checkpoint", ck,
                                             "--out", str(tmp_path / "img.png")]) == 0
    jstate = jckpt.load_render_state(ck, J.RenderState.create(_jax_cfg()))
    assert int(jstate.num_samples) == 2
    state = ckpt.load_render_state(ck, P.RenderState.create(_cli_cfg(), "cpu"))
    np.testing.assert_array_equal(np.asarray(jstate.radiance_sum), state.radiance_sum.numpy())
    ref = np.asarray(_jax_frames(jstate, range(2, 4)).mean())
    got = P.render_radiance(P.cornell_scene(device="cpu"), _cli_camera(), _cli_cfg(), frames=4)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_pytree_keys_cross_packages(tmp_path):
    """A port scene saved by save_pytree loads with JAX's load_pytree into
    a JAX scene, and back: the same key paths."""
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    pscene = P.cornell_scene(device="cpu")
    ckpt.save_pytree(p, {"scene": pscene, "steps": [torch.tensor(3), torch.ones(2)]})
    jtmpl = {"scene": J.cornell_scene(), "steps": [jnp.int32(0), jnp.zeros(2)]}
    jtree = jckpt.load_pytree(p, jtmpl)
    np.testing.assert_array_equal(np.asarray(jtree["scene"].geometry.v2),
                                  pscene.geometry.v2.numpy())
    assert int(jtree["steps"][0]) == 3
    jckpt.save_pytree(q, jtree)
    back = ckpt.load_pytree(q, {"scene": pscene, "steps": [torch.tensor(0), torch.zeros(2)]})
    assert torch.equal(back["scene"].materials.diffuse, pscene.materials.diffuse)
    assert back["steps"][0].item() == 3 and torch.equal(back["steps"][1], torch.ones(2))


def test_shading_point_matches_jax():
    from mini_opencl_raytracer_tpu.ops.intersect import shading_point as j_shading_point
    r = np.random.default_rng(8)
    o = r.uniform([-7, -20, 1], [7, 19, 16], size=(256, 3)).astype(np.float32)
    d = r.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    js, ps = J.cornell_scene(), P.cornell_scene(device="cpu")
    jh = J.intersect_brute(jnp.asarray(o), jnp.asarray(d), js.geometry, t_max=1e5)
    ph = P.intersect_brute(torch.from_numpy(o), torch.from_numpy(d), ps.geometry, t_max=1e5)
    np.testing.assert_array_equal(ph.tri_idx.numpy(), np.asarray(jh.tri_idx))
    ref = j_shading_point(jnp.asarray(o), jnp.asarray(d), jh, js.geometry)
    got = shading_point(torch.from_numpy(o), torch.from_numpy(d), ph, ps.geometry)
    assert ph.hit.any() and not ph.hit.all()
    for f in dataclasses.fields(got):
        g, want = getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert g.shape == want.shape and g.dtype == want.dtype, f.name
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=1e-5, err_msg=f.name)


@pytest.mark.parametrize("backend", ["bruteforce", "bvh"])
def test_bounce_occupancy_matches_jax(backend):
    kw = dict(width=16, height=16, bounces=4, backend=backend)
    ref = np.asarray(j_occupancy(J.cornell_scene(), J.Camera.default(), J.RenderConfig(**kw)))
    got = bounce_occupancy(P.cornell_scene(device="cpu"), P.Camera.default(device="cpu"),
                           P.RenderConfig(**kw))
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_trace_paths_stats_do_not_change_radiance():
    """with_stats=True returns the same radiance (sorted and unsorted
    wavefronts) and one fraction per bounce; zero bounces give none."""
    from mini_opencl_raytracer_tpu_torch.ops import rng
    from mini_opencl_raytracer_tpu_torch.ops.camera import generate_rays
    from mini_opencl_raytracer_tpu_torch.ops.integrator import trace_paths
    scene, cam = P.cornell_scene(device="cpu"), P.Camera.default(device="cpu")
    for sort_rays, bounces in ((False, 3), (True, 3), (True, 1), (False, 0)):
        cfg = P.RenderConfig(width=16, height=16, bounces=bounces, backend="bruteforce",
                             sort_rays=sort_rays)
        pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
        seeds = rng.pixel_seeds(pix, 2)
        o, d = generate_rays(cam, cfg, pix, seeds)
        inter = P.make_intersectors(scene, cfg)
        plain = trace_paths(scene, cfg, o, d, seeds, *inter)
        rad, stats = trace_paths(scene, cfg, o, d, seeds, *inter, with_stats=True)
        assert torch.equal(rad, plain) and stats.shape == (bounces,)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port (nor chip_smoke.py) imports JAX or the JAX
    package: by source, and by what importing every module loads."""
    import pathlib
    import re
    import subprocess
    import sys
    root = pathlib.Path(P.__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|mini_opencl_raytracer_tpu)(\.|\s|$)")
    files = sorted((root / "mini_opencl_raytracer_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    bad = [f"{f.name}:{i + 1}" for f in files
           for i, line in enumerate(f.read_text().splitlines()) if pattern.match(line)]
    assert not bad, bad
    mods = sorted(".".join(f.relative_to(root).with_suffix("").parts)
                  for f in files[:-1] if f.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'mini_opencl_raytracer_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=root, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
