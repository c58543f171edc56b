"""The port's compiled programs (jit.py) and tensor frames on the CPU,
against the JAX package.

On the CPU a compiled call runs its function eagerly, so these tests hold
what the graphs are built from: a frame given as a 0-d tensor renders
bitwise what the same int frame renders (seeds and images, on ``mega``,
``pallas`` through the panel and the cluster traversal, and
``bruteforce``; spp = 2 across the 2**32 wrap), and the same images as
JAX's ``jax.jit(render_sample)`` with the frame traced, and JAX's jitted
``render``, within atol 2e-5 / rtol 1e-4 (as tests/test_torch_render.py:
the same float32 math in another operation order); ``direct_light`` on
point, directional and spot lights against JAX's; the key of a compiled
call; and the tree flattening that copies a call's tensors into a
graph's inputs. 32x32 with at most 4 bounces. The graphs themselves
run on the card: tests/test_torch_cuda.py (marked ``cuda``) and
chip_smoke.py phases 15a and 16.

The rule of when a call is compiled, on a gloo group of one process in
this process: ``comm.Axis.capturable`` is false for a gloo group and true
for NCCL; ``jit`` captures only tensors on CUDA whose groups are all
NCCL, runs a gloo group on CUDA eagerly and says so once on stderr. With
the backend name set to "nccl", a CUDA device put into the key and a
stand-in for the graph (its capture runs the function, its replay
nothing), three replays of ``render_sample_dp`` and ``train_step_dp`` add
three eager calls' collective bytes (``comm.BYTES``).

The spans and counts of a compiled call, with the same stand-in: under
a CPU-only ``torch.profiler``, a warm-up and a capture, then three
replays, each ``mrt.jit.call`` holding its key, copy-in, launch and
outputs in that order; with no profiler no range is built; ``COUNTS``
adds the warm-up, the capture, the replays and their input bytes, counts
calls on the CPU as eager, and survives ``clear()``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import mini_opencl_raytracer_tpu as J
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu.models.procedural import bunny_scene as jbunny
from mini_opencl_raytracer_tpu.ops import lights as jlights
from mini_opencl_raytracer_tpu.ops import rng as jrng
from mini_opencl_raytracer_tpu_torch import jit as pjit
from mini_opencl_raytracer_tpu_torch.ops import lights as plights
from mini_opencl_raytracer_tpu_torch.ops import rng as prng
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.parallel import comm, shard
from mini_opencl_raytracer_tpu_torch.parallel import mesh as pmesh
from mini_opencl_raytracer_tpu_torch.utils import metrics

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
CPU = "cpu"
U32_MAX = 2**32 - 1
# (frame, spp): 0, 7 and the largest u32 at one sample; spp = 2 from
# frame 2**31 (samples 2**32 and 2**32 + 1 wrap to 0 and 1) and from the
# largest u32.
FRAMES = [(0, 1), (7, 1), (U32_MAX, 1), (2**31, 2), (U32_MAX, 2)]
# Backends and their scenes: Cornell on the mega kernels' plain versions,
# on the panel's (pallas, 36 triangles) and on the oracle; the bunny (3880
# triangles) on the cluster traversal's.
BACKENDS = [("mega", "cornell", 3), ("pallas", "cornell", 3), ("bruteforce", "cornell", 2),
            ("pallas", "bunny", 2)]


def _arrays(jscene):
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, js in (("cornell", J.cornell_scene()), ("bunny", jbunny(target_tris=4000))):
        out[name] = (js, P.scene_from_numpy(_arrays(js), device=CPU))
    return out


def _cfgs(backend, bounces, spp=1, size=32):
    kw = dict(width=size, height=size, bounces=bounces, backend=backend, spp=spp)
    return J.RenderConfig(**kw), P.RenderConfig(**kw)


def _frame(f):
    return torch.tensor(f, dtype=torch.int64)


@pytest.mark.parametrize("frame,spp", FRAMES)
def test_tensor_frame_seeds_bitwise(frame, spp):
    """Seeds of a tensor frame equal the int frame's and JAX's uint32
    arithmetic, sample by sample; premix_t equals premix."""
    pix = np.arange(512, dtype=np.uint32)
    tpix = torch.from_numpy(pix.astype(np.int64))
    for s in range(spp):
        fr_int = prng.sample_frame(frame, spp, s)
        fr_t = prng.sample_frame(_frame(frame), spp, s)
        assert fr_t.dim() == 0 and int(fr_t) == fr_int
        jfr = jnp.uint32(frame) * jnp.uint32(spp) + jnp.uint32(s)
        assert int(jfr) == fr_int
        assert int(prng.premix_t(fr_t)) == prng.premix(fr_int)
        got = prng.pixel_seeds(tpix, fr_t)
        assert torch.equal(got, prng.pixel_seeds(tpix, fr_int))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jrng.pixel_seeds(jnp.asarray(pix), jfr))
                                      .astype(np.int64))


@pytest.mark.parametrize("backend,scene,bounces", BACKENDS)
@pytest.mark.parametrize("frame,spp", FRAMES)
def test_tensor_frame_image_bitwise(scenes, backend, scene, bounces, frame, spp):
    """render_sample at a tensor frame is bitwise the int frame's image."""
    _, ps = scenes[scene]
    _, pc = _cfgs(backend, bounces, spp)
    cam = P.Camera.default(device=CPU)
    ref = P.render_sample(ps, cam, pc, frame=frame)
    got = P.render_sample(ps, cam, pc, frame=_frame(frame))
    assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def jax_samples(scenes):
    """jax.jit(render_sample) with the frame as a traced argument, one
    executable per (backend, scene, spp)."""
    cache = {}

    def get(backend, scene, bounces, spp):
        key = (backend, scene, spp)
        if key not in cache:
            js = scenes[scene][0]
            jc, _ = _cfgs(backend, bounces, spp)
            cache[key] = jax.jit(lambda f: J.render_sample(js, J.Camera.default(), jc,
                                                           frame=f))
        return cache[key]

    return get


@pytest.mark.parametrize("backend,scene,bounces", BACKENDS)
@pytest.mark.parametrize("frame,spp", [(7, 1), (U32_MAX, 1), (2**31, 2)])
def test_tensor_frame_matches_jax_jit(scenes, jax_samples, backend, scene, bounces, frame,
                                      spp):
    _, ps = scenes[scene]
    _, pc = _cfgs(backend, bounces, spp)
    ref = np.asarray(jax_samples(backend, scene, bounces, spp)(jnp.uint32(frame)))
    got = P.render_sample(ps, P.Camera.default(device=CPU), pc, frame=_frame(frame))
    assert got.shape == (32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("backend,bounces", [("mega", 4), ("pallas", 3)])
def test_render_frames_matches_jax_render(scenes, backend, bounces):
    """render(frames=3), the compiled entry point (eager on the CPU),
    against JAX's jitted render."""
    js, ps = scenes["cornell"]
    jc, pc = _cfgs(backend, bounces)
    ref = np.asarray(J.render(js, J.Camera.default(), jc, frames=3))
    got = P.render(ps, P.Camera.default(device=CPU), pc, frames=3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def _mixed_lights(lib, rs):
    """A point, a directional and a spot light, then a second point: numpy
    values from ``rs``, built with ``lib`` (J or P)."""
    kinds = np.array([P.LIGHT_POINT, P.LIGHT_DIRECTIONAL, P.LIGHT_SPOT, P.LIGHT_POINT],
                     np.int32)
    n = len(kinds)
    vals = dict(position=rs.uniform(-8.0, 16.0, (n, 3)), direction=rs.normal(size=(n, 3)),
                light_type=kinds, intensity=rs.uniform(2.0, 16.0, n),
                attenuation=rs.uniform(0.05, 0.8, n), cos_cutoff=rs.uniform(0.5, 0.95, n))
    vals = {k: v if k == "light_type" else v.astype(np.float32) for k, v in vals.items()}
    if lib is J:
        return J.Lights(**{k: jnp.asarray(v) for k, v in vals.items()})
    return P.Lights(**{k: torch.from_numpy(v) for k, v in vals.items()})


@pytest.mark.parametrize("direct_specular", [False, True])
def test_direct_light_mixed_types_matches_jax(direct_specular):
    rs = np.random.default_rng(21)
    R = 2048
    pos = rs.uniform(-8.0, 8.0, (R, 3)).astype(np.float32)
    nrm = rs.normal(size=(R, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = rs.normal(size=(R, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    ns = rs.uniform(1.0, 200.0, R).astype(np.float32)
    jl = _mixed_lights(J, np.random.default_rng(5))
    pl = _mixed_lights(P, np.random.default_rng(5))
    ref = jlights.direct_light(jl, *(jnp.asarray(a) for a in (pos, nrm, wo, ns)),
                               direct_specular=direct_specular)
    got = plights.direct_light(pl, *(torch.from_numpy(a) for a in (pos, nrm, wo, ns)),
                               direct_specular=direct_specular)
    for name in ("diffuse_weight", "specular_weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=RTOL)
    assert got.diffuse_weight.abs().max() > 0
    assert (got.specular_weight.abs().max() > 0) == direct_specular


def test_light_types_read_once_and_after_a_change(monkeypatch):
    """light_types reads a tensor once, and again after an in-place change."""
    lights = _mixed_lights(P, np.random.default_rng(1))
    assert plights.light_types(lights) == (1, 0, 2, 1)
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append(1) or real(t))
    assert plights.light_types(lights) == (1, 0, 2, 1) and not reads
    lights.light_type[1] = P.LIGHT_SPOT
    assert plights.light_types(lights) == (1, 2, 2, 1) and len(reads) == 1


def _program(scene, camera, accel, cfg):
    return P.render_sample(scene, camera, cfg, accel=accel)


def test_jit_key_follows_static_args_shapes_and_light_types(scenes):
    """The key changes with cfg, the triangle count and the light types,
    and not with the leaves' values."""
    prog = pjit.jit(_program, static_argnames=("cfg",))
    cornell, bunny = scenes["cornell"][1], scenes["bunny"][1]
    cam = P.Camera.default(device=CPU)
    cfg = P.RenderConfig(width=32, height=32, bounces=2)
    key = prog.key(cornell, cam, None, cfg)[0]
    assert prog.key(cornell, cam, None, cfg)[0] == key
    moved = dataclasses.replace(cornell, geometry=dataclasses.replace(
        cornell.geometry, v0=cornell.geometry.v0 + 1.0))
    brighter = dataclasses.replace(cornell, materials=dataclasses.replace(
        cornell.materials, diffuse=cornell.materials.diffuse * 0.5))
    assert prog.key(moved, cam, None, cfg)[0] == key
    assert prog.key(brighter, P.Camera.default(device=CPU), None, cfg)[0] == key
    assert prog.key(cornell, cam, None, dataclasses.replace(cfg, bounces=3))[0] != key
    assert prog.key(bunny, cam, None, cfg)[0] != key
    spot = dataclasses.replace(cornell, lights=dataclasses.replace(
        cornell.lights, light_type=torch.full_like(cornell.lights.light_type, P.LIGHT_SPOT)))
    assert prog.key(spot, cam, None, cfg)[0] != key
    # An accel tensor's shape is part of the key; its values are not.
    tris = P.build_accel(cornell, P.RenderConfig(backend="mega"))
    with_accel = prog.key(cornell, cam, tris, cfg)[0]
    assert with_accel != key and prog.key(cornell, cam, tris * 2.0, cfg)[0] == with_accel


def _same_tree(a, b):
    if isinstance(a, torch.Tensor):
        return a is b
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same_tree(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same_tree(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("accel", ["none", "mega", "clustered", "bvh"])
def test_flatten_roundtrip_is_identity(scenes, accel):
    """A (scene, camera, accel, frame) tree flattened into leaves and back
    is the same tree, every tensor in its place."""
    cornell, bunny = scenes["cornell"][1], scenes["bunny"][1]
    scene = bunny if accel == "clustered" else cornell
    acc = {"none": None,
           "mega": P.build_accel(cornell, P.RenderConfig(backend="mega")),
           "clustered": P.build_accel(bunny, P.RenderConfig()),
           "bvh": P.build_bvh(cornell.geometry)}[accel]
    tree = {"scene": scene, "camera": P.Camera.default(device=CPU), "accel": acc,
            "frame": _frame(3), "pair": (1, "x")}
    leaves, treedef = pjit.flatten(tree)
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    assert _same_tree(pjit.unflatten(treedef, leaves), tree)
    assert pjit.flatten(pjit.unflatten(treedef, leaves))[1] == treedef
    hash(treedef)


def test_compiled_call_on_the_cpu_runs_eagerly():
    """On the CPU a compiled call runs its function every time; arguments
    on two devices, or none, raise."""
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    prog = pjit.jit(fn, static_argnames=("k",))
    x = torch.arange(4.0)
    assert torch.equal(prog(x, 2), x * 2) and torch.equal(prog(x, k=3), x * 3)
    assert calls == [2, 3]
    with pytest.raises(ValueError, match="one device"):
        pjit.jit(lambda a: a)(1)
    with pytest.raises(ValueError, match="not parameters"):
        pjit.jit(fn, static_argnames=("y",))


def test_scan_frames_frames_are_base_plus_k():
    """scan_frames' frames are base, base + 1, ... (mod 2**32), as 0-d
    int64 tensors, and the call returns the sum of f's scalars."""
    seen = []

    def f(fr, data):
        seen.append(fr)
        return data * fr

    out = metrics.scan_frames(f, 3)(U32_MAX, torch.ones(()))
    assert [int(x) for x in seen] == [U32_MAX, 0, 1]
    assert all(x.dtype == torch.int64 and x.dim() == 0 for x in seen)
    assert float(out) == float(U32_MAX + 1)


@pytest.fixture(scope="module")
def mesh11():
    """A 1 x 1 (dp, tp) mesh over a gloo group of this process alone."""
    yield pmesh.single_device_mesh(P.MeshConfig(), device_type="cpu")
    dist.destroy_process_group()


class _StandInGraph:
    """torch.cuda.CUDAGraph's place on the CPU: the capture (``_capture``
    below) runs the function once, a replay runs nothing, so a replay
    returns the captured outputs and adds the captured counts."""

    def replay(self):
        pass


def _as_if_on_cuda(monkeypatch, backend: str):
    """jit sees ``backend`` groups and a CUDA device in the key; captures
    run eagerly into _StandInGraph. Returns the capture modes used."""
    modes = []
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    real_key = pjit.Compiled.key

    def key(self, *args, **kwargs):
        k, leaves, types, _ = real_key(self, *args, **kwargs)
        cuda = torch.device("cuda", 0)
        return k[:4] + (cuda,) + k[5:], leaves, types, cuda

    @contextlib.contextmanager
    def capture(graph, device, mode):
        modes.append(mode)
        yield

    monkeypatch.setattr(pjit.Compiled, "key", key)
    monkeypatch.setattr(pjit, "_capture", capture)
    monkeypatch.setattr(pjit, "_sync", lambda device: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    return modes


def test_axis_capturable_follows_the_backend(mesh11, monkeypatch):
    """A gloo group (the CPU mesh's) is not capturable and stages through
    host memory; an NCCL group is capturable and keeps its tensors."""
    for name in ("dp", "tp"):
        ax = comm.Axis(mesh11, name)
        assert (ax.backend, ax.capturable, ax.staged) == ("gloo", False, True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    ax = comm.Axis(mesh11, "dp")
    assert (ax.backend, ax.capturable, ax.staged) == ("nccl", True, False)


@pytest.mark.parametrize("backend,device,graph", [
    ("gloo", "cpu", False), ("nccl", "cpu", False), ("gloo", "cuda", False),
    ("nccl", "cuda", True)])
def test_capture_rule(mesh11, monkeypatch, capsys, backend, device, graph):
    """A graph only for tensors on CUDA whose groups are all NCCL, captured
    in thread_local mode; anything else runs eagerly at every call, and a
    gloo group on CUDA says so once on stderr."""
    if device == "cuda":
        modes = _as_if_on_cuda(monkeypatch, backend)
    else:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    calls = []

    def fn(x, mesh):
        calls.append(1)
        return comm.psum(x, comm.Axis(mesh, "dp"))

    prog = pjit.jit(fn, static_argnames=("mesh",))
    x = torch.arange(4.0)
    key = prog.key(x, mesh11)[0]
    assert key[6] == tuple((n, backend, backend == "nccl") for n in ("dp", "tp"))
    assert prog.captures(key) == graph
    for _ in range(3):
        assert torch.equal(prog(x, mesh11), x)
    assert len(prog._programs) == int(graph)
    assert len(calls) == (2 if graph else 3)
    if graph:
        assert modes == ["thread_local"]
    err = capsys.readouterr().err
    announced = err.count("fn runs eagerly on cuda:0: the groups of axes dp (gloo), tp (gloo)")
    assert announced == int(device == "cuda" and backend == "gloo"), err


@pytest.mark.parametrize("entry", ["render_sample_dp", "train_step_dp"])
def test_replays_add_the_captured_bytes(mesh11, monkeypatch, entry):
    """Three replays add three eager calls' collective bytes and return the
    eager call's outputs; the capture's own bytes are not counted."""
    _as_if_on_cuda(monkeypatch, "nccl")
    scene, cam = P.cornell_scene(device=CPU), P.Camera.default(device=CPU)
    cfg = P.RenderConfig(width=16, height=16, bounces=1, backend="bruteforce")
    call = {"render_sample_dp": lambda: shard.render_sample_dp(scene, cam, cfg, mesh11),
            "train_step_dp": lambda: shard.train_step_dp(scene, cam, cfg, mesh11,
                                                         grad_buckets=2)}[entry]
    compiled = shard.render_sample_dp if entry == "render_sample_dp" else shard._train_step_dp
    try:
        for k in comm.BYTES:
            comm.BYTES[k] = 0
        first = call()
        one = {k: v for k, v in comm.BYTES.items() if v}
        assert len(compiled._programs) == 1 and one
        for k in comm.BYTES:
            comm.BYTES[k] = 0
        outs = [call() for _ in range(3)]
        assert {k: v for k, v in comm.BYTES.items() if v} == {k: 3 * v for k, v in one.items()}
        la, da = pjit.flatten(first)
        for out in outs:
            lb, db = pjit.flatten(out)
            assert da == db and all(torch.equal(a, b) for a, b in zip(la, lb))
    finally:
        compiled.clear()


def test_disable_jit_runs_eagerly(mesh11, monkeypatch):
    """Inside disable_jit() a call that would be captured runs its
    function each time and makes no program."""
    _as_if_on_cuda(monkeypatch, "nccl")
    calls = []

    def fn(x, mesh):
        calls.append(1)
        return comm.psum(x, comm.Axis(mesh, "dp"))

    prog = pjit.jit(fn, static_argnames=("mesh",))
    with pjit.disable_jit():
        for _ in range(2):
            prog(torch.ones(3), mesh11)
    assert len(calls) == 2 and not prog._programs
    prog(torch.ones(3), mesh11)
    assert len(calls) == 4 and len(prog._programs) == 1


def _jit_spans(prof):
    """(name, start ns, end ns) of the trace's mrt.jit.* host ranges, in
    order of start."""
    rows = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("mrt.jit.")]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def _scaled(x, idx):
    """A compiled function of no group, so the backend that _as_if_on_cuda
    sets plays no part ("gloo": the profiler reads it at its start, and
    asks NCCL for its version under "nccl")."""
    return x * 2.0 + 1.0, idx + 1


def _deltas(before):
    return {k: pjit.COUNTS[k] - v for k, v in before.items()}


def test_spans_nest_in_order(monkeypatch):
    """A key's first call: warm-up then capture inside mrt.jit.call, the
    device synchronised before the warm-up, after it and after the
    capture; each replay: key, copy-in, launch and outputs inside its
    call, in that order, and no synchronisation."""
    from torch.profiler import ProfilerActivity, profile
    _as_if_on_cuda(monkeypatch, "gloo")
    syncs = []
    monkeypatch.setattr(pjit, "_sync", lambda device: syncs.append(str(device)))
    prog = pjit.jit(_scaled)
    x, idx = torch.arange(5.0), torch.arange(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog(x, idx)
        assert syncs == ["cuda:0"] * 3
        for _ in range(3):
            prog(x, idx)
    assert syncs == ["cuda:0"] * 3
    spans = _jit_spans(prof)
    replay = ["mrt.jit.call", "mrt.jit.key", "mrt.jit.copy_in", "mrt.jit.launch",
              "mrt.jit.outputs"]
    assert [n for n, _, _ in spans] == (["mrt.jit.call", "mrt.jit.key", "mrt.jit.warmup",
                                         "mrt.jit.capture"] + replay * 3)
    calls = [i for i, (n, _, _) in enumerate(spans) if n == "mrt.jit.call"]
    for i, j in zip(calls, calls[1:] + [len(spans)]):
        _, a, b = spans[i]
        kids = spans[i + 1:j]
        assert all(a <= ka <= kb <= b for _, ka, kb in kids)
        assert all(kids[k][2] <= kids[k + 1][1] for k in range(len(kids) - 1))
    assert spans[calls[0]][2] <= spans[calls[1]][1]


def test_no_profiler_builds_no_range(monkeypatch):
    """With no profiler recording, a span is the one shared no-op context
    and the range class is never called, on a capture, a replay or an
    eager call."""
    def refuse(name):
        raise AssertionError(f"range {name} built with no profiler")

    monkeypatch.setattr(pjit, "_RANGE", refuse)
    assert pjit._span("mrt.jit.call") is pjit._span("mrt.jit.key") is pjit._OFF
    x, idx = torch.arange(5.0), torch.arange(3)
    eager = pjit.jit(_scaled)
    assert torch.equal(eager(x, idx)[0], x * 2.0 + 1.0)
    _as_if_on_cuda(monkeypatch, "gloo")
    prog = pjit.jit(_scaled)
    for _ in range(3):
        assert torch.equal(prog(x, idx)[1], idx + 1)


def test_counts_of_warmup_capture_and_replays(monkeypatch):
    """COUNTS: one warm-up and one capture with their seconds, three
    replays that each copy both leaves' bytes in, no eager call; calls on
    the CPU count as eager, under a mrt.jit.eager span, and calls inside
    disable_jit() count nothing."""
    from torch.profiler import ProfilerActivity, profile
    x, idx = torch.arange(5.0), torch.arange(3)
    before = dict(pjit.COUNTS)
    cpu = pjit.jit(_scaled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cpu(x, idx)
        cpu(x, idx)
    with pjit.disable_jit():
        cpu(x, idx)
    assert _deltas(before) == dict.fromkeys(before, 0) | {"eager": 2}
    assert [n for n, _, _ in _jit_spans(prof)] == ["mrt.jit.call", "mrt.jit.key",
                                                    "mrt.jit.eager"] * 2
    _as_if_on_cuda(monkeypatch, "gloo")
    before = dict(pjit.COUNTS)
    prog = pjit.jit(_scaled)
    for _ in range(4):
        prog(x, idx)
    got = _deltas(before)
    assert got["warmup_s"] > 0 and got["capture_s"] > 0
    assert {k: v for k, v in got.items() if not k.endswith("_s")} == {
        "replays": 3, "copy_in_bytes": 3 * (x.nbytes + idx.nbytes), "copy_in_leaves": 6,
        "warmups": 1, "captures": 1, "eager": 0, "clustered_closest_rays": 0,
        "clustered_any_rays": 0, "shade_fused_rays": 0, "shade_plain_rays": 0,
        "shade_adjoint_rays": 0, "mega_fwd_rays": 0, "mega_shadow_rays": 0,
        "raygen_fused_rays": 0, "raygen_plain_rays": 0, "wave_shadow_rays": 0}


# The ray counts of COUNTS (K6's, the wavefront shading's, K1 / K2's, the
# wavefront raygen's and its light loop's shadow-ray slots).
NO_RAYS = ("clustered_closest_rays", "clustered_any_rays", "shade_fused_rays",
           "shade_plain_rays", "shade_adjoint_rays", "mega_fwd_rays", "mega_shadow_rays",
           "raygen_fused_rays", "raygen_plain_rays", "wave_shadow_rays")


@pytest.mark.parametrize("counted, render_kw", [
    # K6: a closest-hit launch of x's rays and an any-hit launch of idx's.
    ((("clustered_closest", "clustered_closest"), ("clustered_any", "clustered_any")),
     dict(bounces=1, shadow_rays=True)),
    # A bounce's shading: the kernel's launch over x's rays, and the plain
    # path's idx rays.
    ((("shade", "shade_fused"), (None, "shade_plain")), dict(bounces=2)),
    # A bounce's shading under a gradient: the forward kernel's launch over
    # x's rays, the adjoint's over idx's.
    ((("shade", "shade_fused"), ("shade_adjoint", "shade_adjoint")), dict(bounces=2)),
    # K1 / K2: the rays a launch is handed, and its shadow rays' slots.
    ((("bounce_fwd", "mega_fwd"), (None, "mega_shadow")),
     dict(bounces=2, shadow_rays=True, direct_specular=True)),
    # The wavefront's raygen: the kernel's launch over x's rays, and the
    # plain route's idx rays.
    ((("raygen", "raygen_fused"), (None, "raygen_plain")), dict(bounces=2)),
    # The wavefront's light loop: K6's any-hit launch over x's rays, and
    # the shadow-ray slots it hands its intersector, idx's.
    ((("clustered_any", "clustered_any"), (None, "wave_shadow")),
     dict(bounces=2, shadow_rays=True, direct_specular=True)),
], ids=["k6", "shading", "adjoint", "mega", "raygen", "wave_shadow"])
def test_replays_add_the_captured_rays(monkeypatch, counted, render_kw):
    """The rays a capture counts in ``build.RAYS`` (K6's by kind; those the
    wavefront shades in its fused kernel, differentiates in its adjoint
    kernel and shades in PyTorch; K1 / K2's and their shadow rays' slots;
    those the wavefront's raygen kernel and PyTorch generate; the
    wavefront's shadow-ray slots)
    are added by each
    replay, as its launches are, and into COUNTS as ``<kind>_rays``; the
    eager warm-up adds its own to ``RAYS`` alone, and the capture's are
    undone. On the CPU a render counts no launch and no ray."""
    def launch(x, idx):
        # What the wrappers count for (launch name, ray kind) of each.
        for (name, kind), n in zip(counted, (x.shape[0], idx.shape[0])):
            if name:
                build.LAUNCHES[name] += 1
            build.RAYS[kind] += n
        return x + 1.0

    def since(before):
        return ({k: v - before[0][k] for k, v in build.LAUNCHES.items() if v != before[0][k]},
                {k: v - before[1][k] for k, v in build.RAYS.items() if v != before[1][k]},
                {k: v for k, v in _deltas(before[2]).items() if k.endswith("_rays")})

    snap = lambda: (dict(build.LAUNCHES), dict(build.RAYS), dict(pjit.COUNTS))
    names = [name for name, _ in counted if name]
    (_, first), (_, second) = counted
    x, idx = torch.arange(5.0), torch.arange(3)
    _as_if_on_cuda(monkeypatch, "gloo")
    prog = pjit.jit(launch)
    before = snap()
    prog(x, idx)
    assert since(before) == (dict.fromkeys(names, 1), {first: 5, second: 3},
                             dict.fromkeys(NO_RAYS, 0))
    before = snap()
    for _ in range(3):
        prog(x, idx)
    assert since(before) == (dict.fromkeys(names, 3), {first: 15, second: 9},
                             dict.fromkeys(NO_RAYS, 0) | {first + "_rays": 15,
                                                          second + "_rays": 9})
    monkeypatch.undo()
    scene = P.bunny_scene(target_tris=4000, device=CPU)
    cfg = P.RenderConfig(width=8, height=8, **render_kw)
    before = snap()
    P.render(scene, P.Camera.default(device=CPU), cfg, accel=P.build_accel(scene, cfg))
    assert since(before) == ({}, {}, dict.fromkeys(NO_RAYS, 0))


def test_replays_carry_a_new_ray_counter(monkeypatch):
    """A kind of rays that only ``build.RAYS`` names, with nothing of it in
    jit.py, is carried by three replays into ``RAYS`` and into COUNTS as
    ``<kind>_rays``."""
    monkeypatch.setitem(build.RAYS, "probe", 0)

    def launch(x):
        build.RAYS["probe"] += x.shape[0]
        return x + 1.0

    _as_if_on_cuda(monkeypatch, "gloo")
    prog = pjit.jit(launch)
    x = torch.arange(5.0)
    try:
        prog(x)
        assert build.RAYS["probe"] == 5 and pjit.COUNTS["probe_rays"] == 0
        for _ in range(3):
            prog(x)
        assert build.RAYS["probe"] == 20 and pjit.COUNTS["probe_rays"] == 15
    finally:
        pjit.COUNTS.pop("probe_rays", None)


def test_replay_outputs_freed_without_the_collector(monkeypatch):
    """A replay's outputs (clones) are freed as soon as the caller drops
    them, with the garbage collector off: flatten and unflatten make no
    reference cycle that would hold them until it runs (a window of calls
    would otherwise hold dozens of images on the device)."""
    import gc
    import weakref
    _as_if_on_cuda(monkeypatch, "gloo")
    prog = pjit.jit(lambda x, idx: {"img": (x * 2.0, [idx + 1]), "n": 3})
    x, idx = torch.arange(5.0), torch.arange(3)
    prog(x, idx)
    gc.disable()
    try:
        for _ in range(2):
            out = prog(x, idx)
            refs = [weakref.ref(out["img"][0]), weakref.ref(out["img"][1][0])]
            assert torch.equal(out["img"][0], x * 2.0) and out["n"] == 3
            del out
            assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_counts_survive_clear(monkeypatch):
    """clear() drops the graphs and keeps COUNTS; the next call warms up
    and captures again."""
    _as_if_on_cuda(monkeypatch, "gloo")
    x, idx = torch.arange(5.0), torch.arange(3)
    prog = pjit.jit(_scaled)
    prog(x, idx)
    prog(x, idx)
    kept = dict(pjit.COUNTS)
    prog.clear()
    assert pjit.COUNTS == kept and not prog._programs
    prog(x, idx)
    got = _deltas(kept)
    assert (got["warmups"], got["captures"], got["replays"]) == (1, 1, 0)
