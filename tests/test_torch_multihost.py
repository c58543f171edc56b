"""The port's process-group start-up (parallel/multihost.py) and meshes
(parallel/mesh.py): the counterpart of tests/test_multihost.py.

Two OS processes with a launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets)
call ``multihost.initialize()`` with no arguments, build a dp=2 mesh and
render one dp-sharded sample, which must match the single-process render
(atol 1e-5, as the JAX test). Skips when localhost port binding is
unavailable. The children ask for the CPU by setting
``config.DEFAULT_DEVICE`` (the entry points' default is the card) and
import no JAX. A third process checks the 1x1 mesh on a group of one and
the mesh's checks (no group, dp x tp not the world, CUDA without a card);
this process checks that ``initialize()`` without a launcher is a no-op.
"""

import os
import socket
import subprocess
import sys

import pytest

from mini_opencl_raytracer_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import os, sys
import numpy as np
import torch
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch import config
from mini_opencl_raytracer_tpu_torch.parallel import mesh, multihost, shard
config.DEFAULT_DEVICE = "cpu"
torch.set_num_threads(1)
scene, cam = P.cornell_scene(), P.Camera.default()
cfg = P.RenderConfig(width=64, height=64, bounces=2, backend="bruteforce")
ref = P.render_sample(scene, cam, cfg).numpy()
"""

_TWO = _PRELUDE + r"""
rank = int(os.environ["RANK"])
assert multihost.initialize(), "initialize() returned False under a launcher"
assert multihost.initialize(), "a second initialize() must return True"
info = multihost.process_info()
assert info == (rank, 2, 1), info
m = mesh.make_mesh(config.MeshConfig(), device_type="cpu")
assert (m.size(0), m.size(1)) == (2, 1)
img = shard.render_sample_dp(scene, cam, cfg, m).numpy()
np.testing.assert_allclose(img, ref, atol=1e-5)
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "mini_opencl_raytracer_tpu")]
print(f"MULTIHOST_OK p{rank}")
"""

_ONE = _PRELUDE + r"""
import torch.distributed as dist
try:
    mesh.make_mesh(device_type="cpu")
    raise AssertionError("make_mesh without a group")
except RuntimeError:
    pass
m = mesh.single_device_mesh(device_type="cpu")
assert dist.get_world_size() == 1 and (m.size(0), m.size(1)) == (1, 1)
for bad in (config.MeshConfig(tp=2), config.MeshConfig(dp=2)):
    try:
        mesh.make_mesh(bad, device_type="cpu")
        raise AssertionError(f"make_mesh accepted {bad}")
    except ValueError:
        pass
if not torch.cuda.is_available():
    try:
        mesh.make_mesh(device_type="cuda")
        raise AssertionError("a CUDA mesh without a card")
    except RuntimeError:
        pass
img = shard.render_sample_ring(scene, cam, cfg, m).numpy()
np.testing.assert_allclose(img, ref, atol=1e-5)
print("SINGLE_OK")
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def test_initialize_without_a_launcher_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is False
    assert multihost.process_info()[:2] == (0, 1)


def test_two_process_dp_render():
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    except OSError:
        pytest.skip("localhost port binding unavailable")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO,
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost children timed out")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {r} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK p{r}" in out, out[-3000:]


def test_single_device_mesh_and_mesh_checks():
    r = subprocess.run([sys.executable, "-c", _ONE], capture_output=True, text=True,
                       cwd=REPO, env=_env(), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "SINGLE_OK" in r.stdout
