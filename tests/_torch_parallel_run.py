"""Shared by tests/test_torch_parallel.py and
tests/test_torch_parallel_stages.py: the inputs both packages render, and
the launch of the port's ranks (tests/_torch_parallel_child.py), which run
in their own processes over a gloo group on the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_parallel_child.py")
# Images: the tolerances of tests/test_torch_render.py; gradients:
# tests/test_torch_grad.py's scale-normalised atol.
ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL = 1e-4


def scene_arrays(jscene):
    """The JAX scene's leaves by path, for convert.scene_from_numpy."""
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def camera_arrays(jcam):
    return {f.name: np.asarray(getattr(jcam, f.name)) for f in dataclasses.fields(jcam)}


def start(world: int, group: str, indir: str, workdir: str):
    """Start the ``world`` ranks of ``group``; returns (processes, outdir)."""
    outdir = os.path.join(workdir, f"out_{group}")
    os.makedirs(outdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{group}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, CHILD, str(r), str(world), store, indir,
                               outdir, group],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    return procs, outdir


def finish(procs, timeout: int = 300):
    """Wait for every rank; (all succeeded, their output)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        return False, "ranks timed out:\n" + "\n".join(outs)
    ok = all(p.returncode == 0 and "CHILD_OK" in out for p, out in zip(procs, outs))
    return ok, "\n".join(f"--- rank {r} (exit {p.returncode}):\n{out[-3000:]}"
                         for r, (p, out) in enumerate(zip(procs, outs)))


def load(outdir: str, name: str, world: int):
    """One scenario's result: a dict of arrays per rank."""
    return [dict(np.load(os.path.join(outdir, f"{name}.r{r}.npz"))) for r in range(world)]


class Ranks:
    """The port's ranks of several groups, started together; a group's
    results are read once all its ranks have finished."""

    def __init__(self, indir: str, workdir: str, groups):
        self.groups = {group: (world,) + start(world, group, indir, workdir)
                       for world, group in groups}
        self.status = {}

    def close(self):
        for group, (_, procs, _) in self.groups.items():
            if group not in self.status:
                self.status[group] = finish(procs)

    def result(self, group: str, name: str):
        """[rank 0's arrays, ...] of one scenario."""
        world, procs, outdir = self.groups[group]
        if group not in self.status:
            self.status[group] = finish(procs)
        ok, out = self.status[group]
        assert ok, out
        return load(outdir, name, world)

    def replicated(self, group: str, name: str) -> dict:
        """A result that every rank must hold bitwise: rank 0's."""
        per_rank = self.result(group, name)
        for r, arrays in enumerate(per_rank[1:], 1):
            for k, v in arrays.items():
                assert np.array_equal(v, per_rank[0][k]), (name, k, r)
        return per_rank[0]


def assert_grads_close(got: dict, ref: dict):
    """Every float leaf of ``ref`` within GRAD_ATOL of max |ref| (scale-
    normalised, as tests/test_torch_grad.py); the port's gradient is
    finite everywhere, and entries where JAX's is not (its NaN d/dNs) are
    left out, in the Ns row only."""
    for k, r in ref.items():
        r = np.asarray(r)
        if not np.issubdtype(r.dtype, np.floating):
            continue
        g = got[k]
        assert np.isfinite(g).all(), k
        fin = np.isfinite(r)
        assert fin.all() or k == "materials.roughness", k
        scale = max(float(np.abs(r[fin]).max(initial=0.0)), 1e-6)
        np.testing.assert_allclose(g[fin] / scale, r[fin] / scale, atol=GRAD_ATOL,
                                   rtol=0, err_msg=k)


def jax_leaves(tree) -> dict:
    """{leaf path: numpy array} of a JAX Scene (the port's leaf names)."""
    return {f"{group}.{f.name}": np.asarray(getattr(getattr(tree, group), f.name))
            for group in ("geometry", "materials", "lights")
            for f in dataclasses.fields(getattr(tree, group))}
