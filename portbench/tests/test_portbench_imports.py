"""The benchmark loads neither JAX nor the JAX package, and its plain
reference loads nothing of the program either.

Each check runs in a fresh interpreter, so that what this test process
has imported does not count. Names are compared by their top-level part
(before the first dot) as whole words: ``mini_opencl_raytracer_tpu_torch``
begins with ``mini_opencl_raytracer_tpu`` and is not the JAX package.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "mini_opencl_raytracer_tpu"}
PROGRAM = "mini_opencl_raytracer_tpu_torch"

_PROBE = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_names(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_its_files_load_no_jax():
    """The harness, every configuration, traffic (mix and kind), limits,
    metric and work file, the reference and the program load no JAX."""
    body = """
import json
from portbench.harness import cell, check, control, peaks, readers, trace, traffic
from portbench.reference import scenes, tracer
import mini_opencl_raytracer_tpu_torch
import mini_opencl_raytracer_tpu_torch.grad, mini_opencl_raytracer_tpu_torch.jit
import mini_opencl_raytracer_tpu_torch.render
bench = Path({bench!r})
for p in sorted((bench / "configs").glob("*.json")) + sorted((bench / "traffic").glob("*.json")) \
        + sorted((bench / "limits").glob("*.json")):
    json.loads(p.read_text())
for p in sorted((bench / "metrics").glob("*.py")) + sorted((bench / "work").glob("*.py")) \
        + sorted((bench / "traffic").glob("*.py")):
    cell.load_module(p)
""".format(bench=str(BENCH))
    names = _top_level_names(body)
    assert PROGRAM in names
    assert not names & JAX_NAMES, sorted(names & JAX_NAMES)


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names("from portbench.reference import scenes, tracer\n"
                             "import portbench.reference")
    assert PROGRAM not in names
    assert not names & JAX_NAMES, sorted(names & JAX_NAMES)


def test_run_refuses_a_process_that_loaded_jax_names():
    """The run's own guard compares whole top-level names."""
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    assert run.forbidden_modules([PROGRAM, PROGRAM + ".render", "torch", "numpy"]) == []
    assert run.forbidden_modules([PROGRAM, "mini_opencl_raytracer_tpu.render"]) == [
        "mini_opencl_raytracer_tpu"]
    assert run.forbidden_modules(["jaxlib.xla_client", "flax"]) == ["flax", "jaxlib"]
