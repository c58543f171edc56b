"""The control and the planted faults at each cell's own size, on the card.

For every cell of BENCHMARK.json and three seeds: the plain reference put
in the program's place, computed in bfloat16 (the configurations state
float32), has to fail the cell's comparison; and the readings of the
planted faults (harness/control.py) are printed, one JSON line each, for
the limits (run with ``-s``). Needs a CUDA device; imports no JAX.

    python -m pytest portbench/tests/test_portbench_control.py -m cuda -s
"""

import json
from pathlib import Path

import pytest
import torch

from portbench.harness import cell as cells
from portbench.harness import control
from portbench.reference import scenes

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2718281828459, 3141592653589, 1618033988749)
FAULTS = {"train": ("half_batch", "altered"), "render": ("half_batch", "altered", "unchanged")}


def _cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells())
def test_control_fails_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = cells.load_cell(ROOT, name)
    arrays = scenes.make_scene(c.config["scene"])
    camera = scenes.make_camera(c.config["camera"])
    for seed in SEEDS:
        low = control.readings(c, arrays, camera, seed, "cuda", torch.bfloat16)
        print(json.dumps({"cell": name, "seed": seed, "run": "control bfloat16",
                          "numbers": low}, default=str), flush=True)
        for fault in FAULTS[c.traffic["kind"]]:
            r = control.readings(c, arrays, camera, seed, "cuda", fault=fault)
            print(json.dumps({"cell": name, "seed": seed, "run": f"fault {fault}",
                              "numbers": r, "fails": control.fails(r, c)}, default=str),
                  flush=True)
        assert control.fails(low, c), low
