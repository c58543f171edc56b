"""The readings that set a render cell's limits, at the cell's own size on
the card: the plain reference put in the program's place with one part of
the light path taken away (the ablations of config2_ablations.py), in
bfloat16, and with each planted fault (harness/control.py), each against
the whole reference under the cell's comparison. One JSON line a seed and
run: the compared numbers, whether they fail the cell's limits, and the
seconds the reading took (imports no JAX):

    python3 portbench/tests/render_controls.py \\
        --workload bunny-1080p-b2-shadows.render --seeds 2718281828459 3141592653589

``--runs`` picks some of ``RUNS`` (all by default). The bfloat16 run also
gives each image's pixels that are not finite.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from portbench.harness import cell as cells
from portbench.harness import control
from portbench.reference import scenes
from portbench.tests import config2_ablations as ablations

FAULTS = ("altered", "half_batch", "unchanged")
RUNS = tuple(ablations.ABLATIONS) + ("bfloat16",) + tuple("fault_" + f for f in FAULTS)


def reading(cell: cells.Cell, run: str, seed: int, device) -> dict:
    """{"numbers", "fails"} of one run of ``RUNS`` on ``seed``, and for
    bfloat16 the images' pixels that are not finite."""
    if run in ablations.ABLATIONS:
        numbers = ablations.readings(cell, run, seed, device)
        return {"numbers": numbers, "fails": control.fails(numbers, cell)}
    arrays = scenes.make_scene(cell.config["scene"])
    camera = scenes.make_camera(cell.config["camera"])
    dtype = torch.bfloat16 if run == "bfloat16" else torch.float32
    fault = run[len("fault_"):] if run.startswith("fault_") else None
    ev = control.evidence(cell, arrays, camera, seed, device, dtype, fault)
    numbers = cell.kind().numbers(cell, arrays, camera, ev, device)
    out = {"numbers": numbers, "fails": control.fails(numbers, cell)}
    if run == "bfloat16":
        out["non_finite_pixels"] = [int((~np.isfinite(img).all(axis=-1)).sum())
                                    for _, _, img in ev["images"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(ROOT, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        for run in args.runs:
            t0 = time.perf_counter()
            out = reading(cell, run, seed, device)
            print(json.dumps({"cell": args.workload, "seed": seed, "run": run, **out,
                              "seconds": time.perf_counter() - t0}, default=float), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
