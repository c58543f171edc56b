"""The mechanism of BASELINE.json config 2's light path, taken apart: the
plain reference with one part of it taken away, put in the program's
place, against the whole reference under the cell's comparison. Each
ablation has to fail the cell's limits; otherwise the comparison could
not tell the part from its absence.

Ablations (``ABLATIONS``: a configuration -> that configuration without
the part): ``shadow_rays_off``, ``direct_specular_off``,
``second_light_dropped``.

Run on the card, this prints the readings at the cell's own size, one
JSON line each, for the limits file's ``set_from`` (imports no JAX):

    python3 portbench/tests/config2_ablations.py --seeds 2718281828459 3141592653589

With each seed also the bfloat16 control, its non-finite pixels, and
those of the bfloat16 control without the direct specular term.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from portbench.harness import cell as cells
from portbench.harness import control
from portbench.reference import scenes

CELL = "cornell-1080p-b2-shadows.render"


def _render(conf: dict, **kw) -> dict:
    return {**conf, "render": {**conf["render"], **kw}}


ABLATIONS = {
    "shadow_rays_off": lambda conf: _render(conf, shadow_rays=False),
    "direct_specular_off": lambda conf: _render(conf, direct_specular=False),
    "second_light_dropped": lambda conf: {
        **conf, "scene": {**conf["scene"], "lights": conf["scene"]["lights"][:1]}},
}


def resized(cell: cells.Cell, width: int, height: int, frames: int) -> cells.Cell:
    """The cell at another image size and number of frames (a test's size)."""
    return dataclasses.replace(cell, config=_render(cell.config, width=width, height=height),
                               traffic={**cell.traffic, "frames": frames})


def readings(cell: cells.Cell, ablation: str, seed: int, device,
             dtype=torch.float32) -> dict:
    """The compared numbers of the reference without the part ``ablation``
    names, in the program's place, against the whole reference."""
    arrays = scenes.make_scene(cell.config["scene"])
    camera = scenes.make_camera(cell.config["camera"])
    without = dataclasses.replace(cell, config=ABLATIONS[ablation](cell.config))
    ev = control.evidence(without, scenes.make_scene(without.config["scene"]), camera, seed,
                          device, dtype)
    return cell.kind().numbers(cell, arrays, camera, ev, device)


def nonfinite(cell: cells.Cell, seed: int, device, dtype=torch.bfloat16) -> list:
    """Per image the reference hands the comparison in ``dtype``: its pixels
    with a channel that is not finite, and the first few (row, column)."""
    arrays = scenes.make_scene(cell.config["scene"])
    camera = scenes.make_camera(cell.config["camera"])
    out = []
    for _, _, img in control.evidence(cell, arrays, camera, seed, device, dtype)["images"]:
        bad = ~np.isfinite(img).all(axis=-1)
        out.append({"pixels": int(bad.sum()), "first": np.argwhere(bad)[:8].tolist()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(ROOT, CELL)
    no_dspec = dataclasses.replace(cell, config=ABLATIONS["direct_specular_off"](cell.config))
    for seed in args.seeds:
        for name in ABLATIONS:
            r = readings(cell, name, seed, args.device)
            print(json.dumps({"cell": CELL, "seed": seed, "run": name, "numbers": r,
                              "fails": control.fails(r, cell)}), flush=True)
        print(json.dumps({"cell": CELL, "seed": seed, "run": "bfloat16 non-finite",
                          "images": nonfinite(cell, seed, args.device),
                          "without_direct_specular": nonfinite(no_dspec, seed, args.device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
