"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own under the benchmark's folder:

  configs/<config>.json      the configuration (scene, render settings);
                             its scene's ``lights`` lists "point" or
                             light records (type, position, direction,
                             intensity, attenuation, cos_cutoff), as
                             reference/scenes.py says
  traffic/<traffic>.json     the traffic mix's parameters, with its kind
  traffic/<kind>.py          the code that drives a kind of mix and works
                             out its compared numbers (harness/traffic.py)
  limits/<workload>.json     the limits of the cell's comparison
  metrics/<metric>.py        one per-layer metric's reader: read(ctx)
  work/<kernel>.py           one kernel's work count: count(ctx)

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here names any of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.root / BENCH_DIR.name / "metrics" / f"{name}.py")

    def work(self, kernel: str) -> ModuleType:
        return load_module(self.root / BENCH_DIR.name / "work" / f"{kernel}.py")

    def kind(self) -> ModuleType:
        return load_module(self.root / BENCH_DIR.name / "traffic" / f"{self.traffic['kind']}.py")


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _in_cell(metric: dict, workload: str, reported: set) -> bool:
    """A metric is reported in a cell that it lists, or, without a list,
    in every cell that reports the end-to-end metric it moves (a metric
    that a later entry adds without a list)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    here = root / BENCH_DIR.name
    traffic = _read_json(here / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(here / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload, reported)]
    return Cell(root, bench, w, config, traffic, limits, e2e, per_layer)


_MODULES: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (file names may hold
    dots, so not by module name)."""
    path = path.resolve()
    mod: Optional[ModuleType] = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        spec = importlib.util.spec_from_file_location(
            "portbench_" + "_".join((path.parent.name, path.stem)).replace(".", "_")
            .replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod
