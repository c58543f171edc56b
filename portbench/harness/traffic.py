"""What every traffic mix shares, and the one general generator's entry.

A mix is a data file, ``traffic/<mix>.json``, whose ``kind`` names the
code that drives it: ``traffic/<kind>.py``, found by that name
(``cell.Cell.kind``). A kind's file gives

* ``Mix(mrt, cell, arrays, camera, device, seed)``: sets up the program
  and warms every shape the mix uses; ``call()`` makes one call of the
  closed loop (one caller: a call's result is read on the host before the
  next call is made); ``after_call()`` (optional) runs after each call,
  outside its time; ``evidence()`` hands what the window produced to the
  comparison; ``free()`` drops the program's state; ``rays_per_call``,
  ``accel_build_s`` and ``setup_parts`` are read by the harness;
* ``numbers(cell, arrays, camera, evidence, device, dtype, counts)``: the
  compared numbers of that evidence against the plain reference;
* ``control_evidence(cell, arrays, camera, seed, device, dtype, fault)``:
  the evidence the plain reference would hand ``numbers`` in the
  program's place, in ``dtype`` and with ``fault`` planted.

A new mix of a kind that exists adds a data file; a new kind adds its
file too, and edits none. The program gets only the generated inputs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leaf(tree, path: str):
    for part in path.split("."):
        tree = getattr(tree, part)
    return tree


def with_leaf(scene, path: str, value):
    group, name = path.split(".")
    return dataclasses.replace(scene, **{group: dataclasses.replace(
        getattr(scene, group), **{name: value})})


def draw_leaf_target(leaf0: torch.Tensor, mix: dict, gen: torch.Generator) -> torch.Tensor:
    """The perturbed leaf the target is rendered with: the leaf plus a
    normal draw of ``perturb_sigma``, clamped to ``perturb_clamp``."""
    noise = torch.randn(leaf0.shape, generator=gen, device=leaf0.device,
                        dtype=leaf0.dtype) * mix["perturb_sigma"]
    lo, hi = mix["perturb_clamp"]
    return torch.clamp(leaf0 + noise, lo, hi)


def draw_positions(base: torch.Tensor, mix: dict, gen: torch.Generator) -> torch.Tensor:
    """[poses, 3] camera positions, uniform within ``camera_jitter`` of
    ``base`` on every axis."""
    u = torch.rand((mix["poses"], 3), generator=gen, device=base.device, dtype=base.dtype)
    return base[None, :] + (u * 2.0 - 1.0) * mix["camera_jitter"]


def generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return gen


def seed_words(seed: int) -> List[int]:
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 0x5EED]


class BaseMix:
    """What every kind shares: the program's scene, camera and accel."""

    def __init__(self, mrt, cell, arrays: Dict[str, np.ndarray],
                 camera: Dict[str, np.ndarray], device: torch.device, seed: int):
        self.mrt, self.cell, self.mix = mrt, cell, cell.traffic
        self.device, self.seed = device, seed
        self.setup_parts = {}
        t0 = time.perf_counter()
        render = dict(cell.config["render"])
        self.cfg = mrt.RenderConfig(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in render.items()})
        self.scene = mrt.scene_from_numpy(arrays, device=device)
        self.camera = mrt.camera_from_numpy(camera, device=device)
        want = cell.config.get("path")
        got = mrt.resolve_backend(self.scene, self.cfg)
        if want is not None and got != want:
            raise RuntimeError(f"{cell.config['name']}: the program resolves backend "
                               f"{got!r}, the configuration states {want!r}")
        sync(device)
        t1 = time.perf_counter()
        self.setup_parts["scene"] = t1 - t0
        self.accel = mrt.build_accel(self.scene, self.cfg)
        sync(device)
        self.accel_build_s = time.perf_counter() - t1
        self.gen = generator(device, seed)

    def free(self) -> None:
        self.scene = self.camera = self.accel = None


def make(mrt, cell, arrays, camera, device, seed):
    """The cell's mix, set up and warm."""
    return cell.kind().Mix(mrt, cell, arrays, camera, device, seed)
