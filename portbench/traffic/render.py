"""The ``render`` kind: each request is one image of ``frames``
progressive frames (the program's ``render``), from a camera whose
position is drawn per request from the seed within ``camera_jitter``
scene units of the configuration's on every axis (same look direction),
copied into host memory.

The comparison (``numbers``) holds each image kept from the window (a
reservoir sample drawn from the seed, ``images`` of the cell's limits)
against the reference's image at the same camera, at the timed size.
Compared, worst image:

* ``img_mean_abs``: the mean |difference| over pixels and channels;
* ``img_frac_off``: the share of pixel channels that differ by more than
  the cell's ``px_tol``. A pixel that is not finite differs by infinity.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import List, Optional

import numpy as np
import torch

from portbench.harness import check
from portbench.harness import traffic as gen
from portbench.reference import tracer


class Mix(gen.BaseMix):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        mix, cfg = self.mix, self.cfg
        self.positions = gen.draw_positions(self.camera.position, mix, self.gen)
        self.frames = mix["frames"]
        self.rays_per_call = cfg.width * cfg.height * cfg.bounces * cfg.spp * self.frames
        pin = self.device.type == "cuda"
        self.host = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                                pin_memory=pin)
        self.kept: List[tuple] = []
        self.keep = int(self.cell.limits.get("images", 1))
        self.pick = np.random.default_rng(gen.seed_words(self.seed))
        self.count = 0
        for k in range(mix["warm_calls"]):
            t = time.perf_counter()
            self._render(self.camera)
            self.setup_parts[f"image {k + 1}"] = time.perf_counter() - t

    def _render(self, camera):
        img = self.mrt.render(self.scene, camera, self.cfg, frames=self.frames,
                              accel=self.accel)
        self.host.copy_(img)
        return self.host

    def call(self) -> None:
        i = self.count % self.positions.shape[0]
        cam = dataclasses.replace(self.camera, position=self.positions[i])
        self._render(cam)
        self.count += 1

    def after_call(self) -> None:
        """Reservoir sampling, drawn from the seed, of the images to check
        (outside the call's own time)."""
        n = self.count
        idx = n - 1
        if len(self.kept) < self.keep:
            self.kept.append((idx, self.host.clone()))
        else:
            j = int(self.pick.integers(0, n))
            if j < self.keep:
                self.kept[j] = (idx, self.host.clone())

    def evidence(self) -> dict:
        pos = self.positions.detach().cpu().numpy()
        return {"images": [(i, pos[i % pos.shape[0]], img.numpy()) for i, img in self.kept]}

    def free(self) -> None:
        importlib.import_module(self.mrt.__name__ + ".render")._render_compiled.clear()
        super().free()


def numbers(cell, arrays, camera, ev: dict, device, dtype=torch.float32,
            counts: Optional[tracer.Counts] = None) -> dict:
    """Each kept image against the reference's; returns the worst numbers
    (and fills ``counts`` with the ray classes of the images traced)."""
    s = tracer.Settings.from_render(cell.config["render"])
    scene = check.tensors(arrays, device)
    tol = float(cell.limits["px_tol"])
    frames = int(cell.traffic["frames"])
    mean_abs, frac = [], []
    for _, pos, img in ev["images"]:
        cam = check.tensors({**camera, "position": np.asarray(pos, np.float32)}, device)
        ref = tracer.image(scene, cam, s, frames, dtype, counts).float().cpu().numpy()
        diff = np.abs(img.astype(np.float64) - ref.astype(np.float64))
        diff[~np.isfinite(diff)] = np.inf
        mean_abs.append(float(diff.mean()))
        frac.append(float((diff > tol).mean()))
    if not mean_abs:
        return {"img_mean_abs": float("inf"), "img_frac_off": float("inf"), "_images": 0}
    return {"img_mean_abs": max(mean_abs), "img_frac_off": max(frac),
            "_images": len(mean_abs), "_compared": len(mean_abs)}


def control_evidence(cell, arrays, camera, seed: int, device, dtype=torch.float32,
                     fault: Optional[str] = None) -> dict:
    """The first requests' images, made by the plain reference in the
    program's place.

    Faults: ``half_batch``, the image is the mean of the first half of its
    frames; ``unchanged``, every request gets the first request's image;
    ``altered``, an 8 x 8 block of each image is black."""
    s = tracer.Settings.from_render(cell.config["render"])
    mix = cell.traffic
    cam = check.tensors(camera, device)
    scene = check.tensors(arrays, device)
    positions = gen.draw_positions(cam["position"], mix, gen.generator(device, seed))
    frames = mix["frames"] // 2 if fault == "half_batch" else mix["frames"]
    images, first = [], None
    for i in range(int(cell.limits.get("images", 1))):
        pos = positions[i]
        img = tracer.image(scene, {**cam, "position": pos}, s, frames, dtype)
        img = img.float().cpu().numpy()
        if fault == "altered":
            img[:8, :8] = 0.0
        if fault == "unchanged":
            first = img if first is None else first
            img = first
        images.append((i, pos.float().cpu().numpy(), img))
    return {"images": images}
