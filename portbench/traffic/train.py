"""The ``train`` kind: the inverse-rendering loop of the program's
``optimize`` command.

Set-up renders a target image of the scene with one leaf perturbed by a
draw from the seed. Each step is ``grad.loss_and_grads`` of the L2 loss
against it, compiled as the program compiles its training step
(``jit.jit``: the first call runs eagerly and captures, later calls
replay the graph), its loss read on the host, then the clamped gradient
step on the updated leaf. The first ``warm_steps`` steps are set-up; the
window runs the same call.

The comparison (``numbers``) follows the warm steps (the first eager,
the others replays of the captured step) from the same scene, camera and
perturbed leaf with the plain reference and its own target, and takes two
steps of the window from the program's own leaf at each: the window's
first step, whose outputs are held across every later call of the
window, and its last. Compared, over those steps:

* ``loss_gap``: the largest |program loss - reference loss| over the
  larger of the step's reference loss and the first step's;
* ``grad_gap``: the worst leaf's |norm of the program's gradient - norm
  of the reference's| over the larger of the reference's norm of that
  leaf at that step and of the first step's median leaf (every float leaf
  of the scene and the camera). The first step's scale stands for the
  later steps' too, where the loop has converged and every gradient is
  all but zero;
* ``update_gap``: the same gap for the updated leaf's change after the
  warm steps (leaves whose reference gradient is under a thousandth of
  the median leaf's would be left out; the updated leaf is not).
"""

from __future__ import annotations

import importlib
import time
from typing import List, Optional

import numpy as np
import torch

from portbench.harness import check
from portbench.harness import traffic as gen
from portbench.reference import tracer


class L2Loss:
    """mean((image - target)^2) over every pixel and channel."""

    def __init__(self, target: torch.Tensor):
        self.target = target

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return torch.mean((img - self.target) ** 2)


class Mix(gen.BaseMix):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        mrt, mix, cfg = self.mrt, self.mix, self.cfg
        self.grad = importlib.import_module(mrt.__name__ + ".grad")
        jit = importlib.import_module(mrt.__name__ + ".jit")
        path = mix["leaf"]
        self.leaf0 = gen.leaf(self.scene, path)
        self.leaf_target = gen.draw_leaf_target(self.leaf0, mix, self.gen)
        t = time.perf_counter()
        with torch.no_grad():
            target = mrt.render_radiance(gen.with_leaf(self.scene, path, self.leaf_target),
                                         self.camera, cfg, frames=1, accel=self.accel)
        target.sum().item()
        self.setup_parts["target"] = time.perf_counter() - t
        self.loss_fn = L2Loss(target)
        self.step_fn = jit.jit(self._step)
        self.leaf = self.leaf0
        self.rays_per_call = cfg.width * cfg.height * cfg.bounces * cfg.spp
        self.steps = 0
        self.losses: List[float] = []
        self.grads: List[dict] = []
        # (step, leaf in, loss, scene gradient, camera gradient) of the
        # window's first and last steps: references, no copies.
        self.window: List[tuple] = []
        for k in range(mix["warm_steps"]):
            t = time.perf_counter()
            self.call()
            self.setup_parts[f"step {k + 1}"] = time.perf_counter() - t
        self.leaf_after = self.leaf.detach().cpu().numpy()

    def _step(self, scene, camera, accel):
        return self.grad.loss_and_grads(scene, camera, self.cfg, self.loss_fn,
                                        accel=accel)

    def call(self) -> None:
        path = self.mix["leaf"]
        leaf_in = self.leaf
        loss, gs, gc = self.step_fn(gen.with_leaf(self.scene, path, leaf_in),
                                    self.camera, self.accel)
        value = loss.item()
        lo, hi = self.mix["update_clamp"]
        self.leaf = torch.clamp(leaf_in - self.mix["lr"] * gen.leaf(gs, path), lo, hi)
        self.steps += 1
        if self.steps <= self.mix["warm_steps"]:
            self.losses.append(value)
            self.grads.append(check.host_leaves(gs, gc))
        else:
            self.window[1:] = [(self.steps, leaf_in, value, gs, gc)]

    def evidence(self) -> dict:
        return {"losses": self.losses, "grads": self.grads,
                "leaf_before": self.leaf0.detach().cpu().numpy(),
                "leaf_after": self.leaf_after,
                "leaf_target": self.leaf_target.detach().cpu().numpy(),
                "window": [{"step": step, "leaf": leaf_in.detach().cpu().numpy(),
                            "loss": value, "grads": check.host_leaves(gs, gc)}
                           for step, leaf_in, value, gs, gc in self.window]}

    def free(self) -> None:
        self.step_fn.clear()
        self.step_fn = self.loss_fn = self.window = None
        super().free()


def _host(g: dict) -> dict:
    return {n: v.float().cpu().numpy() for n, v in g.items()}


def numbers(cell, arrays, camera, ev: dict, device, dtype=torch.float32,
            counts: Optional[tracer.Counts] = None) -> dict:
    """The reference follows the warm steps and takes the window's; returns
    the compared numbers (and fills ``counts`` with the first step's ray
    classes)."""
    s = tracer.Settings.from_render(cell.config["render"])
    mix = cell.traffic
    leaf = mix["leaf"]
    scene = check.tensors(arrays, device)
    cam = check.tensors(camera, device)
    lo, hi = mix["update_clamp"]
    target = tracer.radiance({**scene, leaf: torch.from_numpy(ev["leaf_target"]).to(device)},
                             cam, s, 0, dtype)
    x = scene[leaf].to(dtype)
    losses, grads = [], []
    for k in range(len(ev["losses"])):
        loss, g = tracer.loss_and_grads({**scene, leaf: x}, cam, s, target, dtype,
                                        counts if k == 0 else None)
        losses.append(float(loss))
        grads.append(_host(g))
        x = torch.clamp(x - mix["lr"] * g[leaf], lo, hi)
    ref_after = x.float().cpu().numpy()
    steps = list(range(1, len(losses) + 1))
    prog_losses, prog_grads = list(ev["losses"]), list(ev["grads"])
    for w in ev["window"]:
        loss, g = tracer.loss_and_grads(
            {**scene, leaf: torch.from_numpy(w["leaf"]).to(device)}, cam, s, target, dtype)
        steps.append(w["step"])
        losses.append(float(loss))
        grads.append(_host(g))
        prog_losses.append(w["loss"])
        prog_grads.append(w["grads"])
    first = grads[0]
    med = float(np.median([check.norm(v) for v in first.values()]))
    scales = [max(abs(r), abs(losses[0])) for r in losses]
    loss_gaps = [abs(p - r) / d if d > 0 else float("inf")
                 for p, r, d in zip(prog_losses, losses, scales)]
    loss_gaps = [x if np.isfinite(x) else float("inf") for x in loss_gaps]
    worst = (-1.0, "", 0)
    for step, p, r in zip(steps, prog_grads, grads):
        gap, name = check.grad_gap(p, r, med)
        if gap > worst[0]:
            worst = (gap, name, step)
    d_prog = check.norm(ev["leaf_after"] - ev["leaf_before"])
    d_ref = check.norm(ref_after - ev["leaf_before"])
    update = (abs(d_prog - d_ref) / d_ref
              if d_ref > 0 and check.norm(first[leaf]) >= 1e-3 * med else 0.0)
    return {"loss_gap": max(loss_gaps), "grad_gap": worst[0],
            "update_gap": update, "_grad_worst_leaf": worst[1], "_grad_worst_step": worst[2],
            "_compared_steps": steps, "_compared": len(steps),
            "_losses_program": prog_losses, "_losses_reference": losses}


def control_evidence(cell, arrays, camera, seed: int, device, dtype=torch.float32,
                     fault: Optional[str] = None) -> dict:
    """The warm steps and two more steps (the window's first and, standing
    for its last, the one after) of the plain reference in the program's
    place.

    Faults: ``half_batch``, the loss is the mean over the image's first
    half of rows; ``unchanged``, the step leaves the updated leaf as it
    was; ``altered``, the loss is 5% high where it is produced."""
    s = tracer.Settings.from_render(cell.config["render"])
    mix = cell.traffic
    g0 = gen.generator(device, seed)
    scene = check.tensors(arrays, device)
    cam = check.tensors(camera, device)
    leaf = mix["leaf"]
    leaf0 = scene[leaf]
    leaf_target = gen.draw_leaf_target(leaf0, mix, g0)
    target = tracer.radiance({**scene, leaf: leaf_target}, cam, s, 0, dtype)
    x, losses, grads, leaves = leaf0.to(dtype), [], [], []
    lo, hi = mix["update_clamp"]
    rows = s.height // 2 if fault == "half_batch" else None
    w = mix["warm_steps"]
    for _ in range(w + 2):
        leaves.append(x.float().cpu().numpy())
        loss, g = tracer.loss_and_grads({**scene, leaf: x}, cam, s, target, dtype,
                                        loss_rows=rows)
        if fault == "unchanged":
            g[leaf] = torch.zeros_like(g[leaf])
        losses.append(float(loss) * (1.05 if fault == "altered" else 1.0))
        grads.append(_host(g))
        x = torch.clamp(x - mix["lr"] * g[leaf], lo, hi)
    return {"losses": losses[:w], "grads": grads[:w], "leaf_before": leaves[0],
            "leaf_after": leaves[w], "leaf_target": leaf_target.float().cpu().numpy(),
            "window": [{"step": k + 1, "leaf": leaves[k], "loss": losses[k], "grads": grads[k]}
                       for k in (w, w + 1)]}
