"""The plain reference put in the program's place: what it would hand the
comparison for a cell and a seed, computed in a given precision and,
optionally, with one fault planted (each kind's ``control_evidence`` in
``traffic/<kind>.py``). The control of every cell is this in bfloat16
(the configurations state float32); the readings of the planted faults
set the training cells' upper limits. Neither runs in a benchmark run:
the tests under ``portbench/tests`` drive them.

Faults: ``half_batch`` (half of the batch left out), ``unchanged`` (the
state or the answer left as it was), ``altered`` (an answer altered where
it is produced); each kind's file says what they are there.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import check


def evidence(cell, arrays, camera, seed: int, device, dtype=torch.float32,
             fault: Optional[str] = None) -> dict:
    """What the program's mix would hand the comparison for this cell and
    seed, made by the reference in ``dtype`` with ``fault`` planted."""
    return cell.kind().control_evidence(cell, arrays, camera, seed, device, dtype, fault)


def readings(cell, arrays, camera, seed: int, device, dtype=torch.float32,
             fault: Optional[str] = None) -> dict:
    """The compared numbers of the reference in the program's place."""
    ev = evidence(cell, arrays, camera, seed, device, dtype, fault)
    return cell.kind().numbers(cell, arrays, camera, ev, device)


def fails(numbers: dict, cell) -> bool:
    return not check.judge(numbers, cell.limits["limits"])[0]
