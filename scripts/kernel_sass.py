#!/usr/bin/env python3
"""What the compiler made of the kernels: registers, shared memory and
spills per kernel from ``ptxas -v``, and the static SASS instruction mix of
each kernel from ``cuobjdump -sass`` of the built library.

    python3 scripts/kernel_sass.py [--match bwd]

Per kernel whose name contains ``--match``: the instruction count and how
many are MUFU (sin, cos, ex2, lg2, rsq, rcp: the transcendental unit),
CALL (IEEE divide and square-root subroutines), FADD / FMUL / FFMA, SHFL,
BAR, and LDL / STL (local memory: spills and stack). Counts are static,
not executed instructions. Needs ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

# The package is not installed where this runs: import it from the checkout.
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = ("MUFU", "CALL", "FADD", "FMUL", "FFMA", "SHFL", "BAR", "LDL", "STL")


def sass_mix(lib: Path, match: str) -> dict:
    """{kernel name: Counter of opcode classes, with 'n' the total}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    mix, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = mix.setdefault(m.group(1), collections.Counter()) if match in m.group(1) else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m:
            op = m.group(1)
            cur["n"] += 1
            cur[next((c for c in CLASSES if op.startswith(c)), "other")] += 1
    return mix


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--match", default="bwd")
    args = ap.parse_args()
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    build.library_path().unlink(missing_ok=True)  # rebuild, so that ptxas reports
    lib = build.build(verbose=True)
    lines = build.LAST_BUILD_LOG.splitlines()
    for head, props, regs in zip(lines, lines[1:], lines[2:]):
        if "Function properties" in head and args.match in head:
            name = head.split("for ")[-1]
            print(f"ptxas {name}: {props.strip()}; {regs.split(':', 1)[-1].strip()}")
    for name, c in sass_mix(lib, args.match).items():
        print(f"sass {name}: {c['n']} instructions; " + ", ".join(
            f"{k} {c[k]}" for k in CLASSES) + f"; MUFU share {c['MUFU'] / max(c['n'], 1):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
