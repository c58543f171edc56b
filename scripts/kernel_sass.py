#!/usr/bin/env python3
"""What the compiler made of the kernels: registers, shared memory and
spills per kernel from ``ptxas -v``, and the static SASS instruction mix of
each kernel from ``cuobjdump -sass`` of the built library.

    python3 scripts/kernel_sass.py [--match bwd] [--listing]

Per kernel whose name contains ``--match``: the instruction count and how
many are MUFU (sin, cos, ex2, lg2, rsq, rcp: the transcendental unit),
CALL (IEEE divide and square-root subroutines), FADD / FMUL / FFMA, SHFL,
BAR, and LDL / STL (local memory: spills and stack); then each innermost
loop (a backward branch that encloses no other) with its instructions,
its mix and its MUFU.RCP count: in the intersection kernels one RCP is one
Möller–Trumbore test's 1 / det, so instructions / RCP is the static size
of a test in that loop. Counts are static, not executed instructions.
``--listing`` also prints each innermost loop's instructions.
Needs ``nvcc`` and ``cuobjdump``.
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


def _classify(ops) -> collections.Counter:
    c = collections.Counter(n=len(ops))
    for op in ops:
        c[next((k for k in CLASSES if op.startswith(k)), "other")] += 1
    c["RCP"] = sum(op.startswith("MUFU.RCP") for op in ops)
    return c


def sass_mix(lib: Path, match: str):
    """({kernel name: Counter of opcode classes, with 'n' the total},
    {kernel name: [(start, end, Counter) per innermost loop]})."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    code, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = code.setdefault(m.group(1), []) if match in m.group(1) else None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    mix, loops = {}, {}
    for name, ins in code.items():
        mix[name] = _classify([op for _, op, _ in ins])
        spans = []
        for addr, op, rest in ins:
            t = re.match(r"\s*(?:`\()?0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                spans.append((int(t.group(1), 16), addr))
        inner = [a for a in spans if not any(b != a and a[0] <= b[0] and b[1] <= a[1]
                                             for b in spans)]
        loops[name] = [(lo, hi, _classify([op for a, op, _ in ins if lo <= a <= hi]),
                        [f"{op} {rest}" for a, op, rest in ins if lo <= a <= hi])
                       for lo, hi in sorted(set(inner))]
    return mix, loops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--match", default="bwd")
    ap.add_argument("--listing", action="store_true")
    args = ap.parse_args()
    from mini_opencl_raytracer_tpu_torch.ops.cuda import build
    build.library_path().unlink(missing_ok=True)  # rebuild, so that ptxas reports
    lib = build.build(verbose=True)
    lines = build.LAST_BUILD_LOG.splitlines()
    for head, props, regs in zip(lines, lines[1:], lines[2:]):
        if "Function properties" in head and args.match in head:
            name = head.split("for ")[-1]
            print(f"ptxas {name}: {props.strip()}; {regs.split(':', 1)[-1].strip()}")
    mix, loops = sass_mix(lib, args.match)
    for name, c in mix.items():
        print(f"sass {name}: {c['n']} instructions; " + ", ".join(
            f"{k} {c[k]}" for k in CLASSES) + f"; MUFU share {c['MUFU'] / max(c['n'], 1):.4f}")
        for lo, hi, lc, text in loops[name]:
            per = f", {lc['n'] / lc['RCP']:.1f} per RCP" if lc["RCP"] else ""
            print(f"  innermost loop 0x{lo:x}-0x{hi:x}: {lc['n']} instructions, RCP "
                  f"{lc['RCP']}{per}; " + ", ".join(f"{k} {lc[k]}" for k in CLASSES))
            if args.listing:
                print("\n".join(f"    {t}" for t in text))
    return 0


if __name__ == "__main__":
    sys.exit(main())
