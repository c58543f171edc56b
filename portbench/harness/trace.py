"""Reduction of a ``torch.profiler`` trace to the per-layer quantities.

The traced window runs the cell's calls under the profiler, each inside
a ``portbench.call`` range. From the trace:

* the window: the first call's start to the last call's end, host side;
* device busy time: the union of every device interval (kernels, copies,
  fills) inside the window, so overlapping work counts once;
* device time by kernel name, and which kernels are the program's own
  (the ``__global__`` functions of its CUDA sources);
* idle gaps: the stretches of the window with nothing on the device,
  each named by the innermost host range open at its middle, and the
  idle time that falls inside the host's events of one name.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CALL = "portbench.call"
_GLOBAL = re.compile(r"__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def program_kernels(csrc: Path) -> List[str]:
    """Names of the ``__global__`` functions in a folder of CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text()))
    return sorted(names)


def kernel_base(name: str) -> str:
    """A device event's function name without return type, namespaces,
    template arguments or parameters: "void (anonymous namespace)::k<1>
    (float*)" -> "k"."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    head = head.strip().split()[-1] if head.strip() else name
    return head.rsplit("::", 1)[-1]


def _merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """Device and host intervals of one traced window, in ns."""

    def __init__(self, device: Sequence[Tuple[str, int, int]],
                 host: Sequence[Tuple[str, int, int]], calls: int):
        spans = [(a, b) for n, a, b in host if n == CALL]
        self.calls = calls
        self.start = min(a for a, _ in spans) if spans else 0
        self.end = max(b for _, b in spans) if spans else 0
        self.device = [(n, max(a, self.start), min(b, self.end)) for n, a, b in device
                       if b > self.start and a < self.end]
        self.host = [(n, a, b) for n, a, b in host if n != CALL]
        self._busy = _merge((a, b) for _, a, b in self.device if b > a)

    @staticmethod
    def from_profiler(prof, calls: int) -> "Trace":
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            a, dur = e.start_ns(), e.duration_ns()
            row = (e.name(), a, a + dur)
            if str(e.device_type()).endswith("CPU"):
                host.append(row)
            elif not e.is_user_annotation():   # a host range mirrored on the device
                device.append(row)
        return Trace(device, host, calls)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e9

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            out[n] = out.get(n, 0.0) + (b - a) / 1e9
        return out

    def kernel_seconds(self, bases: Iterable[str], then: Optional[str] = None) -> float:
        """Device seconds of the kernels whose base name is in ``bases``;
        with ``then``, each launch of ``then`` that directly follows one of
        them on the device counts with it."""
        bases = set(bases)
        total, prev = 0.0, None
        for n, a, b in sorted(self.device, key=lambda r: r[1]):
            base = kernel_base(n)
            if base in bases or (then is not None and base == then and prev in bases):
                total += (b - a) / 1e9
            prev = base
        return total

    def _gaps(self) -> List[Tuple[int, int]]:
        """The stretches of the window with nothing on the device."""
        gaps, t = [], self.start
        for a, b in self._busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def idle_inside(self, name: str) -> float:
        """Seconds of the window in which the device is idle while the host
        is inside an event (an operation, a CUDA runtime call) named
        ``name``."""
        inside = _merge((a, b) for n, a, b in self.host if n == name)
        total, i = 0, 0
        for a, b in self._gaps():
            while i < len(inside) and inside[i][1] <= a:
                i += 1
            j = i
            while j < len(inside) and inside[j][0] < b:
                total += min(b, inside[j][1]) - max(a, inside[j][0])
                j += 1
        return total / 1e9

    def other_seconds(self, own: Iterable[str]) -> float:
        """Device seconds of everything that is not one of ``own`` kernels."""
        own = set(own)
        return sum((b - a) / 1e9 for n, a, b in self.device if kernel_base(n) not in own)

    def top_ops(self, n: int = 10) -> List[List]:
        by = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], s] for name, s in by]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time of the window summed by what the host was doing in
        each gap (the innermost host range open at its middle)."""
        gaps = self._gaps()
        host = sorted(self.host, key=lambda r: r[1])
        starts = [a for _, a, _ in host]
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for name, ha, hb in host[max(0, i - 400):i]:
                if ha <= mid < hb and (best is None or hb - ha < best[1]):
                    best = (name, hb - ha)
            key = best[0][:120] if best else "host between operations"
            by[key] = by.get(key, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
