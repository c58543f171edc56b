#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA path tracer
(``mini_opencl_raytracer_tpu_torch``): one cell of ``BENCHMARK.json`` per
run, one JSON line as the last line of standard output.

    python3 portbench/run.py --workload cornell-1080p-b9.train \\
        --seed 12345 --seconds 25 --trace 0

A run: checks for the card; makes the configuration's scene and the
traffic's inputs from the seed; sets up the program (its kernels, and
the bytecode of every module the run imports, are built into ``build/``
in the checkout on the first run and loaded from there later), builds
its accel, and warms every shape the traffic uses (``setup_s`` ends
here); drives the traffic for ``--seconds``; reads the peak device
memory; frees the program's state; holds what the window produced
against the plain reference (``correct``); and prints the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
``torch.profiler`` trace of a shorter window (``--trace 1``).

It fails, and prints no result, without a CUDA device, without the
program in the checkout, or when the process has loaded JAX or the JAX
package. Every cell's metrics and limits are found by name
(harness/cell.py).
"""

from __future__ import annotations

T_IMPORT = __import__("time").perf_counter()

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "mini_opencl_raytracer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mini_opencl_raytracer_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# Seconds between process start and this module's first line.
STARTUP = max(0.0, process_age() - (time.perf_counter() - T_IMPORT))


def forbidden_modules(modules=None) -> list:
    """The JAX names among the top-level names of ``modules`` (by default
    this process's ``sys.modules``), compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


class Context:
    """What a metric's reader reads (metrics/<name>.py: read(ctx))."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    """One run. ``device`` None is the benchmark's own look for the card;
    a test passes a device to drive the rest of a run without it."""
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell as cells
    cell = cells.load_cell(ROOT, args.workload)

    import torch
    # One host thread: the window's calls do their tensor work on the
    # device, so the host's part is a single caller's (launches, copies,
    # Python), and a pool of intra-op threads only adds to the spread
    # between runs.
    torch.set_num_threads(1)
    t_torch = time.perf_counter()
    if device is None:
        need = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: {args.workload} needs {need} CUDA device(s); this machine "
                  f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    t_card = time.perf_counter()

    import importlib
    try:
        mrt = importlib.import_module(PROGRAM)
    except ImportError as e:
        print(f"portbench: the program {PROGRAM} is not in {ROOT}: {e}", file=sys.stderr)
        return 4
    if ROOT not in Path(mrt.__file__).resolve().parents:
        print(f"portbench: {PROGRAM} was loaded from {mrt.__file__}, outside {ROOT}",
              file=sys.stderr)
        return 4

    from portbench.harness import check, traffic, trace as traces
    from portbench.reference import scenes, tracer
    t_program = time.perf_counter()

    arrays = scenes.make_scene(cell.config["scene"])
    camera = scenes.make_camera(cell.config["camera"])
    t_mix = time.perf_counter()
    mix = traffic.make(mrt, cell, arrays, camera, device, args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = STARTUP + time.perf_counter() - T_IMPORT
    parts = {"process start to first line": STARTUP,
             "harness and torch imports": t_torch - T_IMPORT, "card": t_card - t_torch,
             "program import": t_program - t_card, "scene arrays": t_mix - t_program,
             **mix.setup_parts, "accel": mix.accel_build_s}
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()),
          file=sys.stderr)

    # The window.
    seconds = args.seconds
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    after = getattr(mix, "after_call", None)
    # Set-up's objects go to the collector's permanent generation, so that
    # a collection in the window does not walk them.
    gc.collect()
    gc.freeze()
    calls = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        if prof is not None:
            with record_function(traces.CALL):
                mix.call()
        else:
            mix.call()
        calls += 1
        if after is not None:
            after()
        if time.perf_counter() >= end:
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # The program's state goes before the reference runs.
    evidence, accel_build_s, rays = mix.evidence(), mix.accel_build_s, mix.rays_per_call
    mix.free()
    del mix
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    counts = tracer.Counts.zeros(int(cell.config["render"]["bounces"]))
    t_ref = time.perf_counter()
    numbers = cell.kind().numbers(cell, arrays, camera, evidence, device, counts=counts)
    print(f"portbench: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s (accel "
          f"{accel_build_s:.4f} s), window {window_s:.3f} s, {calls} calls, "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct, checks = check.judge(numbers, cell.limits["limits"])

    ctx = Context(cell=cell, device=device, calls=calls, window_s=window_s,
                  rays_per_call=rays, setup_s=setup_s, peak_bytes=peak,
                  accel_build_s=accel_build_s, counts=counts,
                  settings=tracer.Settings.from_render(cell.config["render"]),
                  evidence=evidence, numbers=numbers, trace=None, program_kernels=[],
                  triangles=int(arrays["geometry.v0"].shape[0]))
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
                "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        tr = traces.Trace.from_profiler(prof, calls)
        ctx.trace = tr
        ctx.program_kernels = traces.program_kernels(Path(mrt.__file__).parent / "csrc")
        from portbench.harness import peaks
        ctx.card, ctx.power_limit_w = peaks.card(device.index or 0)
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        wanted = cell.per_layer
    else:
        wanted = cell.end_to_end
    metrics, notes = {}, {}
    for m in wanted:
        reader = cell.metric_reader(m["name"])
        value = reader.read(ctx)
        if value is None:
            continue
        if isinstance(value, tuple):
            value, notes[m["name"]] = value
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"portbench: this process has loaded {found}", file=sys.stderr)
        return 5
    result = {"correct": bool(correct), "attempted": calls,
              "failed": 0 if correct else max(1, int(numbers.get("_compared", 1))),
              "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if notes:
        result["notes"] = notes
    result["details"] = {k: v for k, v in numbers.items() if k.startswith("_")}
    result["checks"] = checks
    print(json.dumps(result, default=float), flush=True)
    for line in check.lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


def cache_bytecode() -> None:
    """Keep the compiled bytecode of every module a run imports in
    ``build/pycache`` in the checkout, and read it from there. Where the
    environment forbids writing it beside the sources
    (``PYTHONDONTWRITEBYTECODE``) and the installed PyTorch ships none,
    each run would otherwise compile its two thousand modules from source
    again: seconds of set-up, which swing with the host's load. Only the
    first run in a checkout writes the cache; it is keyed, as
    ``__pycache__`` is, by each source's path, size and time."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


if __name__ == "__main__":
    cache_bytecode()
    raise SystemExit(main())
