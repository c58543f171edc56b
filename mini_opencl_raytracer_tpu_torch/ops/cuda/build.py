"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

``csrc/*.cu`` compile in parallel, one ``nvcc`` per source, and link into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes), written to
``build/torch_kernels/`` at the repository root under a name keyed by a
hash of the sources and flags, so a stale library is never loaded. The
build runs at first use, never at import: importing this module needs
neither CUDA nor ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# -fmad=false: no multiply-add contraction, so the kernels round like
# their plain PyTorch versions (csrc/megakernel.cu explains why).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points of csrc/*.cu: (argtypes, restype). Every pointer, the
# params struct and the stream are c_void_p.
_SIGNATURES = {
    # (params, table, tris, lights, cam, pixel_ids,
    #  o, d, beta, alive, rad, idx, occ, seeds, stats, stream)
    "mrt_bounce0_fwd": ([_P] * 16, _I),
    # (params, table, tris, lights, o_in, d_in, beta_in, alive_in, seeds,
    #  o, d, beta, alive, rad, idx, occ, stream)
    "mrt_bounce_fwd": ([_P] * 17, _I),
    # (params, grid, smem_table, table, lights, cam, pixel_ids, winner,
    #  occ, co, cd, cbeta, crad, part, d_table, d_lights, d_cam, stream)
    "mrt_bounce0_bwd": ([_P] + [_I] * 2 + [_P] * 15, _I),
    # (params, grid, smem_table, table, lights, o, d, beta, alive, seeds,
    #  winner, occ, co, cd, cbeta, crad, part, d_o, d_d, d_beta, d_table,
    #  d_lights, stream)
    "mrt_bounce_bwd": ([_P] + [_I] * 2 + [_P] * 20, _I),
    # csrc/panel.cu: (R, T, cull, any, tris, o, d, t_init, t_out, idx,
    #  stats, stream)
    "mrt_panel": ([_I] * 4 + [_P] * 8, _I),
    # csrc/clustered.cu: (R, inner nodes, clusters, grid, cull, any, tree,
    #  cl_aabb, tris, slot_to_tri, cl_count, attrs, o, d, t_init, t_out,
    #  slot, rows, stats, counter, stream); (any, out)
    "mrt_clustered": ([_I] * 6 + [_P] * 15, _I),
    "mrt_clustered_blocks_per_sm": ([_I, _P], _I),
    "mrt_error_string": ([_I], ctypes.c_char_p),
}

_LIB: Optional[ctypes.CDLL] = None
LAST_BUILD_LOG = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmrt_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands in parallel; return their output, or raise with the
    first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{o}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the sources if their library is missing; return its path.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) to a fresh build; its output lands in ``LAST_BUILD_LOG``."""
    global LAST_BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, compiles = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            compiles.append([nvcc] + NVCC_FLAGS
                            + (["-Xptxas", "-v"] if verbose else [])
                            + ["-I", str(CSRC), "-c", "-o", objs[-1], str(src)])
        LAST_BUILD_LOG = _run(compiles)
        so = os.path.join(tmp, "lib.so")
        LAST_BUILD_LOG += _run([[nvcc, "-shared", "-o", so] + objs])
        os.replace(so, out)   # atomic: a reader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        msg = library().mrt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
