"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

``csrc/*.cu`` compile into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes), written to
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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points of csrc/megakernel.cu: (argtypes, restype). Every pointer,
# the params struct and the stream are c_void_p.
_SIGNATURES = {
    # (params, table, tris, lights, cam, pixel_ids,
    #  o, d, beta, alive, rad, idx, occ, seeds, stream)
    "mrt_bounce0_fwd": ([_P] * 15, _I),
    # (params, table, tris, lights, o_in, d_in, beta_in, alive_in, seeds,
    #  o, d, beta, alive, rad, idx, occ, stream)
    "mrt_bounce_fwd": ([_P] * 17, _I),
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


def build(verbose: bool = False) -> Path:
    """Compile the sources if their library is missing; return its path.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) to a fresh build; its output lands in ``LAST_BUILD_LOG``."""
    global LAST_BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-I", str(CSRC), "-o", tmp] + cu
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        LAST_BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{LAST_BUILD_LOG}")
        os.replace(tmp, out)   # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
