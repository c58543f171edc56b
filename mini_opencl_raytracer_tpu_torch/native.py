"""Native (C++) host components: OBJ parsing and the binned-SAH build.

The port's ctypes loader for the C++ sources in the repository's
``native/`` directory (``objparse.cpp``, ``sahbvh.cpp``), the same
sources and the same ``g++`` flags as the JAX package uses, so both
packages get the same SAH layout. The library is built at first use into
``build/native/`` at the repository root, under a name keyed by a hash of
the sources, the flags and what ``-march=native`` resolves to on this
host, so neither a stale library nor one built for another CPU is ever
loaded. Without a compiler everything returns None and callers take
their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
_SOURCES = [_REPO / "native" / f for f in ("objparse.cpp", "sahbvh.cpp")]
BUILD_DIR = _REPO / "build" / "native"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


@functools.lru_cache(maxsize=None)
def _target() -> str:
    """The target options ``-march=native`` selects on this host (empty
    without g++): a library built for another CPU may use instructions
    this one lacks."""
    try:
        out = subprocess.run(["g++"] + _FLAGS[:2] + ["-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (subprocess.SubprocessError, FileNotFoundError):
        return ""
    return out.stdout


def library_path() -> Path:
    """Where the library for the current sources, flags and host CPU
    lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_target().encode())
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmrt_native_{h.hexdigest()[:16]}.so"


def _build_library() -> Optional[Path]:
    if not all(s.exists() for s in _SOURCES):
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        cmd = ["g++"] + _FLAGS + ["-o", so] + [str(s) for s in _SOURCES]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(so, out)   # atomic: a reader never sees half a file
    return out


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _lib_failed = True
            return None
        lib.obj_count.restype = ctypes.c_int64
        lib.obj_count.argtypes = [ctypes.c_char_p]
        lib.obj_num_materials.restype = ctypes.c_int
        lib.obj_material_name.restype = ctypes.c_int
        lib.obj_material_name.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.obj_fill.restype = ctypes.c_int
        lib.obj_fill.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [
            ctypes.POINTER(ctypes.c_int32)]
        lib.sah_build.restype = ctypes.c_int
        lib.sah_build.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_library() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_obj_native(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray,
                                                  List[str]]]:
    """Parse an OBJ with the C++ parser.

    Returns (v [3,T,3], n [3,T,3], uv [3,T,2], mat_idx [T], usemtl names)
    or None if the native library is unavailable or the parse failed.
    """
    lib = get_library()
    if lib is None:
        return None
    T = lib.obj_count(path.encode())
    if T < 0:
        return None
    v = np.empty((3, T, 3), np.float32)
    n = np.empty((3, T, 3), np.float32)
    uv = np.empty((3, T, 2), np.float32)
    mat = np.empty((T,), np.int32)
    names = []
    buf = ctypes.create_string_buffer(512)
    for i in range(lib.obj_num_materials()):
        lib.obj_material_name(i, buf, 512)
        names.append(buf.value.decode())
    if lib.obj_fill(_fptr(v), _fptr(n), _fptr(uv), _iptr(mat)) != 0:
        return None
    return v, n, uv, mat, names


def sah_order(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_size: int = 64) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]]:
    """Binned-SAH build -> (order [T], leaf_starts [L], leaf_counts [L]).

    ``order`` is the depth-first triangle permutation; consecutive leaf
    ranges are spatially tight (the clustered kernel's SAH layout). None
    if the native library is unavailable.
    """
    lib = get_library()
    if lib is None:
        return None
    T = int(v0.shape[0])
    if T == 0:
        return (np.zeros(0, np.int32),) * 3
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    order = np.empty((T,), np.int32)
    max_leaves = 2 * T + 8
    starts = np.empty((max_leaves,), np.int32)
    counts = np.empty((max_leaves,), np.int32)
    L = lib.sah_build(T, _fptr(v0), _fptr(v1), _fptr(v2), int(leaf_size),
                      _iptr(order), _iptr(starts), _iptr(counts), max_leaves)
    if L < 0:
        return None
    return order, starts[:L].copy(), counts[:L].copy()
