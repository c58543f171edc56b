"""The directories where the port's compiled code lives.

The JAX package keeps a persistent XLA compilation cache; the port's
counterpart is its build directory at the repository root, which keeps
the nvcc-built kernel library (``build/torch_kernels/``, ops/cuda/build.py)
and the g++-built native library (``build/native/``, native.py) between
processes, each under a name keyed by a hash of its sources and flags.
"""

from __future__ import annotations

from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
KERNEL_DIR = BUILD_ROOT / "torch_kernels"
NATIVE_DIR = BUILD_ROOT / "native"


def enable_persistent_cache() -> Path:
    """Create the build directories; return the kernel build directory."""
    for path in (KERNEL_DIR, NATIVE_DIR):
        path.mkdir(parents=True, exist_ok=True)
    return KERNEL_DIR
