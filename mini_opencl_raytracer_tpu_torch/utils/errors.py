"""Typed device-error layer: decode runtime and build failures into
actionable exceptions (the JAX package's ``utils/errors.py``).

The reference wraps every OpenCL status in a ``CLException`` with an
error-name table (CLutils.h:29-105) and shows it in a message box
(CLEngineBase.cpp:181-185). Here the failures this stack raises are
classified into the JAX package's exception classes, with the remedy
attached:

* device out of memory: ``torch.cuda.OutOfMemoryError`` ("CUDA out of
  memory"), or a kernel wrapper's ``cudaError_t`` 2 ("out of memory",
  ops/cuda/build.check);
* kernel build or load failures: "nvcc not found" / "nvcc failed"
  (ops/cuda/build.py), a kernel image the card cannot run;
* no card: ``config.default_device``'s "there is no CUDA device here",
  the CUDA runtime's "no CUDA-capable device";
* sharding mismatches, by the JAX package's message strings.
"""

from __future__ import annotations

from typing import Callable, TypeVar

T = TypeVar("T")


class RaytracerError(RuntimeError):
    """Base class for decoded device-layer failures."""


class DeviceOutOfMemoryError(RaytracerError):
    """Device memory exhausted. Remedies: lower width/height or spp, or
    render fewer pixels per call."""


class KernelCompileError(RaytracerError):
    """A CUDA kernel failed to build or load for this card. Remedies: check
    the CUDA toolkit (nvcc for sm_90a), or render with backend='bvh' or
    'bruteforce' (plain PyTorch) and report the kernel and shapes."""


class NoAcceleratorError(RaytracerError):
    """No usable CUDA device. Remedies: pass device='cpu' (--device cpu) to
    run the plain PyTorch versions on the CPU, or fix the CUDA driver."""


class ShardingError(RaytracerError):
    """Mesh/sharding mismatch (e.g. pixel count not divisible by the dp
    axis). Remedies: pick width*height divisible by the mesh axis sizes
    or adjust MeshConfig."""


_CLASSIFIERS = (
    (("out of memory",), DeviceOutOfMemoryError),
    (("nvcc not found", "nvcc failed", "no kernel image is available",
      "invalid device function", "PTX JIT"), KernelCompileError),
    (("there is no CUDA device here", "no CUDA-capable device",
      "CUDA driver version is insufficient"), NoAcceleratorError),
    (("not divisible", "sharding", "NamedSharding mismatch"), ShardingError),
)


def _is_runtime_exc(exc: BaseException) -> bool:
    """Only the exception types the runtime and the build raise
    (``torch.cuda.OutOfMemoryError`` subclasses RuntimeError) are
    classified: an application error whose message happens to mention
    'sharding' is not rewrapped."""
    return isinstance(exc, (RuntimeError, ValueError, OSError))


def decode_error(exc: BaseException) -> RaytracerError | None:
    """Map a raw runtime exception to a typed RaytracerError, or None if
    unrecognised. The caller chains the original (``raise decoded from
    exc``)."""
    if isinstance(exc, RaytracerError) or not _is_runtime_exc(exc):
        return None
    msg = str(exc)
    for needles, cls in _CLASSIFIERS:
        if any(n in msg for n in needles):
            summary = msg.strip().splitlines()[0][:300]
            return cls(f"{' '.join(cls.__doc__.split())} [{summary}]")
    return None


def run_decoded(fn: Callable[[], T]) -> T:
    """Run ``fn``, re-raising recognised device failures as typed
    exceptions with the original chained (the CLI's counterpart of the
    reference's CLException -> MessageBox path)."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - deliberate broad decode
        decoded = decode_error(exc)
        if decoded is not None:
            raise decoded from exc
        raise
