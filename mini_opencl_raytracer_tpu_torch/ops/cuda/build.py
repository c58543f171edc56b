"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

``csrc/*.cu`` compile in parallel, one ``nvcc`` per source, and link into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes), written to
``build/torch_kernels/`` at the repository root (utils/cache.py) under a name keyed by a
hash of the sources and flags, so a stale library is never loaded. The
build runs at first use, never at import: importing this module needs
neither CUDA nor ``nvcc``.

It is also the one seam between the kernel wrappers (``ops/cuda/*.py``)
and the library: ``launch`` calls an entry point on the current stream,
checks its error and counts it; ``check_tensor`` and ``refuse_grad`` check
a wrapper's inputs. ``LAUNCHES`` counts the launches by name and ``RAYS``
the rays each kind of launch was handed (each launch's R, from its shapes
on the host; ``shade_plain`` counts the rays the integrator shades in
PyTorch on a CUDA device instead, ``shade_adjoint`` those the shading's
adjoint kernel differentiates; ``mega_fwd`` the rays each K1 / K2 launch
is handed, ``mega_shadow`` those times the lights where the launch casts
shadow rays: the any-hit slots it may fill; ``raygen_fused`` the rays the
raygen kernel generated, ``raygen_plain`` those PyTorch generated for the
wavefront on a CUDA device; ``wave_shadow`` the shadow-ray slots the
wavefront's light loop hands its any-hit intersector on a CUDA device, the
rays times the lights of each bounce that casts shadow rays). A compiled
program's replays add what its capture counted to both (jit.py), and
``RAYS`` also to ``jit.COUNTS`` as ``<name>_rays``. Plain runs on the CPU
count nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from ...utils.cache import KERNEL_DIR as BUILD_DIR

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
# -fmad=false: no multiply-add contraction, so the kernels round like
# their plain PyTorch versions (csrc/megakernel.cu explains why).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points of csrc/*.cu: (argtypes, restype). Every pointer, the
# params struct and the stream are c_void_p.
_SIGNATURES = {
    # (params, frame_cm, table, tris, lights, cam, pixel_ids,
    #  o, d, beta, alive, rad, idx, occ, seeds, stats, stream)
    "mrt_bounce0_fwd": ([_P] * 17, _I),
    # (params, table, tris, lights, o_in, d_in, beta_in, alive_in, seeds,
    #  o, d, beta, alive, rad, idx, occ, resid, rank, count, stream)
    "mrt_bounce_fwd": ([_P] * 20, _I),
    # (params, grid, smem_table, frame_cm, table, lights, cam, pixel_ids,
    #  winner, occ, co, cd, cbeta, crad, part, d_table, d_lights, d_cam,
    #  stream)
    "mrt_bounce0_bwd": ([_P] + [_I] * 2 + [_P] * 16, _I),
    # (params, grid, smem_table, table, lights, o, d, beta, alive, seeds,
    #  winner, occ, co, cd, cbeta, crad, part, d_o, d_d, d_beta, d_table,
    #  d_lights, resid, rank, stream)
    "mrt_bounce_bwd": ([_P] + [_I] * 2 + [_P] * 22, _I),
    # csrc/panel.cu: (R, T, cull, any, tris, o, d, t_init, t_out, idx,
    #  stats, stream)
    "mrt_panel": ([_I] * 4 + [_P] * 8, _I),
    # csrc/clustered.cu: (R, inner nodes, clusters, grid, cull, any, tree,
    #  cl_aabb, tris, slot_to_tri, cl_count, attrs, o, d, t_init, t_out,
    #  slot, rows, stats, counter, stream); (any, out)
    "mrt_clustered": ([_I] * 6 + [_P] * 15, _I),
    "mrt_clustered_blocks_per_sm": ([_I, _P], _I),
    # csrc/bvh.cu: (R, leaves, leaf_size, cull, node_lo, node_hi, pv0, pv1,
    #  pv2, o, d, t_init, t_out, slot, stream)
    "mrt_bvh_walk": ([_I] * 4 + [_P] * 11, _I),
    # csrc/material_rows.cu: (T, M, rows, f64, cot, row stride, column
    #  stride, mat, part, d_packed, stream)
    "mrt_material_rows_bwd": ([_I] * 4 + [_P] + [ctypes.c_longlong] * 2 + [_P] * 4, _I),
    # csrc/shade.cu: (params, rows, table, tri_idx, hit, alive, seeds, lights,
    #  then o, d, beta, rad each with its row stride, o_out, d_out, beta_out,
    #  rad_out, alive_out, stream)
    "mrt_shade": ([_P] * 8 + [_P, ctypes.c_longlong] * 4 + [_P] * 6, _I),
    # csrc/shade_bwd.cu: (params, grid, rows, hit, alive, seeds, lights, then
    #  o, d, beta, the cotangents co, cd, cbeta, crad each with its row
    #  stride, part, d_o, d_d, d_beta, d_rows, d_lights, stream)
    "mrt_shade_bwd": ([_P, _I] + [_P] * 5 + [_P, ctypes.c_longlong] * 7 + [_P] * 7, _I),
    # csrc/raygen.cu: (params, frame_cm, cam, pixel_ids, seeds, d, stream)
    "mrt_raygen": ([_P] * 7, _I),
    "mrt_error_string": ([_I], ctypes.c_char_p),
}

# The launches by name, and the entry point each calls; a residual variant
# of a mega kernel counts apart from the kernel.
_ENTRIES = {
    "bounce0_fwd": "mrt_bounce0_fwd", "bounce_fwd": "mrt_bounce_fwd",
    "bounce_fwd_resid": "mrt_bounce_fwd", "bounce0_bwd": "mrt_bounce0_bwd",
    "bounce_bwd": "mrt_bounce_bwd", "bounce_bwd_resid": "mrt_bounce_bwd",
    "panel_closest": "mrt_panel", "panel_any": "mrt_panel",
    "clustered_closest": "mrt_clustered", "clustered_any": "mrt_clustered",
    "bvh_walk": "mrt_bvh_walk", "material_rows_bwd": "mrt_material_rows_bwd",
    "shade": "mrt_shade", "shade_adjoint": "mrt_shade_bwd", "raygen": "mrt_raygen",
}
LAUNCHES = dict.fromkeys(_ENTRIES, 0)
RAYS = dict.fromkeys(("clustered_closest", "clustered_any", "shade_fused", "shade_plain",
                      "shade_adjoint", "mega_fwd", "mega_shadow", "raygen_fused",
                      "raygen_plain", "wave_shadow"), 0)

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


@contextlib.contextmanager
def _on(device):
    """The device guard of ``device`` and its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device, args: Callable[[int], Sequence],
           rays: Optional[Dict[str, int]] = None) -> None:
    """Launch ``name`` (a key of ``LAUNCHES``) on ``device``'s current
    stream: ``args(stream)`` gives its entry point's arguments before the
    stream, a tensor among them passing its data pointer and None a null
    one. Raises with ``name`` if the entry point returns an error; else
    counts the launch, and ``rays`` ({key of ``RAYS``: count})."""
    entry = getattr(library(), _ENTRIES[name])
    with _on(device) as stream:
        err = entry(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args(stream)], stream)
    check(err, name)
    LAUNCHES[name] += 1
    for kind, n in (rays or {}).items():
        RAYS[kind] += n


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (TypeError for the dtype, ValueError otherwise)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(tensors: Dict[str, Optional[torch.Tensor]],
                why: str = "intersection is not differentiable; detach the inputs") -> None:
    """A wrapper is not differentiable: raise ValueError, ``why`` after the
    name, if grad mode is on and one of ``tensors`` requires grad."""
    if torch.is_grad_enabled():
        for name, t in tensors.items():
            if t is not None and t.requires_grad:
                raise ValueError(f"{name} requires grad: {why}")
