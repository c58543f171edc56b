"""The backward of the per-triangle material gather as a CUDA reduction.

``ops/shading.material_rows`` gathers each triangle's material columns
(Kd, Ks, Ke, Ns) from the packed ``[M, 10]`` material block. Its gradient
is the sum of the ``[T, 10]`` cotangent rows by material. The kernel,
written by hand in ``csrc/material_rows.cu``, is the counterpart of the
VJP of ``jnp.take`` in the JAX package's ``build_shading_table``; it is not
the port of a Pallas kernel. It replaces PyTorch's sort-based
``index_put_(accumulate=True)`` (``reduce_plain``, the plain version the
kernel is held against), which walks each material's rows one after
another, with a deterministic segmented reduction that takes any number
of materials, in float32 or float64. ``build.LAUNCHES`` counts its calls.
"""

from __future__ import annotations

import torch

from . import build

COLS = 10
_BLOCK = 256
_F64 = {torch.float32: 0, torch.float64: 1}


def rows_per_block(num_materials: int) -> int:
    """Rows of the cotangent a block reduces (csrc/material_rows.cu): four
    rounds of 256, more where M is large, so the partials stay small."""
    return _BLOCK * max(4, -(-num_materials // 64))


def reduce_plain(cot: torch.Tensor, mat_idx: torch.Tensor, num_materials: int) -> torch.Tensor:
    """cot [T, C], mat_idx [T] int64 -> [M, C]: the rows summed by
    material, as autograd's backward of ``packed[mat_idx]``."""
    out = cot.new_zeros((num_materials, cot.shape[1]))
    return out.index_put_((mat_idx,), cot, accumulate=True)


def reduce_by_material(cot: torch.Tensor, mat_idx: torch.Tensor,
                       num_materials: int) -> torch.Tensor:
    """cot [T, 10] float32 or float64 on a CUDA device (any strides),
    mat_idx [T] contiguous int64 on the same device -> d_packed [M, 10]
    in cot's dtype."""
    device = cot.device
    T = mat_idx.shape[0]
    if (device.type != "cuda" or cot.dtype not in _F64 or tuple(cot.shape) != (T, COLS)
            or mat_idx.dtype != torch.int64 or mat_idx.device != device
            or not mat_idx.is_contiguous() or num_materials < 1):
        raise ValueError(f"material_rows: cotangent {cot.dtype} {tuple(cot.shape)} on {device}, "
                         f"indices {mat_idx.dtype} {tuple(mat_idx.shape)} on {mat_idx.device}, "
                         f"{num_materials} materials: expected float32 or float64 [T, {COLS}] "
                         "and contiguous int64 [T] on one CUDA device, and M >= 1")
    M, rows = num_materials, rows_per_block(num_materials)
    part = torch.empty((-(-T // rows), M * COLS), dtype=cot.dtype, device=device)
    out = torch.empty((M, COLS), dtype=cot.dtype, device=device)
    build.launch("material_rows_bwd", device, lambda _: (
        T, M, rows, _F64[cot.dtype], cot, cot.stride(0), cot.stride(1), mat_idx, part, out))
    return out
