"""The LBVH walk of the ``bvh`` backend as a CUDA kernel.

The kernel, written by hand in ``csrc/bvh.cu``, is the counterpart of the
JAX package's LBVH walk (``ops/bvh.py:_intersect_one``, a vmapped
``lax.while_loop`` in jnp that XLA runs on the device); it is not the port
of a Pallas kernel. Its plain version is ``ops/bvh.walk_plain``, the
host loop over the live rays. ``walk`` runs the plain version for tensors
on the CPU and launches the kernel for tensors on a CUDA device; there is
no fallback between the two. ``build.LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import torch

from . import build

# Stack entries of a ray in the kernel (csrc/bvh.cu kMaxStack); a walk
# needs the tree's depth + 2.
MAX_STACK = 64


def walk(o, d, t_init, bvh, backface_cull: bool = False):
    """Closest hit below ``t_init`` [R] of rays o, d [R, 3] through ``bvh``
    (an ``ops/bvh.BVH``): (best t [R], best slot [R] int64, 0 where
    nothing is below t_init), bitwise the plain walk's."""
    device = o.device
    if device.type == "cpu":
        from ..bvh import walk_plain   # ops/bvh imports this module
        return walk_plain(o, d, t_init, bvh, backface_cull)
    if device.type != "cuda":
        raise ValueError(f"bvh_walk runs on cpu or cuda, not {device}")
    if bvh.depth + 2 > MAX_STACK:
        raise ValueError(f"a tree of depth {bvh.depth} outgrows the kernel's stack of "
                         f"{MAX_STACK} entries")
    R, N, S = o.shape[0], bvh.num_nodes, bvh.num_leaves * bvh.leaf_size
    named = {"o": o, "d": d, "t_init": t_init, "node_lo": bvh.node_lo,
             "node_hi": bvh.node_hi, "pv0": bvh.pv0, "pv1": bvh.pv1, "pv2": bvh.pv2}
    build.refuse_grad(named)
    for n, shape in (("o", (R, 3)), ("d", (R, 3)), ("t_init", (R,)), ("node_lo", (N, 3)),
                     ("node_hi", (N, 3)), ("pv0", (S, 3)), ("pv1", (S, 3)), ("pv2", (S, 3))):
        build.check_tensor(named[n], n, torch.float32, shape, device)
    t_out = torch.empty((R,), dtype=torch.float32, device=device)
    slot = torch.empty((R,), dtype=torch.int64, device=device)
    if R:
        build.launch("bvh_walk", device, lambda _: (
            R, bvh.num_leaves, bvh.leaf_size, int(backface_cull), bvh.node_lo, bvh.node_hi,
            bvh.pv0, bvh.pv1, bvh.pv2, o, d, t_init, t_out, slot))
    return t_out, slot
