"""Checkpoint / resume for progressive renders and optimisation loops.

The reference keeps its accumulation only in the device buffer (its File
> Save/Load items are empty stubs, CLui.cpp:146-158). Here the state is
a tree of dataclasses, dicts, lists and arrays saved as one ``.npz``
whose keys are the JAX package's pytree key paths (``.radiance_sum``,
``.geometry/.v0``, ``['name']``, ``[0]``), so a checkpoint written by
either package loads in the other. A progressive render state holds
``.radiance_sum`` (float32 [H, W, 3]) and ``.num_samples`` (int32 []).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..render import RenderState


def _walk(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """Rebuild ``tree`` with every leaf replaced by ``fn(key, leaf)``; keys
    as ``jax.tree_util`` prints key paths, joined by "/"."""
    join = lambda k: f"{path}/{k}" if path else k
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _walk(getattr(tree, f.name), fn, join(f".{f.name}"))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, join(f"[{k!r}]")) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, join(f"[{i}]")) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> str:
    """Save every array leaf of ``tree`` to one .npz file, atomically
    (written to ``path + ".tmp"`` first, then renamed)."""
    flat: Dict[str, np.ndarray] = {}
    _walk(tree, lambda key, leaf: flat.__setitem__(key, _numpy(leaf)))
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    return path


def load_pytree(path: str, template: Any) -> Any:
    """Load arrays saved by save_pytree into ``template``'s structure.
    Each leaf takes the template leaf's shape check, dtype and device;
    a Python number leaf comes back as a Python number."""
    with np.load(path) as data:
        flat = dict(data)

    def leaf(key, ref):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, want = flat[key], _numpy(ref)
        if arr.shape != want.shape:
            raise ValueError(f"shape mismatch for {key!r}: {arr.shape} vs {want.shape}")
        arr = arr.astype(want.dtype)
        if isinstance(ref, torch.Tensor):
            return torch.from_numpy(arr).to(ref.device)
        if isinstance(ref, (int, float, bool)):
            return type(ref)(arr)
        return arr

    return _walk(template, leaf)


def save_render_state(path: str, state: RenderState) -> str:
    """Save a progressive render state in the JAX package's format."""
    return save_pytree(path, dataclasses.replace(state,
                                                 num_samples=np.int32(state.num_samples)))


def load_render_state(path: str, template: RenderState) -> RenderState:
    return load_pytree(path, template)
