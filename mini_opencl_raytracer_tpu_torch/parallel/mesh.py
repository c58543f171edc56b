"""Device meshes for sharded rendering (the JAX package's
``parallel/mesh.py``).

A mesh lays the process group's ranks out on two named dimensions:

* ``dp``: data parallel over pixels (the reference's one work item per
  pixel, CLRaytracer.cpp:53-54, spread over devices);
* ``tp``: geometry parallel: triangle buffers sharded over the devices,
  rays passed between the shards (parallel/shard.py).

One rank is one process holding one device, so a mesh covers the whole
group: ``dp * tp`` must equal the world size (the JAX version may leave
devices out instead).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import MeshConfig, default_device


def _device_type(device_type: str) -> str:
    """Raises for CUDA without a card, as config.default_device does."""
    return default_device(device_type).type


def make_mesh(cfg: MeshConfig = MeshConfig(),
              device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over the initialised process group; ``dp``
    defaults to world // tp."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize first")
    n = dist.get_world_size()
    tp = max(cfg.tp, 1)
    if n % tp:
        raise ValueError(f"device count {n} not divisible by tp={tp}")
    dp = cfg.dp or n // tp
    if dp * tp != n:
        raise ValueError(f"dp={dp} x tp={tp} does not cover the {n} ranks")
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=(cfg.dp_axis, cfg.tp_axis))


def single_device_mesh(cfg: MeshConfig = MeshConfig(),
                       device_type: str = "cuda") -> DeviceMesh:
    """1x1 mesh (for code paths that always go through a mesh). Starts a
    group of one process on an in-memory store if there is none."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("a 1x1 mesh needs a group of one process, not "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=(cfg.dp_axis, cfg.tp_axis))
