"""Process-group start-up for multi-process rendering (the JAX package's
``parallel/multihost.py``).

PyTorch runs one process per rank. ``initialize`` joins this process to
the group: from explicit arguments, or from the variables a launcher
such as ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), as the JAX version reads its
coordinator's. The meshes of parallel/mesh.py are then laid over the
group's ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import default_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join the process group; True once this process is in one.

    Returns False, and does nothing, when the process is single: no
    ``coordinator_address`` and no launcher environment (``WORLD_SIZE``).
    Safe to call twice. ``backend`` defaults to ``"nccl"`` when ``device``
    (default ``config.DEFAULT_DEVICE``) is CUDA and ``"gloo"`` when it is
    the CPU; a CUDA device without a card raises, and a failed init
    raises: no other backend is tried.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "WORLD_SIZE" not in env:
        return False
    dev = default_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(env.get("LOCAL_RANK", 0)))
    if coordinator_address is None:
        init_method = "env://"
        world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        rank = int(env["RANK"]) if process_id is None else process_id
    else:
        # host:port is a TCP rendezvous; a URL (tcp://, file://) is used
        # as it is.
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        world, rank = num_processes, process_id
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank)
    return True


def process_info():
    """(rank, world size, local device count): the CUDA devices this
    process sees, or 1 for a CPU process."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return rank, world, torch.cuda.device_count() or 1
