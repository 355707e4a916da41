"""deepspeed_tpu_torch.comm — ``torch.distributed`` behind DeepSpeed's comm
surface.

Counterpart of ``deepspeed_tpu/comm/__init__.py`` (``is_initialized`` line
46, ``init_distributed`` line 50, ``barrier`` line 106, ``get_topology`` line
121, ``get_rank`` line 140, ``destroy_process_group`` line 149). Where the JAX
package's backend is the XLA runtime, here ``init_distributed`` starts the
default process group (with the caller's backend, as DeepSpeed's
``dist_backend``: NCCL when CUDA is present, else gloo) and builds the
:class:`MeshTopology` over its ranks; the ops in :mod:`.collectives` take the
topology's per-axis groups.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import log_dist
from . import collectives  # noqa: F401
from .collectives import (all_gather, all_reduce, all_to_all, broadcast,  # noqa: F401
                          ring_shift)
from .topology import AXIS_ORDER, MeshTopology, ParallelDims  # noqa: F401

_TOPOLOGY: Optional[MeshTopology] = None


def is_initialized() -> bool:
    return _TOPOLOGY is not None


def default_backend() -> str:
    """DeepSpeed's accelerator default: NCCL with CUDA, gloo without."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(dist_backend: Optional[str] = None,
                     dims: Optional[ParallelDims] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> MeshTopology:
    """Parity: deepspeed.init_distributed().

    Starts the default process group unless one exists: with
    ``dist_backend`` (default :func:`default_backend`), ``init_method``,
    ``world_size`` and ``rank`` as given, or from the launcher's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with
    neither, the job is one process and no group starts. Then builds the
    topology ``dims`` over the world (a dp-only one by default). Every rank
    calls it at the same point of its program."""
    global _TOPOLOGY
    if not dist.is_initialized():
        ws = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
        if ws > 1 or init_method is not None:
            dist.init_process_group(
                backend=dist_backend or default_backend(),
                init_method=init_method or "env://", world_size=ws,
                rank=rank if rank is not None else int(os.environ.get("RANK", "0")))
    elif dist_backend is not None and dist.get_backend() != dist_backend:
        raise ValueError(f"init_distributed: the process group runs {dist.get_backend()}, "
                         f"not the {dist_backend} asked for")
    if dims is not None or _TOPOLOGY is None:
        _TOPOLOGY = MeshTopology(dims or ParallelDims())
    log_dist(f"init_distributed: {_TOPOLOGY}"
             + (f", backend {dist.get_backend()}" if dist.is_initialized() else ""))
    return _TOPOLOGY


def get_topology() -> MeshTopology:
    if _TOPOLOGY is None:
        init_distributed()
    return _TOPOLOGY


def get_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Parity: deepspeed.comm.barrier; a no-op in a one-process job."""
    if dist.is_initialized():
        dist.barrier()


def destroy_process_group() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None
    if dist.is_initialized():
        dist.destroy_process_group()
