"""A local launcher: one function run by every rank of a world of spawned
processes on this host.

The counterpart of the JAX package's ``local`` launcher backend
(``deepspeed_tpu/launcher/runner.py``) for ``torch.distributed``: each rank is
a fresh process (the ``spawn`` start method, so a parent that has touched
CUDA can start CUDA ranks), joins the default process group through a
``file://`` rendezvous in a temporary directory (no port to collide on) with
the caller's backend, runs ``fn(rank, *args)``, and hands its picklable
result back through a file. Used by the sequence-parallel tests on the CPU
(gloo) and by ``chip_smoke.py``, whose ranks share one card over gloo.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from . import comm


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, workdir: str,
               threads: int, args: Sequence[Any]) -> None:
    # the ranks share the caller's cores: no rank spins on all of them
    torch.set_num_threads(threads)
    if backend == "nccl":  # one card a rank, as NCCL requires
        torch.cuda.set_device(rank % torch.cuda.device_count())
    comm.init_distributed(dist_backend=backend,
                          init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                          world_size=world_size, rank=rank)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
    finally:
        comm.destroy_process_group()


def launch_local(fn: Callable, world_size: int, args: Sequence[Any] = (),
                 backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks joined in one
    process group (``backend``: default ``comm.default_backend()``); returns
    the ranks' results in rank order. ``fn`` must be importable by name (a
    module-level function). Raises if any rank fails; every rank process has
    ended when it returns."""
    backend = backend or comm.default_backend()
    threads = max(1, torch.get_num_threads() // world_size)  # the caller's share, split
    with tempfile.TemporaryDirectory(prefix="dstorch_world_") as workdir:
        mp.start_processes(_rank_main,
                           args=(fn, world_size, backend, workdir, threads, tuple(args)),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"result{r}.pt"), weights_only=False)
                for r in range(world_size)]
