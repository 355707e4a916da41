"""The process topology: ranks laid out over named parallel axes.

Counterpart of ``deepspeed_tpu/comm/topology.py`` (``AXIS_ORDER`` line 25,
``ParallelDims`` line 39, ``MeshTopology`` line 67). Where the JAX package
names the axes of a device mesh and lets XLA route each axis's collectives,
the port enumerates ``torch.distributed`` ranks in the same order (rank =
row-major index over ``AXIS_ORDER``, the innermost axis fastest, as
``get_coord`` line 196 and ``get_rank`` line 201 compute it) and makes one
process group per communicator of each live axis (``get_axis_comm_lists``,
line 207), every rank creating every group in the same order, as
``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

# Canonical axis order, outermost → innermost.
AXIS_ORDER: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclass(frozen=True)
class ParallelDims:
    """Requested parallel degrees; dp is inferred when left at 0."""

    dp: int = 0
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, world_size: int) -> Dict[str, int]:
        sizes = {"fsdp": self.fsdp, "pp": self.pp, "ep": self.ep, "sp": self.sp,
                 "tp": self.tp}
        known = int(np.prod(list(sizes.values())))
        if self.dp:
            sizes["dp"] = self.dp
            if self.dp * known != world_size:
                raise ValueError(
                    f"parallel dims {sizes} do not multiply to world size {world_size}"
                )
        else:
            if world_size % known != 0:
                raise ValueError(
                    f"world size {world_size} not divisible by non-dp dims product {known}"
                )
            sizes["dp"] = world_size // known
        return {ax: sizes[ax] for ax in AXIS_ORDER}


class MeshTopology:
    """The default process group's ranks (one rank without one) over named
    axes, with DeepSpeed-style rank/coord queries and this rank's process
    group along each live axis. Every rank builds its topology at the same
    point of its program (``new_group`` is collective)."""

    def __init__(self, dims: Optional[ParallelDims] = None):
        live = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if live else 1
        self.rank = dist.get_rank() if live else 0
        self.sizes = (dims or ParallelDims()).resolve(self.world_size)
        self.axes: Tuple[str, ...] = AXIS_ORDER
        self.sp_mode: Optional[str] = None  # set by the engine (JAX engine.py:433)
        self._groups: Dict[str, object] = {}
        if self.world_size > 1:
            for axis in self.axes:
                if self.sizes[axis] == 1:
                    continue
                for ranks in self.get_axis_comm_lists(axis):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axis] = group

    # -- DeepSpeed ProcessTopology parity -------------------------------------
    @property
    def dp_size(self) -> int:
        return self.sizes["dp"]

    @property
    def sp_size(self) -> int:
        return self.sizes["sp"]

    @property
    def data_shard_size(self) -> int:
        """Total ways the global batch is split (dp × fsdp share the batch)."""
        return self.sizes["dp"] * self.sizes["fsdp"]

    def get_coord(self, rank: int) -> Dict[str, int]:
        shape = [self.sizes[ax] for ax in self.axes]
        coords = np.unravel_index(rank, shape)
        return {ax: int(c) for ax, c in zip(self.axes, coords)}

    def get_rank(self, **coords: int) -> int:
        full = [coords.get(ax, 0) for ax in self.axes]
        shape = [self.sizes[ax] for ax in self.axes]
        return int(np.ravel_multi_index(full, shape))

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Ranks grouped into communicators along ``axis`` (reference parity)."""
        others = [ax for ax in self.axes if ax != axis]
        lists = []
        for combo in itertools.product(*(range(self.sizes[ax]) for ax in others)):
            fixed = dict(zip(others, combo))
            lists.append([self.get_rank(**{**fixed, axis: i})
                          for i in range(self.sizes[axis])])
        return lists

    # -- this rank's place and groups -----------------------------------------
    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.get_coord(self.rank)[axis]

    def world_group(self):
        """The default process group when the world has several ranks, else
        None."""
        return dist.group.WORLD if self.world_size > 1 else None

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None for an axis of
        size 1)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        dims = "x".join(f"{ax}={self.sizes[ax]}" for ax in self.axes if self.sizes[ax] > 1)
        return f"MeshTopology({dims or 'single-process'}, world={self.world_size})"
