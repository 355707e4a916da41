"""The topology the model code runs under.

Counterpart of ``deepspeed_tpu/models/sharding.py`` (``current_topology``,
``use_topology``, lines 24-29). The JAX package's model code constrains
activation shardings and lets XLA insert collectives; the port's model code
asks :func:`current_topology` where its sequence chunk sits and which
process groups its attention exchanges over. With no topology installed
(one device), model code runs as it always did.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from ..comm.topology import MeshTopology

_local = threading.local()


def current_topology() -> Optional[MeshTopology]:
    return getattr(_local, "topology", None)


@contextlib.contextmanager
def use_topology(topology: Optional[MeshTopology]):
    prev = current_topology()
    _local.topology = topology
    try:
        yield topology
    finally:
        _local.topology = prev


def sp_topology() -> Optional[MeshTopology]:
    """The installed topology when it splits the sequence (sp > 1)."""
    topo = current_topology()
    return topo if topo is not None and topo.sp_size > 1 else None
