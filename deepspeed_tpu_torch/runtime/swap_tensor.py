"""Host buffers for device→host snapshots.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor.py:23 PinnedBufferPool``,
the pool alone: the asynchronous checkpoint writer (``runtime/ckpt``) takes
its snapshot buffers here. The NVMe swapper (``TensorSwapper``) comes with
offload (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, List

import torch


class PinnedBufferPool:
    """Two-generation keyed host-buffer pool.

    Buffers are CPU tensors, page-locked when ``pin`` (a copy from the card
    into them runs asynchronously at the link's rate); the writer reads them
    as numpy views. A generation's buffers become reusable only after ITS
    consumers have fully landed (the caller blocks before calling
    :meth:`retire_generation`), and even then one generation later: the
    checkpoint writer retires its generation with an empty one as soon as
    its write has landed, so one generation serves every save. A retired
    generation is kept whole: the writer's generation is the whole state,
    and its next save takes every buffer again."""

    def __init__(self, pin: bool = False):
        self.pin = bool(pin)
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._last_gen: List[torch.Tensor] = []
        self._generation = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        lst = self._free.get((tuple(shape), dtype))
        if lst:
            return lst.pop()
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.pin)

    def retire_generation(self, bufs: List[torch.Tensor], pending_ids=frozenset()) -> None:
        """Rotate generations: the previous fill's buffers become reusable now
        that a newer generation has fully landed.

        A buffer may never sit in the free pool while an in-flight write
        still reads from it: the next fill would overwrite bytes a writer is
        persisting. ``pending_ids`` is the ``id()`` set of buffers still
        referenced by in-flight writes; refuse loudly rather than corrupt the
        destination. The whole generation is checked before any buffer is
        freed, so a refusal leaves no buffer half-retired."""
        if any(id(b) in pending_ids for b in self._last_gen):
            raise RuntimeError(
                "PinnedBufferPool: refusing to recycle a read buffer that an "
                "in-flight write still references (read-after-overwrite hazard)")
        for b in self._last_gen:
            self._free.setdefault((tuple(b.shape), b.dtype), []).append(b)
        self._last_gen = list(bufs)
        self._generation += 1

    @property
    def generation(self) -> int:
        """Completed buffer generations."""
        return self._generation
