"""Checkpointing on one device: the snapshot pipeline and its async writer
(:mod:`.async_writer`), the commit rule (:mod:`.manifest`: a tag is visible
to restore iff its manifest landed) and the restore (:mod:`.load`).

Counterpart of ``deepspeed_tpu/runtime/ckpt``; the restore onto a sharded
target (``reshard.py``) comes with ZeRO over ranks (ROADMAP A7).
"""

from .async_writer import (CheckpointGuard, install_preempt_handler,
                           reset_preempt_handler, save_checkpoint, unregister_preempt)
from .load import load_checkpoint
from .manifest import (MANIFEST_VERSION, UncommittedCheckpointError, is_committed,
                       latest_committed_tag, require_committed)

__all__ = [
    "CheckpointGuard",
    "MANIFEST_VERSION",
    "UncommittedCheckpointError",
    "install_preempt_handler",
    "is_committed",
    "latest_committed_tag",
    "load_checkpoint",
    "require_committed",
    "reset_preempt_handler",
    "save_checkpoint",
    "unregister_preempt",
]
