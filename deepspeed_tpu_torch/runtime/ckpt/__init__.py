"""Checkpointing: the snapshot pipeline and its async writer
(:mod:`.async_writer`), the commit rule (:mod:`.manifest`: a tag is visible
to restore iff its manifest landed) and the restore (:mod:`.load`), of whole
leaves (a state split over dp ranks is gathered before the write, and each
rank keeps its part of a loaded leaf).

Counterpart of ``deepspeed_tpu/runtime/ckpt``; per-rank files and the
overlap reads of ``reshard.py`` are ROADMAP A7 item 2c-4.
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
