"""The checkpoint manifest: the commit record and the atomicity rule.

Counterpart of ``deepspeed_tpu/runtime/ckpt/manifest.py``. A tag directory
is COMMITTED iff its ``metadata.json`` exists: the shard files land first,
the manifest last (written to a temporary file, then ``os.replace``, so it is
never seen half-written), and the root ``latest`` pointer moves only after
the commit. A writer killed mid-save leaves a torn tag that restore never
sees: ``latest`` still names the previous committed tag,
``list_checkpoints`` skips the torn directory, and asking for the torn tag by
name raises :class:`UncommittedCheckpointError`.

The manifest is a superset of the older ``metadata.json``: per component it
also records each leaf's global shape, dtype, per-dimension shard divisors
(``leaf_dimspecs``; all ones on one device) and the bounds token of each
shard.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

from ...utils.logging import log_dist
from ..checkpointing import list_checkpoints

MANIFEST_VERSION = 1
MANIFEST_NAME = "metadata.json"


class UncommittedCheckpointError(RuntimeError):
    """An explicitly requested tag exists on disk but never committed (a torn
    save: the writer died before its manifest landed)."""


def manifest_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, str(tag), MANIFEST_NAME)


def is_committed(save_dir: str, tag: str) -> bool:
    return os.path.exists(manifest_path(save_dir, tag))


def require_committed(save_dir: str, tag: str) -> str:
    """The tag's directory, or a loud error when its shards exist without a
    manifest (never restore a torn checkpoint)."""
    path = os.path.join(save_dir, str(tag))
    if is_committed(save_dir, tag):
        return path
    if os.path.isdir(path):
        raise UncommittedCheckpointError(
            f"checkpoint tag {tag!r} under {save_dir!r} is NOT committed (shard files "
            f"without a manifest: the writer died mid-save). Refusing to restore a "
            f"torn checkpoint; resume from the latest committed tag instead (tag=None).")
    raise FileNotFoundError(f"no checkpoint tag {tag!r} under {save_dir!r}")


def latest_committed_tag(save_dir: str) -> Optional[str]:
    """The newest committed tag: ``latest`` when it names a committed tag,
    else (a crash left it on a torn or deleted tag) the newest committed
    directory."""
    latest = os.path.join(save_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            tag = f.read().strip()
        if tag and is_committed(save_dir, tag):
            return tag
        log_dist(f"ckpt: `latest` names uncommitted tag {tag!r} (torn save?); "
                 f"falling back to the newest committed tag")
    tags = list_checkpoints(save_dir)  # committed only, by construction
    return tags[-1] if tags else None


def read_manifest(save_dir: str, tag: str) -> Dict[str, Any]:
    with open(manifest_path(save_dir, tag)) as f:
        return json.load(f)


def write_manifest(save_dir: str, tag: str, meta: Dict[str, Any]) -> str:
    """Land the manifest atomically: the commit point of a save. Call it
    only once every shard file of the tag is on disk."""
    path = manifest_path(save_dir, tag)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def advance_latest(save_dir: str, tag: str) -> None:
    """Point ``latest`` at a freshly committed tag (atomically, as the
    manifest)."""
    path = os.path.join(save_dir, "latest")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(tag))
    os.replace(tmp, path)


def prune_keep_last(save_dir: str, keep_last: int) -> list:
    """Delete the committed tags beyond the newest ``keep_last`` (0 keeps
    everything), and torn tags (unreachable, they only take disk; only a
    directory with a params component counts as a tag, never a foreign one).
    Returns the removed tags."""
    if keep_last <= 0:
        return []
    committed = list_checkpoints(save_dir)
    doomed = committed[:-keep_last] if len(committed) > keep_last else []
    doomed += [d for d in os.listdir(save_dir)
               if os.path.isdir(os.path.join(save_dir, d)) and d not in committed
               and not is_committed(save_dir, d)
               and os.path.isdir(os.path.join(save_dir, d, "params"))]
    for tag in doomed:
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        log_dist(f"ckpt: pruned tag {tag} (keep_last={keep_last})")
    return doomed
