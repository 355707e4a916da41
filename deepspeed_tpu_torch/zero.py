"""ZeRO's user-facing checkpoint export: ``zero_to_fp32``.

Counterpart of ``deepspeed_tpu/zero.py:70-140`` (and DeepSpeed's
``deepspeed/utils/zero_to_fp32.py``): the full fp32 model state of an engine
checkpoint, assembled from its shard files of any mesh or ZeRO stage,
without an engine. Every checkpoint root carries a ``zero_to_fp32.py`` that
calls :func:`convert_zero_checkpoint_to_fp32_state_dict`. The ZeRO-3 shims
(``Init``, ``GatheredParameters``) come with stage 3 over ranks (ROADMAP A7
item 2b).

    python -m deepspeed_tpu_torch.zero <checkpoint_dir> <output.npz> [tag]
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .runtime.checkpointing import (_assemble_leaf, _check_not_orbax, _index_shard_files,
                                    _read_meta, _stored_names, resolve_tag)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """{keystr name: fp32 array} of the params component of
    ``checkpoint_dir`` (its ``latest`` tag when ``tag`` is None), in the
    stored order; a checkpoint without names gets ``leaf_NNNNN`` keys."""
    path = resolve_tag(checkpoint_dir, tag)
    pdir = os.path.join(path, "params")
    _check_not_orbax(pdir)
    files = _index_shard_files(pdir)
    names = _stored_names(_read_meta(path), "params")
    if names is None:  # a checkpoint older than its name records: positional keys
        names = [f"leaf_{i:05d}" for i in sorted(files)]
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        entries = files.get(i)
        if not entries:
            raise FileNotFoundError(
                f"checkpoint missing shard files for leaf {name!r} (index {i})")
        out[name] = np.asarray(_assemble_leaf(entries), np.float32)
    return out


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> None:
    """zero_to_fp32.py's entry: the assembled state dict into one .npz."""
    np.savez(output_file, **get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag))


if __name__ == "__main__":
    import sys

    convert_zero_checkpoint_to_fp32_state_dict(
        sys.argv[1], sys.argv[2], tag=sys.argv[3] if len(sys.argv) > 3 else None)
