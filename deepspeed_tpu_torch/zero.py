"""ZeRO's user-facing API: the ZeRO-3 shims and the checkpoint export
``zero_to_fp32``.

Counterpart of ``deepspeed_tpu/zero.py`` (and DeepSpeed's
``deepspeed/utils/zero_to_fp32.py``): ``Init`` (line 30) and
``GatheredParameters`` (line 39), then the full fp32 model state of an
engine checkpoint, assembled from its shard files of any mesh or ZeRO stage,
without an engine. Every checkpoint root carries a ``zero_to_fp32.py`` that
calls :func:`convert_zero_checkpoint_to_fp32_state_dict`.

    python -m deepspeed_tpu_torch.zero <checkpoint_dir> <output.npz> [tag]
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from .runtime.checkpointing import (_assemble_leaf, _check_not_orbax, _index_shard_files,
                                    _read_meta, _stored_names, resolve_tag)


@contextlib.contextmanager
def Init(*args, **kwargs):
    """Parity: deepspeed.zero.Init, module construction under ZeRO-3. The
    engine cuts the masters into each rank's parts inside ``initialize``, so
    the context is a no-op, as the JAX package's: reference training scripts
    run unmodified."""
    yield


@contextlib.contextmanager
def GatheredParameters(params, modifier_rank: Optional[int] = None, **kwargs):
    """Parity: deepspeed.zero.GatheredParameters. ``params`` is an engine
    (its whole fp32 masters; at stage 3 over dp ranks each held part is
    gathered, so every rank must enter) or a parameter tree. Yields host
    copies (CPU tensors) of the whole tree. In-context changes are not
    written back, so ``modifier_rank`` warns, as the JAX package's does."""
    from .utils.logging import log_dist
    from .utils.tree import tree_map

    if modifier_rank is not None:
        log_dist("warning: zero.GatheredParameters(modifier_rank=...) yields DETACHED "
                 "host copies - in-context mutations are NOT written back to the "
                 "engine's masters; pass the changed tree to initialize(model_parameters=...)")
    tree = params.whole_params() if hasattr(params, "whole_params") else params
    with torch.no_grad():
        yield tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


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
