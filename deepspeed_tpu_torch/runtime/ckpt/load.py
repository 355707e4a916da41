"""Restore an engine from a committed checkpoint.

Counterpart of ``deepspeed_tpu/runtime/ckpt/reshard.py:205 load_checkpoint``:
each leaf is assembled whole from whatever rectangles are on disk, so a
checkpoint of any mesh or ZeRO stage loads, the JAX package's included, and
the older ``metadata.json`` without ``manifest_version`` too. Each leaf is
matched by its stored name and copied in place into the engine's tensor, on
its device; under ZeRO stages 1 and 2 over dp ranks a sharded state leaf
(``runtime.zero.ShardedLeaf``) keeps this rank's part of it. The overlap
reads that would read only a rank's rectangle are ROADMAP A7 item 2c-4.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...utils.logging import log_dist
from ..checkpointing import _assemble_leaf, _barrier, _match_leaves, _stored_names
from ..zero import ShardedLeaf
from . import manifest as _manifest

_TENSOR_LEAVES = (torch.Tensor, ShardedLeaf)  # copied into; the rest the engine checks


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    strict: bool = True) -> Tuple[Optional[str], Dict[str, Any]]:
    """Restore ``engine`` from ``load_dir`` (the newest committed tag when
    ``tag`` is None; a torn tag named explicitly raises). The engine's
    :meth:`checkpoint_components` name the tensors filled in place; its
    :meth:`check_restored` checks the non-tensor leaves (the optimizer's
    update counts, the loss scale) against the manifest. Returns
    ``(path, client_state)``, or ``(None, {})`` when nothing is committed."""
    _barrier("load_checkpoint")  # never read while a peer is mid-save
    if tag is None:
        tag = _manifest.latest_committed_tag(load_dir)
        if tag is None:
            log_dist(f"no committed checkpoint under {load_dir}; nothing loaded")
            return None, {}
    path = _manifest.require_committed(load_dir, tag)
    meta = _manifest.read_manifest(load_dir, tag)
    engine.check_layout(meta)
    components = engine.checkpoint_components()

    # every leaf of every component matched and checked from the file names
    # first, so that a refused checkpoint changes no tensor
    matched = {comp: _match_leaves(named, os.path.join(path, comp), strict,
                                   _stored_names(meta, comp))
               for comp, named in components.items()}
    # then the host-side leaves (the optimizer's update counts, the loss scale),
    # which the engine checks before any tensor changes
    host = {comp: {name: _assemble_leaf(entries) for name, leaf, entries in leaves
                   if entries is not None and not isinstance(leaf, _TENSOR_LEAVES)}
            for comp, leaves in matched.items()}
    engine.check_restored(host, meta)
    with torch.no_grad():  # then the tensors, one leaf in host memory at a time
        for leaves in matched.values():
            for _, leaf, entries in leaves:
                if entries is not None and isinstance(leaf, _TENSOR_LEAVES):
                    arr = np.asarray(_assemble_leaf(entries), order="C")
                    leaf.copy_(torch.from_numpy(arr).to(leaf.dtype))
    engine.global_steps = int(meta["global_steps"])
    engine.micro_steps = int(meta["micro_steps"])
    engine.skipped_steps = int(meta.get("skipped_steps", 0))
    engine.restore_loss_scale(host.get("loss_scale", {}))
    log_dist(f"loaded checkpoint {path} (step {meta['global_steps']}; saved at ZeRO "
             f"stage {meta.get('zero_stage')} on {meta.get('world_size')} device(s), "
             f"manifest version {meta.get('manifest_version', 'none')})")
    return path, meta.get("client_state", {})
