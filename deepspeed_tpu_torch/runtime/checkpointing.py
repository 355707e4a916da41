"""The checkpoint layout on disk, and its readers.

Counterpart of ``deepspeed_tpu/runtime/checkpointing.py``, the same layout,
so that either package reads what the other wrote::

    <save_dir>/latest                  the newest committed tag
    <save_dir>/zero_to_fp32.py         the fp32 export, runnable on its own
    <save_dir>/<tag>/metadata.json     the manifest, written last (the commit)
    <save_dir>/<tag>/{params,opt_state,loss_scale}/leaf_NNNNN.shard.<bounds>.npy

Each leaf is one or more shard files, each a rectangle of one logical array
whose global slice bounds are in the name (``leaf_00012.shard.0-256_0-64.npy``;
``0d`` for a scalar). A reader assembles whatever rectangles it finds, so a
checkpoint that the JAX package wrote from any mesh or ZeRO stage loads here
on one device. Leaves are matched by the name recorded in the manifest (the
``jax.tree_util.keystr`` of its path; by position only in a checkpoint that
records no names): the two packages walk their trees in different orders. A
component is written in the JAX package's order (dict keys sorted), so the
files of a state saved by either package are the same.

The writer is ``runtime/ckpt`` (the snapshot pipeline and the commit rule);
this module keeps the names, the file format and the readers that
``runtime/ckpt``, ``zero`` and ``init_inference(checkpoint=)`` share. A
checkpoint is handled as components of named leaves: lists of
``(keystr name, tensor or numpy array)``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist
from ..utils.tree import tree_items

# the unsharded leaf_NNNNN.npy of older checkpoints is read too
_SHARD_FMT = "leaf_{:05d}.shard.{}.npy"
_COMPONENTS = ("params", "opt_state", "loss_scale")
_ORBAX_SUBDIR = "orbax"

NamedLeaves = List[Tuple[str, Any]]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a torch leaf is stored as (a TypeError for bf16, which
    numpy lacks)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _is_writer() -> bool:
    """Only rank 0 writes files, of whole leaves (a state sharded over dp
    ranks is gathered whole before the snapshot)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _barrier(name: str) -> None:
    """Every rank waits here (no-op on one process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _tag_dir(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, str(tag))


def _bounds_token(index, shape) -> str:
    """Encode a shard's global slice bounds for its filename."""
    if not shape:
        return "0d"
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}-{stop}")
    return "_".join(parts)


def _full_token(shape) -> str:
    """The token of a leaf written whole."""
    return _bounds_token(tuple(slice(0, d) for d in shape), tuple(shape))


def _parse_bounds(token: str):
    """Filename token → tuple of slices (or () for 0-d)."""
    if token == "0d":
        return ()
    return tuple(slice(int(a), int(b)) for a, b in (p.split("-") for p in token.split("_")))


def _check_not_orbax(directory: str) -> None:
    if os.path.isdir(os.path.join(directory, _ORBAX_SUBDIR)):
        raise NotImplementedError(
            f"{directory!r} holds an Orbax checkpoint (checkpoint.engine 'orbax' of "
            f"the JAX package deepspeed_tpu); deepspeed_tpu_torch reads the native "
            f"shard-file layout only: re-save it from deepspeed_tpu with the "
            f"'native' engine")


def _clean_component_dir(directory: str) -> None:
    """Remove the previous generation's shard files (and a stale ``orbax/``
    tree) before a save: mixing generations would assemble stale arrays."""
    if _is_writer() and os.path.isdir(directory):
        for f in os.listdir(directory):
            if f.startswith("leaf_") and f.endswith(".npy"):
                os.remove(os.path.join(directory, f))
        stale = os.path.join(directory, _ORBAX_SUBDIR)
        if os.path.isdir(stale):
            shutil.rmtree(stale)
    _barrier("save_tree_clean")


def _index_shard_files(directory: str) -> Dict[int, list]:
    """Map stored leaf index → [(bounds, path)] for both layouts."""
    out: Dict[int, list] = {}
    if not os.path.isdir(directory):
        return out
    shard_re = re.compile(r"^leaf_(\d{5})\.shard\.([0-9d_\-]+)\.npy$")
    legacy_re = re.compile(r"^leaf_(\d{5})\.npy$")
    for f in os.listdir(directory):
        m = shard_re.match(f)
        if m:
            out.setdefault(int(m.group(1)), []).append(
                (_parse_bounds(m.group(2)), os.path.join(directory, f)))
            continue
        m = legacy_re.match(f)
        if m:  # unsharded layout: one full-array file
            out.setdefault(int(m.group(1)), []).append((None, os.path.join(directory, f)))
    return out


def _assemble_leaf(entries) -> np.ndarray:
    """Read shard files into one host array (None bounds = full array); the
    shards must tile the array exactly."""
    if any(b is None for b, _ in entries):
        if len(entries) > 1:
            raise ValueError(
                f"corrupt checkpoint: legacy and shard files coexist for one leaf: "
                f"{[p for _, p in entries]}")
        return np.load(entries[0][1])
    first = np.load(entries[0][1])
    if not entries[0][0]:  # 0-d
        return first
    shape = [0] * first.ndim  # the global shape: the largest stop per dim
    for bounds, _ in entries:
        for d, sl in enumerate(bounds):
            shape[d] = max(shape[d], sl.stop)
    if len(entries) == 1 and tuple(shape) == first.shape:
        return first
    out = np.empty(shape, first.dtype)
    covered = 0
    for bounds, path in entries:
        piece = first if path == entries[0][1] else np.load(path)
        out[bounds] = piece
        covered += piece.size
    if covered != out.size:  # the rectangles are disjoint, so their sizes must tile
        raise ValueError(
            f"corrupt checkpoint: shards cover {covered} of {out.size} elements for "
            f"{entries[0][1].rsplit('.shard.', 1)[0]} (missing or duplicated shard "
            f"files: a partial save?)")
    return out


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list)) else tuple(leaf.shape)


def _stored_shape(entries) -> Optional[Tuple[int, ...]]:
    """A stored leaf's global shape from its shard names (the largest stop
    per dim; an unsharded file's own header), None for mixed layouts (which
    :func:`_assemble_leaf` refuses)."""
    bounds0, path0 = entries[0]
    if bounds0 is None:
        return tuple(np.load(path0, mmap_mode="r").shape) if len(entries) == 1 else None
    if bounds0 == ():
        return ()
    shape = [0] * len(bounds0)
    for bounds, _ in entries:
        if bounds is None or len(bounds) != len(shape):
            return None
        for d, sl in enumerate(bounds):
            shape[d] = max(shape[d], sl.stop)
    return tuple(shape)


def _match_leaves(template: NamedLeaves, directory: str, strict: bool = True,
                  stored_names: Optional[Sequence[str]] = None) -> List[Tuple[str, Any, Any]]:
    """``[(name, leaf, shard entries)]`` for each leaf of ``template``
    (``[(name, leaf or shape)]``), matched by the stored name (the
    manifest's ``leaf_names``); by position in ``template`` only for a
    checkpoint that records no names, or names that repeat. Every leaf is
    checked from the file names before a byte is read: a missing or
    reshaped leaf raises, or with ``strict=False`` gets None entries (the
    caller keeps its current value)."""
    _check_not_orbax(directory)
    files = _index_shard_files(directory)
    if stored_names and len(stored_names) == len(set(stored_names)):
        name_to_stored = {n: i for i, n in enumerate(stored_names)}
    else:
        name_to_stored = {n: i for i, (n, _) in enumerate(template)}  # positional
    out = []
    for name, leaf in template:
        stored_i = name_to_stored.get(name)
        entries = files.get(stored_i) if stored_i is not None else None
        if not entries:
            if strict:
                raise FileNotFoundError(
                    f"checkpoint missing leaf {name!r} (index {stored_i}) under {directory}")
            log_dist(f"strict=False: missing leaf {name}, keeping current value")
            entries = None
        else:
            shape, want = _stored_shape(entries), _shape_of(leaf)
            if shape is not None and shape != want:
                if strict:
                    raise ValueError(
                        f"checkpoint leaf {name} shape {shape} != expected {want} (did "
                        f"the model/optimizer config change? pass strict=False to keep "
                        f"mismatched leaves at their current values)")
                log_dist(f"strict=False: leaf {name} shape {shape} != {want}, "
                         f"keeping current value")
                entries = None
        out.append((name, leaf, entries))
    return out


def _load_tree(template: NamedLeaves, directory: str, strict: bool = True,
               stored_names: Optional[Sequence[str]] = None) -> List[Optional[np.ndarray]]:
    """Each leaf of ``template`` assembled as a host array (None where
    ``strict=False`` keeps the current value); see :func:`_match_leaves`."""
    return [None if entries is None else _assemble_leaf(entries)
            for _, _, entries in _match_leaves(template, directory, strict, stored_names)]


def _stored_names(meta: Dict[str, Any], component: str) -> Optional[List[str]]:
    return (meta.get("components", {}).get(component) or {}).get("leaf_names")


_ZERO_TO_FP32_SCRIPT = '''\
#!/usr/bin/env python
"""Assemble the full fp32 model weights from this (possibly ZeRO-sharded)
checkpoint directory: no engine, no config (the zero_to_fp32.py DeepSpeed
drops into every checkpoint). A thin shim over deepspeed_tpu_torch.zero, so
the export logic has one implementation.

Usage: python zero_to_fp32.py <checkpoint_dir> <output.npz> [tag]
"""
import sys

from deepspeed_tpu_torch.zero import convert_zero_checkpoint_to_fp32_state_dict

if __name__ == "__main__":
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    convert_zero_checkpoint_to_fp32_state_dict(
        sys.argv[1], sys.argv[2],
        tag=sys.argv[3] if len(sys.argv) > 3 else None,
    )
    print(f"wrote {sys.argv[2]}")
'''


def resolve_tag(load_dir: str, tag: Optional[str] = None,
                component: Optional[str] = "params") -> str:
    """A checkpoint tag (the ``latest`` file's when None) → its directory,
    checking that the requested component exists."""
    if tag is None:
        latest = os.path.join(load_dir, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(
                f"no `latest` file under {load_dir!r}: not an engine checkpoint "
                f"directory (expected the layout written by save_checkpoint)")
        with open(latest) as f:
            tag = f.read().strip()
    path = _tag_dir(load_dir, tag)
    if component and not os.path.isdir(os.path.join(path, component)):
        raise FileNotFoundError(f"checkpoint {path!r} has no {component} component")
    return path


def _read_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_params(load_dir: str, template, tag: Optional[str] = None):
    """The params component of an engine checkpoint as the port's parameter
    tree of CPU tensors, in the stored dtype (fp32 masters).

    ``template`` is a nested dict whose leaves are tensors or shapes (e.g.
    ``param_specs(cfg)``'s shapes): the tree to fill. Used by
    ``init_inference(checkpoint=...)`` to serve trained weights without a
    training engine. The template is walked in the writers' order (keys
    sorted), so a checkpoint that records no leaf names still matches each
    leaf to its own file, and the tree is filled by name."""
    path = resolve_tag(load_dir, tag)
    named = tree_items(template, sort_keys=True)
    arrays = _load_tree(named, os.path.join(path, "params"), True,
                        _stored_names(_read_meta(path), "params"))
    by_name = {name: torch.from_numpy(np.asarray(a, order="C"))
               for (name, _), a in zip(named, arrays)}

    def rebuild(node, prefix: str):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}[{k!r}]") for k, v in node.items()}
        return by_name[prefix]

    return rebuild(template, "")


def list_checkpoints(save_dir: str) -> list:
    """The committed tags under ``save_dir``, sorted by their trailing step
    number (tags without one after, by name)."""
    if not os.path.isdir(save_dir):
        return []
    tags = [d for d in os.listdir(save_dir)
            if os.path.isdir(os.path.join(save_dir, d))
            and os.path.exists(os.path.join(save_dir, d, "metadata.json"))]

    def key(t):
        m = re.search(r"(\d+)$", t)
        return (0, int(m.group(1))) if m else (1, t)

    return sorted(tags, key=key)
