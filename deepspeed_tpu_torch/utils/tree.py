"""Helpers over the port's parameter trees (nested dicts of tensors).

Counterpart of ``deepspeed_tpu/utils/tree.py``; the dtype cast of a tree
is ``ops.quantizer.cast_floating``.
"""

from __future__ import annotations

from typing import Callable, Iterator, List

import torch


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    return list(_iter_leaves(tree))


def _iter_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    else:
        yield tree


def tree_size(tree) -> int:
    """Total number of elements across all leaves (a PackedWeight leaf
    counts its dense weight's elements)."""
    return sum(t.numel() for t in tree_leaves(tree))


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors with fp32 accumulation, as a device scalar
    (no host sync)."""
    if not leaves:
        return torch.zeros(())
    sq = torch.stack([t.float().square().sum() for t in leaves])
    return sq.sum().sqrt()
