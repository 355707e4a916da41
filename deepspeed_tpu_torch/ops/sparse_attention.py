"""Block-sparse attention.

Counterpart of ``deepspeed_tpu/ops/sparse_attention.py`` (the reference's
``SparseSelfAttention`` and ``sparsity_config.py``). A sparsity config makes
one [S/block, S/block] 0/1 layout per sequence length, the same layout as the
JAX package's for the same config (the random blocks come from the same
``numpy.random.RandomState`` seeds); the layout drives the flash kernels'
block-sparse form (``ops/cuda/flash_attention.py``), which walks only each
row's active blocks through compaction tables kept on the device per layout,
so inactive blocks are neither computed nor read. CPU tensors (and the plain
path, ``kernels=False``) take the plain attention with the layout expanded to
a token mask.

Patterns: Fixed (local + periodic global), BigBird (window + global +
random), BSLongformer (sliding window + global blocks), Variable (windows of
varying width + global + random) and Dense. ``block`` is a multiple of 128
that divides the sequence length, as the JAX flash entry requires.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .cuda.flash_attention import LAYOUT_BLOCK, flash_attention_plain


@dataclass
class SparsityConfig:
    """Base: the layout's block, in tokens."""

    block: int = 128

    def make_layout(self, seq_len: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def _n(self, seq_len: int) -> int:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by sparsity block {self.block}"
            )
        return seq_len // self.block


@dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks visible (debug/reference)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        return np.ones((n, n), np.int32)


@dataclass
class FixedSparsityConfig(SparsityConfig):
    """Each block attends to its local window of ``num_local_blocks`` and to
    the last ``num_global_blocks`` of every preceding window (the "summary"
    blocks other windows expose)."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        nl, ng = self.num_local_blocks, self.num_global_blocks
        layout = np.zeros((n, n), np.int32)
        for qi in range(n):
            window = qi // nl
            layout[qi, window * nl : (window + 1) * nl] = 1  # local window
            for w in range(window):  # global summary blocks of prior windows
                lo = (w + 1) * nl - ng
                layout[qi, max(lo, 0) : (w + 1) * nl] = 1
        return layout


@dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Sliding window + global + random."""

    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    num_random_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        w = self.num_sliding_window_blocks // 2
        layout = np.zeros((n, n), np.int32)
        for qi in range(n):
            layout[qi, max(0, qi - w) : min(n, qi + w + 1)] = 1  # window
        layout[:, : self.num_global_blocks] = 1  # global cols
        layout[: self.num_global_blocks, :] = 1  # global rows
        rng = np.random.RandomState(self.seed)
        for qi in range(n):
            for ki in rng.choice(n, size=min(self.num_random_blocks, n), replace=False):
                layout[qi, ki] = 1
        return layout


@dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + chosen global block indices that everyone attends to
    (and that attend to everyone)."""

    num_sliding_window_blocks: int = 3
    global_block_indices: List[int] = field(default_factory=lambda: [0])

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        w = self.num_sliding_window_blocks // 2
        layout = np.zeros((n, n), np.int32)
        for qi in range(n):
            layout[qi, max(0, qi - w) : min(n, qi + w + 1)] = 1
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = 1
                layout[g, :] = 1
        return layout


@dataclass
class VariableSparsityConfig(SparsityConfig):
    """Local windows of varying width (``local_window_blocks``, the last
    entry repeats), chosen global block indices, plus random blocks."""

    num_random_blocks: int = 0
    local_window_blocks: List[int] = field(default_factory=lambda: [4])
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), np.int32)
        # tile variable-width local windows over the block axis
        start = 0
        widths = list(self.local_window_blocks) or [1]
        wi = 0
        while start < n:
            w = widths[min(wi, len(widths) - 1)]
            end = min(start + w, n)
            layout[start:end, start:end] = 1
            start = end
            wi += 1
        for g in self.global_block_indices:
            if g < n:
                layout[:, g] = 1
                layout[g, :] = 1
        rng = np.random.RandomState(self.seed)
        for qi in range(n):
            if self.num_random_blocks:
                for ki in rng.choice(
                    n, size=min(self.num_random_blocks, n), replace=False
                ):
                    layout[qi, ki] = 1
        return layout


def causal_trim(layout: np.ndarray) -> np.ndarray:
    """Zero strictly-upper block diagonals (the kernels also causal-mask
    inside diagonal blocks)."""
    return np.asarray(np.tril(np.ones_like(layout)) * layout, np.int32)


_LAYOUTS: Dict[tuple, np.ndarray] = {}


def sparse_layout(config: SparsityConfig, seq_len: int, causal: bool) -> np.ndarray:
    """The layout the attention runs: ``config``'s, causally trimmed, made
    once per (config, seq_len, causal); raises unless the block is a multiple
    of 128 that divides ``seq_len`` (the JAX flash entry's tile rule,
    flash_attention.py:1163-1167)."""
    key = (repr(config), seq_len, causal)
    if key not in _LAYOUTS:
        layout = config.make_layout(seq_len)
        if config.block % LAYOUT_BLOCK:
            raise ValueError(
                f"sparse attention block {config.block} is not a multiple of "
                f"{LAYOUT_BLOCK}: the flash kernels' layout needs 128-aligned blocks"
            )
        _LAYOUTS[key] = causal_trim(layout) if causal else layout
    return _LAYOUTS[key]


def sparse_attention(q, k, v, config: SparsityConfig, *, causal: bool = True,
                     segment_ids=None, alibi_slopes=None, kernels: bool = True):
    """Block-sparse attention in model layout q[B,S,H,D] → [B,S,H,D] (the
    reference's ``SparseSelfAttention.forward``): the flash kernels'
    block-sparse form, or with ``kernels=False`` the plain attention under
    the layout's token mask (differentiated by torch)."""
    from .attention import flash_attention

    layout = sparse_layout(config, q.shape[1], causal)
    if not kernels:
        return flash_attention_plain(q, k, v, causal, alibi_slopes, None, segment_ids,
                                     layout)[0]
    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                           alibi_slopes=alibi_slopes, layout=layout)


def dense_blocksparse_reference(q, k, v, layout, block, *, causal=True):
    """Oracle: dense attention with the block mask expanded to tokens as an
    additive bias of -1e30."""
    from .attention import plain_attention

    S = q.shape[1]
    n = S // block
    tok_mask = np.kron(np.asarray(layout)[:n, :n], np.ones((block, block)))
    bias = torch.where(torch.from_numpy(tok_mask).to(q.device) > 0, 0.0, -1e30)
    return plain_attention(q, k, v, causal=causal, bias=bias[None, None])


def from_ds_config(sa_cfg) -> Optional[SparsityConfig]:
    """ds_config "sparse_attention" section → SparsityConfig (None = off)."""
    mode = getattr(sa_cfg, "mode", "none")
    if mode in ("none", None):
        return None
    if mode == "dense":
        return DenseSparsityConfig(block=sa_cfg.block)
    if mode == "fixed":
        return FixedSparsityConfig(
            block=sa_cfg.block,
            num_local_blocks=sa_cfg.num_local_blocks,
            num_global_blocks=sa_cfg.num_global_blocks,
        )
    if mode == "bigbird":
        return BigBirdSparsityConfig(
            block=sa_cfg.block,
            num_sliding_window_blocks=sa_cfg.num_sliding_window_blocks,
            num_global_blocks=sa_cfg.num_global_blocks,
            num_random_blocks=sa_cfg.num_random_blocks,
        )
    if mode == "bslongformer":
        return BSLongformerSparsityConfig(
            block=sa_cfg.block,
            num_sliding_window_blocks=sa_cfg.num_sliding_window_blocks,
            global_block_indices=list(sa_cfg.global_block_indices),
        )
    if mode == "variable":
        return VariableSparsityConfig(
            block=sa_cfg.block,
            num_random_blocks=sa_cfg.num_random_blocks,
            local_window_blocks=[sa_cfg.num_local_blocks],
            global_block_indices=list(sa_cfg.global_block_indices),
        )
    raise ValueError(f"unknown sparse_attention mode {mode!r}")


def make_attention_impl(config: SparsityConfig, kernels: bool = True):
    """An attention-signature callable for the engine's scoped impl stack;
    ``kernels=False`` runs the plain path (the engine's flash switch off)."""

    def impl(q, k, v, *, causal=True, bias=None, segment_ids=None,
             alibi_slopes=None):
        if bias is not None:
            raise ValueError(
                "sparse_attention cannot compose with a dense attention bias"
            )
        return sparse_attention(
            q, k, v, config, causal=causal, segment_ids=segment_ids,
            alibi_slopes=alibi_slopes, kernels=kernels,
        )

    return impl
