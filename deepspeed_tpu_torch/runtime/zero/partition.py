"""ZeRO over the data-parallel ranks: the part of each master leaf that a dp
rank owns, and the collectives that move the parts.

Counterpart of ``deepspeed_tpu/runtime/zero/partition.py``. The JAX package
states the stages as placement rules on its data axes (``zero_specs`` line
81): stage 1 shards the optimizer state (``opt_spec`` line 109), stage 2 the
gradients too (``grad_spec`` line 102), and below stage 3 the parameters, the
fp32 masters, stay whole on every device (``param_spec`` line 97);
``add_data_axes`` (line 53) shards a leaf on its largest dimension that the
data-axis size divides and leaves it replicated when none does. XLA then
emits the collectives.

The port runs the collectives itself, and the fused Adam kernel takes one
contiguous, 16-byte aligned buffer. So a shard here is one contiguous region
of the flattened leaf: the leaf cut into dp equal parts, each a multiple of 4
fp32 elements, rank r owning part r. Where dp divides the leaf's first
dimension the part is a block of rows (layout ``rows``), otherwise a flat
split (``flat``); a leaf that neither fits stays ``replicated``, and every
rank updates it whole, with the same result. Checkpoints hold whole leaves,
so the layout is the port's own. The plan is a pure function of the shapes,
the dp size and the rank.

Stage 3 (:func:`stage3_plan`) shards the masters themselves: every leaf of
``stage3_param_persistence_threshold`` elements or more (JAX ``param_spec``
line 97) is held on each rank as its part only, with its optimizer state and
its gradient (``grad_spec`` line 102: a gradient has its parameter's
layout). A stacked ``layers`` leaf [L, ...] is cut within each layer (layout
``layers``): rank r owns, for every layer l, one contiguous run of layer l's
flattened slice, so the part is one contiguous [L, run] tensor (one fused
Adam launch) and gathering layer l is one all-gather in which every rank
sends the same share, as JAX's stage 3 shards ``wq`` as P(None, 'dp', ...).
Any other such leaf splits as at stage 1. A leaf under the threshold, or one
that does not split into 16-byte runs, stays whole (persistent) with whole
gradients; its optimizer state still splits as at stage 1 (``opt_spec``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ...comm.collectives import all_gather, all_reduce, group_rank, group_size, reduce_scatter

ALIGN_ELEMS = 4  # fp32 elements in 16 bytes: the fused Adam kernel's vector


@dataclass(frozen=True)
class LeafShard:
    """One leaf's part on one rank: ``layout`` (rows | flat | layers |
    replicated), the whole leaf's ``shape``, and the part's first element
    ``start`` and element count ``size`` in the flattened leaf (0 and the
    whole leaf when replicated). Under ``layers`` the part is a run of
    :attr:`run` elements from ``start`` in each layer's flattened slice, and
    ``size`` is L x run."""

    layout: str
    shape: Tuple[int, ...]
    start: int
    size: int

    @property
    def sharded(self) -> bool:
        return self.layout != "replicated"

    @property
    def run(self) -> int:
        """The part's elements in one layer (``layers``), else its size."""
        return self.size // self.shape[0] if self.layout == "layers" else self.size

    def part(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's region of ``whole`` (contiguous, the leaf's shape), as
        a view: a block of rows, a 1-D run, or under ``layers`` a strided
        [L, run]."""
        if not self.sharded:
            return whole
        if self.layout == "layers":
            return whole.reshape(self.shape[0], -1).narrow(1, self.start, self.run)
        return self.shaped(whole.view(-1).narrow(0, self.start, self.size))

    def shaped(self, run: torch.Tensor) -> torch.Tensor:
        """A part's 1-D run of elements in the part's shape."""
        if self.layout == "layers":
            return run.view(self.shape[0], self.run)
        return run.view(-1, *self.shape[1:]) if self.layout == "rows" else run

    def by_rank(self, whole: torch.Tensor) -> torch.Tensor:
        """``whole`` (the leaf's shape, contiguous) as [dp, size]: row r is
        rank r's part (rows and flat layouts)."""
        return whole.view(-1, self.size)

    def assemble(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the ranks' parts flattened in rank order (an
        all-gather's output of dp x size elements)."""
        if self.layout == "layers":
            L = self.shape[0]
            return gathered.view(-1, L, self.run).transpose(0, 1).reshape(self.shape)
        return gathered.view(self.shape)


class ShardedLeaf:
    """A checkpoint's view of a leaf split over the dp ``group``: the whole
    leaf's ``shape`` and ``dtype``, and this rank's ``part``. The loader
    assembles the whole leaf from the files and copies it in; the part keeps
    its region. The writer asks for it :meth:`whole`, one leaf at a time."""

    def __init__(self, part: torch.Tensor, entry: LeafShard, group):
        self.part, self.entry, self.group = part, entry, group
        self.shape, self.dtype = entry.shape, part.dtype

    def copy_(self, whole: torch.Tensor) -> "ShardedLeaf":
        self.part.copy_(self.entry.part(whole.contiguous()))
        return self

    def whole(self) -> torch.Tensor:
        """The whole leaf, a new tensor: the ranks' parts in rank order (one
        all-gather; every rank of the group calls)."""
        return self.entry.assemble(all_gather(self.part.reshape(-1), self.group))


def storage_bytes(tensors: Sequence[torch.Tensor]) -> int:
    """The bytes of the distinct storages under ``tensors`` (views of one
    buffer count it once)."""
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return sum(held.values())


def leaf_shard(shape: Sequence[int], dp: int, rank: int) -> LeafShard:
    """Rank ``rank``'s part of a leaf of ``shape`` split over ``dp`` ranks."""
    shape = tuple(int(d) for d in shape)
    numel = math.prod(shape)
    if dp > 1 and numel % dp == 0 and (numel // dp) % ALIGN_ELEMS == 0:
        size = numel // dp
        layout = "rows" if shape[0] % dp == 0 else "flat"
        return LeafShard(layout, shape, rank * size, size)
    return LeafShard("replicated", shape, 0, numel)


def shard_plan(shapes: Sequence[Sequence[int]], dp: int, rank: int) -> List[LeafShard]:
    """Each leaf's :class:`LeafShard` on rank ``rank`` of ``dp``."""
    return [leaf_shard(s, dp, rank) for s in shapes]


def stage3_shard(shape: Sequence[int], stacked: bool, dp: int, rank: int,
                 threshold: int) -> Tuple[LeafShard, bool]:
    """Rank ``rank``'s part of a leaf of ``shape`` at stage 3 over ``dp``
    ranks, and whether the master itself is held as that part (False: a
    persistent leaf, whole, its optimizer state split by :func:`leaf_shard`).
    ``stacked``: a [L, ...] leaf of the ``layers`` group, cut within each
    layer."""
    shape = tuple(int(d) for d in shape)
    numel = math.prod(shape)
    if dp > 1 and numel >= threshold:
        if stacked and len(shape) > 1:
            per_layer = numel // shape[0]
            if per_layer % dp == 0 and (per_layer // dp) % ALIGN_ELEMS == 0:
                run = per_layer // dp
                return LeafShard("layers", shape, rank * run, shape[0] * run), True
        elif not stacked:
            entry = leaf_shard(shape, dp, rank)
            if entry.sharded:
                return entry, True
    return leaf_shard(shape, dp, rank), False


def stage3_plan(shapes: Sequence[Sequence[int]], stacked: Sequence[bool], dp: int,
                rank: int, threshold: int) -> List[Tuple[LeafShard, bool]]:
    """:func:`stage3_shard` of each leaf."""
    return [stage3_shard(s, k, dp, rank, threshold) for s, k in zip(shapes, stacked)]


class ZeroPartition:
    """A plan over the leaves of the masters (in ``tree_leaves`` order) on
    the dp ``group``, and its collectives, each one call on one flat buffer
    (gloo stages a card's tensor through host memory per call). Stages 1 and
    2 by default; stage 3 when ``stacked`` (each leaf's membership of the
    ``layers`` group) is given with the persistence ``threshold``: ``plan``
    then holds each leaf's optimizer-state part, and ``gathered`` the leaves
    whose masters and gradients are held as that part too."""

    def __init__(self, shapes: Sequence[Sequence[int]], group,
                 stacked: Optional[Sequence[bool]] = None, threshold: int = 0):
        self.group = group
        self.dp = group_size(group)
        self.rank = group_rank(group)
        if stacked is None:
            self.plan, self.gathered = shard_plan(shapes, self.dp, self.rank), []
        else:
            pairs = stage3_plan(shapes, stacked, self.dp, self.rank, threshold)
            self.plan = [e for e, _ in pairs]
            self.gathered = [i for i, (_, held) in enumerate(pairs) if held]
        self.sharded = [i for i, e in enumerate(self.plan) if e.sharded]
        self.replicated = [i for i, e in enumerate(self.plan) if not e.sharded]
        held = set(self.gathered)
        # the whole leaves an update all-gathers from their parts: every
        # sharded leaf below stage 3, the persistent ones at stage 3
        self.regathered = [i for i in self.sharded if i not in held]
        offsets, o = {}, 0
        for i in self.regathered:
            offsets[i] = o
            o += self.plan[i].size
        self.offsets, self.part_numel = offsets, o  # this rank's elements of those leaves

    def parts(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's part of each leaf, as views: a whole leaf's region
        (the leaf itself where replicated); a stage-3 leaf held as its part
        passes as it is."""
        held = set(self.gathered)
        return [t if i in held else e.part(t)
                for i, (e, t) in enumerate(zip(self.plan, leaves))]

    def cut(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Stage 3: the whole masters → the ones this rank holds: a new
        contiguous tensor of its part of each gathered leaf, the others as
        they are."""
        held = set(self.gathered)
        return [self.plan[i].part(t).clone(memory_format=torch.contiguous_format)
                if i in held else t for i, t in enumerate(leaves)]

    def gather_(self, leaves: Sequence[torch.Tensor]) -> None:
        """Fill every rank's whole ``leaves`` from each rank's part of them
        (after the update of the parts): one all-gather. At stage 3 only the
        persistent leaves are whole, and only they are filled."""
        if not self.regathered:
            return
        send = torch.cat([self.plan[i].part(leaves[i]).reshape(-1) for i in self.regathered])
        got = all_gather(send, self.group).view(self.dp, self.part_numel)
        for i in self.regathered:
            e, o = self.plan[i], self.offsets[i]
            e.by_rank(leaves[i]).copy_(got[:, o:o + e.size])

    def reduce_scatter_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Stage 2: the world's sum of each sharded leaf's gradient, this
        rank's part of it only (one reduce-scatter), and the replicated
        leaves' sums whole (one all-reduce). The parts are views of one new
        buffer; ``grads`` are left as they were. ``send_bytes``: the bytes of
        the reduce-scatter's input buffer, a [dp, part_numel] copy of the
        sharded leaves' gradients."""
        out = list(grads)
        self.send_bytes = 0
        if self.sharded:
            send = torch.empty(self.dp, self.part_numel, dtype=grads[self.sharded[0]].dtype,
                               device=grads[self.sharded[0]].device)
            for i in self.sharded:
                e, o = self.plan[i], self.offsets[i]
                send[:, o:o + e.size].copy_(e.by_rank(grads[i]))
            mine = reduce_scatter(send.view(-1), self.group)
            self.send_bytes = send.nbytes
            del send
            for i in self.sharded:
                e, o = self.plan[i], self.offsets[i]
                out[i] = e.shaped(mine.narrow(0, o, e.size))
        if self.replicated:
            rep = [grads[i] for i in self.replicated]
            flat = torch.cat([t.reshape(-1) for t in rep])
            all_reduce(flat, self.group)
            for i, part in zip(self.replicated, flat.split([t.numel() for t in rep])):
                out[i] = part.view_as(grads[i])
        return out

    def square_sums(self, *lists: Sequence[torch.Tensor],
                    sharded: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Each leaf's sum of squares over the whole leaf, [len(lists),
        n_leaves] fp32, from this rank's parts in each of ``lists`` (whole
        where replicated): the partial sums of the leaves in ``sharded``
        (default: those whose optimizer state splits; stage 3's gradients
        pass ``gathered``) added over the group in one all-reduce."""
        sharded = self.sharded if sharded is None else list(sharded)
        sq = torch.stack([torch.stack([t.float().square().sum() for t in parts])
                          for parts in lists])
        if not sharded:
            return sq
        mask = torch.zeros(sq.shape[1], dtype=torch.bool)
        mask[sharded] = True
        mask = mask.to(sq.device).expand_as(sq)
        partial = torch.where(mask, sq, torch.zeros_like(sq))
        all_reduce(partial, self.group)
        return torch.where(mask, partial, sq)
