"""ZeRO stage 3 over the dp ranks: each layer's weights gathered on use and
released after it, the gradients reduce-scattered a layer at a time, and the
optional one-layer-ahead prefetch.

Counterpart of ``deepspeed_tpu/runtime/zero/prefetch.py``. There the layer
scan's body takes its layer slice through a sharding put that XLA turns into
an all-gather (``build_layer_puts`` line 103), its transpose a
reduce-scatter, and ``scan_layers`` (line 173) issues layer i+1's gather
before layer i's math. The port runs the forward as a Python loop, so the
engine enters a :class:`GatherScope` around its step (``use_gather``, the
counterpart of JAX's ``prefetch_scope``) and the model's reads of the masters
consult it (``models/transformer.py``: ``layer_slice`` and ``whole_params``):

- A layer (:meth:`GatherScope.layer`): this rank's run of every sharded
  stacked leaf at layer l, cast to the compute dtype, in one all-gather (the
  cast is elementwise, so this is bit for bit JAX's gather of the cast
  weights, line 241, at half the fp32 bytes). One autograd Function takes
  all of them; its backward casts the layer's whole gradients to fp32,
  reduce-scatters them in one call and adds this rank's share into each
  part's ``.grad[l]``, then frees the layer's slices.
- Without recompute (remat ``none``) autograd would keep every layer's
  slices for backward. So once a layer's forward is done its slices' storage
  is freed (:meth:`GatherScope.layer_done`), and a hook on the layer's output
  gradient gathers them again into the same storage just before the layer's
  backward (FSDP's trick: the saved tensors see the refilled storage). At
  most two layers' slices are then alive at once, three with the prefetch.
  Under ``activation_checkpointing`` the recompute gathers again by itself.
- The other sharded leaves (the token table, the head, positions and norms)
  are gathered whole in fp32 for their use (:meth:`GatherScope.whole`) and
  dropped after it; a leaf's gradient accumulates whole over its uses (a
  tied table's lookup and head), in the dtype and order of stage 0's, and
  once the last use's has arrived it is reduce-scattered into the part's
  ``.grad``: the head's early in backward, the table's at its end, so the
  two whole gradients never stand together.
- ``stage3_layer_prefetch``: the next layer's all-gather (forward: l+1;
  backward: l-1) starts asynchronously right after layer l's own lands, so
  it runs under layer l's math. The bytes are the same, so the result is
  the same bit for bit.

The gradient reaches ``.grad`` only: as with ``_LayerSlice``,
``torch.autograd.grad``, ``create_graph`` and hooks on a part are refused in
backward.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...comm.collectives import all_gather, all_gather_async, all_reduce, reduce_scatter
from .partition import ZeroPartition, storage_bytes

_ACTIVE: List["GatherScope"] = []


def gather_scope() -> Optional["GatherScope"]:
    """The innermost entered :class:`GatherScope`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def use_gather(scope: Optional["GatherScope"]):
    """Enter ``scope`` (None: nothing) for the model's reads of the masters;
    on exit any gather still in flight is waited for."""
    if scope is None:
        yield None
        return
    _ACTIVE.append(scope)
    try:
        yield scope
    finally:
        _ACTIVE.pop()
        scope.drain()


def _check_backward(ctx, parts: Sequence[torch.Tensor]) -> None:
    """``_LayerSlice``'s refusals: the gradient lands in ``.grad`` in place,
    so only ``loss.backward()`` without ``create_graph`` and without hooks on
    the parts may run this backward."""
    try:
        to_grad = torch._C._will_engine_execute_node(
            next(fn for fn, _ in ctx.next_functions if fn is not None))
    except (RuntimeError, StopIteration):  # torch.autograd.grad is running
        to_grad = False
    if not to_grad or torch.is_grad_enabled() or any(
            p._backward_hooks or getattr(p, "_post_accumulate_grad_hooks", None)
            for p in parts):
        raise RuntimeError(
            "a ZeRO stage-3 parameter's gradient lands in its .grad in place "
            "(runtime/zero/prefetch.py): differentiate with loss.backward(), without "
            "create_graph and without hooks on the parameter, not with "
            "torch.autograd.grad")


class _GatheredLayer(torch.autograd.Function):
    """Layer ``l``'s gathered slices of the sharded stacked leaves (``parts``,
    this rank's [L, run] masters); backward reduce-scatters their gradients
    into the parts' ``.grad[l]``."""

    @staticmethod
    def forward(ctx, scope, l, dtype, *parts):
        ctx.scope, ctx.l, ctx.parts = scope, l, parts
        return tuple(scope._gather_layer(l, dtype))

    @staticmethod
    def backward(ctx, *grads):
        _check_backward(ctx, ctx.parts)
        with torch.no_grad():
            ctx.scope._layer_backward(ctx.l, grads)
        return (None, None, None) + (None,) * len(grads)


class _GatheredWhole(torch.autograd.Function):
    """The leaves ``idx`` gathered whole in fp32; backward adds their
    gradients to the scope's whole gradients."""

    @staticmethod
    def forward(ctx, scope, idx, *parts):
        ctx.scope, ctx.idx, ctx.parts = scope, idx, parts
        return tuple(scope._gather_whole(idx))

    @staticmethod
    def backward(ctx, *grads):
        _check_backward(ctx, ctx.parts)
        with torch.no_grad():
            ctx.scope._add_whole_grads(ctx.idx, grads)
        return (None, None) + (None,) * len(grads)


class GatherScope:
    """One step's (or one evaluation's) gather on use of the stage-3
    masters ``leaves`` (``tree_leaves`` order) planned by ``partition``.
    ``stacked`` marks the leaves of the ``layers`` group. Counters:
    ``peak_layers`` / ``peak_layers_backward``, the most layers whose gathered
    slices were alive at once (a gather in flight counts), overall and during
    backward; ``gathers`` and ``gather_s``, the layer gathers and the host
    seconds spent waiting for them (the whole call without the prefetch);
    ``transient``, the most gradient bytes alive at one gradient collective
    (the parts' ``.grad``, the whole gradients held here, and the
    collective's buffers)."""

    def __init__(self, partition: ZeroPartition, leaves: Sequence[torch.Tensor],
                 stacked: Sequence[bool], prefetch: bool = False):
        self.partition, self.group, self.dp = partition, partition.group, partition.dp
        self.leaves = list(leaves)
        self.prefetch = prefetch
        held = partition.gathered
        self.layer_idx = [i for i in held if stacked[i]]
        self.whole_idx = [i for i in held if not stacked[i]]
        self._held = {id(self.leaves[i]): i for i in held}
        self.persistent = [i for i in range(len(self.leaves)) if i not in set(held)]
        self.num_layers = self.leaves[self.layer_idx[0]].shape[0] if self.layer_idx else 0
        self._cols, o = [], 0  # each layer leaf's columns in a layer's [dp, width] buffer
        for i in self.layer_idx:
            run = partition.plan[i].run
            self._cols.append((o, run))
            o += run
        self._width = o
        self.backward = False  # set by the engine around loss.backward()
        self.grads: Dict[int, torch.Tensor] = {}  # whole fp32 gradients of whole_idx
        self._uses: Dict[int, int] = {}  # whole_idx gathered in this micro-batch's forward
        self._arrived: Dict[int, int] = {}  # ... and their gradients arrived since
        self._live: Dict[int, List[Tuple]] = {}  # layer -> its slices' (storage, shape, dtype)
        self._freed: Dict[int, List[Tuple]] = {}  # layer -> freed slices awaiting refill
        self._pending: Dict[int, object] = {}  # layer -> PendingGather
        self.peak_layers = self.peak_layers_backward = 0
        self.gathers, self.gather_s, self.transient = 0, 0.0, 0

    # ------------------------------------------------------------ lookups
    def holds(self, t) -> bool:
        """Whether ``t`` is a master held as this rank's part."""
        return id(t) in self._held

    def layer(self, l: int, dtype: Optional[torch.dtype]) -> Dict[int, torch.Tensor]:
        """Layer ``l``'s gathered slices, {id(part): slice in the layer's
        shape, cast to ``dtype``}, through one autograd Function."""
        parts = [self.leaves[i] for i in self.layer_idx]
        outs = _GatheredLayer.apply(self, l, dtype, *parts)
        return {id(p): t for p, t in zip(parts, outs)}

    def whole(self, tree, paths: Sequence[Tuple[str, ...]]):
        """``tree`` (the masters' nested dict) with the held leaves under
        ``paths`` (key tuples, each to a leaf or a group) gathered whole in
        fp32, all in one all-gather; a new dict along those paths, the rest
        shared."""
        found: List[Tuple[Tuple[str, ...], torch.Tensor]] = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif self.holds(node):
                found.append((path, node))

        for path in paths:
            node = tree
            for k in path:
                node = node.get(k) if isinstance(node, dict) else None
            if node is not None:
                walk(node, tuple(path))
        if not found:
            return tree
        idx = tuple(self._held[id(t)] for _, t in found)
        if torch.is_grad_enabled():
            for i in idx:
                self._uses[i] = self._uses.get(i, 0) + 1
        outs = _GatheredWhole.apply(self, idx, *[t for _, t in found])
        out = dict(tree)
        for (path, _), t in zip(found, outs):
            node = out
            for k in path[:-1]:
                node[k] = dict(node[k])
                node = node[k]
            node[path[-1]] = t
        return out

    # ------------------------------------------------------------- layers
    def _note_alive(self) -> None:
        n = len(self._live) + len(self._pending)
        self.peak_layers = max(self.peak_layers, n)
        if self.backward:
            self.peak_layers_backward = max(self.peak_layers_backward, n)

    def _send(self, l: int, dtype) -> torch.Tensor:
        return torch.cat([self.leaves[i].detach()[l].to(dtype or self.leaves[i].dtype)
                          for i in self.layer_idx])

    def _fetch(self, l: int, dtype) -> torch.Tensor:
        """Layer ``l``'s slices as the all-gather returns them, [dp, width]:
        the prefetched gather, or one now; then, with the prefetch, the next
        layer's gather (l + 1 forward, l - 1 backward) started."""
        t0 = time.perf_counter()
        pending = self._pending.pop(l, None)
        got = pending.wait() if pending is not None else all_gather(self._send(l, dtype),
                                                                    self.group)
        self.gather_s += time.perf_counter() - t0
        self.gathers += 1
        nxt = l - 1 if self.backward else l + 1
        if self.prefetch and 0 <= nxt < self.num_layers and nxt not in self._pending \
                and nxt not in self._live:
            self._pending[nxt] = all_gather_async(self._send(nxt, dtype), self.group)
        return got.view(self.dp, self._width)

    def _gather_layer(self, l: int, dtype) -> List[torch.Tensor]:
        got = self._fetch(l, dtype)
        outs = []
        for i, (o, run) in zip(self.layer_idx, self._cols):
            t = torch.empty(self.partition.plan[i].shape[1:], dtype=got.dtype,
                            device=got.device)
            t.view(self.dp, run).copy_(got[:, o:o + run])
            outs.append(t)
        self._live[l] = [(t.untyped_storage(), t.shape, t.dtype) for t in outs]
        self._note_alive()
        return outs

    def layer_done(self, l: int, x: torch.Tensor, saved: bool) -> torch.Tensor:
        """After layer ``l``'s forward, whose output is ``x``: where autograd
        saved its slices (``saved``: no recompute, a gradient recorded) their
        storage is freed now and refilled by a hook on ``x``'s gradient,
        before the layer's backward; otherwise the slices are dropped."""
        live = self._live.pop(l, [])
        if live and saved and x.requires_grad and torch.is_grad_enabled():
            for storage, _, _ in live:
                storage.resize_(0)
            self._freed[l] = live
            x.register_hook(lambda g, l=l: self._refill(l))
        return x

    def _refill(self, l: int) -> None:
        freed = self._freed.pop(l, None)
        if freed is None:
            return
        got = self._fetch(l, freed[0][2])
        for (storage, shape, dtype), (o, run) in zip(freed, self._cols):
            storage.resize_(got.element_size() * shape.numel())
            t = torch.empty(0, dtype=dtype, device=got.device).set_(storage, 0, shape)
            t.view(self.dp, run).copy_(got[:, o:o + run])
        self._live[l] = freed
        self._note_alive()

    def _layer_backward(self, l: int, grads) -> None:
        send = torch.empty(self.dp, self._width, dtype=torch.float32,
                           device=self.leaves[self.layer_idx[0]].device)
        for (o, run), g in zip(self._cols, grads):
            if g is None:
                send[:, o:o + run].zero_()
            else:
                send[:, o:o + run].copy_(g.reshape(self.dp, run))
        share = reduce_scatter(send.view(-1), self.group)
        self._note(send, share)
        del send
        for i, (o, run) in zip(self.layer_idx, self._cols):
            p = self.leaves[i]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad[l] += share[o:o + run]
        for storage, _, _ in self._live.pop(l, []):
            storage.resize_(0)

    # ------------------------------------------------------- whole leaves
    def _gather_whole(self, idx) -> List[torch.Tensor]:
        plan = self.partition.plan
        got = all_gather(torch.cat([self.leaves[i].detach().reshape(-1) for i in idx]),
                         self.group).view(self.dp, -1)
        outs, o = [], 0
        for i in idx:
            size = plan[i].size
            outs.append(plan[i].assemble(got[:, o:o + size].reshape(-1)))
            o += size
        return outs

    def _add_whole_grads(self, idx, grads) -> None:
        for i, g in zip(idx, grads):
            if g is not None:
                if i in self.grads:
                    self.grads[i] += g
                else:
                    self.grads[i] = g.detach().contiguous()
            self._arrived[i] = self._arrived.get(i, 0) + 1
            if self._arrived[i] >= self._uses.get(i, 0):  # the last use's gradient
                self._uses[i] = self._arrived[i] = 0
                self._reduce_whole(i)

    def _reduce_whole(self, i: int) -> None:
        """Leaf ``i``'s whole gradient reduce-scattered (one call: the
        gradient is laid out by rank already) and this rank's share added
        into its part's ``.grad``."""
        g = self.grads.pop(i, None)
        if g is None:
            return
        share = reduce_scatter(g.view(-1), self.group)
        self._note(g, share)
        del g
        p = self.leaves[i]
        if p.grad is None:
            p.grad = share.view_as(p)
        else:
            p.grad += share.view_as(p)

    # ------------------------------------------------ after the backward
    def _note(self, *buffers: torch.Tensor) -> None:
        held = [p.grad for p in self.leaves if p.grad is not None] + list(self.grads.values())
        self.transient = max(self.transient, storage_bytes(held + list(buffers)))

    def reduce_grads(self) -> List[torch.Tensor]:
        """After the step's backward: a whole-gathered leaf's gradient still
        held (a use whose gradient never came) reduce-scattered, then the
        persistent leaves' whole gradients all-reduced (one flat call).
        Returns every leaf's gradient: this rank's part of the sum for a
        held leaf, the whole sum for a persistent one."""
        for i in self.whole_idx:
            self._reduce_whole(i)
        rest = [self.leaves[i].grad for i in self.persistent]
        if rest:
            flat = torch.cat([t.reshape(-1) for t in rest])
            self._note(flat)
            all_reduce(flat, self.group)
            for t, part in zip(rest, flat.split([t.numel() for t in rest])):
                t.copy_(part.view_as(t))
        return [p.grad for p in self.leaves]

    def drain(self) -> None:
        """Wait for any gather still in flight (after an error mid-forward:
        the ranks' collectives stay matched)."""
        for pending in self._pending.values():
            pending.wait()
        self._pending.clear()
