"""Per-layer ("sub-group") optimizer stepping for offloaded state.

Counterpart of ``deepspeed_tpu/runtime/bucketed_opt.py:50 BucketedOptimizer``.
With ``offload_optimizer.device: cpu`` the optimizer state rests in host
memory (page-locked on a card) and the update streams it through the device
a layer at a time, so the device holds one layer's state, not the tree's:

- the state is ``{"rest": state of the non-layer leaves, "layers": state of
  the stacked [L, ...] decoder leaves}``, each slot's tree like the params';
  a checkpoint names it as the JAX package's vmapped chain does
  (``['layers'][0][0].mu['attn']['wq']``, each ``['layers']`` update count an
  [L] int32, all equal);
- the ``rest`` leaves update first, one leaf at a time (copy its state in,
  update, copy it out: the device holds one leaf's state, the embedding's at
  most), then the layers in order; each layer's update is the optimizer's
  :meth:`~.optimizers.Optimizer.update_leaf` on each stacked leaf's slice
  (one fused Adam launch per stacked leaf per layer on a card). Every
  transform is elementwise except lamb's trust ratio, which takes the
  slice's norms, as the JAX scan does; every other optimizer equals the
  resident update bit for bit;
- ``offload_param`` (stage 3) keeps the fp32 masters on the host too: each
  slice's master streams in and out beside its state; a ``compute`` tree
  (fp16 training's device copy of the masters in the compute dtype) takes
  each updated slice, cast on the device, so it needs no copy of its own;
- the layer stream's form follows the device: on the CPU, per layer, the
  copies in, the update, the copies out, through one slot of buffers; on a
  card, double buffered (JAX's ``offload_double_buffer``, always on): two
  slots; layer i+1's state is copied in on a copy-in stream while layer i's
  update runs on the current stream, and layer i's result is copied out on a
  copy-out stream behind it. Events order each slot's reuse: a copy in waits
  for the copy out of the layer that last held its slot, a copy out for its
  layer's update, an update for its copy in; the step ends with the current
  stream waiting for the copy-out stream. Layer order and per-layer
  arithmetic are the serial form's, so the two are bitwise equal.

With ``timing`` on, CUDA events bracket every copy and update; after the step
(one synchronisation) ``last_ms`` holds the summed copy-in, update and
copy-out device milliseconds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..utils.tree import tree_leaves, tree_map
from .swap_tensor import host_empty

KEY = "layers"


def bucketed_applicable(params) -> bool:
    """The per-layer update needs the stacked ``layers`` group beside other
    leaves (JAX ``bucketed_applicable``)."""
    return isinstance(params, dict) and KEY in params and len(params) > 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class BucketedOptimizer:
    """Wraps an :class:`~.optimizers.Optimizer` with per-layer stepping over
    host-resident state (``pin``: page-locked). ``offload_param``: the
    masters rest on the host as well and stream with the state."""

    def __init__(self, optimizer, *, pin: bool = False, offload_param: bool = False):
        self.optimizer = optimizer
        self.double_buffer = False  # set by init: on a card
        self.pin = bool(pin)
        self.offload_param = bool(offload_param)
        self.timing = False
        self.last_ms: Dict[str, float] = {}
        self._streams: Dict[torch.device, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}

    @staticmethod
    def split(tree):
        return {k: v for k, v in tree.items() if k != KEY}, tree[KEY]

    def init(self, params) -> Dict[str, Dict[str, object]]:
        """The state on the host: every slot of both groups, filled with the
        optimizer's initial value."""
        fill = self.optimizer.slot_fill

        def slot(p):
            return host_empty(p.shape, torch.float32, self.pin).fill_(fill)

        rest, layers = self.split(params)
        first = tree_leaves(layers)[0]
        self.L = int(first.shape[0])
        self.double_buffer = first.device.type == "cuda"
        return {group: {name: tree_map(slot, tree) for name in self.optimizer.slots}
                for group, tree in (("rest", rest), ("layers", layers))}

    def state_items(self, state, count: int) -> List[Tuple[str, object]]:
        """The state under the JAX bucketed state's names, in its flatten
        order (``layers`` before ``rest``)."""
        return (self.optimizer.state_items(state["layers"], count, "['layers']", (self.L,))
                + self.optimizer.state_items(state["rest"], count, "['rest']"))

    def stream_bytes(self, state, host_params=None) -> Dict[str, object]:
        """The bytes the update moves each way (JAX ``_compute_offload_stream``):
        every host-resident state leaf (and master, under ``offload_param``)
        of both groups; ``slot_bytes`` one layer's share of the stacked group,
        ``slots`` resident at once. The forward's copy of the masters under
        ``offload_param`` is the engine's ``forward_bytes_in``."""
        groups = {g: sum(_nbytes(t) for name in self.optimizer.slots
                         for t in tree_leaves(state[g][name])) for g in ("rest", "layers")}
        if self.offload_param and host_params is not None:
            rest, layers = self.split(host_params)
            groups["rest"] += sum(_nbytes(t) for t in tree_leaves(rest))
            groups["layers"] += sum(_nbytes(t) for t in tree_leaves(layers))
        L = self.L
        total = groups["rest"] + groups["layers"]
        return {"bytes_in": total, "bytes_out": total, "layer_bytes": groups["layers"],
                "rest_bytes": groups["rest"], "slot_bytes": groups["layers"] // max(L, 1),
                "slots": 2 if self.double_buffer else 1, "layers": L,
                "double_buffer": self.double_buffer}

    # ------------------------------------------------------------ the step
    def step(self, params, grads, state, step: int, clip: Optional[torch.Tensor] = None,
             host_params=None, compute=None) -> None:
        """One update, in place on the host state (and ``host_params`` under
        ``offload_param``) or on ``params``' device masters. ``grads`` are the
        device gradients (the params' tree); ``compute``, under
        ``offload_param``, a device tree the updated masters are cast into."""
        opt = self.optimizer
        g_rest, g_layers = self.split(grads)
        p_rest, p_layers = self.split(params)
        src = host_params if self.offload_param else None
        h_rest, h_layers = self.split(src) if src is not None else (None, None)
        c_rest, c_layers = self.split(compute) if compute is not None else (None, None)
        device = tree_leaves(g_layers)[0].device
        on_cuda = device.type == "cuda"
        timer = _Timer(on_cuda and self.timing)

        def leaf_lists(group, p_tree, g_tree, h_tree, c_tree):
            hosts = [tree_leaves(state[group][name]) for name in opt.slots]
            ps, gs = tree_leaves(p_tree), tree_leaves(g_tree)
            hps = tree_leaves(h_tree) if h_tree is not None else [None] * len(ps)
            cs = tree_leaves(c_tree) if c_tree is not None else [None] * len(ps)
            return [([h[j] for h in hosts] + ([hps[j]] if hps[j] is not None else []),
                     ps[j], gs[j], cs[j]) for j in range(len(ps))]

        with torch.no_grad():
            # the rest group, a leaf at a time
            for hosts, p, g, c in leaf_lists("rest", p_rest, g_rest, h_rest, c_rest):
                bufs = [torch.empty(h.shape, dtype=h.dtype, device=device) for h in hosts]
                with timer("copy_in"):
                    for b, h in zip(bufs, hosts):
                        b.copy_(h, non_blocking=True)
                with timer("update"):
                    self._update(p, g, bufs, step, clip, c)
                with timer("copy_out"):
                    for b, h in zip(bufs, hosts):
                        h.copy_(b, non_blocking=True)
            leaves = leaf_lists("layers", p_layers, g_layers, h_layers, c_layers)
            L = int(leaves[0][2].shape[0])
            slots = [[[torch.empty(h.shape[1:], dtype=h.dtype, device=device) for h in hosts]
                      for hosts, *_ in leaves] for _ in range(2 if on_cuda else 1)]
            if on_cuda:
                self._double_buffered(leaves, slots, L, step, clip, device, timer)
            else:  # serial: one slot, the copies in, the update, the copies out
                for i in range(L):
                    self._copy_in(leaves, slots[0], i)
                    self._update_layer(leaves, slots[0], i, step, clip)
                    self._copy_out(leaves, slots[0], i)
        self.last_ms = timer.totals()

    def _update(self, p, g, bufs, step, clip, c=None):
        k = len(self.optimizer.slots)
        target = bufs[k] if self.offload_param else p
        self.optimizer.update_leaf(target, g, bufs[:k], step, clip)
        if c is not None:
            c.copy_(target)

    def _update_layer(self, leaves, bufs, i, step, clip):
        for (hosts, p, g, c), b in zip(leaves, bufs):
            self._update(p[i], g[i], b, step, clip, None if c is None else c[i])

    @staticmethod
    def _copy_in(leaves, bufs, i):
        for (hosts, *_), bs in zip(leaves, bufs):
            for b, h in zip(bs, hosts):
                b.copy_(h[i], non_blocking=True)

    @staticmethod
    def _copy_out(leaves, bufs, i):
        for (hosts, *_), bs in zip(leaves, bufs):
            for b, h in zip(bs, hosts):
                h[i].copy_(b, non_blocking=True)

    def _double_buffered(self, leaves, slots, L, step, clip, device, timer):
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        s_in, s_out = self._streams[device]
        cur = torch.cuda.current_stream(device)
        s_in.wait_stream(cur)  # the previous step's copies out, which cur waited for
        in_done = [torch.cuda.Event() for _ in range(2)]
        upd_done = [torch.cuda.Event() for _ in range(2)]
        out_done = [torch.cuda.Event() for _ in range(2)]

        def fetch(i):
            s = i % 2
            with torch.cuda.stream(s_in):
                if i >= 2:  # the slot's last layer (i - 2) is out
                    s_in.wait_event(out_done[s])
                with timer("copy_in", s_in):
                    self._copy_in(leaves, slots[s], i)
                in_done[s].record(s_in)

        fetch(0)
        for i in range(L):
            s = i % 2
            if i + 1 < L:
                fetch(i + 1)
            cur.wait_event(in_done[s])
            with timer("update", cur):
                self._update_layer(leaves, slots[s], i, step, clip)
            upd_done[s].record(cur)
            with torch.cuda.stream(s_out):
                s_out.wait_event(upd_done[s])
                with timer("copy_out", s_out):
                    self._copy_out(leaves, slots[s], i)
                out_done[s].record(s_out)
        # the slots' last use is behind the current stream before they are freed
        cur.wait_stream(s_out)


class _Timer:
    """CUDA-event brackets summed by label (a no-op when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.pairs: Dict[str, list] = {}

    def __call__(self, label: str, stream=None):
        return _Span(self, label, stream)

    def totals(self) -> Dict[str, float]:
        if not self.on or not self.pairs:
            return {}
        torch.cuda.synchronize()
        return {k: float(sum(a.elapsed_time(b) for a, b in v)) for k, v in self.pairs.items()}


class _Span:
    def __init__(self, timer: _Timer, label: str, stream):
        self.timer, self.label, self.stream = timer, label, stream

    def __enter__(self):
        if self.timer.on:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.timer.on:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            self.timer.pairs.setdefault(self.label, []).append((self.start, end))
        return False


