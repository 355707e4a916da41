"""Collectives over ``torch.distributed`` process groups.

Counterpart of ``deepspeed_tpu/comm/collectives.py`` (``all_reduce`` line 55,
``reduce_scatter`` line 69, ``all_gather`` line 76, ``broadcast`` line 82,
``all_to_all`` line 93, ``permute`` line 111). The JAX package runs them
inside ``shard_map`` over a mesh axis name; here each takes the process group
of that axis (``MeshTopology.group``). A group whose backend is gloo carries
host tensors only, so CUDA tensors are staged through host buffers
explicitly (decided by the group's backend, never by trying): gloo is the
transport of a CPU world, and of ranks that share one card, where NCCL
refuses two ranks on a device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

_PINNED: Dict[Tuple[torch.dtype, int, str], torch.Tensor] = {}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through a host buffer on ``group``."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(shape, dtype: torch.dtype, slot: str = "") -> torch.Tensor:
    """A pinned host buffer of ``shape``, kept per (dtype, size, ``slot``):
    the engine stages the same flat buffers every step; an asynchronous
    collective takes a slot of its own, which no blocking one touches while
    it is in flight."""
    numel = math.prod(shape)
    key = (dtype, numel, slot)
    if key not in _PINNED:
        _PINNED[key] = torch.empty(numel, dtype=dtype, pin_memory=True)
    return _PINNED[key].view(shape)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Parity: deepspeed.comm.all_reduce, in place on ``x``; returns ``x``."""
    if group_size(group) == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}.get(op)
    if red is None:
        raise ValueError(f"unsupported reduce op {op}")
    if _staged(group, x):
        h = _pinned(x.shape, x.dtype)
        h.copy_(x)
        dist.all_reduce(h, red, group)
        x.copy_(h)
    else:
        dist.all_reduce(x, red, group)
    return x


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Parity: deepspeed.comm.broadcast, in place: every member takes the
    value of the member at ``src`` (its index in ``group``)."""
    if group_size(group) == 1:
        return x
    root = dist.get_global_rank(group, src)
    if _staged(group, x):
        h = _pinned(x.shape, x.dtype)
        h.copy_(x)
        dist.broadcast(h, root, group)
        x.copy_(h)
    else:
        dist.broadcast(x, root, group)
    return x


def _staged_io(group, src: torch.Tensor, out_shape):
    """A collective's input and output: ``src`` and a new tensor beside it,
    or both in pinned host buffers where the group stages; and whether it
    stages."""
    if not _staged(group, src):
        return src, torch.empty(out_shape, dtype=src.dtype, device=src.device), False
    return (_pinned(src.shape, src.dtype).copy_(src), _pinned(out_shape, src.dtype), True)


def _landed(out: torch.Tensor, dim: int, device, staged: bool) -> torch.Tensor:
    """A collective's output with its blocks back on ``dim``, contiguous, on
    ``device``."""
    out = out.movedim(0, dim)
    if staged:
        out = out.to(device)
    return out.contiguous() if dim else out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Parity: deepspeed.comm.all_gather_into_tensor (tiled): the members'
    tensors concatenated along ``dim`` in member order, in one call. No
    gradient."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.detach().movedim(dim, 0).contiguous()
    src, out, staged = _staged_io(group, src, (n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return _landed(out, dim, x.device, staged)


class PendingGather:
    """An all-gather in flight (:func:`all_gather_async`): :meth:`wait`
    returns what :func:`all_gather` of the same tensor along dim 0 returns."""

    def __init__(self, work, out: torch.Tensor, device, staged: bool, src: torch.Tensor):
        self._work, self._out, self._device, self._staged = work, out, device, staged
        self._src = src  # the input stays alive until the collective has read it

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = self._src = None
        return self._out.to(self._device) if self._staged else self._out


def all_gather_async(x: torch.Tensor, group, slot: str = "async") -> PendingGather:
    """:func:`all_gather` along dim 0 started with ``async_op``: the call
    returns once the input is staged (a card's tensor is copied into a
    pinned host buffer of its own ``slot`` first, where the group stages),
    and the transfer runs on the backend's thread until :meth:`PendingGather.
    wait`. One gather a slot may be in flight."""
    n = group_size(group)
    if n == 1:
        return PendingGather(None, x, x.device, False, x)
    src = x.detach().contiguous()
    shape = (n * src.shape[0], *src.shape[1:])
    staged = _staged(group, src)
    if staged:
        src = _pinned(src.shape, src.dtype, slot + ".in").copy_(src)
        out = _pinned(shape, src.dtype, slot + ".out")
    else:
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    work = dist.all_gather_into_tensor(out, src, group=group, async_op=True)
    return PendingGather(work, out, x.device, staged, src)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Parity: deepspeed.comm.reduce_scatter_tensor (JAX ``reduce_scatter``,
    tiled, summed): the members' tensors summed, member i keeping block i of
    ``dim`` cut into one block a member, in one call. Raises when the group
    does not divide the size of ``dim``. No gradient."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[dim]} does not "
                         f"split over {n} members")
    src = x.detach().movedim(dim, 0).contiguous()
    src, out, staged = _staged_io(group, src, (src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, dist.ReduceOp.SUM, group=group)
    return _landed(out, dim, x.device, staged)


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()  # [n, ...] chunk i → member i
    staged = _staged(group, send)
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_dim)  # from member i → block i


class _AllToAll(torch.autograd.Function):
    """DeepSpeed's ``_SeqAllToAll`` (deepspeed/sequence/layer.py): split
    ``split_dim`` across the members, concatenate what arrives along
    ``concat_dim``; the backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group, ctx.concat_dim, ctx.split_dim), \
            None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Parity: deepspeed.comm.all_to_all_single (tiled), differentiable:
    ``x``'s ``split_dim`` is cut into one block per member, block i goes to
    member i, and the blocks received are concatenated along ``concat_dim``
    in member order."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ring_shift(tensors: Sequence[torch.Tensor], group, step: int = 1) -> List[torch.Tensor]:
    """Parity: ``permute`` with the ring permutation r → r + step (the sp
    ring's ``ppermute``): each member sends every tensor to member
    (i + step) mod n and returns the ones received from (i - step) mod n,
    all in one ``batch_isend_irecv``. No gradient."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    me = group_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    sends = [t.detach().contiguous() for t in tensors]
    staged = [_staged(group, t) for t in sends]
    sends = [t.cpu() if s else t for t, s in zip(sends, staged)]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends] + \
          [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) if s else r for r, t, s in zip(recvs, tensors, staged)]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, step, *tensors):
        ctx.group, ctx.step = group, step
        return tuple(ring_shift(tensors, group, step))

    @staticmethod
    def backward(ctx, *grads):
        # a gradient flows back against the ring (grads are materialized)
        return (None, None, *ring_shift(grads, ctx.group, -ctx.step))


def ring_shift_differentiable(tensors: Sequence[torch.Tensor], group,
                              step: int = 1) -> List[torch.Tensor]:
    """:func:`ring_shift` of floating tensors whose backward sends each
    gradient the other way round the ring (``ppermute``'s transpose)."""
    if group_size(group) == 1:
        return list(tensors)
    return list(_RingShift.apply(group, step, *tensors))
