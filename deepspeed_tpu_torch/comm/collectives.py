"""Collectives over ``torch.distributed`` process groups.

Counterpart of ``deepspeed_tpu/comm/collectives.py`` (``all_reduce`` line 55,
``all_gather`` line 76, ``broadcast`` line 82, ``all_to_all`` line 93,
``permute`` line 111). The JAX package runs them inside ``shard_map`` over a
mesh axis name; here each takes the process group of that axis
(``MeshTopology.group``). A group whose backend is gloo carries host tensors
only, so CUDA tensors are staged through host buffers explicitly (decided by
the group's backend, never by trying): gloo is the transport of a CPU world,
and of ranks that share one card, where NCCL refuses two ranks on a device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

_PINNED: Dict[Tuple[torch.dtype, int], torch.Tensor] = {}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through a host buffer on ``group``."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer shaped like ``t``, kept per (dtype, size): the
    engine stages the same flat gradient buffer every step."""
    key = (t.dtype, t.numel())
    if key not in _PINNED:
        _PINNED[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
    return _PINNED[key].view(t.shape)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Parity: deepspeed.comm.all_reduce, in place on ``x``; returns ``x``."""
    if group_size(group) == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}.get(op)
    if red is None:
        raise ValueError(f"unsupported reduce op {op}")
    if _staged(group, x):
        h = _pinned(x)
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
        h = _pinned(x)
        h.copy_(x)
        dist.broadcast(h, root, group)
        x.copy_(h)
    else:
        dist.broadcast(x, root, group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Parity: deepspeed.comm.all_gather_into_tensor (tiled): the members'
    tensors concatenated along ``dim`` in member order. No gradient."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.detach().contiguous()
    staged = _staged(group, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


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
