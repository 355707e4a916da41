"""Host buffers and NVMe tensor swapping.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor.py``: the two-generation
:class:`PinnedBufferPool` (line 23; the asynchronous checkpoint writer takes
its snapshot buffers there too) and :class:`TensorSwapper` (line 93), which
streams a tree's leaves to raw ``<name>.leaf<i>.bin`` files plus a
``<name>.json`` of their shapes and dtypes under ``swap_dir`` through the aio
pool (``ops/aio.py``). This is the storage layer behind ZeRO
``offload_optimizer {"device": "nvme", "nvme_path": ...}``: the optimizer state
lives on disk between steps.

Page-locked buffers come from :func:`pinned_empty`: ordinary host memory
registered with the driver (``cudaHostRegister``), sized to the byte, and
unregistered and freed with its last tensor. Torch's own pinned allocator
rounds each block up to a power of two and keeps freed blocks for the life of
the process, which a 64 GB optimizer state cannot afford.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.aio import AsyncIOHandle
from ..utils.tree import tree_items, tree_map

_PAGE = 4096


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised CPU tensor in page-locked memory, so that copies
    between it and the card run asynchronously at the link's rate. Raises if
    the driver refuses to lock it (there is no unpinned fallback)."""
    shape = tuple(int(d) for d in shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    base = np.empty(nbytes + _PAGE, np.uint8)  # page-aligned below: no page is shared
    off = (-base.ctypes.data) % _PAGE
    view = base[off:off + nbytes]
    ptr = view.ctypes.data
    # fault the pages in on torch's threads first: the driver faults them one
    # thread at a time (4 GiB: 3.1 s, against 0.8 s + 0.4 s registering
    # touched pages; H100 box)
    torch.from_numpy(view).zero_()
    err = torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: error {int(err)}")
    # runs when the buffer's last tensor goes, before numpy frees the memory
    weakref.finalize(base, _unregister, ptr)
    return torch.from_numpy(view).view(dtype).view(shape)


def _sorted_leaves(tree) -> list:
    """The leaves in the order ``jax.tree_util`` flattens a dict (keys
    sorted): leaf i of a swap directory is the same leaf in both packages."""
    return [t for _, t in tree_items(tree, sort_keys=True)]


def _unflatten_sorted(template, leaves: list):
    """``template``'s dict structure over ``leaves`` in sorted-key order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)

    return build(template)


def host_empty(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """:func:`pinned_empty` when ``pin``, else an ordinary CPU tensor."""
    return pinned_empty(shape, dtype) if pin else torch.empty(tuple(shape), dtype=dtype)


class PinnedBufferPool:
    """Two-generation keyed host-buffer pool.

    Buffers are CPU tensors, page-locked when ``pin`` (a copy from the card
    into them runs asynchronously at the link's rate); the writer reads them
    as numpy views. A generation's buffers become reusable only after ITS
    consumers have fully landed (the caller blocks before calling
    :meth:`retire_generation`), and even then one generation later: the
    checkpoint writer retires its generation with an empty one as soon as
    its write has landed, so one generation serves every save. A retired
    generation is kept whole: the writer's generation is the whole state,
    and its next save takes every buffer again."""

    def __init__(self, pin: bool = False):
        self.pin = bool(pin)
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._last_gen: List[torch.Tensor] = []
        self._generation = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        lst = self._free.get((tuple(shape), dtype))
        if lst:
            return lst.pop()
        return host_empty(shape, dtype, self.pin)

    def retire_generation(self, bufs: List[torch.Tensor], pending_ids=frozenset()) -> None:
        """Rotate generations: the previous fill's buffers become reusable now
        that a newer generation has fully landed.

        A buffer may never sit in the free pool while an in-flight write
        still reads from it: the next fill would overwrite bytes a writer is
        persisting. ``pending_ids`` is the ``id()`` set of buffers still
        referenced by in-flight writes; refuse loudly rather than corrupt the
        destination. The whole generation is checked before any buffer is
        freed, so a refusal leaves no buffer half-retired."""
        if any(id(b) in pending_ids for b in self._last_gen):
            raise RuntimeError(
                "PinnedBufferPool: refusing to recycle a read buffer that an "
                "in-flight write still references (read-after-overwrite hazard)")
        for b in self._last_gen:
            self._free.setdefault((tuple(b.shape), b.dtype), []).append(b)
        self._last_gen = list(bufs)
        self._generation += 1

    @property
    def generation(self) -> int:
        """Completed buffer generations."""
        return self._generation

    def held_bytes(self) -> int:
        """Bytes of the buffers the pool holds (free and the last generation)."""
        bufs = [b for lst in self._free.values() for b in lst] + self._last_gen
        return sum(b.numel() * b.element_size() for b in bufs)


class TensorSwapper:
    """A tree's leaves on disk between uses (JAX ``TensorSwapper``).

    ``swap_out`` copies each leaf into a host buffer (every copy from the card
    started first, then one synchronisation) and submits its write;
    ``blocking=False`` returns with the writes in flight, and the next
    ``swap_in`` or ``wait_pending`` of that name waits for them
    (read-after-write). ``swap_in`` reads the files back into host buffers and
    returns the tree, moved to ``device`` when one is given. With
    ``reuse_buffers`` the host buffers come from a :class:`PinnedBufferPool`
    (page-locked when ``pin``): a read generation retires once its copies to
    the device have landed, a write generation once its writes have landed,
    and the pool refuses to recycle a buffer an in-flight write still reads.
    Without it every swap takes fresh buffers and a tree read without a
    ``device`` is returned on those buffers (never recycled)."""

    def __init__(self, swap_dir: str, num_threads: int = 4, reuse_buffers: bool = False,
                 pin: bool = False):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.aio = AsyncIOHandle(num_threads=num_threads)
        self._meta: Dict[str, Any] = {}
        # in-flight writes per name: (request ids, the host buffers they read)
        self._pending: Dict[str, Any] = {}
        # reads started by prefetch: (meta, buffers, request ids, pooled, start)
        self._reading: Dict[str, Any] = {}
        self._reuse = bool(reuse_buffers)
        self._pin = bool(pin)
        self._pool = PinnedBufferPool(pin=pin)
        self.bytes_written = self.bytes_read = 0
        self.write_s = self.read_s = 0.0  # seconds waited on the disk

    def _take_buf(self, shape, dtype) -> torch.Tensor:
        return (self._pool.take(shape, dtype) if self._reuse
                else host_empty(shape, dtype, self._pin))

    def _retire_gen(self, bufs: list) -> None:
        """Rotate the pool's generations; an alias of an in-flight write's
        buffer among the previous generation is refused."""
        pending_ids = {id(h) for _reqs, hosts in self._pending.values() for h in (hosts or [])}
        self._pool.retire_generation(bufs, pending_ids=pending_ids)

    @property
    def generation(self) -> int:
        """Completed buffer generations."""
        return self._pool.generation

    @property
    def _last_gen(self) -> list:
        return self._pool._last_gen

    def held_bytes(self) -> int:
        """Host bytes in the pool plus the in-flight writes' buffers."""
        inflight = sum(h.numel() * h.element_size()
                       for _r, hosts in self._pending.values() for h in (hosts or []))
        return self._pool.held_bytes() + inflight

    def _leaf_path(self, name: str, i: int) -> str:
        return os.path.join(self.swap_dir, f"{name}.leaf{i}.bin")

    def wait_pending(self, name: str) -> None:
        """Block until the in-flight writes of ``name`` have landed; their
        buffers then retire as a generation."""
        reqs, hosts = self._pending.pop(name, ([], None))
        t0 = time.perf_counter()
        for r in reqs:
            self.aio.wait(r)
        self.write_s += time.perf_counter() - t0
        if hosts and self._reuse:
            self._retire_gen(list(hosts))

    def swap_out(self, name: str, tree, blocking: bool = True) -> None:
        """Write every leaf of ``tree`` (tensors on any device) to disk."""
        self.wait_pending(name)  # two write generations never interleave
        leaves = _sorted_leaves(tree)
        hosts, meta, devices = [], [], set()
        for leaf in leaves:
            src = leaf.detach()
            host = self._take_buf(src.shape, src.dtype)
            host.copy_(src, non_blocking=True)
            if src.device.type == "cuda":
                devices.add(src.device)
            hosts.append(host)
            meta.append({"shape": list(src.shape),
                         "dtype": str(src.dtype).replace("torch.", "")})
        for dev in devices:  # the copies off the card land before the disk reads them
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        reqs = [self.aio.submit_write(self._leaf_path(name, i), h) for i, h in enumerate(hosts)]
        self.bytes_written += sum(h.numel() * h.element_size() for h in hosts)
        # the structure alone: the meta must not keep the device tensors alive
        self._meta[name] = {"leaves": meta, "tree": tree_map(lambda _: None, tree)}
        with open(os.path.join(self.swap_dir, f"{name}.json"), "w") as f:
            json.dump({"leaves": meta}, f)
        self._pending[name] = (reqs, hosts)
        self.write_s += time.perf_counter() - t0
        if blocking:
            self.wait_pending(name)

    def prefetch(self, name: str, template=None, device: Optional[torch.device] = None) -> None:
        """Start reading ``name`` back (after its in-flight writes land): the
        reads run on the aio threads while the caller goes on, and the next
        :meth:`swap_in` of ``name`` (with the same ``device``) takes them."""
        if name in self._reading:
            return
        pooled = self._reuse and device is not None
        self.wait_pending(name)
        meta = self._meta.get(name)
        if meta is None:
            with open(os.path.join(self.swap_dir, f"{name}.json")) as f:
                meta = {"leaves": json.load(f)["leaves"], "tree": template}
        bufs, reqs = [], []
        for i, lm in enumerate(meta["leaves"]):
            dtype = getattr(torch, lm["dtype"])
            buf = (self._pool.take(lm["shape"], dtype) if pooled
                   else host_empty(lm["shape"], dtype, self._pin))
            reqs.append(self.aio.submit_read(self._leaf_path(name, i), buf))
            bufs.append(buf)
        self._reading[name] = (meta, bufs, reqs, pooled, time.perf_counter())

    def swap_in(self, name: str, template=None, device: Optional[torch.device] = None):
        """Read ``name`` back: the tree of the last ``swap_out`` (or of
        ``template``, or a list when neither is known: a directory another
        process wrote), copied to ``device`` when given."""
        use_pool = self._reuse and device is not None
        if name in self._reading and self._reading[name][3] != use_pool:
            self._finish_reads(name)  # a prefetch into the other kind of buffer
        self.prefetch(name, template, device)
        meta, bufs = self._finish_reads(name)
        leaves = bufs
        if device is not None:
            leaves = [b.to(device, non_blocking=True, copy=use_pool) for b in bufs]
            if use_pool:
                # the copies may still be reading the buffers: they retire
                # only once the device holds the tree
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                self._retire_gen(bufs)
        if meta["tree"] is None:
            return leaves
        return _unflatten_sorted(meta["tree"], leaves)

    def _finish_reads(self, name: str):
        meta, bufs, reqs, _pooled, t0 = self._reading.pop(name)
        for r in reqs:
            self.aio.wait(r)
        self.read_s += time.perf_counter() - t0
        self.bytes_read += sum(b.numel() * b.element_size() for b in bufs)
        return meta, bufs

    def release(self, name: str) -> None:
        """Forget ``name`` and delete its files."""
        if name in self._reading:
            self._finish_reads(name)
        self.wait_pending(name)
        meta = self._meta.pop(name, None)
        n = len(meta["leaves"]) if meta else 0
        for i in range(n):
            try:
                os.remove(self._leaf_path(name, i))
            except FileNotFoundError:
                pass
        try:
            os.remove(os.path.join(self.swap_dir, f"{name}.json"))
        except FileNotFoundError:
            pass

    def close(self) -> None:
        for name in list(self._reading):
            self._finish_reads(name)
        for name in list(self._pending):
            self.wait_pending(name)
        self.aio.close()
