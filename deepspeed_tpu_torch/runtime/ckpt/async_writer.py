"""The snapshot pipeline: device→pinned-host snapshot, then the shard writer.

Counterpart of ``deepspeed_tpu/runtime/ckpt/async_writer.py``.
``save_checkpoint(engine, ..., async_save=True)`` splits a save in two:

- the **snapshot fence** (main thread): wait for the previous writer (its
  buffers retire at once, so the pool holds one generation of the state),
  copy every leaf into a :class:`~..swap_tensor.PinnedBufferPool` buffer
  (every copy started ``non_blocking`` first, then one synchronisation), and
  rotate the pool's generations. The next step may update the masters in
  place the moment the fence returns: the snapshot is a copy.
- the **background write** (one writer thread, numpy and file I/O only; it
  never touches CUDA): each shard file, then the manifest LAST
  (:mod:`.manifest`'s commit rule), ``latest``, ``zero_to_fp32.py`` and the
  ``keep_last`` pruning.

A :class:`CheckpointGuard` holds one writer in flight and re-raises a
writer's exception on the main thread at the next fence: a failed
background save fails the run, it never silently drops a restore point. A
sync save is the same writer run inline, so its files are byte for byte an
async save's. On more than one rank every save is sync (the commit needs a
barrier a background thread cannot own) and only rank 0 snapshots and
writes, whole leaves: the masters are whole on every rank, and under ZeRO
stages 1 and 2 each leaf of the optimizer state split over the ranks
(``runtime.zero.ShardedLeaf``) is gathered whole, one leaf at a time, every
rank taking part, and rank 0 copies it into its snapshot before the next.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...utils.logging import log_dist
from ..checkpointing import (_COMPONENTS, _SHARD_FMT, _ZERO_TO_FP32_SCRIPT, NamedLeaves,
                             _barrier, _clean_component_dir, _full_token, _is_writer,
                             numpy_dtype, world_size)
from ..swap_tensor import PinnedBufferPool
from ..zero import ShardedLeaf
from . import manifest as _manifest


def _snapshot(components: Dict[str, NamedLeaves], pool: PinnedBufferPool,
              writer: bool = True):
    """Copy every leaf of ``components`` into pool buffers: every copy is
    started first (``non_blocking`` from the card into pinned memory), then
    one synchronisation. A :class:`ShardedLeaf` is gathered whole first, on
    every rank (``writer`` False: a rank that only takes part in the
    gathers), and dropped once its copy is queued, so a rank holds one
    gathered leaf at a time. Returns ``(entries_by_comp, metas, bufs)``:
    per component ``[(filename, numpy view)]`` for the writer and its
    manifest record."""
    entries_by_comp: Dict[str, list] = {}
    metas: Dict[str, Dict[str, Any]] = {}
    bufs: List[torch.Tensor] = []
    devices = set()
    for comp, named in components.items():
        entries, shapes, dtypes, shards = [], [], [], {}
        for i, (name, leaf) in enumerate(named):
            if isinstance(leaf, ShardedLeaf):
                with torch.no_grad():
                    leaf = leaf.whole()
            if not writer:
                continue
            src = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
            numpy_dtype(src.dtype)  # refuse a dtype numpy cannot hold, before any copy
            buf = pool.take(src.shape, src.dtype)
            buf.copy_(src, non_blocking=True)
            if src.device.type == "cuda":
                devices.add(src.device)
            token = _full_token(src.shape)
            entries.append((_SHARD_FMT.format(i, token), buf))
            shapes.append(list(src.shape))
            dtypes.append(str(numpy_dtype(src.dtype)))
            shards[str(i)] = [token]
            bufs.append(buf)
            del src, leaf  # a gathered leaf goes before the next is gathered
        entries_by_comp[comp] = entries
        metas[comp] = {
            "num_leaves": len(named),
            "leaf_names": [n for n, _ in named],
            "leaf_shapes": shapes,
            "leaf_dtypes": dtypes,
            "leaf_dimspecs": [[1] * len(s) for s in shapes],
            "shards": shards,
        }
    for dev in devices:
        torch.cuda.synchronize(dev)
    # the writer gets numpy views of the host buffers (no CUDA in the thread)
    entries_by_comp = {comp: [(f, b.numpy()) for f, b in entries]
                       for comp, entries in entries_by_comp.items()}
    return entries_by_comp, metas, bufs


class CheckpointGuard:
    """Fences saves: at most ONE writer in flight, a writer's exception
    surfaces on the main thread at the next fence, and the pool's
    generations rotate only after the previous writer has landed: the fence
    that joins a writer retires its buffers, so every save after the first
    reuses one generation. The pool refuses to recycle a buffer the
    in-flight writer still reads. Its buffers are pinned when ``pin``;
    ``last_write_s`` is the last write's seconds (files and commit)."""

    def __init__(self, pin: bool = False):
        self._pool = PinnedBufferPool(pin=pin)
        self._thread: Optional[threading.Thread] = None
        self._writing: List[torch.Tensor] = []  # the in-flight writer's buffers
        self._exc: Optional[BaseException] = None
        self.last_write_s: Optional[float] = None

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def fence(self) -> None:
        """Block until the in-flight writer (if any) has committed; re-raise
        its failure HERE: the main thread must see a lost restore point."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread, self._writing = None, []
            self.landed()  # failed or not, the writer reads its buffers no more
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError(
                f"async checkpoint writer failed: {exc!r} (the previous save did NOT "
                f"commit; restore will resolve the last committed tag)") from exc

    def drain(self) -> None:
        """:meth:`fence` that only logs a writer failure (teardown must not
        raise)."""
        try:
            self.fence()
        except RuntimeError as e:
            log_dist(f"ckpt: {e}")

    def _pending(self) -> frozenset:
        return frozenset(id(b) for b in self._writing) if self.in_flight else frozenset()

    def rotate(self, bufs: List[torch.Tensor]) -> None:
        """Two generations: the one before last becomes reusable now that
        this one is snapshotted."""
        self._pool.retire_generation(list(bufs), pending_ids=self._pending())

    def landed(self) -> None:
        """A write has landed: the generation just written is quiescent and
        retires at once (an empty generation takes its place), so the next
        save reuses its buffers."""
        self._pool.retire_generation([], pending_ids=self._pending())

    def launch(self, fn: Callable[[], None], bufs: List[torch.Tensor]) -> None:
        """Run ``fn`` on the writer thread; ``bufs`` are the buffers it reads."""
        if self.in_flight:
            raise RuntimeError("CheckpointGuard: a writer is already in flight")

        def body():
            t0 = time.perf_counter()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - surfaced at fence
                self._exc = e
            finally:
                self.last_write_s = time.perf_counter() - t0

        # not a daemon: a normal interpreter exit waits for the commit rather
        # than tearing a save mid-write
        self._writing = list(bufs)
        self._thread = threading.Thread(target=body, name="ckpt-writer")
        self._thread.start()


def _build_meta(engine, tag: str, client_state: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "manifest_version": _manifest.MANIFEST_VERSION,
        "tag": tag,
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "step": engine.update_count,  # the updates done: global less skipped
        "rng": engine.rng_key(),
        "client_state": client_state or {},
        "zero_stage": engine.config.zero_config.stage,
        "world_size": engine.topology.world_size,
        "components": {},
    }


def _write_entries(path: str, entries_by_comp) -> None:
    for comp, entries in entries_by_comp.items():
        cdir = os.path.join(path, comp)
        for fname, arr in entries:
            np.save(os.path.join(cdir, fname), arr)


def _commit(save_dir: str, tag: str, meta: Dict[str, Any], keep_last: int) -> None:
    """The manifest-last commit and the root files (the writer rank only)."""
    _manifest.write_manifest(save_dir, tag, meta)
    _manifest.advance_latest(save_dir, tag)
    with open(os.path.join(save_dir, "zero_to_fp32.py"), "w") as f:
        f.write(_ZERO_TO_FP32_SCRIPT)
    _manifest.prune_keep_last(save_dir, keep_last)


def save_checkpoint(engine, save_dir: str, guard: CheckpointGuard,
                    tag: Optional[str] = None,
                    client_state: Optional[Dict[str, Any]] = None,
                    async_save: bool = False) -> str:
    """Save ``engine.checkpoint_components()`` under ``save_dir/tag``
    (``global_step{N}`` by default) through the snapshot pipeline behind
    ``guard`` (the engine's); sync, or with ``async_save`` the write on the
    writer thread. Returns the tag's directory."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    keep_last = int(engine.config.checkpoint.keep_last or 0)
    if async_save and world_size() > 1:
        log_dist("ckpt: async_save on more than one rank falls back to sync (the "
                 "commit needs a barrier the background writer cannot own)")
        async_save = False

    # ---- the snapshot fence (main thread) ----------------------------
    guard.fence()  # one writer in flight; surfaces the previous writer's failure
    path = os.path.join(save_dir, str(tag))
    writer = _is_writer()
    if writer:
        os.makedirs(path, exist_ok=True)
        # re-saving over a committed tag: demote it FIRST, so that a torn
        # rewrite is uncommitted rather than silently stale
        mpath = _manifest.manifest_path(save_dir, tag)
        if os.path.exists(mpath):
            os.remove(mpath)
    meta = _build_meta(engine, tag, client_state or {})
    for name in _COMPONENTS:
        cdir = os.path.join(path, name)
        if writer:
            os.makedirs(cdir, exist_ok=True)
        _clean_component_dir(cdir)  # the stale generation out first
    entries_by_comp: Dict[str, list] = {}
    bufs: List[torch.Tensor] = []
    # every rank: the leaves split over dp ranks are gathered one at a time
    entries_by_comp, metas, bufs = _snapshot(engine.checkpoint_components(), guard._pool,
                                             writer)
    if writer:
        meta["components"] = metas
        guard.rotate(bufs)

    # ---- the write and the commit -------------------------------------
    if async_save:
        def write():
            _write_entries(path, entries_by_comp)
            _commit(save_dir, tag, meta, keep_last)
            log_dist(f"saved checkpoint {path} (async)")

        guard.launch(write, bufs)
        return path

    t0 = time.perf_counter()
    if writer:
        _write_entries(path, entries_by_comp)
        _commit(save_dir, tag, meta, keep_last)
        guard.landed()
    _barrier("ckpt_commit")  # no rank races ahead of the commit
    guard.last_write_s = time.perf_counter() - t0
    log_dist(f"saved checkpoint {path}")
    return path


# ----------------------------------------------- preemption (SIGTERM)
_PREEMPT_LOCK = threading.Lock()
_PREEMPT: Dict[str, Any] = {"installed": False, "prev": None, "engines": []}


def _registered() -> List[tuple]:
    """The live registrations ``(engine, save_dir)``; dead references are
    dropped."""
    live = [(ref(), d) for ref, d in _PREEMPT["engines"]]
    live = [(e, d) for e, d in live if e is not None]
    _PREEMPT["engines"] = [(weakref.ref(e), d) for e, d in live]
    return live


def install_preempt_handler(engine, save_dir: str) -> None:
    """Chain a SIGTERM handler that commits a FINAL SYNC SAVE of each
    registered engine (into the ``save_dir`` it last saved to), then hands
    the signal to the handler installed before (or exits with 128 +
    SIGTERM). One process only: a preempted rank cannot finish the barriers
    a save over ranks needs while its peers train on; such a job resumes
    from its last committed tag. Engines are held by weak reference, so a
    registration never keeps an engine's state alive."""
    import signal

    with _PREEMPT_LOCK:
        _PREEMPT["engines"] = [(weakref.ref(e), d) for e, d in _registered()
                               if e is not engine] + [(weakref.ref(engine), save_dir)]
        if _PREEMPT["installed"]:
            return
        if threading.current_thread() is not threading.main_thread():
            return  # signal handlers install from the main thread only

        def _on_sigterm(signum, frame):
            for eng, sdir in _registered():
                try:
                    if world_size() > 1:
                        log_dist("ckpt: preempted on more than one rank: skipping the "
                                 "final save (peers would hang in its barriers); resume "
                                 "uses the last committed tag")
                        continue
                    if getattr(eng, "params", None) is None:
                        continue  # a destroyed engine
                    eng.save_checkpoint(sdir, async_save=False)
                    log_dist("ckpt: preemption save committed")
                except Exception as e:  # noqa: BLE001 - best effort
                    log_dist(f"ckpt: preemption save failed: {e}")
            prev = _PREEMPT["prev"]
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_IGN:
                return
            else:
                raise SystemExit(128 + int(signum))

        try:
            _PREEMPT["prev"] = signal.signal(signal.SIGTERM, _on_sigterm)
            _PREEMPT["installed"] = True
        except (ValueError, OSError):
            _PREEMPT["prev"] = None


def unregister_preempt(engine) -> None:
    """Drop ``engine``'s registration (``TorchEngine.destroy``)."""
    with _PREEMPT_LOCK:
        _PREEMPT["engines"] = [(weakref.ref(e), d) for e, d in _registered()
                               if e is not engine]


def reset_preempt_handler() -> None:
    """Restore the chained SIGTERM handler and drop the registrations."""
    import signal

    with _PREEMPT_LOCK:
        if _PREEMPT["installed"]:
            try:
                if threading.current_thread() is threading.main_thread():
                    signal.signal(signal.SIGTERM, _PREEMPT["prev"] or signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        _PREEMPT["installed"] = False
        _PREEMPT["prev"] = None
        _PREEMPT["engines"] = []
