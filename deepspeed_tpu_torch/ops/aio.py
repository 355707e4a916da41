"""ctypes bindings for the C++ asynchronous file I/O pool (``csrc/aio/aio.cpp``).

Counterpart of ``deepspeed_tpu/ops/aio.py`` (DeepSpeed's ``aio_handle``): a
pool of worker threads serving pread/pwrite requests, driven through a flat C
API (``dsaio_create/submit/wait/poll/pending/destroy``). The library is built
with g++ at first use into ``build/aio/libdsaio.so`` at the root of the
checkout (rebuilt when the source is newer), never beside the source. Buffers
are contiguous CPU tensors (page-locked where the caller pinned them), passed
by ``data_ptr()``; each is held by the handle until its request is waited.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "aio" / "aio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aio"
LIB_PATH = BUILD_DIR / "libdsaio.so"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``csrc/aio/aio.cpp`` into ``build/aio/libdsaio.so`` unless a
    library newer than the source is there; a failed compile raises with
    g++'s output."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time per checkout
        if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
            return LIB_PATH
        tmp = BUILD_DIR / f"libdsaio.{os.getpid()}.so"
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", str(SOURCE), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"aio build failed ({' '.join(cmd)}):\n{res.stderr}")
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.dsaio_create.restype = ctypes.c_void_p
            lib.dsaio_create.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.dsaio_destroy.argtypes = [ctypes.c_void_p]
            lib.dsaio_submit.restype = ctypes.c_int64
            lib.dsaio_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.dsaio_wait.restype = ctypes.c_int
            lib.dsaio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.dsaio_poll.restype = ctypes.c_int
            lib.dsaio_poll.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.dsaio_pending.restype = ctypes.c_int
            lib.dsaio_pending.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


class AsyncIOHandle:
    """The submit/wait surface of ``aio_handle``: ``submit_write`` and
    ``submit_read`` return a request id at once, ``wait`` blocks on it and
    raises ``OSError`` with the worker's errno."""

    def __init__(self, num_threads: int = 4, use_direct: bool = False):
        self._lib = _lib()
        self._h = self._lib.dsaio_create(int(num_threads), int(use_direct))
        self._inflight: Dict[int, torch.Tensor] = {}

    def _submit(self, path: str, t: torch.Tensor, offset: int, write: bool) -> int:
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError(f"aio buffers are contiguous CPU tensors; got "
                             f"{t.device} contiguous={t.is_contiguous()}")
        req = self._lib.dsaio_submit(self._h, os.fsencode(path), t.data_ptr(),
                                     t.numel() * t.element_size(), int(offset), int(write))
        self._inflight[req] = t
        return req

    def submit_write(self, path: str, tensor: torch.Tensor, offset: int = 0) -> int:
        return self._submit(path, tensor, offset, True)

    def submit_read(self, path: str, tensor: torch.Tensor, offset: int = 0) -> int:
        return self._submit(path, tensor, offset, False)

    def wait(self, req: int) -> None:
        rc = self._lib.dsaio_wait(self._h, req)
        self._inflight.pop(req, None)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc))

    def poll(self, req: int) -> bool:
        return bool(self._lib.dsaio_poll(self._h, req))

    def pending(self) -> int:
        """Requests queued and not yet taken by a worker."""
        return int(self._lib.dsaio_pending(self._h))

    def wait_all(self) -> None:
        for req in list(self._inflight):
            self.wait(req)

    def close(self) -> None:
        if self._h is not None:
            try:
                self.wait_all()
            finally:
                self._lib.dsaio_destroy(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
