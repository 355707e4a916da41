"""Accelerator abstraction: the ``get_accelerator()`` user surface.

Counterpart of ``deepspeed_tpu/accelerator.py`` (``TpuAccelerator``), and of
DeepSpeed's ``get_accelerator()``: device name and count, memory stats,
synchronisation and seeding, answered from ``torch.cuda``. Process-local
queries only; safe before any process group exists.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch


class CudaAccelerator:
    """Process-local accelerator facade over ``torch.cuda``."""

    # -------------------------------------------------------------- identity
    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_count(self) -> int:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def current_device_name(self) -> str:
        return self.device_name(self.current_device())

    def communication_backend_name(self) -> str:
        return "nccl"

    def on_accelerator(self, tensor) -> bool:
        return isinstance(tensor, torch.Tensor) and tensor.is_cuda

    # ---------------------------------------------------------------- memory
    def memory_allocated(self, device_index: int = 0) -> int:
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index: int = 0) -> int:
        return torch.cuda.max_memory_allocated(device_index)

    def total_memory(self, device_index: int = 0) -> int:
        return torch.cuda.get_device_properties(device_index).total_memory

    def available_memory(self, device_index: int = 0) -> int:
        free, _total = torch.cuda.mem_get_info(device_index)
        return int(free)

    def empty_cache(self) -> None:
        torch.cuda.empty_cache()

    def synchronize(self, device_index: Optional[int] = None) -> None:
        """Block until all work queued on the device has finished."""
        torch.cuda.synchronize(device_index)

    # ------------------------------------------------------------------- rng
    def manual_seed(self, seed: int, device_index: int = 0) -> torch.Generator:
        """A generator on the device seeded with ``seed`` (explicit state:
        the process's default generators are left alone)."""
        return torch.Generator(device=f"cuda:{device_index}").manual_seed(int(seed))

    # ----------------------------------------------------------------- dtype
    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()

    def is_fp16_supported(self) -> bool:
        return torch.cuda.is_available()


def resolve_device(device, caller: str) -> torch.device:
    """The device an entry point runs on: the current CUDA device by
    default; with no CUDA device only an explicit ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{caller}: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: {device} requested, no CUDA device")
    return device


_ACCEL: Optional[CudaAccelerator] = None
_LOCK = threading.Lock()


def get_accelerator() -> CudaAccelerator:
    global _ACCEL
    with _LOCK:
        if _ACCEL is None:
            _ACCEL = CudaAccelerator()
    return _ACCEL
