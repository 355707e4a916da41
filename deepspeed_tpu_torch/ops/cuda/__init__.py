"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter. Sources are in ``deepspeed_tpu_torch/csrc``; ``_build``
compiles and loads them on first use.
"""

from . import decode_attention, flash_attention, rmsnorm

KERNEL_MODULES = {
    "flash_attention_fwd": flash_attention,
    "decode_attention": decode_attention,
    "rmsnorm_fwd": rmsnorm,
}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
