"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel
family.

Each module holds the kernels' wrappers, their plain PyTorch versions and a
``launches`` dict counting each kernel's launches. Sources are in
``deepspeed_tpu_torch/csrc``; ``_build`` compiles and loads them on first use.
"""

from . import decode_attention, flash_attention, fused_adam, quantized_matmul, rmsnorm

KERNEL_MODULES = (flash_attention, decode_attention, rmsnorm, fused_adam,
                  quantized_matmul)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: n for mod in KERNEL_MODULES for name, n in mod.launches.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        for name in mod.launches:
            mod.launches[name] = 0
