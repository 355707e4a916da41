"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel
family.

Each module holds the kernels' wrappers, their plain PyTorch versions and a
``launches`` dict counting each kernel's launches; the attention modules also
count their plain versions' calls on CUDA tensors (``plain_on_cuda``), which
a run that should take the kernels keeps at 0. Sources are in
``deepspeed_tpu_torch/csrc``; ``_build`` compiles and loads them on first use.
"""

from . import (decode_attention, flash_attention, fused_adam, layernorm,
               quantized_matmul, rmsnorm)

KERNEL_MODULES = (flash_attention, decode_attention, rmsnorm, layernorm, fused_adam,
                  quantized_matmul)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: n for mod in KERNEL_MODULES for name, n in mod.launches.items()}


def plain_attention_on_cuda() -> dict:
    """Plain attention calls on CUDA tensors since the last reset."""
    return {**decode_attention.plain_on_cuda, **flash_attention.plain_on_cuda}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        for counts in (mod.launches, getattr(mod, "plain_on_cuda", {})):
            for name in counts:
                counts[name] = 0
