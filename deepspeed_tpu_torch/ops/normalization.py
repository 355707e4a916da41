"""Normalization ops: the dispatch between the RMSNorm kernel and the plain
expression.

Counterpart of ``deepspeed_tpu/ops/normalization.py``. Under a
:class:`kernel_rmsnorm_scope` that is on (the inference engine enters one
under kernel injection on a CUDA device), :func:`rmsnorm` goes to the kernel
wrapper, which launches the CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors. Otherwise it is the plain expression, as the JAX
package runs XLA off-kernel.
"""

from __future__ import annotations

import torch

from .cuda.rmsnorm import rmsnorm_fwd, rmsnorm_plain

_scope_stack: list = []


class kernel_rmsnorm_scope:
    """Scoped kernel selection, so two engines with different choices in one
    process do not fight."""

    def __init__(self, flag: bool):
        self.flag = bool(flag)

    def __enter__(self):
        _scope_stack.append(self.flag)
        return self

    def __exit__(self, *exc):
        _scope_stack.pop()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim in fp32, returned in x's dtype."""
    if _scope_stack and _scope_stack[-1]:
        return rmsnorm_fwd(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)
