"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

It grows slice by slice beside the JAX package, which stays the reference.
It serves the Llama family through ``init_inference`` →
``InferenceEngine.generate`` and trains it on one device through
``initialize`` → ``TorchEngine.train_batch``, with hand-written CUDA kernels
(``ops/cuda``): flash attention forward and backward, decode attention,
RMSNorm forward and backward, and the fused Adam update. It imports neither
jax nor deepspeed_tpu.
"""

from .accelerator import get_accelerator  # noqa: F401

__version__ = "0.1.0"


def init_inference(*args, **kwargs):
    """Parity: deepspeed.init_inference."""
    from .inference.engine import init_inference as _init_inference

    return _init_inference(*args, **kwargs)


def initialize(*args, **kwargs):
    """Parity: deepspeed.initialize."""
    from .runtime.engine import initialize as _initialize

    return _initialize(*args, **kwargs)
