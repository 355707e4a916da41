"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

It grows slice by slice beside the JAX package, which stays the reference.
This slice serves the Llama family through ``init_inference`` →
``InferenceEngine.generate``, with hand-written CUDA kernels for flash
prefill attention, decode attention and RMSNorm (``ops/cuda``). It imports
neither jax nor deepspeed_tpu.
"""

from .accelerator import get_accelerator  # noqa: F401

__version__ = "0.1.0"


def init_inference(*args, **kwargs):
    """Parity: deepspeed.init_inference."""
    from .inference.engine import init_inference as _init_inference

    return _init_inference(*args, **kwargs)
