"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

It grows slice by slice beside the JAX package, which stays the reference.
It serves the Llama, Mixtral (MoE at ep = 1), GPT-2 and BLOOM families
through ``init_inference`` → ``InferenceEngine.generate``, Llama and Mixtral
also through the continuous-batching front door ``init_serving`` →
``ServingEngine``, and trains the dense families through ``initialize`` →
``TorchEngine.train_batch`` on one device or a dp × sp world of
``torch.distributed`` ranks (``comm``, sequence parallelism by Ulysses or
ring attention, ``parallel/sequence.py``), with hand-written CUDA kernels
(``ops/cuda``): flash attention forward and backward (with ALiBi, and the
ring hops' offset form), decode
attention over a contiguous cache and over a page pool (with ALiBi), RMSNorm
and LayerNorm forward and backward, the quantized matvec (with its expert
form) and the fused Adam update. ``TorchEngine.save_checkpoint`` /
``load_checkpoint`` and ``init_inference(checkpoint=)`` read and write the JAX
package's checkpoint layout, and ``zero`` assembles a checkpoint's fp32
weights. It imports neither jax nor deepspeed_tpu.
"""

from . import zero  # noqa: F401
from .accelerator import get_accelerator  # noqa: F401
from .models import bloom, gpt2, llama, mixtral  # noqa: F401

__version__ = "0.1.0"


def init_inference(*args, **kwargs):
    """Parity: deepspeed.init_inference."""
    from .inference.engine import init_inference as _init_inference

    return _init_inference(*args, **kwargs)


def init_serving(model=None, serving=None, **kwargs):
    """Continuous-batching serving front door (DeepSpeed-MII / FastGen
    parity): a model and the "serving" config section → a
    :class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` (request queue,
    SplitFuse scheduler, one fixed-shape slot step). Other keyword arguments
    go to ``init_inference`` (``device``, ``dtype``,
    ``replace_with_kernel_inject``, ...), or pass ``engine=``."""
    from .serving.engine import ServingEngine

    return ServingEngine(model=model, serving=serving, **kwargs)


def initialize(*args, **kwargs):
    """Parity: deepspeed.initialize."""
    from .runtime.engine import initialize as _initialize

    return _initialize(*args, **kwargs)
