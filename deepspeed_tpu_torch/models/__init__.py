"""Model families of the PyTorch/CUDA port (this slice: Llama)."""

from .llama import llama, llama_config  # noqa: F401
from .transformer import TransformerConfig, TransformerModel  # noqa: F401
