"""Model families of the PyTorch/CUDA port: Llama, Mixtral, GPT-2 and BLOOM."""

from .bloom import bloom, bloom_config  # noqa: F401
from .gpt2 import gpt2, gpt2_config  # noqa: F401
from .llama import llama, llama_config  # noqa: F401
from .mixtral import mixtral, mixtral_config  # noqa: F401
from .transformer import TransformerConfig, TransformerModel  # noqa: F401
