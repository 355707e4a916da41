"""Llama family presets; counterpart of ``deepspeed_tpu/models/llama.py``."""

from .transformer import TransformerConfig, TransformerModel

_LLAMA_SIZES = {
    "llama-tiny": dict(
        hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=352
    ),
    "llama3-1b": dict(
        hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8, intermediate_size=8192
    ),
    "llama3-8b": dict(
        hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8, intermediate_size=14336
    ),
    "llama3-70b": dict(
        hidden_size=8192, num_layers=80, num_heads=64, num_kv_heads=8, intermediate_size=28672
    ),
}


def llama_config(size: str = "llama3-8b", **overrides) -> TransformerConfig:
    base = dict(
        vocab_size=128256,
        max_seq_len=8192,
        pos_embedding="rope",
        rope_theta=500000.0,
        norm="rmsnorm",
        activation="swiglu",
        use_bias=False,
        tie_embeddings=False,
        name=size,
    )
    base.update(_LLAMA_SIZES[size])
    base.update(overrides)
    return TransformerConfig(**base)


def llama(size: str = "llama3-8b", **overrides) -> TransformerModel:
    return TransformerModel(llama_config(size, **overrides))
