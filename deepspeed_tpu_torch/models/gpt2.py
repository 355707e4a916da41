"""GPT-2 family presets (reference benchmark: GPT-2 125M ZeRO-1 smoke);
counterpart of ``deepspeed_tpu/models/gpt2.py``, the same sizes."""

from .transformer import TransformerConfig, TransformerModel

_GPT2_SIZES = {
    "gpt2-tiny": dict(hidden_size=128, num_layers=2, num_heads=4),  # unit tests
    "gpt2": dict(hidden_size=768, num_layers=12, num_heads=12),  # 125M
    "gpt2-medium": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": dict(hidden_size=1280, num_layers=36, num_heads=20),
    "gpt2-xl": dict(hidden_size=1600, num_layers=48, num_heads=25),
}


def gpt2_config(size: str = "gpt2", **overrides) -> TransformerConfig:
    base = dict(
        vocab_size=50257,
        max_seq_len=1024,
        pos_embedding="learned",
        norm="layernorm",
        activation="gelu_new",
        use_bias=True,
        tie_embeddings=True,
        name=size,
    )
    base.update(_GPT2_SIZES[size])
    base.update(overrides)
    return TransformerConfig(**base)


def gpt2(size: str = "gpt2", **overrides) -> TransformerModel:
    return TransformerModel(gpt2_config(size, **overrides))
