"""Mixtral MoE presets; counterpart of ``deepspeed_tpu/models/mixtral.py``."""

from .transformer import TransformerConfig, TransformerModel

_MIXTRAL_SIZES = {
    "mixtral-tiny": dict(
        hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        intermediate_size=256, num_experts=4, moe_top_k=2,
    ),
    "mixtral-8x7b": dict(
        hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8,
        intermediate_size=14336, num_experts=8, moe_top_k=2,
    ),
    "mixtral-8x22b": dict(
        hidden_size=6144, num_layers=56, num_heads=48, num_kv_heads=8,
        intermediate_size=16384, num_experts=8, moe_top_k=2,
    ),
}


def mixtral_config(size: str = "mixtral-8x7b", **overrides) -> TransformerConfig:
    base = dict(
        vocab_size=32000,
        max_seq_len=8192,
        pos_embedding="rope",
        rope_theta=1000000.0,
        norm="rmsnorm",
        activation="swiglu",
        use_bias=False,
        tie_embeddings=False,
        name=size,
    )
    base.update(_MIXTRAL_SIZES[size])
    base.update(overrides)
    return TransformerConfig(**base)


def mixtral(size: str = "mixtral-8x7b", **overrides) -> TransformerModel:
    return TransformerModel(mixtral_config(size, **overrides))
