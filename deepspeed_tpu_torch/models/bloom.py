"""BLOOM family presets (reference benchmark: BLOOM-176B 3D-parallel);
counterpart of ``deepspeed_tpu/models/bloom.py``, the same sizes."""

from .transformer import TransformerConfig, TransformerModel

_BLOOM_SIZES = {
    "bloom-tiny": dict(hidden_size=128, num_layers=2, num_heads=4),
    "bloom-560m": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "bloom-7b1": dict(hidden_size=4096, num_layers=30, num_heads=32),
    "bloom-176b": dict(hidden_size=14336, num_layers=70, num_heads=112),
}


def bloom_config(size: str = "bloom-560m", **overrides) -> TransformerConfig:
    base = dict(
        vocab_size=250880,
        max_seq_len=2048,
        pos_embedding="alibi",
        norm="layernorm",
        activation="gelu",
        use_bias=True,
        tie_embeddings=True,
        embed_norm=True,
        name=size,
    )
    base.update(_BLOOM_SIZES[size])
    base.update(overrides)
    return TransformerConfig(**base)


def bloom(size: str = "bloom-560m", **overrides) -> TransformerModel:
    return TransformerModel(bloom_config(size, **overrides))
