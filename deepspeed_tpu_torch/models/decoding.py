"""KV-cache decoding forward passes for the transformer core.

Counterpart of ``deepspeed_tpu/models/decoding.py``, for the contiguous,
unquantized cache. The cache is a static buffer ``{"k", "v"}`` of
[L, B, Smax, KV, hd] tensors. Where the JAX package donates the cache and gets
a new one back, the port updates it IN PLACE: every call of
:func:`forward_with_cache` writes the new tokens' K/V into the tensors it was
given and returns the same dict.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.attention import attention, resolve_attention_impl
from ..ops.cuda.decode_attention import cached_attention_plain, decode_attention
from .transformer import (Params, TransformerConfig, _mlp, _norm, _qkv,
                          check_supported, layer_params, lm_head_logits,
                          rope_tables)

Cache = Dict[str, torch.Tensor]


def _is_ragged(cache_len) -> bool:
    """True when ``cache_len`` is a per-row [B] tensor, False for a shared
    scalar."""
    return isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               quantized: bool = False) -> Cache:
    """Zeroed KV buffer for all layers, {"k", "v"}: [L, B, max_len, KV, hd]."""
    if quantized:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (port slice 3)"
        )
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _update_at(cache: torch.Tensor, new: torch.Tensor, cache_len) -> None:
    """Write ``new`` [B, S, KV, hd] into ``cache`` [B, Smax, KV, hd] in place
    at offset ``cache_len``: an int for every row, or a per-row [B] tensor."""
    S = new.shape[1]
    if _is_ragged(cache_len):
        rows = torch.arange(new.shape[0], device=cache.device)[:, None]
        pos = cache_len.to(cache.device).long()[:, None] \
            + torch.arange(S, device=cache.device)[None, :]
        cache[rows, pos] = new.to(cache.dtype)
    else:
        cache[:, cache_len:cache_len + S] = new


def _cached_attention(cfg: TransformerConfig, p: Params, x: torch.Tensor, rope,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len) -> torch.Tensor:
    """Attend the new tokens x [B,S,D] against cache[:cache_len] and
    themselves; writes their K/V into the cache layer first.

    A fresh prefill (``cache_len == 0``, S > 1) attends among the new tokens
    through the registered attention (the flash kernel on CUDA). A single
    token takes the decode kernel when the registered attention is flash.
    Everything else is the plain masked attention over the cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, rope)
    _update_at(k_cache, k, cache_len)
    _update_at(v_cache, v, cache_len)
    if isinstance(cache_len, int) and cache_len == 0 and S > 1:
        out = attention(q, k, v, causal=True)
    elif S == 1 and resolve_attention_impl(q.device) == "flash":
        out = decode_attention(q, k_cache, v_cache, cache_len)
    else:
        out = cached_attention_plain(q, k_cache, v_cache, cache_len)
    return out.reshape(B, S, cfg.num_heads * cfg.hd) @ p["wo"]


def forward_with_cache(cfg: TransformerConfig, params: Params,
                       input_ids: torch.Tensor, cache: Cache, cache_len):
    """Run new tokens [B, S] through all layers against the cache.

    ``cache_len`` is the number of tokens already cached: an int shared by
    every row, or a per-row [B] tensor. Returns (fp32 logits [B, S, V],
    cache); the cache is the argument itself, updated in place."""
    check_supported(cfg)
    B, S = input_ids.shape
    device = input_ids.device
    if _is_ragged(cache_len):
        positions = cache_len.to(device=device, dtype=torch.int32)[:, None] \
            + torch.arange(S, dtype=torch.int32, device=device)[None, :]
    else:
        positions = (cache_len + torch.arange(S, dtype=torch.int32,
                                              device=device)).expand(B, S)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    x = params["embed"]["tok"][input_ids]
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = layer_params(layers, i)
        x = x + _cached_attention(
            cfg, lp["attn"], _norm(cfg, lp["ln1"], x), rope,
            cache["k"][i], cache["v"][i], cache_len,
        )
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, params["final_norm"], x)
    return lm_head_logits(cfg, params, x), cache
