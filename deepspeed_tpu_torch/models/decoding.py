"""KV-cache decoding forward passes for the transformer core.

Counterpart of ``deepspeed_tpu/models/decoding.py``, for the contiguous cache.
The cache is a static buffer ``{"k", "v"}`` of [L, B, Smax, KV, hd] tensors.
Where the JAX package donates the cache and gets a new one back, the port
updates it IN PLACE: every call of :func:`forward_with_cache` writes the new
tokens' K/V into the tensors it was given and returns the same dict.

The int8 cache (``init_cache(quantized=True)``) stores K/V as int8 with one
fp32 absmax scale per (token, kv head), ``"k_scale"``/``"v_scale"`` of
[L, B, KV, Smax]. The JAX package keeps ``SCALE_LANES = 8`` copies of each
scale to fill the TPU's minimum sublane tile; the port keeps one: at hd = 128
the eight copies would add 25 % to the bytes a decode step reads from the
int8 cache, one copy adds 3 %. Column 0 of the JAX scales is the port's.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.attention import attention, resolve_attention_impl
from ..ops.cuda.decode_attention import cached_attention_plain, decode_attention
from ..ops.cuda.quantized_matmul import packed_proj
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
    """Zeroed KV buffer for all layers, {"k", "v"}: [L, B, max_len, KV, hd];
    ``quantized`` stores int8 K/V with fp32 scales {"k_scale", "v_scale"}
    of [L, B, KV, max_len] (one per token and kv head)."""
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    if quantized:
        sshape = (cfg.num_layers, batch, cfg.kv_heads, max_len)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _quantize_kv(t: torch.Tensor):
    """[B,S,KV,hd] → (int8 values [B,S,KV,hd], fp32 scales [B,S,KV]):
    absmax / 127 over hd with a 1e-8 floor, values clipped to ±127."""
    tf = t.float()
    s = (tf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(tf / s).clamp(-127, 127).to(torch.int8)
    return q, s[..., 0]


def _positions(cache_len, B: int, S: int, device) -> torch.Tensor:
    """[B, S] cache positions of S new tokens written at ``cache_len``."""
    base = cache_len.to(device).long()[:, None] if _is_ragged(cache_len) \
        else torch.full((B, 1), int(cache_len), device=device, dtype=torch.long)
    return base + torch.arange(S, device=device)[None, :]


def _update_at(cache: torch.Tensor, new: torch.Tensor, cache_len) -> None:
    """Write ``new`` [B, S, KV, hd] into ``cache`` [B, Smax, KV, hd] in place
    at offset ``cache_len``: an int for every row, or a per-row [B] tensor."""
    S = new.shape[1]
    if _is_ragged(cache_len):
        rows = torch.arange(new.shape[0], device=cache.device)[:, None]
        cache[rows, _positions(cache_len, new.shape[0], S, cache.device)] = \
            new.to(cache.dtype)
    else:
        cache[:, cache_len:cache_len + S] = new


def _update_scale_at(scale: torch.Tensor, new: torch.Tensor, cache_len) -> None:
    """Scale twin of :func:`_update_at`: ``new`` [B, S, KV] goes into
    ``scale`` [B, KV, Smax] in place."""
    S = new.shape[1]
    if _is_ragged(cache_len):
        rows = torch.arange(new.shape[0], device=scale.device)[:, None]
        pos = _positions(cache_len, new.shape[0], S, scale.device)
        scale.transpose(1, 2)[rows, pos] = new
    else:
        scale[:, :, cache_len:cache_len + S] = new.transpose(1, 2)


def _decode_rows(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len, k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode attention for q [B,S,H,hd]: one token a row, or one sequence's
    window of S tokens (a speculative verify) as S single-token rows over the
    same cache layer (batch stride 0), row s seeing positions up to
    ``cache_len + s``. Each window row is then the decode kernel's own
    computation at its position, so a verify window gives the bits that
    single-token decode gives."""
    S = q.shape[1]
    if S == 1:
        return decode_attention(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    lens = _positions(cache_len, 1, S, q.device)[0]

    def rows(t):
        return None if t is None else t.expand(S, *t.shape[1:])

    out = decode_attention(q.transpose(0, 1), rows(k_cache), rows(v_cache), lens,
                           rows(k_scale), rows(v_scale))
    return out.transpose(0, 1)


def _cached_attention(cfg: TransformerConfig, p: Params, x: torch.Tensor, rope,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len, k_scale=None, v_scale=None) -> torch.Tensor:
    """Attend the new tokens x [B,S,D] against cache[:cache_len] and
    themselves; writes their K/V into the cache layer first (int8 with its
    scales when ``k_scale`` is given).

    A fresh prefill (``cache_len == 0``, S > 1) attends among the new tokens,
    with their exact K/V, through the registered attention (the flash kernel
    on CUDA); only reads from the cache dequantize. When the registered
    attention is flash, a single token, and a window of one sequence, take
    the decode kernel (:func:`_decode_rows`). Everything else is the plain
    masked attention over the cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, rope)
    if k_scale is not None:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        _update_at(k_cache, kq, cache_len)
        _update_at(v_cache, vq, cache_len)
        _update_scale_at(k_scale, ks, cache_len)
        _update_scale_at(v_scale, vs, cache_len)
    else:
        _update_at(k_cache, k, cache_len)
        _update_at(v_cache, v, cache_len)
    if isinstance(cache_len, int) and cache_len == 0 and S > 1:
        out = attention(q, k, v, causal=True)
    elif (S == 1 or B == 1) and resolve_attention_impl(q.device) == "flash":
        out = _decode_rows(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    else:
        out = cached_attention_plain(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    return packed_proj(out.reshape(B, S, cfg.num_heads * cfg.hd), p["wo"])


def forward_with_cache(cfg: TransformerConfig, params: Params,
                       input_ids: torch.Tensor, cache: Cache, cache_len):
    """Run new tokens [B, S] through all layers against the cache.

    ``cache_len`` is the number of tokens already cached: an int shared by
    every row, or a per-row [B] tensor. Returns (fp32 logits [B, S, V],
    cache); the cache is the argument itself, updated in place.

    A window of S > 1 tokens against a filled cache (a speculative verify)
    runs the head one token at a time: a library GEMM picks its kernel by
    the row count, and one row gives each token the logits single-token
    decode gives."""
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
    quantized = "k_scale" in cache
    for i in range(cfg.num_layers):
        lp = layer_params(layers, i)
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if quantized else ()
        x = x + _cached_attention(
            cfg, lp["attn"], _norm(cfg, lp["ln1"], x), rope,
            cache["k"][i], cache["v"][i], cache_len, *scales,
        )
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, params["final_norm"], x)
    if S > 1 and not (isinstance(cache_len, int) and cache_len == 0):
        return torch.cat([lm_head_logits(cfg, params, x[:, s:s + 1])
                          for s in range(S)], dim=1), cache
    return lm_head_logits(cfg, params, x), cache
