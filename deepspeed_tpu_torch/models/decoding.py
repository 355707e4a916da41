"""KV-cache decoding forward passes for the transformer core.

Counterpart of ``deepspeed_tpu/models/decoding.py``. Two cache forms:

- the contiguous cache ``{"k", "v"}`` of [L, B, Smax, KV, hd] tensors
  (:func:`init_cache`): the lockstep engine's batch, and the serving engine's
  slots;
- the block-paged pool (:func:`init_paged_cache`) of [L, P+1, page_size, KV,
  hd] tensors shared by every slot through per-slot page tables; physical
  page P is the NULL page, where unmapped logical pages point and padded
  writes land, never attended.

Where the JAX package donates the cache and gets a new one back, the port
updates it IN PLACE: every call of :func:`forward_with_cache` writes the new
tokens' K/V into the tensors it was given and returns the same dict.

The int8 cache (``quantized=True``) stores K/V as int8 with one fp32 absmax
scale per (token, kv head): ``"k_scale"``/``"v_scale"`` of [L, B, KV, Smax]
contiguous, [L, P+1, KV, page_size] paged. The JAX package keeps
``SCALE_LANES = 8`` copies of each scale to fill the TPU's minimum sublane
tile; the port keeps one: at hd = 128 the eight copies would add 25 % to the
bytes a decode step reads from the int8 cache, one copy adds 3 %. Column 0
of the JAX scales is the port's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..moe.sharded_moe import moe_serving_mlp
from ..ops.attention import attention, resolve_attention_impl
from ..ops.cuda.decode_attention import (cached_attention_plain, decode_attention,
                                         decode_attention_plain,
                                         paged_decode_attention,
                                         paged_decode_attention_plain)
from .transformer import (Params, TransformerConfig, _mlp, _norm, _qkv,
                          check_supported, embed_tokens, layer_params,
                          lm_head_logits, model_slopes, out_proj, rope_tables)

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


def init_paged_cache(cfg: TransformerConfig, num_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16, device=None,
                     quantized: bool = False) -> Cache:
    """Zeroed block-paged KV pool for all layers: {"k", "v"} of
    [L, num_pages + 1, page_size, KV, hd]; page ``num_pages`` is the NULL
    page. ``quantized`` stores int8 K/V with fp32 scales of
    [L, num_pages + 1, KV, page_size]."""
    P1 = int(num_pages) + 1
    shape = (cfg.num_layers, P1, page_size, cfg.kv_heads, cfg.hd)
    if quantized:
        sshape = (cfg.num_layers, P1, cfg.kv_heads, page_size)
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


def _page_indices(cache_len: torch.Tensor, S: int, page_table: torch.Tensor,
                  page_size: int):
    """Per-token physical destination of a [B, S] chunk written at the
    per-row frontier: (physical page [B, S], offset in the page [B, S])."""
    mp = page_table.shape[1]
    pos = _positions(cache_len, page_table.shape[0], S, page_table.device)
    pageidx = (pos // page_size).clamp(0, mp - 1)
    return page_table.long().gather(1, pageidx), pos % page_size


def _paged_write(pool: torch.Tensor, new: torch.Tensor, cache_len,
                 page_table: torch.Tensor) -> None:
    """Scatter a chunk's new K/V [B, S, KV, hd] into the page pool
    [P+1, page_size, KV, hd] in place through the per-slot page tables.
    Tokens past a slot's mapped pages (padding) land on the NULL page the
    tables point unmapped entries at, several onto one row: which write
    wins there is unspecified and harmless, since no frontier reaches the
    NULL page."""
    phys, off = _page_indices(cache_len, new.shape[1], page_table, pool.shape[1])
    pool[phys, off] = new.to(pool.dtype)


def _paged_write_scale(pool: torch.Tensor, new: torch.Tensor, cache_len,
                       page_table: torch.Tensor) -> None:
    """Scale twin of :func:`_paged_write`: pool [P+1, KV, ps], new chunk
    scales [B, S, KV]."""
    phys, off = _page_indices(cache_len, new.shape[1], page_table, pool.shape[2])
    kv = torch.arange(pool.shape[1], device=pool.device)
    pool[phys[:, :, None], kv[None, None, :], off[:, :, None]] = new


def paged_cow_copy(cache: Cache, page_table: torch.Tensor, start_pos: torch.Tensor,
                   cow_src: torch.Tensor) -> Cache:
    """Copy-on-write, in place: slots whose ``cow_src`` is a physical page
    (>= 0) copy that page's KV, all layers and scales, onto their frontier
    page before the chunk write, so a slot diverging from a shared prefix
    mid-page keeps the shared tokens without writing the shared page. Every
    source page is read (one gather into a copy) before any destination is
    written: a page freed by one slot's divergence and handed to another in
    the same step still gives its old bytes. Rows with ``cow_src == -1``
    copy their frontier page onto itself (idle rows: the NULL page)."""
    ps = cache["k"].shape[2]
    N, mp = page_table.shape
    rows = torch.arange(N, device=page_table.device)
    pt = page_table.long()
    dst = pt[rows, (start_pos.long() // ps).clamp(0, mp - 1)]
    src = torch.where(cow_src >= 0, cow_src.long(), dst)
    for pool in cache.values():
        pool[:, dst] = pool[:, src]
    return cache


def verify_window_rows(num_new: torch.Tensor, spec_len: torch.Tensor,
                       max_draft: int, W: int) -> torch.Tensor:
    """[B, max_draft + 1] positions of each row's verify window in a ragged
    [B, W] chunk: its last ``spec_len + 1`` real positions (the
    committed-token feed and its drafts), left-aligned; positions past a
    row's ``spec_len`` are clipped and masked by the caller."""
    base = (num_new - 1 - spec_len).long()
    return (base[:, None] + torch.arange(max_draft + 1, device=base.device)[None, :]
            ).clamp(0, W - 1)


def _window_rows(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len, token_valid, page_table, k_scale, v_scale,
                 kernel: bool, slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The window of S tokens of each of B sequences as B*S single-token
    rows, row (b, s) at frontier ``cache_len[b] + s`` (-1 where
    ``token_valid`` is False: a padded row, zeros) through the decode kernel
    with ``rows_per_seq = S``, over the contiguous cache or, with
    ``page_table``, the page pool. ``kernel`` False takes the plain twin.
    Each row's result depends on its own q, frontier and sequence alone
    (the kernel's tile schedule is fixed over absolute key positions), so a
    speculative verify window (B = 1) gives the bits single-token decode
    gives, and S = 1 is single-token decode. ``slopes``: ALiBi's,
    measured from each row's frontier."""
    B, S, H, hd = q.shape
    frontier = _positions(cache_len, B, S, q.device)
    if token_valid is not None:
        frontier = torch.where(token_valid.to(q.device), frontier, -1)
    rows, frontier = q.reshape(B * S, 1, H, hd), frontier.reshape(-1)
    if page_table is not None:
        fn = paged_decode_attention if kernel else paged_decode_attention_plain
        out = fn(rows, k_cache, v_cache, frontier, page_table, k_scale, v_scale,
                 rows_per_seq=S, slopes=slopes)
    else:
        fn = decode_attention if kernel else decode_attention_plain
        out = fn(rows, k_cache, v_cache, frontier, k_scale, v_scale, rows_per_seq=S,
                 slopes=slopes)
    return out.reshape(B, S, H, hd)


def _cached_attention(cfg: TransformerConfig, p: Params, x: torch.Tensor, rope,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len, k_scale=None, v_scale=None, page_table=None,
                      token_valid=None, slopes=None) -> torch.Tensor:
    """Attend the new tokens x [B,S,D] against cache[:cache_len] and
    themselves; writes their K/V into the cache layer first (int8 with its
    scales when ``k_scale`` is given), into the page pool through the page
    tables when ``page_table`` [B, mp] is given.

    A fresh prefill (``cache_len == 0``, S > 1, contiguous) attends among the
    new tokens, with their exact K/V, through the registered attention (the
    flash kernel on CUDA); only reads from the cache dequantize. When the
    registered attention is flash, every other call takes the decode kernels
    with ``rows_per_seq`` (:func:`_window_rows`); so does a paged pool or a
    serving chunk (``token_valid`` given) under the plain attention, through
    the kernels' plain twins. Everything else is the plain masked attention
    over the cache. ALiBi ``slopes`` go into every branch: the decode kernels
    take them too, so an ALiBi step on the card never leaves the kernels."""
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x, rope)
    def write(cache, new, scale=False):
        if page_table is not None:
            (_paged_write_scale if scale else _paged_write)(cache, new, cache_len,
                                                            page_table)
        else:
            (_update_scale_at if scale else _update_at)(cache, new, cache_len)

    if k_scale is not None:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        write(k_cache, kq)
        write(v_cache, vq)
        write(k_scale, ks, scale=True)
        write(v_scale, vs, scale=True)
    else:
        write(k_cache, k)
        write(v_cache, v)
    flash = resolve_attention_impl(q.device) == "flash"
    window = page_table is not None or token_valid is not None
    if not window and isinstance(cache_len, int) and cache_len == 0 and S > 1:
        out = attention(q, k, v, causal=True, alibi_slopes=slopes)
    elif window or flash:
        out = _window_rows(q, k_cache, v_cache, cache_len, token_valid, page_table,
                           k_scale, v_scale, kernel=flash, slopes=slopes)
    else:
        out = cached_attention_plain(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                                     slopes)
    return out_proj(cfg, p, out)


def forward_with_cache(cfg: TransformerConfig, params: Params,
                       input_ids: torch.Tensor, cache: Cache, cache_len, *,
                       page_table: Optional[torch.Tensor] = None,
                       token_valid: Optional[torch.Tensor] = None,
                       head_rows: Optional[torch.Tensor] = None,
                       return_moe_stats: bool = False):
    """Run new tokens [B, S] through all layers against the cache.

    ``cache_len`` is the number of tokens already cached: an int shared by
    every row, or a per-row [B] tensor. Returns (fp32 logits [B, S, V],
    cache); the cache is the argument itself, updated in place.

    The serving engine's step adds ``page_table`` [B, mp] (the cache is then
    a page pool from :func:`init_paged_cache`), ``token_valid`` [B, S] (the
    real tokens of each slot's chunk; padded rows attend nothing) and
    ``head_rows`` [B, K] (the positions whose logits it reads: the head runs
    on those rows only and the logits are [B, K, V]).

    A window of S > 1 tokens against a filled cache (a speculative verify)
    runs the head one token at a time: a library GEMM picks its kernel by
    the row count, and one row gives each token the logits single-token
    decode gives.

    An MoE model's MLP is the routed serving MLP (``moe_serving_mlp``, JAX
    ``models/decoding.py:498-566``): capacity from ``S`` under
    ``token_valid`` (the slot engine's token budget), else from ``B·S`` (the
    lockstep engine, whose padding counts as tokens), padded rows routed to no
    expert. ``return_moe_stats`` adds a third value: {"tokens_per_expert"
    [E] summed over the layers, "drop_fraction" averaged over them}, device
    tensors (None for a dense model)."""
    check_supported(cfg)
    B, S = input_ids.shape
    device = input_ids.device
    if _is_ragged(cache_len):
        positions = cache_len.to(device=device, dtype=torch.int32)[:, None] \
            + torch.arange(S, dtype=torch.int32, device=device)[None, :]
    else:
        positions = (cache_len + torch.arange(S, dtype=torch.int32,
                                              device=device)).expand(B, S)
    rope = (rope_tables(positions, cfg.hd, cfg.rope_theta)
            if cfg.pos_embedding == "rope" else None)
    slopes = model_slopes(cfg, device)
    x = embed_tokens(cfg, params, input_ids, positions)
    layers = params["layers"]
    quantized = "k_scale" in cache
    budget = S if token_valid is not None else B * S
    moe_stats = []
    for i in range(cfg.num_layers):
        lp = layer_params(layers, i)
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if quantized else ()
        x = x + _cached_attention(
            cfg, lp["attn"], _norm(cfg, lp["ln1"], x), rope,
            cache["k"][i], cache["v"][i], cache_len, *scales,
            page_table=page_table, token_valid=token_valid, slopes=slopes,
        )
        normed = _norm(cfg, lp["ln2"], x)
        if cfg.is_moe:
            m, stats = moe_serving_mlp(cfg, lp["mlp"], normed, token_valid=token_valid,
                                       budget_tokens=budget)
            moe_stats.append(stats)
            x = x + m
        else:
            x = x + _mlp(cfg, lp["mlp"], normed)
    if head_rows is not None:
        idx = head_rows.to(device).long()[:, :, None].expand(-1, -1, x.shape[-1])
        logits = lm_head_logits(cfg, params, _norm(cfg, params["final_norm"],
                                                   x.gather(1, idx)))
    else:
        x = _norm(cfg, params["final_norm"], x)
        if S > 1 and not (isinstance(cache_len, int) and cache_len == 0):
            logits = torch.cat([lm_head_logits(cfg, params, x[:, s:s + 1])
                                for s in range(S)], dim=1)
        else:
            logits = lm_head_logits(cfg, params, x)
    if not return_moe_stats:
        return logits, cache
    stats = None
    if moe_stats:
        stats = {"tokens_per_expert": torch.stack(
                     [st["tokens_per_expert"] for st in moe_stats]).sum(dim=0),
                 "drop_fraction": torch.stack(
                     [st["drop_fraction"] for st in moe_stats]).mean()}
    return logits, cache, stats
