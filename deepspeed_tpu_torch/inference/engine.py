"""Inference engine: ``init_inference`` → ``InferenceEngine.generate`` on one
CUDA device (or the CPU, when asked).

Counterpart of ``deepspeed_tpu/inference/engine.py``. One prefill of the
bucketed prompt fills a static KV cache, then a Python token loop (where JAX
has one compiled ``lax.while_loop``) runs one cached forward per token, with
greedy or top-k / top-p / temperature sampling, an optional repetition
penalty, eos forcing, and a stop once every row is done. The cache is updated
in place (models/decoding.py).

``replace_with_kernel_inject=True`` on a CUDA device selects the hand-written
kernels: flash prefill attention, decode attention and RMSNorm or LayerNorm
(``ops/cuda``). Attention resolves to the kernels on CUDA whatever the flag,
as the JAX package resolves flash on a TPU; the flag adds the norm kernels.
The GPT-2 and BLOOM families (LayerNorm, learned positions or ALiBi, GELU,
biases, a tied head) serve in bf16 or fp32; their quantized weights, int8 KV
cache and speculative decode are not ported yet and raise
``NotImplementedError`` naming ROADMAP queue A item 2.

``dtype="int8"|"int4"`` (or ``quantize_bits``) serves weight-only quantized
projections: bf16 compute, the six big projection leaves of every layer
packed (``ops/quantizer.py``) and streamed by the quantized matvec for up to
``matvec_max_rows`` rows (``ops/cuda/quantized_matmul.py``).
``kv_cache_dtype="int8"`` stores the KV cache in int8 with one fp32 scale per
(token, kv head). A Mixtral (MoE) model serves at ep = 1: its expert banks
[L, E, d, f] pack too, and each cached forward routes through
``moe.sharded_moe.moe_serving_mlp``, whose decode steps stream the banks
through the expert form of the matvec; the lockstep engine's capacity counts
the prompt bucket's padding as tokens, as the JAX engine does. A
``draft_model`` (a model, or ``"ngram"`` for prompt-lookup drafting) makes
greedy B = 1 generation speculative: the draft
proposes ``num_draft_tokens`` tokens, the main model verifies the window in
one forward, and the tokens are those of plain greedy decoding (for an MoE
model only where no verify window can drop a token: ``max(capacity_factor,
2) · top_k >= num_experts``, which Mixtral-8x7B's 8 experts do not meet).

Numbers that differ from the JAX engine by design: sampled tokens (a seeded
``torch.Generator`` replaces threefry keys; greedy tokens are the same), and
bf16 logits, which the head rounds to bf16 before the fp32 cast. With an eos
id the loop reads ``done.all()`` on the host once per token; the speculative
loop reads its advance on the host once per round.
"""

from __future__ import annotations

import time
from contextlib import ExitStack
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..models.decoding import forward_with_cache, init_cache
from ..models.transformer import (apply, check_supported, init_leaf,
                                  non_llama_features, param_specs)
from ..ops.attention import attention_impl
from ..ops.cuda.quantized_matmul import matvec_max_rows_scope
from ..ops.normalization import kernel_rmsnorm_scope
from ..ops.quantizer import PackedWeight, cast_floating, pack_quantize_blockwise
from ..serving.spec import (clamp_advance_at_eos, longest_accepted_prefix,
                            ngram_propose)
from ..utils.logging import log_dist
from ..utils.tree import tree_map, tree_size

NEG_INF = -1e30
# the projection leaves weight-only quantization packs
QUANTIZED_LEAVES = ("wq", "wk", "wv", "wo", "wi", "wg")

def _align_cache(n: int, mult: int = 128) -> int:
    """KV-cache capacity rounded up to a multiple of 128 (the JAX engine's
    cache granule; kept so shapes match across the two packages)."""
    return max(-(-n // mult) * mult, mult)


def _bucket_prompt(n: int, mult: int = 32) -> int:
    """Prompt-width bucket: the prefill runs the prompt padded to 32s."""
    return _align_cache(n, mult)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float,
                             active: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """HF-convention repetition penalty: for tokens in ``seen`` [B, V],
    positive logits divide by the penalty, negative multiply. ``active``
    ([B] bool) leaves the rows of finished sequences untouched. ``logits``
    may also be a [B, S, V] verify window (the serving step): the one
    [B, V] ``seen`` matrix then applies to every window position."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    mask = seen if logits.ndim == 2 else seen[:, None, :]
    if active is not None:
        mask = mask & active.reshape((-1,) + (1,) * (logits.ndim - 1))
    return torch.where(mask, penalized, logits)


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """Greedy when temperature is 0, else top-k / top-p filtered sampling.

    The filters keep every maximal logit, so the greedy token is the argmax
    of the scaled logits without them."""
    logits = logits / max(temperature, 1e-6)
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        # nucleus: keep the smallest prefix of the sorted distribution whose
        # mass reaches top_p (the top-1 token always survives)
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[:, 0] = True
        kth = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < kth, NEG_INF, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def init_inference(
    model,
    tensor_parallel: Optional[Dict[str, Any]] = None,
    tp_size: int = 1,
    ep_size: int = 1,
    dtype=torch.bfloat16,
    replace_with_kernel_inject: bool = False,
    quantize_bits: Optional[int] = None,
    max_tokens: int = 1024,
    kv_cache_dtype: str = "auto",
    draft_model=None,
    draft_params=None,
    checkpoint=None,
    params=None,
    rng: Optional[torch.Generator] = None,
    matvec_max_rows: Optional[int] = None,
    config: Optional[Dict[str, Any]] = None,
    device=None,
    **kwargs,
) -> "InferenceEngine":
    """Parity: ``deepspeed.init_inference(model, tp_size, dtype, ...)``.

    ``params`` is the port's parameter tree (see ``models.convert`` for the
    JAX bridge; it may hold packed leaves already); without it the weights
    are drawn from ``rng`` (a ``torch.Generator`` on ``device``, seed 0 by
    default; with quantized weights each projection leaf is drawn and packed
    one layer at a time, :func:`init_layerwise`, so those draws differ from
    the bf16 engine's). ``dtype="int8"|"int4"`` means bf16 compute with 8- or
    4-bit packed projections (MoE expert banks included); ``matvec_max_rows``
    (or ``config={"matvec_max_rows": N}``) sets the row threshold of the
    quantized matvec. ``device`` defaults
    to the current CUDA device; with no CUDA device it must be ``"cpu"``.
    ``checkpoint`` is an engine checkpoint directory (its newest tag; either
    package's): its fp32 masters are served, cast and packed as ``params``
    would be. Arguments that need a later slice of the port raise
    ``NotImplementedError`` naming it."""
    if config:
        if matvec_max_rows is None and "matvec_max_rows" in config:
            matvec_max_rows = int(config["matvec_max_rows"])
        extras = sorted(set(config) - {"matvec_max_rows"})
        if extras:
            log_dist(f"init_inference: ignoring unsupported config keys {extras}")
    later = []
    if tensor_parallel:
        tp_size = tensor_parallel.get("tp_size", tp_size)
        if tensor_parallel.get("overlap_comm"):
            later.append("tensor_parallel.overlap_comm")
    if tp_size > 1:
        later.append(f"tp_size={tp_size} (tensor parallelism)")
    if ep_size > 1:
        later.append(f"ep_size={ep_size} (MoE expert parallelism)")
    if later:
        raise NotImplementedError(
            "deepspeed_tpu_torch serves on one device; not yet ported: "
            + "; ".join(later)
        )
    if kwargs:
        log_dist(f"init_inference: ignoring unsupported arguments {sorted(kwargs)}")
    if checkpoint is not None:
        # JAX inference/engine.py:138-146: the params component, by name, into
        # the model's tree; the serving cast and packing then run as for params=
        if params is not None:
            raise ValueError("pass either checkpoint= or params=, not both")
        from ..runtime.checkpointing import load_params

        params = load_params(checkpoint, tree_map(lambda spec: spec[0],
                                                  param_specs(model.config)))
    if dtype in ("int8", torch.int8):
        dtype, quantize_bits = torch.bfloat16, quantize_bits or 8
    elif dtype == "int4":
        dtype, quantize_bits = torch.bfloat16, quantize_bits or 4
    return InferenceEngine(
        model,
        dtype=dtype,
        kernel_inject=replace_with_kernel_inject,
        quantize_bits=quantize_bits,
        max_tokens=max_tokens,
        kv_cache_dtype=kv_cache_dtype,
        draft_model=draft_model,
        draft_params=draft_params,
        params=params,
        rng=rng,
        matvec_max_rows=matvec_max_rows,
        device=resolve_device(device, "init_inference"),
    )


def quantize_weights(params, bits: int):
    """Weight-only block quantization of the projection leaves
    (:data:`QUANTIZED_LEAVES`: stacked [L, in, out], and MoE expert banks
    [L, E, in, out]) into packed storage; other leaves (the router, the
    norms, the residual-MoE branch, the embedding and the head), and leaves
    already packed, pass through (JAX ``inference/engine.py:388-412``)."""
    def q(tree, name=None):
        if isinstance(tree, dict):
            return {k: q(v, k) for k, v in tree.items()}
        if name in QUANTIZED_LEAVES and not isinstance(tree, PackedWeight) \
                and tree.ndim >= 2:
            return pack_quantize_blockwise(tree, bits=bits)
        return tree

    return q(params)


def init_layerwise(cfg, generator: torch.Generator, dtype: torch.dtype, device,
                   bits: Optional[int] = None):
    """Random parameters of ``cfg`` (the shapes and scales of
    ``models.transformer.init``) where each projection leaf of
    :data:`QUANTIZED_LEAVES` is drawn one layer slice at a time and, with
    ``bits``, packed before the next slice is drawn; without ``bits`` the
    slices are stacked dense. The packed weights never exist whole in
    ``dtype``: Mixtral-8x7B's bf16 tree (93 GB) does not fit one 80 GB card,
    its int8 form (48.4 GB) does.

    The draws follow the tree's order with each such leaf split by layer, so
    they differ from ``init``'s, which draws each leaf whole; the same seed
    gives the same tree in both forms of this function."""
    def make(spec, name=None):
        if isinstance(spec, dict):
            return {k: make(v, k) for k, v in spec.items()}
        shape, std = spec
        if name not in QUANTIZED_LEAVES or isinstance(std, str) or len(shape) < 3:
            return init_leaf(shape, std, generator, dtype, device)
        slices = (init_leaf(shape[1:], std, generator, dtype, device)
                  for _ in range(shape[0]))
        if not bits:
            return torch.stack(list(slices))
        qdata = scale = nibbles = None
        for i, w in enumerate(slices):
            pw = pack_quantize_blockwise(w, bits=bits)
            if qdata is None:  # the stacked storage, filled layer by layer
                qdata = torch.empty((shape[0], *pw.qdata.shape), dtype=torch.int8,
                                    device=device)
                scale = torch.empty((shape[0], *pw.scale.shape), dtype=torch.float32,
                                    device=device)
                nibbles = pw.nibbles
            qdata[i], scale[i] = pw.qdata, pw.scale
            del w, pw
        return PackedWeight(qdata, scale, shape, bits, dtype, nibbles)

    return make(param_specs(cfg))


class InferenceEngine:
    def __init__(self, model, *, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16,
                 kernel_inject: bool = False,
                 quantize_bits: Optional[int] = None, max_tokens: int = 1024,
                 kv_cache_dtype: str = "auto", draft_model=None,
                 draft_params=None, params=None,
                 rng: Optional[torch.Generator] = None,
                 matvec_max_rows: Optional[int] = None):
        self.model = model
        self.config = model.config
        check_supported(self.config)
        family = non_llama_features(self.config)
        if draft_model is not None and not isinstance(draft_model, str):
            family += non_llama_features(draft_model.config)
        llama_only = [what for on, what in (
            (quantize_bits, f"{quantize_bits}-bit weights"),
            (kv_cache_dtype == "int8", "the int8 KV cache"),
            (draft_model is not None, "speculative decode")) if on]
        if family and llama_only:
            raise NotImplementedError(
                f"deepspeed_tpu_torch serves {', '.join(llama_only)} for the Llama "
                f"family only; a model with {', '.join(family)} (GPT-2/BLOOM) is "
                "not ported there yet (ROADMAP queue A item 2)"
            )
        self.device = device
        self.dtype = dtype
        self.max_tokens = min(max_tokens, self.config.max_seq_len)
        self.kernel_inject = kernel_inject
        if kv_cache_dtype not in ("auto", "int8", "bf16", "bfloat16"):
            raise ValueError(
                f"kv_cache_dtype must be auto|bf16|bfloat16|int8, got "
                f"{kv_cache_dtype!r}"
            )
        if quantize_bits not in (None, 4, 8):
            raise ValueError(f"quantize_bits must be 4 or 8, got {quantize_bits!r}")
        self.kv_cache_quantized = kv_cache_dtype == "int8"
        self.kv_cache_storage_dtype = (
            torch.bfloat16 if kv_cache_dtype in ("bf16", "bfloat16") else dtype
        )
        on_cuda = device.type == "cuda"
        if on_cuda and dtype != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA serving kernels take bfloat16; "
                f"got dtype={dtype} (serve other dtypes with device='cpu'; fp16 "
                "serving, the decode kernels' fp16 forms, is ROADMAP A6 part 2)"
            )
        self.matvec_max_rows = (
            int(matvec_max_rows) if matvec_max_rows is not None else None
        )

        if params is None:
            gen = rng if rng is not None else \
                torch.Generator(device=device).manual_seed(0)
            params = (init_layerwise(self.config, gen, dtype, device, quantize_bits)
                      if quantize_bits else model.init(gen, dtype=dtype, device=device))
        params = cast_floating(params, dtype, device)
        if quantize_bits:
            params = quantize_weights(params, quantize_bits)
        self.params = params
        # speculative decoding (greedy, B = 1): a draft proposes, the main
        # model verifies a whole window per forward; "ngram" drafts by
        # prompt lookup in the token buffer
        self.draft_model = draft_model
        self.draft_params = None
        self.spec_ngram_n = 3  # context length of the "ngram" draft
        self.last_spec_rounds: Optional[int] = None
        if isinstance(draft_model, str):
            if draft_model != "ngram":
                raise ValueError(
                    f"draft_model={draft_model!r}: the only string draft is "
                    '"ngram" (prompt-lookup self-drafting); otherwise pass '
                    "a model"
                )
        elif draft_model is not None:
            if draft_model.config.vocab_size != self.config.vocab_size:
                raise ValueError(
                    "draft model must share the main model's vocabulary "
                    f"({draft_model.config.vocab_size} != "
                    f"{self.config.vocab_size})"
                )
            check_supported(draft_model.config)
            if draft_params is None:
                draft_params = draft_model.init(
                    torch.Generator(device=device).manual_seed(1),
                    dtype=dtype, device=device,
                )
            self.draft_params = cast_floating(draft_params, dtype, device)
        self.last_generate_stats: Optional[Dict[str, float]] = None
        n_params = tree_size(self.params)
        log_dist(
            f"InferenceEngine: {n_params / 1e6:.1f}M params, dtype={dtype}, "
            f"quant={quantize_bits or 'off'}, kv_cache={kv_cache_dtype}, "
            f"device={device}, kernel_inject={kernel_inject}"
        )

    def _impl_ctx(self) -> ExitStack:
        """The engine's kernel scopes around a forward: its matvec row
        threshold and, with kernel injection, the flash/decode kernels and the
        norm kernels on CUDA. A method, not a closure kept on the engine: a
        closure over ``self`` would make a reference cycle, and a freed
        engine's weights would stay on the card until the cyclic collector
        ran."""
        stack = ExitStack()
        stack.enter_context(matvec_max_rows_scope(self.matvec_max_rows))
        if self.kernel_inject:
            stack.enter_context(attention_impl("auto"))  # flash on CUDA
            stack.enter_context(kernel_rmsnorm_scope(self.device.type == "cuda"))
        return stack

    # -------------------------------------------------------------- forward
    def forward(self, input_ids) -> torch.Tensor:
        """Plain logits forward (no cache) → fp32 [B, S, V]."""
        ids = _token_ids(input_ids).to(self.device)
        with self._impl_ctx(), torch.inference_mode():
            return apply(self.config, self.params, ids)

    __call__ = forward

    # ------------------------------------------------------------- generate
    def generate(
        self,
        input_ids,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        eos_token_id: int = -1,
        num_draft_tokens: int = 4,
        rng: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Greedy (temperature=0) or top-k / top-p sampled decoding, with
        an optional HF-convention repetition penalty. With a draft model
        attached (``init_inference(draft_model=...)``), greedy B = 1
        generation without a penalty runs speculatively, ``num_draft_tokens``
        proposals per verifier forward, with the plain greedy tokens as
        output (``last_spec_rounds`` counts the verifier forwards).

        Returns [B, prompt + max_new_tokens] int32 token ids on the CPU
        (eos-padded once a row is done). ``rng`` is a ``torch.Generator`` on
        the engine's device (seed 0 when omitted). Timings of the last call
        are in ``last_generate_stats``."""
        ids = _token_ids(input_ids)
        B, prompt_len = ids.shape
        if max_new_tokens <= 0:
            # nothing to generate: echo the prompt
            return ids.to(torch.int32)
        if prompt_len >= self.max_tokens:
            raise ValueError(
                f"prompt length {prompt_len} leaves no room to generate under "
                f"max_tokens={self.max_tokens} (model max_seq_len="
                f"{self.config.max_seq_len}); truncate the prompt or raise "
                f"max_tokens"
            )
        total_len = min(prompt_len + max_new_tokens, self.max_tokens)
        pb, tb = _bucket_prompt(prompt_len), _align_cache(total_len)
        fill = eos_token_id if eos_token_id >= 0 else 0
        speculative = (
            self.draft_model is not None
            and temperature == 0.0
            and B == 1
            and repetition_penalty == 1.0
            and num_draft_tokens >= 1
        )
        k = int(num_draft_tokens) + 1 if speculative else 0  # drafts + bonus
        buf = torch.full((B, tb + k), fill, dtype=torch.long, device=self.device)
        buf[:, :prompt_len] = ids.to(self.device)
        with self._impl_ctx(), torch.inference_mode():
            if speculative:
                self._spec_decode(buf, pb, prompt_len, total_len, k,
                                  int(eos_token_id))
            else:
                if rng is None:
                    rng = torch.Generator(device=self.device).manual_seed(0)
                self._decode(buf, pb, prompt_len, total_len, rng,
                             float(temperature), int(top_k), float(top_p),
                             float(repetition_penalty), int(eos_token_id))
        return buf[:, :total_len].to(torch.int32).cpu()

    def _decode(self, buf, pb, prompt_len, total_len, rng, temperature, top_k,
                top_p, rep_penalty, eos_id) -> None:
        """Prefill, then one cached forward per token, writing into ``buf``."""
        cfg = self.config
        B, tb = buf.shape
        rows = torch.arange(B, device=self.device)
        use_penalty = rep_penalty != 1.0
        seen = None
        if use_penalty:
            seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool,
                               device=self.device)
            seen[rows[:, None], buf[:, :prompt_len]] = True

        def step_sample(logits, live=None):
            if use_penalty:
                logits = apply_repetition_penalty(logits, seen, rep_penalty,
                                                  active=live)
            return _sample(logits, rng, temperature, top_k, top_p)

        clock = _Clock(self.device)
        cache = init_cache(cfg, B, tb, self.kv_cache_storage_dtype, self.device,
                           quantized=self.kv_cache_quantized)
        logits, cache = forward_with_cache(cfg, self.params, buf[:, :pb],
                                           cache, 0)
        nxt = step_sample(logits[:, prompt_len - 1])
        if use_penalty:
            seen[rows, nxt] = True
        buf[:, prompt_len] = nxt
        done = nxt == eos_id
        clock.mark()
        pos, steps = prompt_len, 0
        while pos < total_len - 1:
            if eos_id >= 0 and bool(done.all()):  # one host sync per token
                break
            logits, cache = forward_with_cache(cfg, self.params,
                                               buf[:, pos:pos + 1], cache, pos)
            nxt = step_sample(logits[:, -1], live=~done)
            nxt = torch.where(done, eos_id, nxt)
            if use_penalty:
                # rows already done emit forced eos padding: never book it
                # as seen (and never scatter a negative eos id)
                col = nxt.clamp(0, cfg.vocab_size - 1)
                seen[rows, col] = seen[rows, col] | ~done
            buf[:, pos + 1] = nxt
            done = done | (nxt == eos_id)
            pos += 1
            steps += 1
        prefill_ms, decode_ms = clock.finish()
        self.last_generate_stats = {
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_steps": steps, "batch": B, "prompt_bucket": pb,
        }


    def _spec_decode(self, buf, pb, prompt_len, total_len, k, eos_id) -> None:
        """Greedy speculative decoding of one sequence into ``buf`` [1,
        tb + k]: each round the draft proposes k - 1 tokens after the last
        committed one, the main model scores the k-token window in one cached
        forward at ``cache_len = pos``, and the longest matching draft prefix
        plus the verifier's own next token is accepted (clamped at an eos).

        On the card the verify window computes each of its tokens as
        single-token decode does: the packed matvec sums every row in one
        order whatever the row count, the window's attention is the decode
        kernel a row each, and the head runs a row at a time. With packed
        projections the speculative tokens are therefore the plain greedy
        tokens bit for bit; dense bf16 projections go through cuBLAS, whose
        kernel choice depends on the row count.

        Cache discipline: a verify writes its whole window at the accepted
        position, so rows of rejected drafts are rewritten before any later
        query can attend them (windows are contiguous and advance by at
        least 1). The draft model runs k steps, one past its last proposal:
        that step's token is discarded, but its forward writes the draft
        cache row pos + k - 1, which a fully accepted round would otherwise
        leave empty for good."""
        cfg = self.config
        ngram = isinstance(self.draft_model, str)
        capacity = _align_cache(buf.shape[1])
        clock = _Clock(self.device)
        main_cache = init_cache(cfg, 1, capacity, self.kv_cache_storage_dtype,
                                self.device, quantized=self.kv_cache_quantized)
        prompt = buf[:, :pb]
        logits, _ = forward_with_cache(cfg, self.params, prompt, main_cache, 0)
        buf[:, prompt_len] = logits[:, prompt_len - 1].argmax(dim=-1)
        if not ngram:
            dcfg = self.draft_model.config
            draft_cache = init_cache(dcfg, 1, capacity, self.dtype, self.device)
            forward_with_cache(dcfg, self.draft_params, prompt, draft_cache, 0)
        clock.mark()
        pos, rounds = prompt_len, 0
        done = bool(buf[0, prompt_len] == eos_id)
        while pos < total_len - 1 and not done:
            if ngram:
                cand = torch.cat([
                    buf[:, pos:pos + 1],
                    ngram_propose(buf[0], pos, k - 1, self.spec_ngram_n)[None, :],
                ], dim=1)
            else:
                cand = torch.empty((1, k + 1), dtype=torch.long, device=self.device)
                cand[:, 0] = buf[:, pos]
                for i in range(k):
                    dlog, _ = forward_with_cache(dcfg, self.draft_params,
                                                 cand[:, i:i + 1], draft_cache,
                                                 pos + i)
                    cand[:, i + 1] = dlog[:, -1].argmax(dim=-1)
                cand = cand[:, :k]  # the k-th draft is never proposed
            vlog, _ = forward_with_cache(cfg, self.params, cand, main_cache, pos)
            targets = vlog.argmax(dim=-1)  # [1, k]
            n_acc = longest_accepted_prefix(cand[0, 1:] == targets[0, :k - 1])
            adv, has_eos = clamp_advance_at_eos(targets[0], n_acc + 1, eos_id)
            buf[:, pos + 1:pos + 1 + k] = targets
            adv, has_eos = torch.stack([adv, has_eos.to(adv.dtype)]).tolist()
            pos += adv
            done = bool(has_eos)
            rounds += 1
        # positions past the last accepted token hold rejected-window
        # predictions: restore the fill the buffer started with
        buf[:, pos + 1:] = eos_id if eos_id >= 0 else 0
        prefill_ms, decode_ms = clock.finish()
        self.last_spec_rounds = rounds
        self.last_generate_stats = {
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_steps": min(pos, total_len - 1) - prompt_len, "batch": 1,
            "prompt_bucket": pb, "spec_rounds": rounds,
        }


class _Clock:
    """Prefill and decode times of one generate: CUDA events on the card
    (no host sync until the caller's copy back), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record()
        else:
            self.times = [time.perf_counter()]

    def mark(self) -> None:
        if self.cuda:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
        else:
            self.times.append(time.perf_counter())

    def finish(self):
        self.mark()
        if self.cuda:
            self.events[-1].synchronize()
            e = self.events
            return e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])
        t = self.times
        return (t[1] - t[0]) * 1e3, (t[2] - t[1]) * 1e3


def _token_ids(input_ids) -> torch.Tensor:
    """Token ids as an int64 tensor (a copy of array-likes, so read-only
    numpy arrays are fine)."""
    if isinstance(input_ids, torch.Tensor):
        return input_ids.long()
    return torch.from_numpy(np.array(input_ids, dtype=np.int64))


