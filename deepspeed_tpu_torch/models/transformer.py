"""Decoder transformer core in PyTorch.

Counterpart of ``deepspeed_tpu/models/transformer.py``. A model is a
:class:`TransformerConfig` plus a parameter tree of tensors in the JAX
package's layout: nested dicts, the layers stacked along a leading [L] dim,
projection weights [in, out]. The forward is plain functions on tensors with a
Python loop over the layers where JAX has ``lax.scan``.

The port covers the Llama family (RoPE, RMSNorm, SwiGLU, grouped-query
attention, no biases, an untied head), Mixtral's routed expert MLP
(``num_experts > 0``: a router and [L, E, ...] expert banks, routed by
``moe.sharded_moe.moe_layer`` at the training or the eval capacity) and the
GPT-2 and BLOOM families:
LayerNorm with a bias, learned positions or ALiBi slopes, GELU (erf or tanh),
biases on every projection, a head tied to the token table (its gradient sums
the lookup's and the head's), BLOOM's embedding LayerNorm. What stays
unported raises ``NotImplementedError`` (see :func:`check_supported`). For
training, :func:`loss_fn` is the next-token cross-entropy (dense, or
vocab-chunked under ``ops.cross_entropy.fused_ce_scope``), plus the MoE aux
loss times ``moe_aux_loss_coef`` for an MoE model, and :func:`apply`
can re-run each layer in backward (``remat_policy="full"``). A packed batch's
``segment_ids`` keep attention inside each document and its ``positions``
place RoPE and the learned positions (BLOOM's ALiBi then becomes a dense
bias at those positions), as the JAX ``loss_fn`` passes them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..comm.collectives import all_gather
from ..ops.attention import attention
from ..ops.cross_entropy import chunked_masked_ce, fused_ce_config
from ..ops.cuda.quantized_matmul import packed_proj
from ..ops.normalization import layernorm, rmsnorm
from ..ops.quantizer import cast_floating
from ..runtime.activation_checkpointing import policy_by_name
from .sharding import sp_topology

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # None => MHA
    head_dim: Optional[int] = None
    intermediate_size: Optional[int] = None
    max_seq_len: int = 2048
    pos_embedding: str = "rope"  # rope | learned | alibi | none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    activation: str = "swiglu"  # swiglu | gelu | gelu_new
    use_bias: bool = False
    tie_embeddings: bool = False
    embed_norm: bool = False
    initializer_range: float = 0.02
    # MoE (Mixtral): >0 experts turns the MLP into a routed expert layer
    num_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "einsum"  # einsum (one-hot dots) | gather (indexed)
    moe_capacity_factor: float = 2.0
    moe_aux_loss_coef: float = 0.01
    moe_z_loss_coef: float = 1e-3
    # Residual-MoE (PR-MoE): a dense MLP beside the routed experts, mixed by
    # a learned per-token 2-way coefficient
    moe_use_residual: bool = False
    name: str = "transformer"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Analytic parameter count, the JAX package's formula: biases, the
        LayerNorm bias, learned positions, the embedding norm and, for MoE,
        the experts, the router and the residual branch included."""
        d, v, L = self.hidden_size, self.vocab_size, self.num_layers
        ln_width = 2 * d if self.norm == "layernorm" else d  # scale (+bias)
        qkvo = d * self.num_heads * self.hd * 2 + d * self.kv_heads * self.hd * 2
        mlp = (3 if self.activation == "swiglu" else 2) * d * self.ffn
        if self.is_moe:
            dense_mlp = mlp
            mlp = mlp * self.num_experts + d * self.num_experts  # experts, router
            if self.moe_use_residual:
                mlp += dense_mlp + 2 * d  # the residual dense branch and coef
        biases = 0
        if self.use_bias:
            biases += self.num_heads * self.hd + 2 * self.kv_heads * self.hd + d
            if not self.is_moe and self.activation != "swiglu":
                biases += self.ffn + d
        per_layer = qkvo + mlp + biases + 2 * ln_width
        embed = v * d + (self.max_seq_len * d if self.pos_embedding == "learned" else 0)
        if self.embed_norm:
            embed += ln_width
        head = 0 if self.tie_embeddings else v * d
        return L * per_layer + embed + head + ln_width


POS_EMBEDDINGS = ("rope", "learned", "alibi")
NORMS = ("rmsnorm", "layernorm")
ACTIVATIONS = ("swiglu", "gelu", "gelu_new")


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for a configuration outside the port's families."""
    missing = []
    if cfg.pos_embedding not in POS_EMBEDDINGS:
        missing.append(f"pos_embedding={cfg.pos_embedding!r} (the port has "
                       f"{', '.join(POS_EMBEDDINGS)})")
    if cfg.norm not in NORMS:
        missing.append(f"norm={cfg.norm!r} (the port has {', '.join(NORMS)})")
    if cfg.activation not in ACTIVATIONS:
        missing.append(f"activation={cfg.activation!r} (the port has "
                       f"{', '.join(ACTIVATIONS)})")
    if missing:
        raise NotImplementedError(
            "deepspeed_tpu_torch runs the Llama, GPT-2 and BLOOM families; "
            f"not yet ported: {'; '.join(missing)}"
        )


def non_llama_features(cfg: TransformerConfig) -> List[str]:
    """The GPT-2/BLOOM features ``cfg`` turns on: empty for the Llama family.
    The paths that serve Llama only (quantized and speculative serving, the
    continuous-batching engine) refuse a config that has any."""
    checks = [
        (cfg.norm != "rmsnorm", f"norm={cfg.norm!r}"),
        (cfg.pos_embedding != "rope", f"pos_embedding={cfg.pos_embedding!r}"),
        (cfg.activation != "swiglu", f"activation={cfg.activation!r}"),
        (cfg.use_bias, "biases"),
        (cfg.tie_embeddings, "a tied head"),
        (cfg.embed_norm, "an embedding norm"),
    ]
    return [what for on, what in checks if on]


# -----------------------------------------------------------------------------
# init
# -----------------------------------------------------------------------------
def param_specs(cfg: TransformerConfig) -> Params:
    """The parameter tree as (shape, init): init is the normal's std, or
    ``"ones"`` for a norm scale and ``"zeros"`` for a bias. Leaves, shapes
    and scales are the JAX package's ``init``, leaf for leaf: learned
    positions, the embedding norm, LayerNorm and projection biases where the
    config has them, and no ``lm_head`` when the head is tied."""
    check_supported(cfg)
    std = cfg.initializer_range
    d, hd, nh, nkv, f = cfg.hidden_size, cfg.hd, cfg.num_heads, cfg.kv_heads, cfg.ffn
    L = cfg.num_layers
    ln_bias = cfg.norm == "layernorm"

    def norm(lead=()):
        p = {"scale": ((*lead, d), "ones")}
        if ln_bias:
            p["bias"] = ((*lead, d), "zeros")
        return p

    specs: Params = {"embed": {"tok": ((cfg.vocab_size, d), std)},
                     "final_norm": norm()}
    if cfg.pos_embedding == "learned":
        specs["embed"]["pos"] = ((cfg.max_seq_len, d), std)
    if cfg.embed_norm:
        specs["embed_norm"] = norm()
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.vocab_size), std)
    # residual-branch output projections get depth-scaled init (GPT-2 paper)
    out_std = std / math.sqrt(2 * L)
    attn = {
        "wq": ((L, d, nh * hd), std),
        "wk": ((L, d, nkv * hd), std),
        "wv": ((L, d, nkv * hd), std),
        "wo": ((L, nh * hd, d), out_std),
    }
    if cfg.use_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd),
                            ("bo", d)):
            attn[name] = ((L, width), "zeros")
    if cfg.is_moe:
        # the router [L, d, E] and the expert banks [L, E, d, f] / [L, E, f, d]
        E = cfg.num_experts
        mlp = {"router": ((L, d, E), std), "wi": ((L, E, d, f), std),
               "wo": ((L, E, f, d), out_std)}
        if cfg.activation == "swiglu":
            mlp["wg"] = ((L, E, d, f), std)
        if cfg.moe_use_residual:
            mlp["res_wi"] = ((L, d, f), std)
            mlp["res_wo"] = ((L, f, d), out_std)
            if cfg.activation == "swiglu":
                mlp["res_wg"] = ((L, d, f), std)
            mlp["coef"] = ((L, d, 2), std)
    else:
        mlp = {"wi": ((L, d, f), std), "wo": ((L, f, d), out_std)}
        if cfg.activation == "swiglu":
            mlp["wg"] = ((L, d, f), std)
        elif cfg.use_bias:
            mlp["bi"] = ((L, f), "zeros")
            mlp["bo"] = ((L, d), "zeros")
    specs["layers"] = {"ln1": norm((L,)), "ln2": norm((L,)), "attn": attn, "mlp": mlp}
    return specs


def init_leaf(shape, std, generator: torch.Generator, dtype: torch.dtype,
              device) -> torch.Tensor:
    """One leaf of :func:`param_specs`: ones, zeros, or a normal of std
    ``std`` drawn from ``generator``."""
    if std == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if std == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return t.mul_(std)


def init(cfg: TransformerConfig, generator: torch.Generator,
         dtype: torch.dtype = torch.float32,
         device: Optional[torch.device] = None) -> Params:
    """Random parameters with the JAX package's shapes and scales, drawn
    from ``generator`` (on ``device``, the generator's device by default)."""
    device = torch.device(device) if device is not None else generator.device

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return init_leaf(*spec, generator, dtype, device)

    return make(param_specs(cfg))


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked [L, ...] tensors
    (a PackedWeight leaf gives its layer's packed slice)."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in layers.items()
    }


class _LayerSlice(torch.autograd.Function):
    """Layer ``i``'s slice of a stacked [L, ...] leaf that needs its
    gradient, cast to ``dtype`` (a view of the leaf when no cast is needed);
    the slice's gradient lands in place in the leaf's ``.grad[i]`` (a zero
    [L, ...] gradient made at the first slice a backward reaches), so neither
    an [L, ...] cast of the stack nor an [L, ...] stack of the layers'
    gradients ever exists beside it. The arithmetic is a cast per element and
    a sum of each layer's gradient into zero (then into the earlier
    micro-batches' sum), element for element the whole-stack cast's and the
    stacked gradient's.

    The gradient reaches ``.grad`` only: ``loss.backward()`` is the one way
    to differentiate through it. ``torch.autograd.grad`` over the leaf,
    ``create_graph``, and hooks on the leaf would each miss it, so its
    backward refuses them."""

    @staticmethod
    def forward(ctx, stacked, i, dtype):
        ctx.stacked, ctx.i = stacked, i
        s = stacked.detach()[i]
        return s if dtype is None or dtype == s.dtype else s.to(dtype)

    @staticmethod
    def backward(ctx, g):
        w, i = ctx.stacked, ctx.i
        try:
            to_grad = torch._C._will_engine_execute_node(ctx.next_functions[0][0])
        except RuntimeError:  # torch.autograd.grad is running
            to_grad = False
        if not to_grad or torch.is_grad_enabled() or w._backward_hooks \
                or getattr(w, "_post_accumulate_grad_hooks", None):
            raise RuntimeError(
                "a stacked layer parameter's gradient lands in its .grad in place "
                "(models/transformer.py:_LayerSlice): differentiate with "
                "loss.backward(), without create_graph and without hooks on the "
                "parameter, not with torch.autograd.grad")
        with torch.no_grad():
            if w.grad is None:
                w.grad = torch.zeros_like(w)
            w.grad[i] += g.to(w.dtype)
        return None, None, None


def layer_slice(layers: Params, i: int, dtype: Optional[torch.dtype] = None) -> Params:
    """Layer ``i``'s parameters cast to ``dtype`` (None keeps each leaf's):
    a stacked leaf that needs its gradient goes through :class:`_LayerSlice`
    (its gradient lands in the stacked ``.grad`` in place); any other is
    ``v[i]`` cast (a PackedWeight leaf's layer slice as it is). Called
    inside a checkpointed layer, the cast slice is
    recomputed in backward rather than kept."""
    def one(v):
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.requires_grad and v.is_leaf \
                and torch.is_grad_enabled():
            return _LayerSlice.apply(v, i, dtype if v.is_floating_point() else None)
        return v[i] if dtype is None else cast_floating(v[i], dtype)

    return one(layers)


# -----------------------------------------------------------------------------
# building blocks
# -----------------------------------------------------------------------------
def _norm(cfg: TransformerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm (by ``cfg.norm``) in fp32, returned in x's dtype
    (the kernels fuse the casts)."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """BLOOM's ALiBi head slopes (power-of-2 interpolation), fp32 [H]; the
    JAX package's ``models/transformer.py:alibi_slopes``, computed in Python
    floats and rounded once."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** (2 * i + 1) for i in range(num_heads - closest)]
    return torch.tensor(slopes, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _slopes_on(num_heads: int, device: str) -> torch.Tensor:
    return alibi_slopes(num_heads).to(device)


def model_slopes(cfg: TransformerConfig, device) -> Optional[torch.Tensor]:
    """The model's ALiBi slopes on ``device`` (made once per device), or
    None for a model without ALiBi."""
    if cfg.pos_embedding != "alibi":
        return None
    return _slopes_on(cfg.num_heads, str(torch.device(device)))


def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 rotation tables (cos, signed sin), each [B, S, 1, hd], for
    integer positions [B, S]; computed once per forward and shared by every
    layer."""
    freqs = 1.0 / (theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    ))
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def _rope(q: torch.Tensor, k: torch.Tensor, rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings by split-half rotation in fp32, cast back;
    q/k [B, S, H, hd], ``rope`` from :func:`rope_tables`. With x = [x1, x2],
    x * cos + [x2, x1] * [-sin, sin] is [x1 cos - x2 sin, x2 cos + x1 sin],
    the JAX package's products and sums in the same order."""
    cos, sin = rope

    def rot(x):
        xf = x.float()
        return (xf * cos + xf.roll(x.shape[-1] // 2, dims=-1) * sin).to(x.dtype)

    return rot(q), rot(k)


def _qkv(cfg: TransformerConfig, p: Params, x: torch.Tensor, rope):
    """The q/k/v projections (each through ``packed_proj``: a dense weight
    is ``x @ w``, an int8/int4 one the quantized matvec), their biases where
    the model has them, then RoPE when ``rope`` tables are given."""
    B, S, _ = x.shape
    q = packed_proj(x, p["wq"]).view(B, S, cfg.num_heads, cfg.hd)
    k = packed_proj(x, p["wk"]).view(B, S, cfg.kv_heads, cfg.hd)
    v = packed_proj(x, p["wv"]).view(B, S, cfg.kv_heads, cfg.hd)
    if cfg.use_bias:
        q = q + p["bq"].view(cfg.num_heads, cfg.hd)
        k = k + p["bk"].view(cfg.kv_heads, cfg.hd)
        v = v + p["bv"].view(cfg.kv_heads, cfg.hd)
    if rope is not None:
        q, k = _rope(q, k, rope)
    return q, k, v


def out_proj(cfg: TransformerConfig, p: Params, out: torch.Tensor) -> torch.Tensor:
    """The attention output [B, S, H, hd] through ``wo`` (and ``bo``)."""
    B, S = out.shape[:2]
    y = packed_proj(out.reshape(B, S, cfg.num_heads * cfg.hd), p["wo"])
    return y + p["bo"] if cfg.use_bias else y


def _attention(cfg: TransformerConfig, p: Params, x: torch.Tensor, rope,
               slopes, bias=None, segment_ids=None) -> torch.Tensor:
    """Self-attention of one layer; under a sequence-parallel topology x is
    this rank's sequence chunk and attention crosses the chunks by the sp
    mode (``parallel/sequence.py:sp_attention``; JAX ``_attention``, lines
    268-276)."""
    q, k, v = _qkv(cfg, p, x, rope)
    attn = attention
    if sp_topology() is not None:
        from ..parallel.sequence import sp_attention as attn
    return out_proj(cfg, p, attn(q, k, v, causal=True, bias=bias,
                                 segment_ids=segment_ids, alibi_slopes=slopes))


def _act(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """GELU: the tanh form for ``gelu_new`` (GPT-2), the erf form else."""
    return F.gelu(x, approximate="tanh" if cfg.activation == "gelu_new" else "none")


def _mlp(cfg: TransformerConfig, p: Params, x: torch.Tensor,
         aux: Optional[List[torch.Tensor]] = None, train: bool = False) -> torch.Tensor:
    """SwiGLU MLP, or GELU with its biases; each projection through
    ``packed_proj``. An MoE model routes to the expert layer
    (``moe.sharded_moe.moe_layer``, at the training capacity when
    ``train``), appending its aux loss to ``aux`` when given."""
    if cfg.is_moe:
        from ..moe.sharded_moe import moe_layer

        out, a = moe_layer(cfg, p, x, train=train)
        if aux is not None:
            aux.append(a)
        return out
    if cfg.activation == "swiglu":
        return packed_proj(F.silu(packed_proj(x, p["wg"])) * packed_proj(x, p["wi"]),
                           p["wo"])
    h = packed_proj(x, p["wi"])
    if cfg.use_bias:
        h = h + p["bi"]
    y = packed_proj(_act(cfg, h), p["wo"])
    return y + p["bo"] if cfg.use_bias else y


def embed_tokens(cfg: TransformerConfig, params: Params, input_ids: torch.Tensor,
                 positions: torch.Tensor, cast=lambda t: t) -> torch.Tensor:
    """Token rows (plus learned position rows at ``positions``), then the
    embedding norm where the model has one; ``cast`` casts the looked-up
    rows and the norm's parameters to the compute dtype."""
    x = cast(F.embedding(input_ids, params["embed"]["tok"]))
    if cfg.pos_embedding == "learned":
        x = x + cast(F.embedding(positions.long(), params["embed"]["pos"]))
    if cfg.embed_norm:
        x = _norm(cfg, cast(params["embed_norm"]), x)
    return x


def lm_head_weight(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    """[d, V] head: the token table's transpose when tied, else
    ``lm_head``."""
    return params["embed"]["tok"].t() if cfg.tie_embeddings else params["lm_head"]


def lm_head_logits(cfg: TransformerConfig, params: Params,
                   y: torch.Tensor) -> torch.Tensor:
    """Final projection → fp32 logits [..., S, V].

    The product runs in the compute dtype; a bf16 product rounds the logits
    to bf16 before the fp32 cast, where the JAX head accumulates and returns
    fp32 without that rounding. fp32 models agree exactly."""
    return (y @ lm_head_weight(cfg, params).to(y.dtype)).float()


def default_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def alibi_position_bias(positions: torch.Tensor, slopes: torch.Tensor) -> torch.Tensor:
    """fp32 [B, H, S, S] ALiBi bias slope * -|pos_k - pos_q| at given
    positions [B, S] (JAX ``_attention``'s dense form, ``models/transformer.py
    :258-266``, the same fp32 operations)."""
    pos = positions.float()
    rel = pos[:, None, :] - pos[:, :, None]
    return slopes.to(pos.device)[None, :, None, None] * (-rel.abs())[:, None, :, :]


def _layer(cfg: TransformerConfig, lp: Params, x: torch.Tensor, rope,
           slopes, bias=None, segment_ids=None, aux=None, train=False) -> torch.Tensor:
    x = x + _attention(cfg, lp["attn"], _norm(cfg, lp["ln1"], x), rope, slopes, bias,
                       segment_ids)
    return x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x), aux, train)


def _stacked_layer(cfg: TransformerConfig, layers: Params, i: int, dtype, x, *rest):
    """Layer ``i`` read from the stacked ``layers``, its slice cast inside."""
    return _layer(cfg, layer_slice(layers, i, dtype), x, *rest)


def apply(cfg: TransformerConfig, params: Params, input_ids: torch.Tensor, *,
          dtype: Optional[torch.dtype] = None, remat_policy: Optional[str] = None,
          positions: Optional[torch.Tensor] = None,
          segment_ids: Optional[torch.Tensor] = None, train: bool = False,
          return_hidden: bool = False, return_aux: bool = False):
    """No-cache forward → fp32 logits [B, S, V]; with ``return_hidden`` the
    final normed hidden [B, S, d] instead (the chunked-CE path projects
    chunk by chunk itself); with ``return_aux`` a pair of that and the MoE
    aux loss summed over the layers (load balance plus the scaled z-loss,
    JAX ``apply``'s second value; 0 for a dense model).

    ``dtype`` casts the parameters for compute (each layer's slice of the
    stack inside that layer, element for element the JAX package's cast of
    the whole stack; the embedding rows after the lookup, so the table's
    gradient accumulates in its own dtype). ``remat_policy="full"``
    re-runs each layer in backward when a gradient is being recorded.

    The gradient of a stacked ``layers`` leaf that needs one lands in that
    leaf's ``.grad`` in place, layer by layer (:class:`_LayerSlice`): take it
    with ``loss.backward()``; ``torch.autograd.grad`` over such a leaf,
    ``create_graph`` and hooks on it are refused in backward.
    ``positions`` [B, S] (default 0..S-1) place RoPE and the learned
    positions; given, they turn ALiBi into the dense bias at those positions,
    made once here and shared by every layer. ``segment_ids`` [B, S] keep
    attention inside each packed segment (JAX ``apply``, line 548).
    ``train`` routes an MoE model's tokens at the training capacity.

    Under a sequence-parallel topology (``models.sharding.use_topology``,
    sp > 1) ``input_ids`` (and ``positions``, ``segment_ids``) are this
    rank's chunk of the sequence: the default positions are the chunk's
    global ones (rank * S + 0..S-1), which keep ALiBi as slopes, as the JAX
    package's default positions of the whole sequence do; given positions
    make the dense bias over the whole sequence, gathered from the sp
    group."""
    check_supported(cfg)
    B, S = input_ids.shape
    cast = (lambda t: t) if dtype is None else (lambda t: cast_floating(t, dtype))
    topo = sp_topology()
    pos_default = positions is None
    if pos_default:
        positions = default_positions(B, S, input_ids.device)
        if topo is not None:
            positions = positions + topo.coord("sp") * S
    x = embed_tokens(cfg, params, input_ids, positions, cast)
    rope = (rope_tables(positions, cfg.hd, cfg.rope_theta)
            if cfg.pos_embedding == "rope" else None)
    slopes = model_slopes(cfg, x.device)
    bias = None
    if slopes is not None and not pos_default:
        whole = positions if topo is None else all_gather(positions, topo.group("sp"), 1)
        slopes, bias = None, alibi_position_bias(whole, slopes)
    if segment_ids is not None:  # the kernels' int32 ids, once per forward
        segment_ids = segment_ids.to(torch.int32).contiguous()
    remat = policy_by_name(remat_policy) if torch.is_grad_enabled() else None
    aux: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        if remat:
            x = checkpoint(_stacked_layer, cfg, params["layers"], i, dtype, x, rope, slopes,
                           bias, segment_ids, aux, train, use_reentrant=False)
        else:
            x = _stacked_layer(cfg, params["layers"], i, dtype, x, rope, slopes, bias,
                               segment_ids, aux, train)
    x = _norm(cfg, cast(params["final_norm"]), x)
    out = x if return_hidden else lm_head_logits(cfg, params, x)
    if return_aux:
        total = torch.stack(aux).sum() if aux else torch.zeros((), device=x.device)
        return out, total
    return out


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, denom=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce, total_valid_tokens) from fp32 logits; labels < 0 ignored (HF
    -100 style). A given ``denom`` divides the NLL sum instead of the valid
    tokens here (a rank's share of a loss over a sharded batch)."""
    mask = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    if denom is None:
        denom = mask.sum().clamp(min=1.0)
    return ((logz - gold) * mask).sum() / denom, denom


def loss_fn(cfg: TransformerConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, dtype: Optional[torch.dtype] = torch.bfloat16, train: bool = True,
            remat_policy: Optional[str] = None, num_tokens=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (fp32); labels < 0 are ignored. Under an
    enabled ``fused_ce_scope`` with a vocab wider than one chunk, the
    [B, S, V] logits never materialise (``ops/cross_entropy.py``). A packed
    batch's ``segment_ids`` and ``positions`` go to :func:`apply`.
    ``num_tokens``, the valid tokens of a batch sharded over ranks, divides
    this rank's NLL sum, so the ranks' losses sum to the batch's mean.

    An MoE model's loss is ``ce + moe_aux_loss_coef · aux`` (JAX ``loss_fn``,
    lines 603 and 612), ``aux`` the layers' summed aux losses, with ``train``
    picking the training capacity. The metrics are ``lm_loss`` (the CE),
    ``moe_aux_loss`` (0 for a dense model) and ``tokens``."""
    fused_on, chunk = fused_ce_config()
    kw = dict(dtype=dtype, remat_policy=remat_policy, positions=batch.get("positions"),
              segment_ids=batch.get("segment_ids"), train=train, return_aux=True)
    # one device never shards the vocab: chunk once it spans more than one
    if fused_on and cfg.vocab_size > chunk:
        x, aux = apply(cfg, params, batch["input_ids"], return_hidden=True, **kw)
        ce, denom = chunked_masked_ce(x, lm_head_weight(cfg, params), batch["labels"],
                                      chunk, num_tokens)
    else:
        logits, aux = apply(cfg, params, batch["input_ids"], **kw)
        ce, denom = masked_ce(logits, batch["labels"], num_tokens)
    total = ce + cfg.moe_aux_loss_coef * aux if cfg.is_moe else ce
    return total, {"lm_loss": ce, "moe_aux_loss": aux, "tokens": denom}


def make_lm_batch(input_ids: torch.Tensor, pad_id: int = -1) -> Dict[str, torch.Tensor]:
    """Shift inputs into (input_ids, labels) next-token form."""
    pad = torch.full((input_ids.shape[0], 1), pad_id, dtype=input_ids.dtype,
                     device=input_ids.device)
    return {"input_ids": input_ids,
            "labels": torch.cat([input_ids[:, 1:], pad], dim=1)}


class TransformerModel:
    """Bundles (config, init, apply, loss), the engines' model protocol."""

    def __init__(self, cfg: TransformerConfig):
        self.config = cfg

    def init(self, generator: torch.Generator, dtype=torch.float32, device=None):
        return init(self.config, generator, dtype, device)

    def apply(self, params, input_ids, **kw):
        return apply(self.config, params, input_ids, **kw)

    def loss(self, params, batch, **kw):
        return loss_fn(self.config, params, batch, **kw)

    def num_params(self) -> int:
        return self.config.num_params()
