"""Mixture-of-experts layer on one device (ep = 1), for training and
inference.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (TopKGate + MOELayer of
DeepSpeed): softmax gates, top-k experts per token, each token's slot in its
expert by a cumulative sum, tokens over an expert's capacity dropped, the
kept gates renormalised. One selection loop (:func:`_gating_rounds`) feeds
both dispatch forms, the one-hot dispatch/combine products (``"einsum"``) and
the index tables that drive plain gathers (``"gather"``), so the two cannot
diverge.

What the JAX module adds for an expert-parallel mesh is left out here: the
``ep`` sharding constraints, the decomposed all-to-all overlap of
``moe.overlap_a2a`` and the decode-shaped a2a ring of serving. At ep = 1
each of them is the identity.

Training (``moe_layer(train=True)``) takes the training capacity rule
(:func:`train_capacity`) and is differentiable in both forms: gradients
reach the router through the softmax gates in the combine weights, the gate
fraction of the load-balance loss and the z-loss; the one-hot choices carry
none. Router noise is drawn only when a caller passes ``noise_std > 0`` and a
generator with ``train=True``; ``moe_layer`` passes no ``noise_std``, as the
JAX package does, so it never draws. Gating stays on the device: nothing
here reads a value back to the host.

Expert banks may be packed int8/int4 (``ops/quantizer.PackedWeight``,
[E, G, B, N] a layer), for inference only: :func:`_expert_proj` streams them
through the expert form of the quantized matvec kernel when each expert has
at most ``matvec_max_rows`` rows, and multiplies the dequantized bank
otherwise, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.cuda.quantized_matmul import packed_expert_proj
from ..ops.quantizer import PackedWeight

DISPATCH_FORMS = ("einsum", "gather")


def _gating_rounds(logits: torch.Tensor, top_k: int, capacity: int,
                   rng: Optional[torch.Generator] = None, train: bool = False,
                   noise_std: float = 0.0, valid: Optional[torch.Tensor] = None):
    """The top-k selection loop shared by both dispatch forms: per round
    (expert idx [N], slot position [N], keep mask [N], raw gate [N]), plus
    the aux metrics.

    Router noise (normal, ``noise_std``, drawn from ``rng`` on the logits'
    device) is added only when ``train and noise_std > 0 and rng is not
    None``; otherwise no draw is made and the generator's state is left as
    it was, so gating without noise is the same with and without a
    generator.

    ``valid`` ([N] bool) is the serving engine's null-expert contract: rows
    marked invalid (padded chunk tails, idle slots) never enter the
    selection. They take no capacity slot, shift no other token's position
    and carry zero combine weight, so the routing of the real tokens does not
    depend on how full the step is. Their logits are zeroed (not -inf), so
    no NaN can leak out of a padded row's hidden state."""
    N, E = logits.shape
    if train and noise_std > 0.0 and rng is not None:
        logits = logits + torch.randn(logits.shape, generator=rng, dtype=logits.dtype,
                                      device=logits.device) * noise_std
    if valid is not None:
        logits = torch.where(valid[:, None], logits, 0.0)
    gates = torch.softmax(logits, dim=-1)  # [N, E]
    fill = torch.zeros(E, dtype=torch.int32, device=logits.device)
    masked_gates = gates.detach()  # picks the experts: no gradient
    me = gates.mean(dim=0)  # gate fraction per expert
    ce_acc = torch.zeros(E, dtype=torch.float32, device=logits.device)
    kept_total = torch.zeros((), dtype=torch.float32, device=logits.device)
    rounds = []
    for _ in range(top_k):
        # argmax keeps the first of equal maxima, as jnp.argmax does
        idx = masked_gates.argmax(dim=-1)
        onehot = F.one_hot(idx, E).float()
        if valid is not None:
            onehot = onehot * valid[:, None].float()
        # position of each token within its chosen expert (this round)
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot + fill[None, :] * onehot
        pos_tok = (pos * onehot).sum(dim=-1).to(torch.int32)
        keep = pos_tok < capacity
        if valid is not None:
            keep = keep & valid
        gate_val = (gates * onehot).sum(dim=-1)
        rounds.append((idx, pos_tok, keep, gate_val))
        fill = fill + (onehot * keep[:, None]).sum(dim=0).to(torch.int32)
        ce_acc = ce_acc + onehot.mean(dim=0)
        kept_total = kept_total + keep.float().sum()
        masked_gates = masked_gates * (1.0 - onehot)  # exclude the chosen expert

    aux_loss = E * (me * (ce_acc / top_k)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    # a fill on the device, not a host-to-device copy (which would sync)
    n_routed = valid.float().sum() if valid is not None else \
        torch.full((), float(N), device=logits.device)
    dropped = torch.where(
        n_routed > 0, 1.0 - kept_total / (n_routed * top_k).clamp_min(1.0),
        torch.zeros((), device=logits.device))
    metrics = {
        "aux_loss": aux_loss,
        "z_loss": z_loss,
        "drop_fraction": dropped,
        # tokens that landed a capacity slot, per expert (the fill counters)
        "tokens_per_expert": fill,
        "routed_tokens": kept_total.to(torch.int32),
    }
    return rounds, metrics


def _token_slots(rounds, capacity: int):
    """Each token's slots, one column a round, [N, K] each: the flat slot
    e·C + c (0 for a dropped or invalid token), whether it was kept, and its
    combine weight: the kept gates renormalised over the token's kept
    experts, 0 where dropped (the reference's top-2 behaviour)."""
    slots, kept, w_raw = [], [], []
    for idx, pos_tok, keep, gate_val in rounds:
        flat = idx * capacity + pos_tok.clamp_max(capacity - 1).long()
        slots.append(torch.where(keep, flat, 0))
        kept.append(keep)
        w_raw.append(gate_val * keep)
    w = torch.stack(w_raw, dim=1)
    denom = w.sum(dim=1, keepdim=True)
    w = torch.where(denom > 0, w / denom.clamp_min(1e-9), w)
    return torch.stack(slots, dim=1), torch.stack(kept, dim=1), w


def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int,
                 rng: Optional[torch.Generator] = None, train: bool = False,
                 noise_std: float = 0.0, valid: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32):
    """(dispatch [N, E, C] 0/1, combine [N, E, C], metrics) in ``dtype``: the
    one-hot form. A kept token's (e, c) entry of combine is its weight of
    :func:`_token_slots`, every other entry 0: the JAX package's sum of
    one-hot products then division by the row sum, written as one
    ``scatter_add`` a table (a dropped token adds 0 at slot 0). The values
    are the JAX tables' cast to ``dtype``; a bf16 table is made without the
    fp32 [N, E, C] tensors the products would need."""
    N, E = logits.shape
    rounds, metrics = _gating_rounds(logits, top_k, capacity, rng, train, noise_std, valid)
    slots, kept, w = _token_slots(rounds, capacity)
    zeros = torch.zeros((N, E * capacity), dtype=dtype, device=logits.device)
    dispatch = zeros.scatter_add(1, slots, kept.to(dtype))
    combine = zeros.scatter_add(1, slots, w.to(dtype))
    return (dispatch.view(N, E, capacity), combine.view(N, E, capacity), metrics)


def top_k_gating_indices(logits: torch.Tensor, top_k: int, capacity: int,
                         rng: Optional[torch.Generator] = None, train: bool = False,
                         noise_std: float = 0.0, valid: Optional[torch.Tensor] = None):
    """The index-table form of :func:`top_k_gating`, from the same loop:
    (tok_of_slot [E, C] int32, slot_valid [E, C] bool, slot_of_tok [N, K]
    flat e·C + c, w_of_tok [N, K] fp32, metrics). Dropped and invalid
    tokens write an extra dummy slot, cut off at the end, and point their
    gather at slot 0 with weight 0."""
    N, E = logits.shape
    rounds, metrics = _gating_rounds(logits, top_k, capacity, rng, train, noise_std, valid)
    slot_of_tok, kept, w = _token_slots(rounds, capacity)
    dev = logits.device
    # kept tokens own distinct slots; only the dummy slot sees repeats
    # (scatter_, not index assignment: that reads back to the host on CUDA)
    target = torch.where(kept, slot_of_tok, E * capacity).reshape(-1)
    tok = torch.arange(N, dtype=torch.int32, device=dev)[:, None].expand(N, top_k)
    tok_flat = torch.zeros(E * capacity + 1, dtype=torch.int32, device=dev)
    valid_flat = torch.zeros(E * capacity + 1, dtype=torch.bool, device=dev)
    tok_flat.scatter_(0, target, tok.reshape(-1))
    valid_flat.scatter_(0, target, True)
    return (tok_flat[:-1].reshape(E, capacity), valid_flat[:-1].reshape(E, capacity),
            slot_of_tok, w, metrics)


def train_capacity(cfg, n_tokens: int) -> int:
    """Per-expert capacity in training: ``max(4, ceil(capacity_factor ·
    top_k · n_tokens / E))`` (JAX ``moe_layer``, lines 311-314); tokens over
    it are dropped."""
    return max(4, int(math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * n_tokens
                                / cfg.num_experts)))


def eval_capacity(cfg, n_tokens: int) -> int:
    """Per-expert capacity at inference for a call of at most ``n_tokens``
    real tokens: ``max(4, ceil(max(capacity_factor, 2) · top_k · n_tokens /
    E))``, the reference TopKGate's eval rule. With ``max(capacity_factor,
    2) · top_k >= E`` no token can be dropped, and each token's routing does
    not depend on the others in the call; Mixtral-8x7B (4 < 8) has no such
    guarantee."""
    cap_factor = max(cfg.moe_capacity_factor, 2.0)
    return max(4, int(math.ceil(cap_factor * cfg.moe_top_k * n_tokens
                                / cfg.num_experts)))


def _expert_proj(x: torch.Tensor, w) -> torch.Tensor:
    """x [E, C, d] @ w [E, d, n] → [E, C, n]. A packed bank streams through
    the expert matvec kernel when it takes the shape
    (:func:`~deepspeed_tpu_torch.ops.cuda.quantized_matmul.packed_expert_proj`);
    else the bank is dequantized once and multiplied, as a dense bank is."""
    if isinstance(w, PackedWeight):
        y = packed_expert_proj(x, w)
        if y is not None:
            return y
        w = w.dequantize()
    return torch.bmm(x, w.to(x.dtype))


def _expert_ffn(cfg, p: Dict, expert_in: torch.Tensor) -> torch.Tensor:
    """The expert FFN on [E, C, d] capacity rows: SwiGLU, or GELU (JAX's
    ``jax.nn.gelu`` default, the tanh form)."""
    h = _expert_proj(expert_in, p["wi"])
    if cfg.activation == "swiglu":
        h = F.silu(_expert_proj(expert_in, p["wg"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return _expert_proj(h, p["wo"])


def _residual_mix(cfg, p: Dict, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Residual MoE (DeepSpeed's ``use_residual``): a dense MLP on every
    token and a learned per-token 2-way softmax mixing it with the routed
    output."""
    h = x @ p["res_wi"]
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["res_wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    dense = h @ p["res_wo"]
    coef = torch.softmax(x.float() @ p["coef"].float(), dim=-1).to(x.dtype)
    return dense * coef[..., 0:1] + out * coef[..., 1:2]


def moe_layer(cfg, p: Dict, x: torch.Tensor, rng: Optional[torch.Generator] = None,
              train: bool = False):
    """Routed expert MLP: x [B, S, D] → (out [B, S, D], aux loss, the
    load-balance loss plus the z-loss scaled by ``moe_z_loss_coef /
    moe_aux_loss_coef``, as JAX's ``moe_layer``). ``train`` picks the
    training capacity (:func:`train_capacity`) over the eval one; the noise
    generator ``rng`` goes to the gating without a ``noise_std``, so no noise
    is drawn (JAX lines 342-348). ``cfg.moe_dispatch`` picks the one-hot or
    the gather form. Packed expert banks serve only: training one raises."""
    B, S, D = x.shape
    E, N, K = cfg.num_experts, B * S, cfg.moe_top_k
    if train and any(isinstance(p.get(k), PackedWeight) for k in ("wi", "wg", "wo")):
        raise NotImplementedError(
            "deepspeed_tpu_torch: packed int8/int4 expert banks are for inference; "
            "train the bf16/fp32 banks")
    capacity = train_capacity(cfg, N) if train else eval_capacity(cfg, N)
    dispatch_mode = getattr(cfg, "moe_dispatch", "einsum")
    if dispatch_mode not in DISPATCH_FORMS:
        raise ValueError(f"moe_dispatch {dispatch_mode!r} (must be 'einsum' or 'gather')")
    tokens = x.reshape(N, D)
    router_logits = tokens.float() @ p["router"].float()
    if dispatch_mode == "gather":
        tok_of_slot, slot_valid, slot_of_tok, w_of_tok, metrics = top_k_gating_indices(
            router_logits, K, capacity, rng, train)
        expert_in = tokens[tok_of_slot.reshape(-1).long()].reshape(E, capacity, D) \
            * slot_valid[..., None].to(x.dtype)
        expert_out = _expert_ffn(cfg, p, expert_in)
        picked = expert_out.reshape(E * capacity, D)[slot_of_tok.reshape(-1)]
        out = (picked.reshape(N, K, D) * w_of_tok[..., None].to(x.dtype)).sum(dim=1)
    else:
        dispatch, combine, metrics = top_k_gating(router_logits, K, capacity, rng, train,
                                                  dtype=x.dtype)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
        expert_out = _expert_ffn(cfg, p, expert_in)
        out = torch.einsum("nec,ecd->nd", combine, expert_out)
    aux = metrics["aux_loss"] + (cfg.moe_z_loss_coef
                                 / max(cfg.moe_aux_loss_coef, 1e-9)) * metrics["z_loss"]
    out = out.reshape(B, S, D)
    if cfg.moe_use_residual:
        out = _residual_mix(cfg, p, x, out)
    return out, aux


def moe_serving_mlp(cfg, p: Dict, x: torch.Tensor,
                    token_valid: Optional[torch.Tensor] = None,
                    budget_tokens: Optional[int] = None):
    """Routed expert MLP of the cached forwards: x [B, S, D] → (out [B, S, D],
    stats).

    - Capacity comes from ``budget_tokens``, the most real tokens the caller
      feeds: the slot engine's token budget (the default under
      ``token_valid``: S), or ``B·S`` for the lockstep engine, whose bucket
      padding counts as real tokens, as in the JAX engine.
    - ``token_valid`` [B, S] marks the real positions; the others route to no
      expert (:func:`_gating_rounds`).
    - Dispatch and combine are gathers through the index tables
      (:func:`top_k_gating_indices`); the FFN runs on [E, C, D] rows, packed
      banks through the expert matvec where C fits.

    stats = {"tokens_per_expert" [E] int32, "drop_fraction" fp32 scalar},
    device tensors for the serving metrics (``ServingMetrics.on_moe``)."""
    B, S, D = x.shape
    E, N, K = cfg.num_experts, B * S, cfg.moe_top_k
    if budget_tokens is None:
        budget_tokens = S if token_valid is not None else N
    capacity = eval_capacity(cfg, int(budget_tokens))
    tokens = x.reshape(N, D)
    valid = token_valid.reshape(N) if token_valid is not None else None
    router_logits = tokens.float() @ p["router"].float()
    tok_of_slot, slot_valid, slot_of_tok, w_of_tok, metrics = top_k_gating_indices(
        router_logits, K, capacity, valid=valid)
    expert_in = tokens[tok_of_slot.reshape(-1).long()].reshape(E, capacity, D) \
        * slot_valid[..., None].to(x.dtype)
    expert_out = _expert_ffn(cfg, p, expert_in)
    # dropped and invalid tokens carry w == 0: their slot-0 gather adds zeros
    picked = expert_out.reshape(E * capacity, D)[slot_of_tok.reshape(-1)]
    out = (picked.reshape(N, K, D) * w_of_tok[..., None].to(x.dtype)).sum(dim=1)
    out = out.reshape(B, S, D)
    if cfg.moe_use_residual:
        out = _residual_mix(cfg, p, x, out)
    stats = {"tokens_per_expert": metrics["tokens_per_expert"],
             "drop_fraction": metrics["drop_fraction"]}
    return out, stats
