"""Training engine: ``initialize`` → ``TorchEngine.train_batch`` on one CUDA
device (or the CPU, when asked), or on each rank of a dp × sp world.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``initialize`` line 62,
``TpuEngine.train_batch`` line 2168, ``_train_step`` line 2038) at ZeRO stage
0, bf16 (or fp32) compute over fp32 master weights, and the optimizers of
``runtime/optimizers.py``. An MoE model (Mixtral) trains at ep = 1, its loss
carrying the aux term. A step splits the global batch into ``gradient_accumulation_steps``
micro-batches; each micro-batch's loss is the mean over its own tokens, and
its fp32 gradient accumulates in the masters' ``.grad`` (the sum the JAX scan
carries), scaled by 1/accum at the end (``_compute_grads`` line 1579). Then
the global norm, the clip factor min(1, clip / (norm + 1e-6)) (line 1953), and
the optimizer update in place (line 1973), all on the device: the step reads
nothing back to the host except at a ``steps_per_print`` boundary (or every
step under ``wall_clock_breakdown``, whose device timer has to wait). The
returned loss is a device tensor.

Beside ``train_batch`` the engine has DeepSpeed's imperative loop
(``engine(batch)``, ``engine.backward(loss)``, ``engine.step()``; JAX lines
2757-2807): ``forward`` gives a micro-batch's loss without a gradient,
``backward`` buffers the micro-batch, and ``step`` at the accumulation
boundary feeds the buffered micro-batches, concatenated, to ``train_batch``,
so the loop's update is ``train_batch``'s on the same global batch, bit for
bit. ``prepare_batch`` stages a global batch on the device once and
``train_batch_chain`` runs several steps (JAX lines 2141, 2448).

Where the JAX engine traces one program, the port runs eagerly: the
``tpu_kernels`` section picks the kernels (flash attention forward and
backward, the RMSNorm or LayerNorm kernels, the fused Adam kernel, the chunked CE) through
scoped selections entered around each step; the ``sparse_attention`` section
swaps in the flash kernels' block-sparse form. A batch may carry
``segment_ids`` and ``positions`` (packed documents) beside ``input_ids``
and ``labels``. Everything outside this slice
raises ``NotImplementedError`` naming the ROADMAP item that ports it.

Across ranks (``torch.distributed``, the world laid out dp × sp by
``comm.MeshTopology``; JAX ``initialize`` lines 133-160), the engine does
explicitly what the JAX package's SPMD program does for free: the fp32
masters are broadcast from rank 0; every rank takes the same global batch,
builds the labels on the whole sequence, then keeps its dp rows and its sp
chunk of the sequence; each rank's loss is its NLL sum over the micro-batch's
valid tokens in the whole world, so the ranks' losses sum to the batch mean;
the gradients are summed over the world before the norm and the clip; and
``train_batch`` returns the global loss on every rank. Attention crosses the
sequence chunks by the ``sequence_parallel`` mode (``parallel/sequence.py``).
"""

from __future__ import annotations

import time
from contextlib import ExitStack, contextmanager
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import comm
from ..accelerator import resolve_device
from ..comm.collectives import all_reduce, broadcast
from ..comm.topology import MeshTopology, ParallelDims
from ..config import DeepSpeedConfig
from ..models.sharding import use_topology
from ..models.transformer import check_supported, make_lm_batch
from ..ops.attention import attention_impl
from ..ops.cross_entropy import fused_ce_scope
from ..ops.normalization import kernel_rmsnorm_scope
from ..ops.sparse_attention import from_ds_config, make_attention_impl
from ..utils.logging import log_dist
from ..utils.tree import global_norm, tree_leaves, tree_map, tree_size
from .activation_checkpointing import policy_by_name
from .lr_schedules import build_schedule
from .optimizers import build_optimizer


def _enabled(section: Any) -> bool:
    return isinstance(section, dict) and bool(section.get("enabled"))


def unported_features(cfg: DeepSpeedConfig) -> List[str]:
    """The features a config turns on that a later slice of the port
    brings, each with its ROADMAP queue A item."""
    raw = cfg.raw
    zo = raw.get("zero_optimization") or {}
    pipe = raw.get("pipeline") or {}
    tp = raw.get("tensor_parallel") or {}
    de = raw.get("data_efficiency") or {}
    comp = raw.get("compression_training") or {}
    checks = [
        (cfg.fp16.enabled, "fp16 and its loss scaler (item 6)"),
        (cfg.zero_config.stage > 0, f"ZeRO stage {cfg.zero_config.stage} (item 7)"),
        (any((zo.get(k) or {}).get("device", "none") not in ("none", None)
             for k in ("offload_optimizer", "offload_param")),
         "optimizer/parameter offload, NVMe included (item 7)"),
        (int(pipe.get("stages", pipe.get("num_stages", 1)) or 1) > 1,
         "pipeline parallelism (item 7)"),
        (int(tp.get("tp_size", tp.get("autotp_size", 1)) or 1) > 1,
         "tensor parallelism (item 7)"),
        (cfg.moe.enabled and int(cfg.moe.ep_size) > 1,
         f"expert parallelism, moe.ep_size {cfg.moe.ep_size} (ROADMAP A7/A9)"),
        (_enabled(raw.get("progressive_layer_drop")),
         "progressive layer drop (item 11)"),
        (_enabled(de) or _enabled(raw.get("curriculum_learning"))
         or _enabled((de.get("data_routing") or {}).get("random_ltd"))
         or _enabled((de.get("data_sampling") or {}).get("curriculum_learning")),
         "data efficiency: random-LTD, curriculum (item 11)"),
        (any(_enabled((v or {}).get("shared_parameters")) or _enabled(v)
             for v in comp.values() if isinstance(v, dict)),
         "compression training (item 11)"),
        (cfg.optimizer.type.replace("_", "") in ("onebitadam", "zerooneadam",
                                                 "onebitlamb"),
         "1-bit optimizers (item 11)"),
        (any(_enabled(raw.get(k)) for k in (
            "steptrace", "healthwatch", "flops_profiler", "comms_logger",
            "tensorboard", "wandb", "csv_monitor")),
         "steptrace, healthwatch, profilers and monitors (item 10)"),
    ]
    return [what for on, what in checks if on]


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, rng: Optional[torch.Generator] = None,
               device=None):
    """Parity: ``deepspeed.initialize`` → (engine, engine, None, lr_scheduler).

    ``model`` follows the model protocol (``init``/``loss``, as
    ``models.transformer.TransformerModel``). ``model_parameters`` is a
    parameter tree (see ``models.convert.params_from_numpy``), copied to
    fp32 masters; without it the masters are drawn from ``rng`` (a
    ``torch.Generator`` on ``device``, seeded with the config's ``seed`` by
    default). ``device`` defaults to the current CUDA device; with no CUDA
    device it must be ``"cpu"``. The world is the process group that
    ``comm.init_distributed`` started (with the caller's backend), laid out
    dp × sp by the config's ``sequence_parallel.sp_size``; one process
    without a process group."""
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("initialize() requires config (dict or ds_config.json path)")
    if model is None:
        raise ValueError("initialize() requires model")
    later = []
    if optimizer is not None:
        later.append("a caller-built optimizer (item 6)")
    if lr_scheduler is not None:
        later.append("a caller-built lr scheduler (item 6)")
    if training_data is not None:
        later.append("training_data / the data loader (item 11)")
    cfg = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    later += unported_features(cfg)
    if later:
        raise NotImplementedError(
            "deepspeed_tpu_torch trains at ZeRO stage 0 with bf16/fp32; not yet "
            "ported (ROADMAP queue A): " + "; ".join(later)
        )
    sp = cfg.sequence_parallel.sp_size
    if comm.is_initialized() and comm.get_topology().sp_size == sp:
        topology = comm.get_topology()
    else:
        topology = comm.init_distributed(dims=ParallelDims(sp=sp))
    is_moe = bool(getattr(getattr(model, "config", None), "is_moe", False))
    if is_moe and topology.world_size > 1:
        raise NotImplementedError(
            "deepspeed_tpu_torch trains an MoE model on one rank: capacity and "
            "slots count the whole batch's tokens, which dp or sp > 1 split "
            "(ROADMAP A7)")
    if cfg.moe.overlap_a2a.enabled:
        # JAX engine.py:356-362: at ep = 1 there is no exchange to overlap
        log_dist("moe.overlap_a2a: "
                 + ("ep_size == 1 on this topology" if is_moe else "model is not MoE")
                 + " - no expert exchange to decompose, knob ignored")
    cfg.resolve_batch_sizes(topology.data_shard_size)
    engine = TorchEngine(model, cfg, device=resolve_device(device, "initialize"),
                         model_parameters=model_parameters, rng=rng, topology=topology)
    return engine, engine, None, engine.lr_scheduler


class PreparedBatch(dict):
    """A global batch staged on the engine's device (:meth:`TorchEngine.
    prepare_batch`): {field: [accum, micro, ...] tensor, this rank's part},
    and ``num_tokens``, per micro-batch the global count of valid tokens
    (None on one device)."""

    def __init__(self, fields: Dict[str, torch.Tensor], num_tokens: Optional[torch.Tensor]):
        super().__init__(fields)
        self.num_tokens = num_tokens


class TorchEngine:
    """Parity surface of ``TpuEngine``: train_batch, train_batch_chain,
    prepare_batch, eval_batch, the forward/backward/step loop, lr,
    global_steps, micro_steps, the grad norm; on one device, or on this
    rank of ``topology``'s dp × sp world."""

    def __init__(self, model, config: DeepSpeedConfig, *, device: torch.device,
                 model_parameters=None, rng: Optional[torch.Generator] = None,
                 topology: Optional[MeshTopology] = None):
        self.model = model
        self.config = config
        self.device = device
        self.topology = topology if topology is not None else MeshTopology()
        self._world = self.topology.world_group()
        if self.topology.sp_size > 1:
            # per topology, so two engines with different modes don't fight
            self.topology.sp_mode = config.sequence_parallel.mode
        check_supported(model.config)
        self.compute_dtype = config.compute_dtype
        self.remat_policy = config.activation_checkpointing.policy
        policy_by_name(self.remat_policy)  # raises for a policy not ported
        on_cuda = device.type == "cuda"
        tk = config.tpu_kernels.resolve(on_cuda)
        if on_cuda and tk.flash_attention and self.compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA flash-attention kernels take bfloat16: enable bf16, "
                "or set tpu_kernels.flash_attention to false"
            )
        self.tpu_kernels = tk
        # training-time block-sparse attention (the "sparse_attention"
        # section; JAX engine.py:296-319): the flash kernels' block-sparse
        # form, or its plain version with the flash switch off
        sp_cfg = from_ds_config(config.sparse_attention)
        self._sparse_impl = (make_attention_impl(sp_cfg, kernels=tk.flash_attention)
                             if sp_cfg is not None else None)
        self.lr_schedule = build_schedule(config.scheduler.type,
                                          config.scheduler.params,
                                          config.optimizer.lr)
        self.lr_scheduler = self.lr_schedule
        self.optimizer = build_optimizer(config.optimizer, self.lr_schedule,
                                         use_fused_adam=tk.fused_adam)
        if model_parameters is not None:
            params = tree_map(
                lambda t: torch.as_tensor(t).detach().to(
                    device=device, dtype=torch.float32, copy=True),
                model_parameters)
        else:
            gen = rng if rng is not None else \
                torch.Generator(device=device).manual_seed(config.seed)
            params = model.init(gen, dtype=torch.float32, device=device)
        if self._world is not None:  # one set of masters: rank 0's
            self._flat_over_world(tree_leaves(params), lambda f: broadcast(f, self._world, 0))
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.opt_state = self.optimizer.init(self.params)
        self.global_steps = 0
        self.micro_steps = 0
        self.training = True
        self._micro_buffer: List[Any] = []
        self._pending_batch = None
        self.last_chain_metrics: Optional[Dict[str, torch.Tensor]] = None
        self._metrics: Dict[str, Any] = {}
        self._timings: Dict[str, float] = {}
        log_dist(
            f"TorchEngine: {tree_size(self.params) / 1e6:.1f}M params, "
            f"compute {self.compute_dtype}, device {device}, batch "
            f"{config.train_batch_size} = {config.train_micro_batch_size_per_gpu}"
            f" x {config.gradient_accumulation_steps} x dp {self.topology.dp_size}, "
            f"{self.topology}, remat {self.remat_policy}, kernels {tk}"
        )

    # ------------------------------------------------------------- helpers
    def _kernel_scope(self) -> ExitStack:
        """This engine's kernel selection, scoped to one step."""
        tk = self.tpu_kernels
        stack = ExitStack()
        stack.enter_context(attention_impl(
            self._sparse_impl if self._sparse_impl is not None
            else ("flash" if tk.flash_attention else "plain")))
        stack.enter_context(kernel_rmsnorm_scope(tk.fused_rmsnorm))
        stack.enter_context(fused_ce_scope(tk.fused_ce, tk.ce_chunk))
        stack.enter_context(use_topology(self.topology))
        return stack

    def _to_device(self, v) -> torch.Tensor:
        """Token ids (and a packed batch's ``segment_ids`` and ``positions``)
        as int64 on the engine's device; a host batch goes through pinned
        memory so the copy does not wait for the device."""
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        t = t.long()
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _lm_batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {k: self._to_device(v) for k, v in batch.items()}
        return out if "labels" in out else make_lm_batch(out["input_ids"])

    def _shard(self, batch: Dict[str, torch.Tensor], row_dim: int) -> Dict[str, torch.Tensor]:
        """This rank's part of a global batch whose rows lie on ``row_dim``
        and sequence on the next dim: its dp rows, its sp chunk (the JAX
        batch sharding P(dp, sp)); the whole batch on one device."""
        topo = self.topology
        if topo.world_size == 1:
            return batch
        dp, sp = topo.dp_size, topo.sp_size
        out = {}
        for k, t in batch.items():
            rows, S = t.shape[row_dim], t.shape[row_dim + 1]
            if rows % dp or S % sp:
                raise ValueError(
                    f"batch field {k!r} of {rows} rows x {S} tokens does not split over "
                    f"dp={dp} rows and sp={sp} sequence chunks")
            t = t.narrow(row_dim, topo.coord("dp") * (rows // dp), rows // dp)
            out[k] = t.narrow(row_dim + 1, topo.coord("sp") * (S // sp), S // sp)
        return out

    def _num_tokens(self, labels: torch.Tensor, dims) -> Optional[torch.Tensor]:
        """The valid tokens of the global batch over ``dims``, each rank's CE
        denominator; None on one device (each loss counts its own)."""
        if self.topology.world_size == 1:
            return None
        return (labels >= 0).sum(dims).float().clamp(min=1.0)

    def _prepare_batch(self, batch) -> PreparedBatch:
        """Global batch → :class:`PreparedBatch`; a prepared one passes
        through as it is."""
        accum = self.config.gradient_accumulation_steps
        if isinstance(batch, PreparedBatch):
            if batch["input_ids"].shape[0] != accum or batch["input_ids"].device != self.device:
                raise ValueError("a batch prepared for another accumulation or device")
            return batch
        expect = self.config.train_batch_size
        out = {}
        for k, t in self._lm_batch(batch).items():
            if t.shape[0] != expect:
                raise ValueError(
                    f"batch field {k!r} has batch {t.shape[0]}, config "
                    f"train_batch_size={expect}")
            out[k] = t.reshape(accum, expect // accum, *t.shape[1:])
        return PreparedBatch(self._shard(out, 1), self._num_tokens(out["labels"], (1, 2)))

    @staticmethod
    def _flat_over_world(leaves: List[torch.Tensor], op) -> None:
        """``op`` (a collective in place) on ``leaves`` as one flat buffer:
        one call, and one host buffer where the transport stages."""
        flat = torch.cat([t.reshape(-1) for t in leaves])
        op(flat)
        for t, part in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(part.view_as(t))

    @staticmethod
    def _next_batch(data_iter):
        return next(data_iter) if hasattr(data_iter, "__next__") else data_iter

    # ---------------------------------------------------------------- API
    def train_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """One optimizer step over a global batch dict (``batch=``) or the
        next one from ``data_iter``; returns the mean micro-batch loss as a
        device tensor."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            batch = self._next_batch(data_iter)
        cfg = self.config
        t0 = time.perf_counter()
        prepared = self._prepare_batch(batch)
        num_tokens = prepared.num_tokens
        accum = cfg.gradient_accumulation_steps
        t1 = time.perf_counter()
        loss_sum = m_sum = None
        with self._kernel_scope():
            for i in range(accum):
                mb = {k: v[i] for k, v in prepared.items()}
                loss, m = self.model.loss(
                    self.params, mb, dtype=self.compute_dtype, train=True,
                    remat_policy=self.remat_policy,
                    num_tokens=None if num_tokens is None else num_tokens[i])
                loss.backward()
                loss = loss.detach()
                m = {k: v.detach() for k, v in m.items()}
                loss_sum = loss if loss_sum is None else loss_sum + loss
                m_sum = m if m_sum is None else {k: m_sum[k] + v for k, v in m.items()}
        # the model's metrics over the micro-batches: counts ("tokens") summed,
        # the rest the mean (JAX _compute_grads)
        shares = [k for k in m_sum if k != "tokens"]
        grads = tree_map(lambda p: p.grad, self.params)
        leaves = tree_leaves(grads)
        if self._world is not None:  # the ranks' shares of the batch's loss, gradient
            all_reduce(loss_sum, self._world)
            if shares:
                total = torch.stack([m_sum[k] for k in shares])
                all_reduce(total, self._world)
                m_sum.update(zip(shares, total.unbind()))
            self._flat_over_world(leaves, lambda f: all_reduce(f, self._world))
        if accum > 1:
            for g in leaves:
                g.mul_(1.0 / accum)
        gnorm = global_norm(leaves)
        clip = None
        if cfg.gradient_clipping > 0:
            clip = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
        self.optimizer.step(self.params, grads, self.opt_state, self.global_steps,
                            clip)
        for p in tree_leaves(self.params):
            p.grad = None
        lr = self.lr_schedule(self.global_steps)
        self.global_steps += 1
        self.micro_steps += accum
        loss = loss_sum / accum
        self._metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                         **{k: v if k == "tokens" else v / accum for k, v in m_sum.items()}}
        if cfg.wall_clock_breakdown:
            t2 = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._timings = {"batch_prep": (t1 - t0) * 1e3,
                             "step_dispatch": (t2 - t1) * 1e3,
                             "step_device": (time.perf_counter() - t2) * 1e3}
        if self.global_steps % cfg.steps_per_print == 0:
            msg = (f"step {self.global_steps}: loss={float(loss):.4f} "
                   f"lr={lr:.3e} gnorm={float(gnorm):.3f}")
            if "moe_aux_loss" in self._metrics and self.model.config.is_moe:
                msg += f" moe_aux={float(self._metrics['moe_aux_loss']):.4f}"
            if self._timings:
                msg += " " + " ".join(f"{k}={v:.2f}ms" for k, v in self._timings.items())
            log_dist(msg)
        return loss

    def train_batch_chain(self, batch=None, data_iter=None, steps: int = 1) -> torch.Tensor:
        """``steps`` optimizer steps (JAX line 2448): on ``batch`` each time,
        staged on the device once (:meth:`prepare_batch`), or on the next
        ``steps`` batches of ``data_iter``. Returns the stacked losses
        [steps]; the stacked metrics land in ``last_chain_metrics``. The
        steps are ``train_batch`` calls, bit for bit."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if batch is None and data_iter is None:
            raise ValueError("train_batch_chain needs batch or data_iter")
        if batch is not None:
            batch = self.prepare_batch(batch)
        losses, metrics = [], []
        for _ in range(steps):
            losses.append(self.train_batch(data_iter=data_iter, batch=batch))
            metrics.append(self._metrics)
        self.last_chain_metrics = {
            k: torch.stack([m[k] for m in metrics]) if isinstance(metrics[0][k], torch.Tensor)
            else torch.tensor([m[k] for m in metrics]) for k in metrics[0]}
        return torch.stack(losses)

    def prepare_batch(self, batch) -> PreparedBatch:
        """Stage a global batch on the engine's device in the layout
        ``train_batch`` takes (JAX line 2141); ``train_batch`` takes the
        result without a second upload."""
        return self._prepare_batch(batch)

    def _loss_no_grad(self, batch, train: bool) -> torch.Tensor:
        full = self._lm_batch(batch)
        with torch.no_grad(), self._kernel_scope():
            loss, _ = self.model.loss(self.params, self._shard(full, 0),
                                      dtype=self.compute_dtype, train=train,
                                      num_tokens=self._num_tokens(full["labels"], (0, 1)))
        if self._world is not None:
            all_reduce(loss, self._world)
        return loss

    def eval_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """Loss of a batch dict under the same weights, no gradient (an MoE
        model at the eval capacity)."""
        if batch is None:
            batch = self._next_batch(data_iter)
        return self._loss_no_grad(batch, train=False)

    # ------------------------------------------- the imperative training loop
    def forward(self, batch) -> torch.Tensor:
        """``engine(batch)``: the micro-batch's loss in the engine's mode,
        without a gradient; in train mode the batch is held for
        :meth:`backward` (JAX line 2757)."""
        if self.training:
            self._pending_batch = batch
        return self._loss_no_grad(batch, train=self.training)

    __call__ = forward

    def backward(self, loss=None, batch=None):
        """Buffer the micro-batch of the last :meth:`forward` (or ``batch``);
        the forward and backward run at the boundary inside :meth:`step`
        (JAX line 2781)."""
        mb = batch if batch is not None else self._pending_batch
        if mb is None:
            raise ValueError("backward() without a pending forward batch")
        self._micro_buffer.append(mb)
        self._pending_batch = None
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return len(self._micro_buffer) >= self.config.gradient_accumulation_steps

    def step(self) -> Optional[torch.Tensor]:
        """At the accumulation boundary, one ``train_batch`` over the buffered
        micro-batches, concatenated in order (the token-weighted loss sees the
        whole global batch); its loss, or None between boundaries (JAX line
        2794)."""
        if not self.is_gradient_accumulation_boundary():
            return None
        buffered, self._micro_buffer = self._micro_buffer, []
        merged = {k: torch.cat([self._to_device(mb[k]) for mb in buffered])
                  for k in buffered[0]}
        return self.train_batch(batch=merged)

    @property
    def module(self):
        """The wrapped model (DeepSpeedEngine.module)."""
        return self.model

    def train(self, mode: bool = True):
        """Set the mode :meth:`forward` runs in (an MoE model's capacity rule;
        whether the batch is held for :meth:`backward`)."""
        self.training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def zero_grad(self, set_to_none: bool = True):
        """Nothing to clear: gradients live only inside a step, which drops
        them at its end."""

    @contextmanager
    def no_sync(self):
        """DeepSpeedEngine.no_sync: the gradient sum over the world runs once
        at the boundary, so there is nothing to defer; refused under ZeRO >= 2
        as the reference refuses it (JAX line 2913)."""
        if self.config.zero_config.stage >= 2:
            raise RuntimeError(
                "no_sync is not supported with ZeRO stage >= 2 "
                "(gradient reduce-scatter is the partitioning step)")
        yield

    # ----------------------------------------------------------- properties
    @property
    def lr(self) -> float:
        return float(self.lr_schedule(self.global_steps))

    def get_lr(self):
        return [self.lr]

    @property
    def loss_scale(self) -> float:
        return 1.0  # no fp16 loss scaling on the ported path

    def get_global_grad_norm(self) -> float:
        g = self._metrics.get("grad_norm")
        return float(g) if g is not None else 0.0

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps
