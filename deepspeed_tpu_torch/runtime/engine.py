"""Training engine: ``initialize`` → ``TorchEngine.train_batch`` on one CUDA
device (or the CPU, when asked), or on each rank of a dp × sp world.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``initialize`` line 62,
``TpuEngine.train_batch`` line 2168, ``_train_step`` line 2038): bf16, fp16
or fp32 compute over fp32 master weights and the optimizers of
``runtime/optimizers.py``; on one rank any ZeRO stage (nothing to partition:
stage 0's step) and optimizer/parameter offload (lines 639-720: the
optimizer state in host memory stepped a layer at a time,
``runtime/bucketed_opt.py``, or on NVMe between steps,
``runtime/swap_tensor.py``; the masters in host memory under stage 3). An MoE model (Mixtral) trains at ep = 1, its loss
carrying the aux term. A step splits the global batch into ``gradient_accumulation_steps``
micro-batches; each micro-batch's loss is the mean over its own tokens, and
its fp32 gradient accumulates in the masters' ``.grad`` (the sum the JAX scan
carries), scaled by 1/accum at the end (``_compute_grads`` line 1579). Then
the global norm, the clip factor min(1, clip / (norm + 1e-6)) (line 1953), and
the optimizer update in place (line 1973), all on the device: the step reads
nothing back to the host except at a ``steps_per_print`` boundary (or every
step under ``wall_clock_breakdown``, whose device timer has to wait). The
returned loss is a device tensor. Under fp16 (``runtime/precision.py``,
JAX lines 1567-1630, 1942-1984, 2309-2319) each micro-batch's loss is
multiplied by the dynamic loss scale in fp32 before backward; after the
gradients' sum over the world they are multiplied by 1/scale (by
1/(accum·scale) after the micro-batches' fp32 sum); one flag, any
non-finite element of any rank's gradients (a max over the world), is the
step's one host read; on overflow no optimizer runs (masters, state and
counts stay as they were, no all-gather), ``global_steps`` advances and
``skipped_steps`` counts; the scale moves by the reference rules, and the
lr and the optimizers' counts read the un-skipped steps
(:attr:`TorchEngine.update_count`).

Beside ``train_batch`` the engine has DeepSpeed's imperative loop
(``engine(batch)``, ``engine.backward(loss)``, ``engine.step()``; JAX lines
2757-2807): ``forward`` gives a micro-batch's loss without a gradient,
``backward`` buffers the micro-batch, and ``step`` at the accumulation
boundary feeds the buffered micro-batches, concatenated, to ``train_batch``,
so the loop's update is ``train_batch``'s on the same global batch, bit for
bit. ``prepare_batch`` stages a global batch on the device once and
``train_batch_chain`` runs several steps (JAX lines 2141, 2448).

Checkpointing (JAX lines 2870-3010): ``save_checkpoint`` / ``load_checkpoint``
write and read the JAX package's layout under its leaf names
(``runtime/ckpt``: the fp32 masters, the optimizer state under the optax
chain's names, the loss scaler's state, the counters), sync
or with ``checkpoint.async_save`` behind a snapshot fence, so either package
resumes the other's checkpoints; ``save_16bit_model`` writes one bf16
safetensors file under the HF names (``integrations/hf.py``).

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
ZeRO stages 1 and 2 over the dp ranks (at sp_size 1; JAX ``zero_specs``) keep
the masters whole and split the rest (``runtime/zero/partition.py``): each
rank holds the optimizer state of its parts of the masters and updates only
those parts (one fused Adam launch a part on a card), then one all-gather
gives every rank the whole masters. Stage 1 sums the gradients over the
world as stage 0 does, so its step is stage 0's bit for bit; stage 2
reduce-scatters them, each rank keeping its parts' sums, and takes the
norm from the parts' sums of squares (one all-reduce). Stage 3 (JAX
``engine.py:521-572``) shards the masters too: each rank holds its part of
every leaf of ``stage3_param_persistence_threshold`` elements or more (a
stacked layer leaf cut within each layer), gathers each layer's weights on
use and releases them after (``runtime/zero/prefetch.py``, with the optional
one-layer-ahead prefetch), reduce-scatters the layer gradients in backward
and the embedding's and head's after it, all-reduces the persistent leaves'
gradients, and updates its parts with nothing to gather after. A checkpoint
holds whole leaves, gathered before rank 0 writes them.
"""

from __future__ import annotations

import os
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
from ..utils.tree import global_norm, tree_items, tree_leaves, tree_map, tree_size
from .activation_checkpointing import policy_by_name
from .bucketed_opt import BucketedOptimizer, _nbytes, bucketed_applicable
from .checkpointing import _barrier, _is_writer
from .lr_schedules import build_schedule
from .optimizers import build_optimizer
from .precision import LossScaleState, init_loss_scale, unscale_, update_loss_scale
from .swap_tensor import TensorSwapper, host_empty
from .zero import ShardedLeaf, ZeroPartition, storage_bytes
from .zero.prefetch import GatherScope, use_gather


def _enabled(section: Any) -> bool:
    return isinstance(section, dict) and bool(section.get("enabled"))


def planned_world(cfg: DeepSpeedConfig) -> int:
    """The number of ranks ``initialize`` will train on, known before it
    starts the world: the started process group's, else the launcher's
    ``WORLD_SIZE``, else one rank per sequence-parallel chunk."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(int(os.environ.get("WORLD_SIZE", "1") or 1), cfg.sequence_parallel.sp_size)


def unported_features(cfg: DeepSpeedConfig) -> List[str]:
    """The features a config turns on that a later slice of the port
    brings, each with its ROADMAP queue A item. ZeRO stages 1 and 2 run over
    dp ranks (item 7.2a), stage 3 too (item 7.2b); offload, a stage beside
    sequence parallelism, the quantized wires and the fsdp knobs over ranks
    are item 7.2c. fp16 trains wherever bf16 does (item 6, parts 1 and 2):
    at every stage on one rank and over dp ranks, with offload and with
    sp > 1; fp16 serves wherever bf16 serves (part 2's item 4,
    ``init_inference``)."""
    raw = cfg.raw
    zc = cfg.zero_config
    pipe = raw.get("pipeline") or {}
    tp = raw.get("tensor_parallel") or {}
    de = raw.get("data_efficiency") or {}
    comp = raw.get("compression_training") or {}
    world = planned_world(cfg)
    sp = cfg.sequence_parallel.sp_size
    wire = zc.resolved_grad_wire()
    pwire = zc.resolved_param_wire()  # fp32 below stage 3 (config.py)
    off = zc.offload_optimizer.enabled or zc.offload_param.enabled
    checks = [
        (world > 1 and zc.stage > 0 and sp > 1,
         f"ZeRO stage {zc.stage} (item 7) with sequence parallelism (sp_size {sp}): "
         f"stages over ranks with sp > 1 are item 7.2c; stages 1-3 run over dp "
         f"ranks at sp_size 1"),
        (world > 1 and zc.stage > 0 and wire != "fp32",
         f"ZeRO stage {zc.stage} over {world} ranks with grad_wire {wire} (item 7.2c, "
         f"the comm/wires.py codecs): the stages over ranks move fp32"),
        (world > 1 and zc.stage == 3 and pwire != "fp32",
         f"ZeRO stage 3 over {world} ranks with param_wire {pwire} (item 7.2c, the "
         f"comm/wires.py codecs): stage 3 gathers the compute dtype"),
        (world > 1 and (zc.zero_hpz_partition_size not in (0, 1, None)
                        or zc.mics_shard_size not in (-1, 0, None)),
         f"zero_hpz_partition_size {zc.zero_hpz_partition_size} / mics_shard_size "
         f"{zc.mics_shard_size} over {world} ranks (item 7.2c): the JAX package then "
         f"builds a dp x fsdp topology and cuts the stage-3 masters over fsdp only; the "
         f"port's dp x sp world has no fsdp axis"),
        (world > 1 and off,
         f"optimizer/parameter offload, NVMe included (item 7) over {world} ranks: "
         f"offload runs on one rank; over ranks it is item 7.2c"),
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
            "deepspeed_tpu_torch trains with bf16, fp16 or fp32, ZeRO stages 1-3 over dp "
            "ranks, every stage and offload on one rank; not yet ported (ROADMAP "
            "queue A): " + "; ".join(later)
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
            "(ROADMAP item 7.2c)")
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
        if on_cuda and tk.flash_attention and self.compute_dtype == torch.float32:
            raise NotImplementedError(
                "the CUDA flash-attention kernels take bfloat16 or float16: enable bf16 "
                "or fp16, or set tpu_kernels.flash_attention to false"
            )
        self.fp16_enabled = config.fp16.enabled
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
        self._setup_state(params)
        self.global_steps = 0
        self.micro_steps = 0
        self.last_gather: Optional[GatherScope] = None  # the last stage-3 step's scope
        self._grad_bytes = (0, 0)  # state_bytes: the last update's gradients, transient
        self.skipped_steps = 0  # fp16 steps whose gradients overflowed
        self._loss_scale = init_loss_scale(config.fp16, self.fp16_enabled)
        self._checkpoint_guard = None
        self.training = True
        self._micro_buffer: List[Any] = []
        self._pending_batch = None
        self.last_chain_metrics: Optional[Dict[str, torch.Tensor]] = None
        self._metrics: Dict[str, Any] = {}
        self._timings: Dict[str, float] = {}
        log_dist(
            f"TorchEngine: {self._num_params / 1e6:.1f}M params, "
            f"compute {self.compute_dtype}, device {device}, batch "
            f"{config.train_batch_size} = {config.train_micro_batch_size_per_gpu}"
            f" x {config.gradient_accumulation_steps} x dp {self.topology.dp_size}, "
            f"{self.topology}, remat {self.remat_policy}, kernels {tk}"
        )

    def _setup_state(self, params) -> None:
        """The masters and the optimizer state, placed by the ZeRO section
        (JAX ``engine.py:521``, ``:639-720``). Over dp ranks, stages 1 and 2
        keep on each rank the optimizer state of its parts of the masters
        only (``runtime/zero/partition.py``); the masters stay whole. Stage 3
        keeps of each leaf over the persistence threshold only this rank's
        part, the master cut from the broadcast whole one. At one
        rank a stage partitions nothing, so stages 1-3 train as stage 0, bit
        for bit. ``offload_optimizer``:
        ``cpu`` keeps the state in host memory (page-locked on a card) and
        steps it a layer at a time (``bucketed_opt.py``); ``nvme`` keeps it in
        files under ``nvme_path/zero_opt_swap`` between steps (``TensorSwapper``;
        the resident layout, read back while forward and backward run and
        written behind the update). ``offload_param`` (stage 3) keeps the fp32
        masters in host memory: forward and backward read a device copy, the
        update streams them beside the state."""
        zc = self.config.zero_config
        off_opt, off_par = zc.offload_optimizer, zc.offload_param
        on_cuda = self.device.type == "cuda"
        self._partition: Optional[ZeroPartition] = None
        self._num_params = tree_size(params)
        # each leaf's membership of the stacked layers group (tree_leaves order)
        self._stacked = [n.startswith("['layers']") for n, _ in tree_items(params)]
        if zc.stage > 0 and self.topology.dp_size > 1:
            stage3 = zc.stage == 3
            self._partition = ZeroPartition(
                [t.shape for t in tree_leaves(params)], self.topology.group("dp"),
                stacked=self._stacked if stage3 else None,
                threshold=zc.stage3_param_persistence_threshold)
            part = self._partition
            log_dist(f"ZeRO stage {zc.stage} over dp {part.dp}: {len(part.sharded)} leaves "
                     f"sharded, {len(part.replicated)} replicated"
                     + (f", {len(part.gathered)} masters held as parts (threshold "
                        f"{zc.stage3_param_persistence_threshold})" if stage3 else ""))
            if stage3:  # the whole masters go: each rank keeps its parts
                cut = iter(part.cut(tree_leaves(params)))
                params = tree_map(lambda _: next(cut), params)
        elif zc.stage > 0:
            log_dist(f"ZeRO stage {zc.stage} on one rank: nothing to partition, the step "
                     f"is stage 0's")
        if off_par.device == "nvme":
            log_dist("offload_param.device=nvme: params stage in pinned host memory (disk "
                     "swap applies to optimizer state via offload_optimizer.device=nvme)")
        self._param_offload = off_par.enabled
        self._bucketed: Optional[BucketedOptimizer] = None
        self._swapper: Optional[TensorSwapper] = None
        if off_opt.device == "cpu":
            if not bucketed_applicable(params):
                raise ValueError("offload_optimizer.device cpu steps the stacked 'layers' "
                                 "group a layer at a time; this model's parameters have none")
            self._bucketed = BucketedOptimizer(
                self.optimizer, pin=on_cuda and off_opt.pin_memory, offload_param=self._param_offload)
            self.opt_state = self._bucketed.init(params)
            self._bucketed.timing = self.config.wall_clock_breakdown
        elif self._partition is not None:
            parts = iter(self._partition.parts(tree_leaves(params)))
            self.opt_state = self.optimizer.init(tree_map(lambda _: next(parts), params))
        else:
            self.opt_state = self.optimizer.init(params)
        if off_opt.device == "nvme":
            self._swapper = TensorSwapper(
                os.path.join(off_opt.nvme_path, "zero_opt_swap"), reuse_buffers=on_cuda,
                pin=on_cuda and off_opt.pin_memory)
            self._swapped_bytes = sum(_nbytes(t) for t in tree_leaves(self.opt_state))
            self._swapper.swap_out("opt_state", self.opt_state)  # on disk between steps
            self.opt_state = None
        # fp16 under offload_param: the card's copy of the masters in the
        # compute dtype, made on first use and refreshed by an applied update
        # only (the update casts each master it moves into it), so a skipped
        # step moves no master between host and card
        self._compute_copy = None
        if self._param_offload:
            pin = on_cuda and off_par.pin_memory
            self.params = tree_map(lambda t: host_empty(t.shape, t.dtype, pin).copy_(t), params)
        else:
            self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.offload_stream = self._offload_stream()

    def _offload_stream(self) -> Optional[Dict[str, Any]]:
        """The bytes one step moves between host (or disk) and device (JAX
        ``_compute_offload_stream``): the update's ``bytes_in`` and
        ``bytes_out``, ``slot_bytes`` (one layer of the stacked group),
        ``slots``, ``layers``, ``double_buffer``; beside JAX's fields
        ``forward_bytes_in`` (under ``offload_param`` the device copy of the
        masters that forward and backward read) and ``device``; None when
        nothing is offloaded."""
        fwd = sum(_nbytes(t) for t in tree_leaves(self.params)) if self._param_offload else 0
        if self._bucketed is not None:
            return {**self._bucketed.stream_bytes(
                self.opt_state, self.params if self._param_offload else None),
                "forward_bytes_in": fwd, "device": "cpu"}
        swapped = self._swapped_bytes if self._swapper is not None else 0
        if not swapped + fwd:
            return None
        return {"bytes_in": swapped, "bytes_out": swapped + fwd, "slot_bytes": swapped + fwd,
                "slots": 1, "layers": 0, "double_buffer": False, "forward_bytes_in": fwd,
                "device": "nvme" if self._swapper is not None else "cpu"}

    @property
    def offloaded(self) -> bool:
        """Whether any state rests off the device (host memory or disk)."""
        return self._bucketed is not None or self._swapper is not None or self._param_offload

    def host_state_bytes(self) -> int:
        """Host bytes the engine's offloaded state holds: the bucketed state,
        the host masters, the swapper's buffers."""
        total = 0
        if self._bucketed is not None and self.opt_state is not None:
            total += sum(_nbytes(t) for t in tree_leaves(self.opt_state))
        if self._param_offload and self.params is not None:
            total += sum(_nbytes(t) for t in tree_leaves(self.params))
        if self._swapper is not None:
            total += self._swapper.held_bytes()
        return total

    def state_bytes(self) -> Dict[str, int]:
        """This rank's device bytes of the training state, each read from the
        live tensors: the fp32 ``masters`` (at stage 3 over ranks this rank's
        parts, and the persistent leaves whole), the optimizer state
        (``optimizer``; under ZeRO over dp ranks this rank's parts), the
        ``gradients`` the last update read (whole, or at stages 2 and 3 over
        ranks this rank's parts of the summed gradients; 0 before the first
        step) and ``total``, their sum. Beside them ``gradients_transient``:
        the gradient bytes alive at once at the last step's gradient
        collective, the whole gradients that backward left, the collective's
        buffer and what it returned (at stage 2 as at stage 0: the whole
        gradients stand until the reduce-scatter; at stage 3 the most at any
        of its collectives: the parts' gradients so far, one layer's whole
        gradient or the embedding's and head's, and the call's buffers).
        Offloaded state counts in :meth:`host_state_bytes` instead."""
        masters = 0 if self._param_offload else sum(_nbytes(t) for t in tree_leaves(self.params))
        resident = self._bucketed is None and self._swapper is None
        optimizer = sum(_nbytes(t) for t in tree_leaves(self.opt_state)) if resident else 0
        grads, transient = self._grad_bytes
        return {"masters": masters, "optimizer": optimizer, "gradients": grads,
                "total": masters + optimizer + grads, "gradients_transient": transient}

    @property
    def _stage2(self) -> bool:
        """Gradients reduce-scattered after backward (ZeRO stage 2 over dp ranks)."""
        return self._partition is not None and self.config.zero_config.stage == 2

    @property
    def _stage3(self) -> bool:
        """Masters sharded and gathered on use (ZeRO stage 3 over dp ranks)."""
        return self._partition is not None and self.config.zero_config.stage == 3

    def _gather_scope(self, params) -> Optional[GatherScope]:
        """A new stage-3 gather scope over the masters ``params`` (None below
        stage 3); the last one stays in ``last_gather`` with its counters."""
        if not self._stage3:
            return None
        self.last_gather = GatherScope(self._partition, tree_leaves(params), self._stacked,
                                       prefetch=self.config.zero_config.layer_prefetch)
        return self.last_gather

    def _step_params(self, grad: bool):
        """The masters forward and backward read: the device masters, or
        under ``offload_param`` a device copy of the host masters (JAX
        ``_device_params``), a leaf needing its gradient when ``grad``. Under
        fp16 that copy is the compute copy widened on the device: the compute
        dtype's cast of it is the cast of the masters, bit for bit, so forward,
        backward and the fp32 gradients are the resident run's."""
        if not self._param_offload:
            return self.params
        if not self.fp16_enabled:
            return tree_map(lambda h: h.to(self.device, non_blocking=True, copy=True)
                            .requires_grad_(grad), self.params)
        if self._compute_copy is None:
            self._compute_copy = tree_map(
                lambda h: h.to(self.device, non_blocking=True).to(self.compute_dtype),
                self.params)
        return tree_map(lambda c: c.float().requires_grad_(grad), self._compute_copy)

    def _quiesce(self) -> None:
        """Wait for the copies into host memory still in flight (the offloaded
        update's), before the host reads that memory."""
        if self.offloaded and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _update(self, params, grads, clip, step: int) -> None:
        """The optimizer half of the step (JAX ``_apply_update``), its lr and
        counts those of update ``step``."""
        if self._bucketed is not None:
            self._bucketed.step(params, grads, self.opt_state, step, clip,
                                host_params=self.params if self._param_offload else None,
                                compute=self._compute_copy)
            return
        if self._swapper is not None:  # its reads started before forward (not under fp16)
            self.opt_state = self._swapper.swap_in("opt_state", device=self.device)
        if self._compute_copy is not None:
            # the step's leaves widen the compute copy; the update takes the
            # masters themselves, moved in on this applied step only
            params = tree_map(lambda h: h.to(self.device, non_blocking=True, copy=True),
                              self.params)
        self.optimizer.step(params, grads, self.opt_state, step, clip)
        if self._param_offload:
            with torch.no_grad():
                for h, d in zip(tree_leaves(self.params), tree_leaves(params)):
                    h.copy_(d, non_blocking=True)
                if self._compute_copy is not None:
                    for c, d in zip(tree_leaves(self._compute_copy), tree_leaves(params)):
                        c.copy_(d)
        if self._swapper is not None:
            # the writes run on the aio threads behind the rest of this step;
            # the next train_batch's prefetch waits for them before its reads
            self._swapper.swap_out("opt_state", self.opt_state, blocking=False)
            self.opt_state = None

    def _update_parts(self, params, grads: List[torch.Tensor], clip, step: int) -> None:
        """ZeRO over dp ranks: the optimizer on this rank's parts of the
        masters (from the whole summed gradients at stage 1, from this rank's
        parts of them at stage 2; at stage 3 the held parts from their
        parts, the persistent leaves as at stage 1), then every rank's parts
        of the whole masters all-gathered into them (none at stage 3 but the
        persistent ones)."""
        part = self._partition
        leaves = tree_leaves(params)
        self.optimizer.step_leaves(
            part.parts(leaves), grads if self._stage2 else part.parts(grads),
            self.optimizer.slot_leaves(self.opt_state), step, clip, partition=part)
        with torch.no_grad():
            part.gather_(leaves)

    @property
    def update_count(self) -> int:
        """The optimizer updates done: the steps less the fp16 overflow skips
        (JAX's ``state.step``, ``new_step`` at line 2027), which the lr
        schedule and every optimizer's counts read."""
        return self.global_steps - self.skipped_steps

    def _unscale(self, leaves: List[torch.Tensor], scale, accum: int) -> bool:
        """fp16: the gradients (this rank's, after their sum over the world)
        times 1/scale, or 1/(accum * scale) after the micro-batches' fp32
        sum, the factor computed in fp32 (JAX lines 1597-1598, 1629-1630),
        and whether any element of any rank's gradients is not finite (one
        flag, the max over the world, read on the host: the step's one
        sync)."""
        one = np.float32(1.0)
        inv = float(one / scale if accum == 1 else one / (np.float32(accum) * scale))
        flag = unscale_(leaves, inv).to(self.device)
        if self._world is not None:
            all_reduce(flag, self._world, op="max")
        return bool(flag.item())

    def _swap_in_opt(self) -> None:
        """NVMe: the state back on the device (a no-op when resident)."""
        if self._swapper is not None and self.opt_state is None:
            self.opt_state = self._swapper.swap_in("opt_state", device=self.device)

    def _swap_out_opt(self) -> None:
        """NVMe: the state to disk and off the device (blocking)."""
        if self._swapper is not None and self.opt_state is not None:
            self._swapper.swap_out("opt_state", self.opt_state)
            self.opt_state = None

    # ------------------------------------------------------------- helpers
    def _kernel_scope(self, gather: Optional[GatherScope] = None) -> ExitStack:
        """This engine's kernel selection, scoped to one step, with the
        stage-3 ``gather`` scope entered when given."""
        tk = self.tpu_kernels
        stack = ExitStack()
        stack.enter_context(use_gather(gather))
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
    def _flat_over_world(leaves: List[torch.Tensor], op) -> int:
        """``op`` (a collective in place) on ``leaves`` as one flat buffer:
        one call, and one host buffer where the transport stages. Returns
        the flat buffer's bytes."""
        flat = torch.cat([t.reshape(-1) for t in leaves])
        op(flat)
        for t, part in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(part.view_as(t))
        return flat.nbytes

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
        if self._swapper is not None and self.opt_state is None and not self.fp16_enabled:
            # NVMe: the state's reads run on the aio threads under forward and
            # backward (JAX train_batch's swap-in between its two programs);
            # under fp16 they wait for the overflow test, so a skipped step
            # reads nothing
            self._swapper.prefetch("opt_state", device=self.device)
        params = self._step_params(True)
        loss_sum = m_sum = None
        scale = self._loss_scale.scale
        gather = self._gather_scope(params)
        with self._kernel_scope(gather):
            for i in range(accum):
                mb = {k: v[i] for k, v in prepared.items()}
                loss, m = self.model.loss(
                    params, mb, dtype=self.compute_dtype, train=True,
                    remat_policy=self.remat_policy,
                    num_tokens=None if num_tokens is None else num_tokens[i])
                if gather is not None:  # its prefetch runs the layers backwards
                    gather.backward = True
                # fp16: the loss times the scale in fp32 (JAX _loss_for, line 1567)
                (loss * float(scale) if self.fp16_enabled else loss).backward()
                if gather is not None:
                    gather.backward = False
                loss = loss.detach()
                m = {k: v.detach() for k, v in m.items()}
                loss_sum = loss if loss_sum is None else loss_sum + loss
                m_sum = m if m_sum is None else {k: m_sum[k] + v for k, v in m.items()}
        # the model's metrics over the micro-batches: counts ("tokens") summed,
        # the rest the mean (JAX _compute_grads)
        shares = [k for k in m_sum if k != "tokens"]
        breakdown = cfg.wall_clock_breakdown and self.offloaded
        if breakdown:
            self._sync()
            t_fb = time.perf_counter()
        if gather is not None:  # the layers' parts came in backward; the rest now
            leaves, grads = gather.reduce_grads(), None
            transient = gather.transient
        else:
            grads = tree_map(lambda p: p.grad, params)
            leaves = tree_leaves(grads)
            transient = storage_bytes(leaves)  # the whole gradients backward left
        if self._world is not None:  # the ranks' shares of the batch's loss, gradient
            all_reduce(loss_sum, self._world)
            if shares:
                total = torch.stack([m_sum[k] for k in shares])
                all_reduce(total, self._world)
                m_sum.update(zip(shares, total.unbind()))
            if self._stage2:  # this rank's parts of the sum; the whole gradients go
                leaves = self._partition.reduce_scatter_grads(leaves)
                transient += self._partition.send_bytes + storage_bytes(leaves)
                for p in tree_leaves(params):
                    p.grad = None
                grads = None
            elif gather is None:
                transient += self._flat_over_world(leaves, lambda f: all_reduce(f, self._world))
        self._grad_bytes = (storage_bytes(leaves), transient)
        overflow = False
        if self.fp16_enabled:
            overflow = self._unscale(leaves, scale, accum)
        elif accum > 1:
            for g in leaves:
                g.mul_(1.0 / accum)
        if self._stage2:
            gnorm = self._partition.square_sums(leaves).sum().sqrt()
        elif self._stage3 and self._partition.gathered:
            gnorm = self._partition.square_sums(
                leaves, sharded=self._partition.gathered).sum().sqrt()
        else:
            gnorm = global_norm(leaves)
        clip = None
        if cfg.gradient_clipping > 0:
            clip = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
        step = self.update_count
        if not overflow:  # a skipped step leaves the masters and optimizer state as they were
            if self._partition is not None:
                self._update_parts(params, leaves, clip, step)
            else:
                self._update(params, grads, clip, step)
        for p in tree_leaves(params):
            p.grad = None
        del grads, leaves, params
        lr = self.lr_schedule(step)
        self.global_steps += 1
        self.micro_steps += accum
        self._loss_scale = update_loss_scale(self._loss_scale, overflow, cfg.fp16,
                                             self.fp16_enabled)
        if overflow:
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: fp16 overflow, skipping update (new scale "
                     f"{float(self._loss_scale.scale)})")
        loss = loss_sum / accum
        self._metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "overflow": overflow,
                         "loss_scale": float(self._loss_scale.scale),
                         **{k: v if k == "tokens" else v / accum for k, v in m_sum.items()}}
        if cfg.wall_clock_breakdown:
            t2 = time.perf_counter()
            self._sync()
            t3 = time.perf_counter()
            self._timings = {"batch_prep": (t1 - t0) * 1e3,
                             "step_dispatch": (t2 - t1) * 1e3,
                             "step_device": (t3 - t2) * 1e3}
            if breakdown:  # the offloaded step's halves, and the layer stream's device ms
                self._timings.update({"fwd_bwd": (t_fb - t1) * 1e3, "update": (t3 - t_fb) * 1e3})
                if self._bucketed is not None:
                    self._timings.update({f"stream_{k}": v
                                          for k, v in self._bucketed.last_ms.items()})
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
        params = self._step_params(False)
        with torch.no_grad(), self._kernel_scope(self._gather_scope(params)):
            loss, _ = self.model.loss(params, self._shard(full, 0),
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

    # --------------------------------------------------------- checkpointing
    def rng_key(self) -> List[int]:
        """The metadata's ``rng``: ``jax.random.PRNGKey(seed)`` of the
        config's seed as two uint32 words, which the JAX package's loader
        reads as its engine key. The port draws nothing from a key after
        ``initialize`` (its masters come from a ``torch.Generator``), so a
        resumed run continues the same whatever key is stored."""
        seed = self.config.seed
        return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]

    def checkpoint_components(self) -> Dict[str, List]:
        """The checkpoint's components as named leaves, each in the JAX
        engine's flatten order: ``params`` the fp32 masters, ``opt_state``
        the optimizer's state under the optax chain's names with its update
        counts (:attr:`update_count`), ``loss_scale`` the scaler's live state
        (JAX ``precision.py:LossScaleState``: under fp16 the dynamic scale, its
        good steps and hysteresis left; a bf16/fp32 run's stays scale 1, no
        good steps, the configured hysteresis). Under ZeRO over
        dp ranks a sharded state leaf, and at stage 3 a master held as its
        part, is a :class:`ShardedLeaf` (the whole leaf's shape; a copy into
        it keeps this rank's part, and its ``whole()`` gathers it, every rank
        together)."""
        if self._swapper is not None and self.opt_state is None:
            raise RuntimeError("the NVMe-offloaded optimizer state is on disk: "
                               "save_checkpoint / load_checkpoint swap it in first")
        self._quiesce()  # the offloaded update's copies into host memory have landed
        opt = (self._bucketed.state_items(self.opt_state, self.update_count)
               if self._bucketed is not None
               else self.optimizer.state_items(self.opt_state, self.update_count))
        if self._partition is not None:
            opt = self._sharded_state(opt)
        held = self._held_masters()
        return {
            "params": [(n, held.get(id(t), t)) for n, t in tree_items(self.params, True)],
            "opt_state": opt,
            "loss_scale": [(f".{k}", np.asarray(v)) for k, v in self._loss_scale._asdict().items()],
        }

    def _slot_parts(self):
        """Per slot, its leaves in ``tree_leaves`` order (each aligned with
        the partition's plan)."""
        return [tree_leaves(self.opt_state[name]) for name in self.optimizer.slots]

    def _sharded_state(self, named: List) -> List:
        part = self._partition
        entry = {id(t): e for parts in self._slot_parts() for t, e in zip(parts, part.plan)}
        return [(n, ShardedLeaf(t, entry[id(t)], part.group)
                 if isinstance(t, torch.Tensor) and entry[id(t)].sharded else t)
                for n, t in named]

    def check_restored(self, restored: Dict[str, Dict[str, np.ndarray]],
                       meta: Dict[str, Any]) -> None:
        """Refuse a checkpoint this engine cannot continue: a manifest whose
        ``step`` (the updates done, JAX's ``state.step``; older manifests
        without it: ``global_steps - skipped_steps``) is not its
        ``global_steps`` less its ``skipped_steps``, or an optimizer update
        count other than that ``step`` (Adam's bias correction and the lr
        schedule run on it)."""
        done = int(meta["global_steps"]) - int(meta.get("skipped_steps", 0))
        step = int(meta.get("step", done))
        if step != done:
            raise ValueError(
                f"checkpoint step {step} (the optimizer's update count) != global_steps "
                f"{meta['global_steps']} - skipped_steps {meta.get('skipped_steps', 0)}")
        for name, count in restored.get("opt_state", {}).items():
            count = np.asarray(count)  # a bucketed state's ['layers'] counts are [L]
            if np.any(count != step):
                raise ValueError(
                    f"checkpoint optimizer count {name} = {count.tolist()} != step "
                    f"{step}: this engine cannot resume a state whose updates and "
                    f"steps differ")

    def restore_loss_scale(self, leaves: Dict[str, np.ndarray]) -> None:
        """The scaler's state from a checkpoint's ``loss_scale`` leaves (a
        leaf missing keeps its value); under bf16/fp32 it is kept, not
        applied, as the JAX package's scaler update is a no-op there."""
        cur = self._loss_scale._asdict()
        self._loss_scale = LossScaleState(**{
            k: type(v)(leaves[f".{k}"]) if f".{k}" in leaves else v for k, v in cur.items()})

    def check_layout(self, meta: Dict[str, Any]) -> None:
        """Refuse a checkpoint whose optimizer state is laid out otherwise
        than this engine's: the bucketed per-layer state of an
        ``offload_optimizer: cpu`` run (``['rest']`` / ``['layers']``, the
        JAX package's too) and the resident one (one optax chain over the
        whole tree) hold the same numbers under other names and shapes."""
        names = (meta.get("components", {}).get("opt_state") or {}).get("leaf_names")
        if not names:
            return
        stored = all(n.startswith(("['rest']", "['layers']")) for n in names)
        mine = self._bucketed is not None
        if stored != mine:
            def layout(bucketed):
                return ("the bucketed per-layer layout ({'rest', 'layers'}, of an "
                        "offload_optimizer cpu run)" if bucketed
                        else "the resident layout (one optax chain over the whole tree)")
            raise ValueError(f"checkpoint optimizer state is in {layout(stored)}; this "
                             f"engine's is in {layout(mine)}: set offload_optimizer as "
                             f"the saving run did")

    def _ckpt_guard(self):
        """This engine's CheckpointGuard (pinned snapshot buffers on a card)."""
        if self._checkpoint_guard is None:
            from .ckpt import CheckpointGuard

            self._checkpoint_guard = CheckpointGuard(pin=self.device.type == "cuda")
        return self._checkpoint_guard

    def save_checkpoint(self, save_dir, tag=None, client_state=None, async_save=None) -> str:
        """Parity: DeepSpeedEngine.save_checkpoint (JAX line 2946). Writes
        ``save_dir/tag`` (``global_step{N}`` by default): sync, or with
        ``async_save`` (default: the config's ``checkpoint.async_save``) the
        files on a writer thread after a snapshot fence, the next step free
        to run. The first save arms the SIGTERM handler that commits a final
        save (``checkpoint.on_preempt``). Only rank 0 writes; every rank
        calls. Returns the tag's directory."""
        from .ckpt import install_preempt_handler
        from .ckpt import save_checkpoint as _save

        ckpt_cfg = self.config.checkpoint
        if async_save is None:
            async_save = bool(ckpt_cfg.async_save)
        if ckpt_cfg.on_preempt == "save":
            install_preempt_handler(self, save_dir)
        self._swap_in_opt()  # NVMe: swap in, save, swap out (JAX lines 2966-2976)
        try:
            return _save(self, save_dir, self._ckpt_guard(), tag=tag,
                         client_state=client_state or {}, async_save=async_save)
        finally:
            self._swap_out_opt()

    def load_checkpoint(self, load_dir, tag=None, strict: bool = True):
        """Parity: DeepSpeedEngine.load_checkpoint (JAX line 2980): the
        newest committed tag (or ``tag``) copied into the masters and the
        optimizer state in place, the counters restored; a checkpoint of the
        JAX package, from any mesh or ZeRO stage, loads too. ``strict=False``
        keeps the current value of a missing or reshaped leaf. Returns
        ``(path, client_state)``, ``(None, {})`` when nothing is committed."""
        from .ckpt import load_checkpoint as _load

        if self._checkpoint_guard is not None:
            self._checkpoint_guard.fence()  # never read a tag still being written
        self._swap_in_opt()  # the loader fills the state in place
        try:
            return _load(self, load_dir, tag=tag, strict=strict)
        finally:
            self._swap_out_opt()
            self._compute_copy = None  # the masters changed under it

    def _held_masters(self) -> Dict[int, ShardedLeaf]:
        """Stage 3 over ranks: each master held as this rank's part, by the
        part's id, as a :class:`ShardedLeaf` (empty below stage 3)."""
        if not self._stage3:
            return {}
        part, leaves = self._partition, tree_leaves(self.params)
        return {id(leaves[i]): ShardedLeaf(leaves[i], part.plan[i], part.group)
                for i in part.gathered}

    def whole_params(self, dtype: Optional[torch.dtype] = None):
        """The whole fp32 masters as a tree: at stage 3 over ranks each held
        part gathered a leaf at a time (every rank calls), each leaf cast to
        ``dtype`` right after its gather when given; else the masters
        themselves."""
        held = self._held_masters()
        if not held:
            return self.params

        def whole(t):
            w = held[id(t)].whole() if id(t) in held else t
            return w if dtype is None else w.to(dtype)

        it = iter([whole(t) for t in tree_leaves(self.params)])
        return tree_map(lambda _: next(it), self.params)

    def save_16bit_model(self, save_dir, save_filename: str = "model.safetensors") -> str:
        """Parity: DeepSpeedEngine.save_16bit_model (JAX line 2870): the
        masters in bf16 (round to nearest even, on the device) in one
        safetensors file, no optimizer state, under the HF names for the
        llama/mistral, gpt2, bloom and mixtral families and the keystr names
        otherwise. The family is the one the config's name starts with, so
        the ``llama3-*`` presets export under the HF Llama names, where the
        JAX package, which takes the name up to its first "-", writes keystr
        names for them. At stage 3 over ranks each held leaf is gathered and
        cast to bf16 in turn (every rank calls; the export only moves
        elements, so the file is stage 0's byte for byte), whatever
        ``stage3_gather_16bit_weights_on_model_save`` says, as the JAX
        package's. Only rank 0 writes. Returns the file's path."""
        import os

        from ..integrations.hf import HF_FAMILIES, export_hf_state_dict, write_safetensors

        name = str(getattr(self.model.config, "name", "")).lower()
        fam = next((f for f in HF_FAMILIES if name.startswith(f)), name.split("-")[0])
        self._quiesce()
        with torch.no_grad():
            params = self.whole_params(torch.bfloat16)  # stage 3: one leaf at a time
            if fam in HF_FAMILIES:
                flat = export_hf_state_dict(params, self.model.config, fam)
                log_dist(f"save_16bit_model: HF state_dict names ({fam})")
            else:
                flat = dict(tree_items(params, sort_keys=True))
                log_dist(f"save_16bit_model: family {fam!r} has no HF exporter; writing "
                         "internal keystr names (same-framework reload only)")
            flat = {k: v.detach().to(torch.bfloat16) if v.is_floating_point() else v.detach()
                    for k, v in flat.items()}
        path = os.path.join(save_dir, save_filename)
        if _is_writer():
            os.makedirs(save_dir, exist_ok=True)
            write_safetensors(path, flat)
        _barrier("save_16bit_model")
        return path

    def destroy(self) -> None:
        """Parity: DeepSpeedEngine.destroy: land an in-flight async save (a
        writer failure is logged, teardown does not raise) and drop the
        state, so the device memory can be reused; the SIGTERM handler
        forgets the engine."""
        from .ckpt import unregister_preempt

        if self._checkpoint_guard is not None:
            self._checkpoint_guard.drain()
            self._checkpoint_guard = None
        unregister_preempt(self)
        if self._swapper is not None:
            self._swapper.release("opt_state")
            self._swapper.close()
            self._swapper = None
        self._quiesce()
        self.params = self.opt_state = self._compute_copy = None
        self._micro_buffer, self._pending_batch, self._metrics = [], None, {}

    # ----------------------------------------------------------- properties
    @property
    def lr(self) -> float:
        return float(self.lr_schedule(self.update_count))

    def get_lr(self):
        return [self.lr]

    @property
    def loss_scale(self) -> float:
        """The live loss scale (1 unless fp16, or a restored fp16 state)."""
        return float(self._loss_scale.scale)

    def get_global_grad_norm(self) -> float:
        g = self._metrics.get("grad_norm")
        return float(g) if g is not None else 0.0

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps
