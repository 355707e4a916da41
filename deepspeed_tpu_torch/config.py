"""DeepSpeed-compatible configuration: the sections the one-device training
step reads.

Counterpart of ``deepspeed_tpu/config.py``. It accepts the same
``ds_config.json`` (a dict or a path), resolves the batch triangle
(``train_batch_size = micro_batch * gradient_accumulation_steps * dp``, dp = 1
on one device), and types the sections the training step reads: optimizer,
scheduler, fp16/bf16, ZeRO stage, activation-checkpointing policy, gradient
clipping, logging, ``tpu_kernels`` (which kernels replace the plain
paths; ``"auto"`` resolves on for a CUDA device as the JAX package's does for
a TPU), ``sparse_attention`` (the block-sparse layout of training's
attention), ``sequence_parallel`` (``sp_size`` and the ``mode``, Ulysses
or ring; the ``sequence_parallel_size`` shorthand), ``moe`` (with its
``overlap_a2a`` subsection, a bool or "auto" spelling normalised) and
``checkpoint`` (the async save, ``keep_last``, the preemption save). It raises
:class:`DeepSpeedConfigError` for the same bad inputs as the JAX package: a
batch-triangle mismatch, fp16 and bf16 both on, a ZeRO stage out of range, an
unknown remat policy, negative clipping, an unknown sparse-attention mode or
one combined with sequence parallelism or random-LTD, and here also an
unknown sequence-parallel mode or a size below 1, and a checkpoint engine
other than "native". Every other section
is kept raw in :attr:`DeepSpeedConfig.raw`; ``initialize`` refuses the ones a
later slice ports when they are turned on.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

import torch

from .runtime.activation_checkpointing import KNOWN_POLICIES
from .utils.logging import log_dist

AUTO = "auto"


class DeepSpeedConfigError(ValueError):
    pass


def _get(d: Dict[str, Any], key: str, default=None):
    v = d.get(key, default)
    return default if v == AUTO else v


def _parse_dc(cls, section):
    """Build dataclass ``cls`` from dict ``section``, ignoring unknown keys."""
    names = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in dict(section or {}).items() if k in names})


@dataclass
class OptimizerConfig:
    """The "optimizer" section."""

    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)

    @property
    def lr(self) -> float:
        return float(self.params.get("lr", 1e-3))

    @property
    def betas(self) -> Tuple[float, float]:
        betas = self.params.get("betas", (0.9, 0.999))
        return (float(betas[0]), float(betas[1]))

    @property
    def eps(self) -> float:
        return float(self.params.get("eps", 1e-8))

    @property
    def weight_decay(self) -> float:
        return float(self.params.get("weight_decay", 0.0))


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class FP16Config:
    """The "fp16" section, dynamic loss-scaling knobs included."""

    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == 0.0

    @property
    def initial_scale(self) -> float:
        """The static ``loss_scale``, or 2**initial_scale_power (JAX
        ``config.py:96``)."""
        if not self.dynamic:
            return float(self.loss_scale)
        return float(2.0 ** self.initial_scale_power)


@dataclass
class BF16Config:
    enabled: bool = False
    accumulate_grads_in_fp32: bool = True


@dataclass
class OffloadConfig:
    """The "offload_optimizer" / "offload_param" subsections (JAX
    ``config.py:110``). The port accepts and ignores ``buffer_count``,
    ``buffer_size`` and ``max_in_cpu``: its swap buffers are one pooled
    generation of the state's own leaves."""

    device: str = "none"  # none | cpu | nvme
    nvme_path: Optional[str] = None
    pin_memory: bool = True

    @property
    def enabled(self) -> bool:
        return self.device not in ("none", None)


@dataclass
class ZeroConfig:
    """The "zero_optimization" section's stage and offload (JAX
    ``config.py:126``). The port accepts and ignores ``sub_group_size`` (the
    offloaded update steps one layer at a time by construction, as the JAX
    package's does) and ``offload_double_buffer`` / ``sub_group_prefetch``
    (the layer stream is double buffered on a card and serial on the CPU,
    bitwise equal). The wire knobs are read (JAX ``config.py:163-196``):
    the stages over ranks move fp32 only, so ``initialize`` refuses another
    resolved codec there. The stage-3 knobs (JAX ``config.py:154-161``):
    ``stage3_param_persistence_threshold`` (a leaf of fewer elements stays
    whole), ``stage3_layer_prefetch`` (alias ``zero3_prefetch``; true, false
    or "auto", which resolves off as the JAX package's empty knob table does;
    ignored with a log line below stage 3) and
    ``stage3_gather_16bit_weights_on_model_save`` (read; ``save_16bit_model``
    gathers at stage 3 whatever its value, as the JAX package's does).
    ``zero_hpz_partition_size`` and ``mics_shard_size`` shard over an
    ``fsdp`` axis: the JAX ``initialize`` builds a dp x fsdp topology of that
    size when it makes the topology itself (``runtime/engine.py:135-138``,
    ``:149-152``) and cuts the stage-3 masters over fsdp only. The port's dp x
    sp world has no fsdp axis: ``initialize`` refuses them over ranks (ROADMAP
    item 7.2c); on one rank, where there is nothing to shard, they are logged
    and ignored."""

    stage: int = 0
    offload_optimizer: OffloadConfig = field(default_factory=OffloadConfig)
    offload_param: OffloadConfig = field(default_factory=OffloadConfig)
    stage3_param_persistence_threshold: int = 10**5
    stage3_layer_prefetch: Any = False  # bool | "auto"
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    grad_wire: str = "auto"  # auto | fp32 | bf16 | int8 | int4
    param_wire: str = "auto"

    WIRE_CODECS = ("auto", "fp32", "bf16", "int8", "int4")

    def resolved_grad_wire(self) -> str:
        """The gradient reduce-scatter's codec: "auto" is int8 under
        ``zero_quantized_gradients``, else fp32."""
        if self.grad_wire != "auto":
            return self.grad_wire
        return "int8" if self.zero_quantized_gradients else "fp32"

    def resolved_param_wire(self) -> str:
        """The stage-3 parameter gather's codec: "auto" is int8 under
        ``zero_quantized_weights``, else fp32."""
        if self.param_wire != "auto":
            return self.param_wire
        return "int8" if self.zero_quantized_weights else "fp32"

    @property
    def layer_prefetch(self) -> bool:
        """``stage3_layer_prefetch`` resolved: "auto" is off."""
        return self.stage3_layer_prefetch is True

    def __post_init__(self):
        for name in ("offload_optimizer", "offload_param"):
            v = getattr(self, name)
            if not isinstance(v, OffloadConfig):
                setattr(self, name, _parse_dc(OffloadConfig, v))
        if not isinstance(self.stage3_layer_prefetch, str):  # JSON 0/1
            self.stage3_layer_prefetch = bool(self.stage3_layer_prefetch)

    def validate(self) -> None:
        """JAX ``ZeroConfig.validate`` (``config.py:199-236``)."""
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")
        for off in (self.offload_optimizer, self.offload_param):
            if off.device not in ("none", "cpu", "nvme", None):
                raise DeepSpeedConfigError(
                    f"offload device must be none|cpu|nvme, got {off.device}")
            if off.device == "nvme" and not off.nvme_path:
                raise DeepSpeedConfigError("nvme offload requires nvme_path")
        if self.offload_param.enabled and self.stage != 3:
            raise DeepSpeedConfigError("offload_param requires ZeRO stage 3")
        if (self.zero_quantized_weights or self.zero_quantized_gradients) and self.stage != 3:
            raise DeepSpeedConfigError(
                "zero_quantized_weights/gradients (ZeRO++) require stage 3")
        if not isinstance(self.stage3_layer_prefetch, bool) \
                and self.stage3_layer_prefetch != AUTO:
            raise DeepSpeedConfigError(
                f"zero_optimization.stage3_layer_prefetch must be true, false or "
                f"\"auto\", got {self.stage3_layer_prefetch!r}")
        for knob in ("grad_wire", "param_wire"):
            if getattr(self, knob) not in self.WIRE_CODECS:
                raise DeepSpeedConfigError(
                    f"zero_optimization.{knob} must be one of {self.WIRE_CODECS}, "
                    f"got {getattr(self, knob)!r}")
        if self.resolved_grad_wire() != "fp32" and self.stage < 1:
            raise DeepSpeedConfigError(
                "zero_optimization.grad_wire requires ZeRO stage >= 1 (stage 0 has "
                "no gradient reduce-scatter to compress)")
        if self.resolved_param_wire() != "fp32" and self.stage != 3:
            raise DeepSpeedConfigError(
                "zero_optimization.param_wire requires ZeRO stage 3 (below it "
                "parameters are never gathered over a wire)")


@dataclass
class ActivationCheckpointingConfig:
    """The "activation_checkpointing" policy."""

    policy: str = "none"

    def validate(self) -> None:
        if self.policy not in (None, "none") and self.policy not in KNOWN_POLICIES:
            raise DeepSpeedConfigError(
                f"activation_checkpointing.policy {self.policy!r} is unknown; "
                f"have none, {', '.join(sorted(KNOWN_POLICIES))}"
            )


@dataclass
class TpuKernelsConfig:
    """Which hand-written kernels replace the plain paths (the JAX
    package's section name). ``"auto"`` resolves on for a CUDA device and
    off elsewhere. Every switch defaults to ``"auto"``: where the JAX
    package defaults the RMSNorm and Adam kernels off, XLA fuses the plain
    versions, but here the plain versions run as separate torch ops and are
    never the faster choice on the card. ``False`` opts out."""

    flash_attention: Any = AUTO
    fused_rmsnorm: Any = AUTO
    fused_adam: Any = AUTO
    fused_ce: Any = AUTO  # vocab-chunked cross-entropy (ops/cross_entropy.py)
    ce_chunk: int = 4096

    def resolve(self, on_cuda: bool) -> "TpuKernelsConfig":
        def res(v):
            return on_cuda if v == AUTO else bool(v)

        return TpuKernelsConfig(
            flash_attention=res(self.flash_attention),
            fused_rmsnorm=res(self.fused_rmsnorm),
            fused_adam=res(self.fused_adam),
            fused_ce=res(self.fused_ce),
            ce_chunk=int(self.ce_chunk),
        )


@dataclass
class CheckpointConfig:
    """The "checkpoint" section (JAX ``config.py:913``): ``async_save`` (the
    write overlaps the next steps; the snapshot fence is the only synchronous
    cost), ``keep_last`` (the newest N committed tags, 0 keeps all) and
    ``on_preempt`` ("save": SIGTERM commits a final sync save). ``engine`` is
    "native" (shard ``.npy`` files); "orbax" is refused: Orbax is a JAX
    library and no torch reader of its format exists. JAX's
    ``save_interval_steps`` is accepted and ignored: only its analysis
    pricing reads it, which the port does not have."""

    engine: str = "native"
    async_save: bool = False
    keep_last: int = 0
    on_preempt: str = "save"

    def validate(self) -> None:
        if self.engine == "orbax":
            raise DeepSpeedConfigError(
                "checkpoint.engine 'orbax' is not available in deepspeed_tpu_torch: "
                "Orbax is a JAX library and no torch reader of its format exists; "
                "use 'native' (the shard .npy layout both packages read)")
        if self.engine != "native":
            raise DeepSpeedConfigError(
                f"checkpoint.engine must be 'native' or 'orbax', got {self.engine!r}")
        if self.keep_last < 0:
            raise DeepSpeedConfigError(
                f"checkpoint.keep_last must be >= 0, got {self.keep_last}")
        if self.on_preempt not in ("save", "none"):
            raise DeepSpeedConfigError(
                f"checkpoint.on_preempt must be 'save' or 'none', got "
                f"{self.on_preempt!r}")


@dataclass
class SparseAttentionConfig:
    """The "sparse_attention" section (the reference's
    ``sparsity_config.py`` schemas; JAX ``config.py:958``): the block-sparse
    layout the training engine's attention runs (``ops/sparse_attention.py``)."""

    mode: str = "none"  # none | dense | fixed | bigbird | bslongformer | variable
    block: int = 128  # layout block in tokens: a multiple of 128 dividing S
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_random_blocks: int = 1
    global_block_indices: List[int] = field(default_factory=lambda: [0])

    def validate(self) -> None:
        modes = ("none", "dense", "fixed", "bigbird", "bslongformer", "variable")
        if self.mode not in modes:
            raise DeepSpeedConfigError(
                f"sparse_attention.mode must be one of {modes}, got {self.mode!r}"
            )


@dataclass
class SequenceParallelConfig:
    """The "sequence_parallel" section (JAX ``config.py:906``): the sp
    degree and how attention crosses the sequence chunks
    (``parallel/sequence.py``)."""

    sp_size: int = 1
    mode: str = "ulysses"  # ulysses | ring

    def validate(self) -> None:
        if self.mode not in ("ulysses", "ring"):
            raise DeepSpeedConfigError(
                f"sequence_parallel.mode must be ulysses or ring, got {self.mode!r}")
        if int(self.sp_size) < 1:
            raise DeepSpeedConfigError(
                f"sequence_parallel.sp_size must be >= 1, got {self.sp_size}")
        self.sp_size = int(self.sp_size)


@dataclass
class MoEOverlapA2AConfig:
    """"moe.overlap_a2a" (JAX ``config.py:307``): the expert exchange
    decomposed into chunked ring hops at ep > 1. At ep = 1 there is no
    exchange: ``initialize`` logs the knob turned on and ignores it."""

    enabled: Any = False  # bool | "auto"
    chunks: int = 1
    bidirectional: bool = False

    def validate(self) -> None:
        _check_tristate("moe.overlap_a2a.enabled", self.enabled)
        if int(self.chunks) < 1:
            raise DeepSpeedConfigError(
                f"moe.overlap_a2a.chunks must be >= 1, got {self.chunks}")


@dataclass
class MoEConfig:
    """The "moe" section (JAX ``config.py:338``). ``initialize`` reads only
    ``enabled``, ``ep_size`` and ``overlap_a2a``, as the JAX engine does: the
    model's own ``moe_*`` fields set top-k, capacity and the loss
    coefficients."""

    enabled: bool = False
    ep_size: int = 1
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3
    drop_tokens: bool = True
    use_residual: bool = False
    overlap_a2a: MoEOverlapA2AConfig = field(default_factory=MoEOverlapA2AConfig)

    def __post_init__(self):
        # the nested section arrives as a dict, or as a bare bool / "auto"
        if isinstance(self.overlap_a2a, bool) or self.overlap_a2a == AUTO:
            self.overlap_a2a = MoEOverlapA2AConfig(enabled=self.overlap_a2a)
        elif isinstance(self.overlap_a2a, dict):
            self.overlap_a2a = _parse_dc(MoEOverlapA2AConfig, self.overlap_a2a)


def _check_tristate(name: str, v) -> None:
    if v not in (True, False, AUTO):
        raise DeepSpeedConfigError(f"{name} must be true|false|\"auto\", got {v!r}")


@dataclass
class SpecDecodeConfig:
    """The "serving.spec" section: speculative decoding inside the slot
    engine (each decode slot drafts up to ``max_draft`` n-gram tokens; the
    one step verifies every window). The serving engine refuses it turned
    on: ROADMAP A4 ports it."""

    enabled: Any = False  # bool | "auto" ("auto" resolves off: no knob table)
    max_draft: int = 4
    draft: str = "ngram"
    ngram_n: int = 3

    def validate(self) -> None:
        if int(self.max_draft) < 1:
            raise DeepSpeedConfigError(
                f"serving.spec.max_draft must be >= 1, got {self.max_draft}")
        if self.draft != "ngram":
            raise DeepSpeedConfigError(
                'serving.spec.draft must be "ngram" (host-side n-gram / '
                f"prompt-lookup), got {self.draft!r}")
        if int(self.ngram_n) < 1:
            raise DeepSpeedConfigError(
                f"serving.spec.ngram_n must be >= 1, got {self.ngram_n}")


@dataclass
class FleetConfig:
    """The "serving.fleet" section's switch (the replicated serving tier);
    its other keys are not read. Refused turned on: ROADMAP A9."""

    enabled: bool = False


@dataclass
class ServingConfig:
    """The "serving" section: the continuous-batching runtime
    (``serving/``), the counterpart of ``deepspeed_tpu/config.py:526``.
    One step of fixed shape [max_slots, token_budget] takes whatever mix of
    prompt chunks and decode tokens the SplitFuse scheduler packs.

    Knobs left ``"auto"`` resolve as the JAX package resolves them on a
    miss of its measured knob table (the H100 has no such table):
    ``paged`` off, ``spec`` off, ``kv_cache_dtype`` the engine's dtype;
    ``moe_a2a`` is accepted and has no effect on a dense model."""

    max_slots: int = 8           # concurrent in-flight requests (KV slots)
    token_budget: int = 64       # tokens per step (the SplitFuse chunk width)
    queue_limit: int = 64        # bounded admission queue; 0 = unbounded
    request_timeout_s: float = 60.0   # queued longer than this -> EVICTED
    eviction_backoff_s: float = 1.0   # retry-after hint: backoff * 2**attempts
    max_tokens: int = 1024       # per-request prompt + output cap
    kv_cache_dtype: str = AUTO   # auto | bf16 | bfloat16 | int8
    paged: Any = False           # block-paged KV pool instead of slot regions
    page_size: int = 16          # tokens per KV page (paged)
    num_pages: int = 0           # pool pages; 0 = max_slots * pages_per_slot
    prefix_cache: bool = True    # shared read-only prefix pages (paged)
    host_pages: int = 0          # tiered KV behind the pool (refused: A4)
    moe_a2a: str = AUTO          # expert-exchange form (MoE serving: A9)
    spec: SpecDecodeConfig = field(default_factory=SpecDecodeConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)

    def __post_init__(self):
        if isinstance(self.spec, bool) or self.spec == AUTO:
            self.spec = SpecDecodeConfig(enabled=self.spec)
        if isinstance(self.spec, dict):
            self.spec = _parse_dc(SpecDecodeConfig, self.spec)
        if isinstance(self.fleet, dict):
            self.fleet = _parse_dc(FleetConfig, self.fleet)

    def resolve_auto(self) -> "ServingConfig":
        """The table-miss defaults of the JAX package's ``resolve_auto_knobs``
        for the knobs the port reads; ``kv_cache_dtype`` "auto" stays, and
        the engine reads it as its own dtype."""
        if self.paged == AUTO:
            self.paged = False
        if self.spec.enabled == AUTO:
            self.spec.enabled = False
        return self

    def pages_per_slot(self, max_tokens: Optional[int] = None) -> int:
        """Logical pages per slot: the per-request token cap plus the
        token_budget write margin (padded chunk tails never leave the mapped
        range). The engine passes its clamped max_tokens."""
        span = int(max_tokens if max_tokens is not None
                   else self.max_tokens) + int(self.token_budget)
        return -(-span // int(self.page_size))

    def validate(self) -> None:
        if int(self.max_slots) < 1:
            raise DeepSpeedConfigError(
                f"serving.max_slots must be >= 1, got {self.max_slots}")
        if int(self.token_budget) < 1:
            raise DeepSpeedConfigError(
                f"serving.token_budget must be >= 1, got {self.token_budget}")
        if int(self.queue_limit) < 0:
            raise DeepSpeedConfigError(
                f"serving.queue_limit must be >= 0, got {self.queue_limit}")
        if float(self.request_timeout_s) <= 0:
            raise DeepSpeedConfigError(
                "serving.request_timeout_s must be > 0, got "
                f"{self.request_timeout_s}")
        if self.kv_cache_dtype not in (AUTO, "int8", "bf16", "bfloat16"):
            raise DeepSpeedConfigError(
                "serving.kv_cache_dtype must be auto|bf16|bfloat16|int8, "
                f"got {self.kv_cache_dtype!r}")
        if int(self.page_size) < 1:
            raise DeepSpeedConfigError(
                f"serving.page_size must be >= 1, got {self.page_size}")
        if int(self.num_pages) < 0:
            raise DeepSpeedConfigError(
                f"serving.num_pages must be >= 0 (0 = auto), got {self.num_pages}")
        if self.moe_a2a not in (AUTO, "stock", "chunked"):
            raise DeepSpeedConfigError(
                f"serving.moe_a2a must be auto|stock|chunked, got {self.moe_a2a!r}")
        if int(self.host_pages) < 0:
            raise DeepSpeedConfigError(
                f"serving.host_pages must be >= 0 (0 = untiered), got "
                f"{self.host_pages}")
        if int(self.host_pages) > 0 and self.paged is False:
            raise DeepSpeedConfigError(
                "serving.host_pages > 0 requires serving.paged: the host tier "
                "demotes and promotes pages of the block-paged arena")
        _check_tristate("serving.spec.enabled", self.spec.enabled)
        _check_tristate("serving.paged", self.paged)
        if self.spec.enabled is True:
            self.spec.validate()
            if int(self.spec.max_draft) + 1 > int(self.token_budget):
                raise DeepSpeedConfigError(
                    f"serving.spec.max_draft {self.spec.max_draft} needs "
                    f"max_draft + 1 <= token_budget {self.token_budget}")


class DeepSpeedConfig:
    """Parsed and validated ds_config (a dict or a json path); the batch
    triangle resolves when ``dp_world_size`` is given (``initialize`` gives
    1)."""

    def __init__(self, config, dp_world_size: Optional[int] = None):
        if isinstance(config, (str, os.PathLike)):
            with open(config, "r") as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise DeepSpeedConfigError(f"config must be dict or path, got {type(config)}")
        self.raw: Dict[str, Any] = copy.deepcopy(config)
        d = self.raw

        self.train_batch_size = _get(d, "train_batch_size")
        self.train_micro_batch_size_per_gpu = _get(d, "train_micro_batch_size_per_gpu")
        self.gradient_accumulation_steps = _get(d, "gradient_accumulation_steps")
        if dp_world_size is not None:
            self.resolve_batch_sizes(dp_world_size)

        self.steps_per_print = int(_get(d, "steps_per_print", 10) or 10)
        self.wall_clock_breakdown = bool(_get(d, "wall_clock_breakdown", False))
        self.gradient_clipping = float(_get(d, "gradient_clipping", 0.0) or 0.0)
        self.seed = int(_get(d, "seed", 1234) or 1234)

        opt = d.get("optimizer") or {}
        self.optimizer = OptimizerConfig(
            type=str(opt.get("type", "adamw")).lower(), params=dict(opt.get("params", {}))
        )
        sched = d.get("scheduler") or {}
        self.scheduler = SchedulerConfig(
            type=(sched.get("type") or None), params=dict(sched.get("params", {}))
        )
        self.fp16 = _parse_dc(FP16Config, d.get("fp16"))
        self.bf16 = _parse_dc(BF16Config, d.get("bf16"))
        zo = dict(d.get("zero_optimization") or {})
        for knob in ("offload_double_buffer", "sub_group_prefetch"):
            if knob in zo:
                log_dist(f"zero_optimization.{knob} is ignored: the offloaded layer "
                         f"stream is double buffered on a card and serial on the CPU")
        if "zero3_prefetch" in zo:  # the alias (JAX config.py:1071)
            zo.setdefault("stage3_layer_prefetch", zo.pop("zero3_prefetch"))
        self.zero_config = _parse_dc(ZeroConfig, zo)
        zc = self.zero_config
        if zc.stage3_layer_prefetch is not False and zc.stage != 3:
            log_dist(f"zero_optimization.stage3_layer_prefetch: stage {zc.stage} has no "
                     f"parameter gathers to prefetch, knob ignored")
        for knob, off in (("zero_hpz_partition_size", 1), ("mics_shard_size", -1)):
            if getattr(zc, knob) not in (off, 0, None):
                log_dist(f"zero_optimization.{knob}: shards over an fsdp axis, which one "
                         f"rank does not have, knob ignored (refused over ranks)")
        self.activation_checkpointing = _parse_dc(
            ActivationCheckpointingConfig, d.get("activation_checkpointing"))
        self.tpu_kernels = _parse_dc(TpuKernelsConfig, d.get("tpu_kernels"))
        self.sparse_attention = _parse_dc(SparseAttentionConfig, d.get("sparse_attention"))
        sp = dict(d.get("sequence_parallel") or {})
        if "sequence_parallel_size" in d:  # the shorthand (JAX config.py:1102)
            sp.setdefault("sp_size", d["sequence_parallel_size"])
        self.sequence_parallel = _parse_dc(SequenceParallelConfig, sp)
        self.moe = _parse_dc(MoEConfig, d.get("moe"))
        self.checkpoint = _parse_dc(CheckpointConfig, d.get("checkpoint"))
        self._validate()

    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        tb, mb, ga = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                      self.gradient_accumulation_steps)
        if tb is not None and mb is not None and ga is not None:
            if tb != mb * ga * dp_world_size:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} != micro_batch {mb} * grad_accum "
                    f"{ga} * dp {dp_world_size}")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} "
                    f"* dp {dp_world_size}")
            ga = tb // (mb * dp_world_size)
        elif tb is not None and ga is not None:
            if tb % (ga * dp_world_size) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by grad_accum {ga} "
                    f"* dp {dp_world_size}")
            mb = tb // (ga * dp_world_size)
        elif mb is not None:
            ga = ga or 1
            tb = mb * ga * dp_world_size
        elif tb is not None:
            ga = 1
            if tb % dp_world_size != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by dp world size "
                    f"{dp_world_size}")
            mb = tb // dp_world_size
        else:
            tb, mb, ga = dp_world_size, 1, 1
        self.train_batch_size, self.train_micro_batch_size_per_gpu = int(tb), int(mb)
        self.gradient_accumulation_steps = int(ga)

    def _validate(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.zero_config.validate()
        if self.gradient_clipping < 0:
            raise DeepSpeedConfigError("gradient_clipping must be >= 0")
        self.activation_checkpointing.validate()
        self.sparse_attention.validate()
        self.sequence_parallel.validate()
        self.moe.overlap_a2a.validate()
        self.checkpoint.validate()
        # the section the second rule reads stays raw (refused turned on);
        # the JAX package's texts (config.py:1236-1250)
        ltd = ((self.raw.get("data_efficiency") or {}).get("data_routing")
               or {}).get("random_ltd")
        if self.sparse_attention.mode not in ("none", "dense") and \
                self.sequence_parallel.sp_size > 1:
            raise DeepSpeedConfigError(
                "sparse_attention is not supported together with sequence "
                "parallelism (the block layout assumes full-sequence tiles)"
            )
        if self.sparse_attention.mode not in ("none", "dense") and (ltd or {}).get("enabled"):
            raise DeepSpeedConfigError(
                "sparse_attention is not supported together with random_ltd "
                "(LTD layers attend over gathered token subsets whose length "
                "is not block-aligned with the sparse layout)"
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.raw)
