"""Config subset of ``deepspeed_tpu/config/config.py``.

Serving: ``ServingConfig`` (:672) and ``SpeculativeConfig`` (:632) with
their validation unchanged; the port's engine accepts only
``speculative.mode == 'off'`` (see ``serving/api.ServingEngine``).

Training: the precision, optimizer, scheduler, ZeRO, parallel, comms-logger
(:213) and checkpoint (:981) sections and the root ``Config`` with its batch
triad (:1062-1192), copied with their validation. The JAX package's other
root sections (observability, monitor, compression, curriculum and the like)
are accepted as raw mappings so that a JAX config loads, and
``Config.check_ported`` raises ``NotImplementedError`` naming each one a
config sets, as it does for a tensor / pipeline / sequence degree above 1,
and for the combinations the port does not run (an expert degree above 1
at ZeRO stage 3, optimizer offload beside LAMB or the 1-bit optimizers,
the NVMe tier in fp16, the 1-bit optimizers above stage 1). The ``aio`` section
(:970) is ported. An unknown key raises ``ConfigError`` naming it, as in
JAX.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Union

from .base import ConfigError, ConfigModel

# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


@dataclass
class FP16Config(ConfigModel):
    """Reference: ``runtime/fp16`` config section (runtime/config.py FP16 keys)."""

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclass
class BF16Config(ConfigModel):
    """Mirrors the reference ``bf16`` section."""

    enabled: bool = False


# ---------------------------------------------------------------------------
# optimizer / scheduler
# ---------------------------------------------------------------------------


@dataclass
class OptimizerConfig(ConfigModel):
    """Reference: ``optimizer`` JSON section (runtime/config.py get_optimizer_params)."""

    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        known = {"adam", "adamw", "lamb", "adagrad", "sgd", "lion",
                 "onebitadam", "onebitlamb", "zerooneadam", "fusedadam", "cpuadam"}
        if self.type.lower() not in known:
            raise ConfigError(f"unknown optimizer type '{self.type}' (known: {sorted(known)})")


@dataclass
class SchedulerConfig(ConfigModel):
    """Reference: ``scheduler`` JSON section → runtime/lr_schedules.py."""

    type: str = "WarmupLR"
    params: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------


@dataclass
class OffloadParamConfig(ConfigModel):
    """Reference: runtime/zero/offload_config.py (DeepSpeedZeroOffloadParamConfig).

    ZeRO-3 parameter offload (``runtime/param_offload.py``): ``device``
    ``cpu`` keeps the layer stack and all of its fp32 state in host memory,
    ``nvme`` its 16-bit params in files under ``nvme_path``.
    ``buffer_size`` is the bytes of one streamed block of layers (at least
    one layer a block), as in JAX. ``buffer_count``, ``max_in_cpu`` and
    ``pin_memory`` are accepted so that JAX configs load, and ignored, as
    JAX ignores them (the executor streams through two pinned staging
    buffers of its own)."""

    device: str = "none"  # none | cpu | nvme
    nvme_path: str = "/local_nvme"
    buffer_count: int = 5          # ignored
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000   # ignored
    pin_memory: bool = False       # ignored

    def validate(self) -> None:
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"offload_param.device must be none|cpu|nvme, got {self.device}")


@dataclass
class OffloadOptimizerConfig(ConfigModel):
    """Reference: runtime/zero/offload_config.py (DeepSpeedZeroOffloadOptimizerConfig)."""

    device: str = "none"
    nvme_path: str = "/local_nvme"
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def validate(self) -> None:
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"offload_optimizer.device must be none|cpu|nvme, got {self.device}")


@dataclass
class ZeroConfig(ConfigModel):
    """Reference: runtime/zero/config.py:76 (DeepSpeedZeroConfig).

    The stages shard optimizer state (1), gradients (2) and parameters (3)
    over the data-parallel group (``parallel/zero.py``). Leaves of at most
    ``stage3_param_persistence_threshold`` elements stay whole at stage 3.
    Bucket / overlap knobs are accepted for config compatibility."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = False
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: OffloadParamConfig = field(default_factory=OffloadParamConfig)
    offload_optimizer: OffloadOptimizerConfig = field(default_factory=OffloadOptimizerConfig)
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False

    DEPRECATED = {
        "stage3_gather_fp16_weights_on_model_save": (
            "stage3_gather_16bit_weights_on_model_save", "renamed in reference v0.6"),
        "cpu_offload": (None, "use offload_optimizer.device=cpu"),
        "cpu_offload_params": (None, "use offload_param.device=cpu"),
    }

    def validate(self) -> None:
        if not 0 <= self.stage <= 3:
            raise ConfigError(f"zero_optimization.stage must be in [0,3], got {self.stage}")


# ---------------------------------------------------------------------------
# parallel topology
# ---------------------------------------------------------------------------


@dataclass
class ParallelConfig(ConfigModel):
    """Mesh-axis degrees (JAX ``ParallelConfig``). ``data_parallel_size`` 0
    means the process group's world size (1 without a group), as JAX's 0
    means every device. ``expert_parallel_size`` splits it into expert
    groups (``parallel/topology.py``); the port has no tensor / pipeline /
    sequence parallelism yet, so those degrees above 1 raise in
    ``Config.check_ported``."""

    data_parallel_size: int = 0
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    sequence_parallel_impl: str = "ulysses"

    def validate(self) -> None:
        for name in ("tensor_parallel_size", "pipeline_parallel_size",
                     "sequence_parallel_size", "expert_parallel_size"):
            if getattr(self, name) < 1:
                raise ConfigError(f"{name} must be >= 1")
        if self.sequence_parallel_impl not in ("ulysses", "ring"):
            raise ConfigError("sequence_parallel_impl must be 'ulysses' or "
                              f"'ring', got '{self.sequence_parallel_impl}'")


# ---------------------------------------------------------------------------
# comms logger / checkpoint
# ---------------------------------------------------------------------------


@dataclass
class CommsLoggerConfig(ConfigModel):
    """Reference: deepspeed/comm/config.py."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class CheckpointConfig(ConfigModel):
    """Reference: checkpoint section keys (tag_validation etc.)."""

    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False

    def validate(self) -> None:
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ConfigError("checkpoint.tag_validation must be "
                              "Ignore|Warn|Fail")


@dataclass
class AIOConfig(ConfigModel):
    """Reference: the ``aio`` section, the knobs of the async-I/O handle
    (``ops/aio.py``) the NVMe tier reads and writes through. The handle
    takes ``queue_depth`` and ``thread_count``; ``block_size``,
    ``single_submit`` and ``overlap_events`` are accepted so that JAX
    configs load, and ignored."""

    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


# ---------------------------------------------------------------------------
# root config
# ---------------------------------------------------------------------------

# root sections of the JAX config the port has no counterpart for yet
UNPORTED_SECTIONS = (
    "activation_checkpointing", "flops_profiler", "monitor",
    "observability", "resilience", "rlhf", "elasticity",
    "curriculum_learning", "progressive_layer_drop", "data_efficiency",
    "compression_training", "compile_cache",
    "tensorboard", "wandb", "csv_monitor")

# the optimizers whose grads cross the wire compressed (comm/compressed.py)
ONEBIT_OPTIMIZERS = ("onebitadam", "onebitlamb", "zerooneadam")
# the optimizers the offload tiers update on the host
OFFLOAD_OPTIMIZERS = ("adam", "adamw", "fusedadam", "cpuadam")


@dataclass
class Config(ConfigModel):
    """Root config — the training subset of JAX ``Config`` (:1062)."""

    train_batch_size: int = 0
    train_micro_batch_size_per_gpu: int = 0
    gradient_accumulation_steps: int = 0

    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    dump_state: bool = False
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    gradient_clipping: float = 0.0
    disable_allgather: bool = False
    communication_data_type: Optional[str] = None
    seed: int = 1234

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    aio: AIOConfig = field(default_factory=AIOConfig)

    # JAX sections without a port: kept as given, refused by check_ported
    activation_checkpointing: Optional[Dict[str, Any]] = None
    flops_profiler: Optional[Dict[str, Any]] = None
    monitor: Optional[Dict[str, Any]] = None
    observability: Optional[Dict[str, Any]] = None
    resilience: Optional[Dict[str, Any]] = None
    rlhf: Optional[Dict[str, Any]] = None
    elasticity: Optional[Dict[str, Any]] = None
    curriculum_learning: Optional[Dict[str, Any]] = None
    progressive_layer_drop: Optional[Dict[str, Any]] = None
    data_efficiency: Optional[Dict[str, Any]] = None
    compression_training: Optional[Dict[str, Any]] = None
    compile_cache: Optional[Dict[str, Any]] = None
    tensorboard: Optional[Dict[str, Any]] = None
    wandb: Optional[Dict[str, Any]] = None
    csv_monitor: Optional[Dict[str, Any]] = None

    DEPRECATED = {
        "train_micro_batch_size": ("train_micro_batch_size_per_gpu", "renamed"),
        "gradient_accumulation_dtype": (None, "grad accumulation is fp32"),
    }

    # -- batch triad ------------------------------------------------------
    def resolve_batch_sizes(self, dp_world_size: int) -> "Config":
        """Resolve (train_batch_size, micro_batch, grad_accum) given the data-
        parallel world size. Mirrors reference runtime/config.py:888
        ``_set_batch_related_parameters``: any two determine the third; one
        given infers the rest with grad_accum=1; none → error."""
        tb, mb, ga = self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps
        if tb and mb and ga:
            if tb != mb * ga * dp_world_size:
                raise ConfigError(
                    f"train_batch_size ({tb}) != micro_batch ({mb}) * grad_accum ({ga}) "
                    f"* dp_world ({dp_world_size})")
        elif tb and mb:
            ga, rem = divmod(tb, mb * dp_world_size)
            if rem or ga < 1:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} * dp {dp_world_size}")
        elif tb and ga:
            mb, rem = divmod(tb, ga * dp_world_size)
            if rem or mb < 1:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by grad_accum {ga} * dp {dp_world_size}")
        elif mb and ga:
            tb = mb * ga * dp_world_size
        elif tb:
            mb, rem = divmod(tb, dp_world_size)
            if rem:
                raise ConfigError(f"train_batch_size {tb} not divisible by dp world {dp_world_size}")
            ga = 1
        elif mb:
            ga = 1
            tb = mb * dp_world_size
        else:
            raise ConfigError(
                "one of train_batch_size / train_micro_batch_size_per_gpu must be set")
        return self.replace(train_batch_size=tb, train_micro_batch_size_per_gpu=mb,
                            gradient_accumulation_steps=ga)

    def validate(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        if self.gradient_clipping < 0:
            raise ConfigError("gradient_clipping must be >= 0")

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` naming every setting of this config
        that the port does not run yet: a JAX-only root section, a tensor /
        pipeline / sequence degree above 1 (the port trains data- and
        expert-parallel only), parameter offload beside pipeline
        parallelism, random-LTD or pruning (JAX's refusals), optimizer
        offload with an optimizer
        outside the Adam family or with the NVMe tier in fp16, and the
        1-bit optimizers above ZeRO stage 1 or with zerooneadam in fp16 (as
        JAX refuses them)."""
        missing = [f"config section '{name}'" for name in UNPORTED_SECTIONS
                   if getattr(self, name) is not None]
        zero = self.zero_optimization
        par = self.parallel
        for name in ("tensor_parallel_size", "pipeline_parallel_size",
                     "sequence_parallel_size"):
            if getattr(par, name) > 1:
                missing.append(f"parallel.{name}={getattr(par, name)} "
                               "(the port trains data- and expert-parallel "
                               "only)")
        if zero.offload_param.device != "none":
            missing += self._param_offload_refusals()
        opt = self.optimizer.type.lower()
        tier = zero.offload_optimizer.device
        if tier != "none" and opt not in OFFLOAD_OPTIMIZERS:
            missing.append(f"zero_optimization.offload_optimizer with "
                           f"optimizer '{opt}' (offload runs the Adam "
                           "family only)")
        if tier == "nvme" and self.fp16.enabled:
            missing.append("zero_optimization.offload_optimizer.device="
                           "'nvme' with fp16 (the overflow skip needs "
                           "resident state; use bf16)")
        if opt in ONEBIT_OPTIMIZERS and zero.stage > 1:
            missing.append(f"optimizer '{opt}' at ZeRO stage {zero.stage} "
                           "(1-bit compression needs whole local grads: "
                           "stage <= 1)")
        if opt == "zerooneadam" and self.fp16.enabled:
            missing.append("optimizer 'zerooneadam' with fp16 (an "
                           "overflow-skipped step would desynchronize its "
                           "variance schedule; use bf16)")
        if missing:
            raise NotImplementedError(
                "not ported to deepspeed_tpu_torch yet: " + "; ".join(missing))

    def _param_offload_refusals(self) -> List[str]:
        """JAX's ``NotImplementedError`` gates of parameter offload, in its
        words (JAX ``engine.py:163-188``)."""
        out = []
        if self.parallel.pipeline_parallel_size > 1:
            out.append("offload_param + pipeline parallelism is not "
                       "supported (the segmented step IS a pipeline over "
                       "layer blocks)")
        de = self.data_efficiency or {}
        routing = de.get("data_routing")
        if (de.get("enabled") and isinstance(routing, dict)
                and (routing.get("random_ltd") or {}).get("enabled")):
            out.append("offload_param + random_ltd is not supported")
        ct = self.compression_training or {}
        if any(ct.get(k) for k in ("sparse_pruning", "row_pruning",
                                   "head_pruning", "channel_pruning")):
            out.append("offload_param + pruning compression is not "
                       "supported (magnitude thresholds couple across the "
                       "full layer stack, which a streamed block cannot "
                       "reproduce)")
        return out

    # -- convenience ------------------------------------------------------
    @property
    def precision_dtype(self) -> str:
        if self.bf16.enabled:
            return "bfloat16"
        if self.fp16.enabled:
            return "float16"
        return "float32"

    @property
    def zero_stage(self) -> int:
        return self.zero_optimization.stage


def load_config(config: Union[str, Mapping[str, Any], Config, None]) -> Config:
    """Accept a path, a dict, an existing Config, or None (defaults)."""
    if config is None:
        return Config()
    if isinstance(config, Config):
        return config
    if isinstance(config, str):
        with open(config) as fh:
            config = json.load(fh)
    if not isinstance(config, Mapping):
        raise ConfigError(f"config must be a path, dict, or Config — got {type(config)}")
    return Config.from_dict(config)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@dataclass
class SpeculativeConfig(ConfigModel):
    """Speculative decoding knobs. The port validates them like the JAX
    package but its engine serves only ``mode='off'``."""

    mode: str = "off"                  # 'off' | 'ngram' | 'draft'
    num_draft_tokens: int = 4          # K: verify program width is K+1
    ngram_max: int = 3
    ngram_min: int = 1
    min_free_blocks: int = 0
    draft_chunk: int = 0

    def validate(self) -> None:
        if self.mode not in ("off", "ngram", "draft"):
            raise ConfigError("speculative.mode must be 'off', 'ngram' or "
                              f"'draft', got '{self.mode}'")
        if self.num_draft_tokens < 1:
            raise ConfigError("speculative.num_draft_tokens must be >= 1")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ConfigError(
                f"speculative ngram lengths need 1 <= ngram_min "
                f"({self.ngram_min}) <= ngram_max ({self.ngram_max})")
        if self.min_free_blocks < 0:
            raise ConfigError("speculative.min_free_blocks must be >= 0")
        if self.draft_chunk < 0:
            raise ConfigError("speculative.draft_chunk must be >= 0")


@dataclass
class ServingConfig(ConfigModel):
    """Continuous-batching serving layer: paged KV arena + iteration-level
    scheduler + streaming front end. ``block_size``, ``max_seqs``,
    ``max_model_len`` and ``prefill_chunk`` fix the shapes of the prefill and
    decode programs."""

    block_size: int = 16               # KV tokens per arena block
    num_blocks: int = 0                # allocatable blocks in the shared
    #   pool (excluding the reserved scratch block); 0 => fully provisioned
    max_seqs: int = 8                  # decode batch rows
    max_model_len: int = 256           # per-sequence token budget
    prefill_chunk: int = 64            # tokens per prefill chunk; a
    #   multiple of block_size
    max_queue: int = 256               # backpressure limit (queued + running)
    fairness: str = "fair"             # 'fair' | 'fcfs'
    default_max_new_tokens: int = 64
    seed: int = 0                      # sampling stream seed
    paged_kernel: str = "auto"         # 'auto': the paged attention kernels
    #   on a CUDA arena (their plain versions on a CPU arena); 'off': the
    #   dense arena[block_table] gather view — the A/B baseline
    prefix_cache: bool = True          # content-hashed prompt-prefix sharing
    speculative: SpeculativeConfig = field(
        default_factory=SpeculativeConfig)

    def blocks_per_seq(self) -> int:
        return self.max_model_len // self.block_size

    def pool_blocks(self) -> int:
        """Allocatable pool size (0 => fully provisioned)."""
        return (self.num_blocks if self.num_blocks
                else self.max_seqs * self.blocks_per_seq())

    def validate(self) -> None:
        if isinstance(self.speculative, dict):
            self.speculative = SpeculativeConfig.from_dict(self.speculative)
        if self.block_size < 1:
            raise ConfigError("serving.block_size must be >= 1")
        if self.max_model_len < 1:
            raise ConfigError("serving.max_model_len must be >= 1")
        if self.max_model_len % self.block_size != 0:
            raise ConfigError(
                f"serving.max_model_len={self.max_model_len} must be a "
                f"multiple of block_size={self.block_size} (whole-block "
                "sequence budget — see inference/kv_cache.py)")
        if self.prefill_chunk < 1:
            raise ConfigError("serving.prefill_chunk must be >= 1")
        if self.prefill_chunk % self.block_size != 0:
            raise ConfigError(
                f"serving.prefill_chunk={self.prefill_chunk} must be a "
                f"multiple of block_size={self.block_size} — a chunk that "
                "ends mid-block would allocate a block it cannot fill")
        if self.max_seqs < 1:
            raise ConfigError("serving.max_seqs must be >= 1")
        if self.max_queue < 1:
            raise ConfigError("serving.max_queue must be >= 1")
        if self.num_blocks and self.num_blocks < self.blocks_per_seq():
            raise ConfigError(
                f"serving.num_blocks={self.num_blocks} cannot hold even one "
                f"max-length sequence ({self.blocks_per_seq()} blocks) — "
                "the scheduler could never make progress")
        if self.fairness not in ("fair", "fcfs"):
            raise ConfigError("serving.fairness must be 'fair' or 'fcfs', "
                              f"got '{self.fairness}'")
        if self.default_max_new_tokens < 1:
            raise ConfigError("serving.default_max_new_tokens must be >= 1")
        if self.paged_kernel not in ("auto", "off"):
            raise ConfigError("serving.paged_kernel must be 'auto' or "
                              f"'off', got '{self.paged_kernel}'")
        self.speculative.validate()
        if (self.speculative.mode != "off"
                and self.speculative.num_draft_tokens + 1
                > self.max_model_len):
            raise ConfigError(
                f"speculative.num_draft_tokens="
                f"{self.speculative.num_draft_tokens} cannot exceed "
                f"serving.max_model_len={self.max_model_len} - 1")
        if (self.speculative.mode == "draft"
                and self.speculative.draft_chunk % self.block_size != 0):
            raise ConfigError(
                f"speculative.draft_chunk={self.speculative.draft_chunk} "
                f"must be a multiple of block_size={self.block_size}")
