"""InferenceEngine — counterpart of ``deepspeed_tpu/inference/engine.py``.

The engine owns the model, its parameters in the inference dtype, the device
they live on, and one dense KV arena reused across ``generate()`` calls. It
serves two callers: offline generation (``generate``, ``forward``) and the
serving layer (``serving/api.py``), which reads ``model``, ``params``,
``config`` and ``device``.

``generate`` follows JAX ``InferenceEngine._generate``: the prompt is padded
to a bucket and prefilled in one static-prefill forward (the flash kernel);
the write cursor is then rewound to the true width and every further token
is one decode forward (the decode kernel) on per-row positions. JAX compiles
the decode loop into one ``lax.scan``; here it is a Python loop that runs
all ``max_new_tokens - 1`` steps without reading anything back from the
device (end-of-sequence is a device-side ``done`` mask), so the host never
waits on the card inside the loop.

The engine runs on CUDA unless the caller passes ``device="cpu"`` (as the
tests do); asking for CUDA where there is none raises — there is no silent
CPU fallback. MoE models generate with exact routing (no capacity drops:
``transformer._moe_ffn``); their expert banks stay dense under weight-only
quantization, as in JAX. Left out of this port (JAX has them): tensor /
expert parallel meshes (``expert_parallel`` above 1 raises), observability
spans and the tpuaudit program registration.

Quantized inference (JAX's ``dtype="int8" | "int4" | "w8a8" | "w4a8"``, or
``quantize_bits`` with a float dtype): the weights are cast to the compute
dtype, then the matmul weights are quantized leaf by leaf
(``transformer.quantize_model_weights``), then placed on the device. The
decode-shaped weight sites take the quantized GEMM kernels; prefill and every
call over more than 8 tokens dequantize (``transformer._qeinsum``). W8A8 /
W4A8 change only the kernel route: its activation rows are quantized too.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Union

import torch

from . import kv_cache
from ..models.core import (Model, cast_floating, is_quantized, param_count,
                           tree_bytes, tree_map)
from ..models.presets import _SIZES, create_model
from ..models.transformer import forward as model_forward
from ..models.transformer import quantize_model_weights
from ..utils.logging import log_dist

_DTYPE_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "fp16": torch.float16, "float16": torch.float16,
                "fp32": torch.float32, "float32": torch.float32}
# quantized modes: (weight bits, activation rows quantized); compute in bf16
_QUANT_MODES = {"int8": (8, False), "int4": (4, False), "w8a8": (8, True),
                "w4a8": (4, True)}


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the GPU. A CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class InferenceConfig:
    """Inference config subset: the compute/arena dtype (bf16, fp16 or fp32,
    or a quantized mode), the per-sequence token budget (the dense arena's
    length), the random init seed, the prompt-length bucket of ``generate``
    and weight-only quantization (JAX's fields and normalisation)."""

    dtype: Any = torch.bfloat16
    max_out_tokens: int = 1024
    seed: int = 0
    prompt_bucket: int = 64   # prompts pad up to a multiple of this (JAX
    #   bounds its compiled prefill programs so; kept for identical padding)
    quantize_bits: Optional[int] = None   # 8: int8 per output channel; 4:
    #   nibble-packed int4 per (group, channel). dtype='int8'/'int4' sets it
    quantize_groups: Optional[int] = None  # int4 group size along K (None:
    #   one group per output channel)
    quantize_activations: bool = False     # W8A8 / W4A8: decode-shaped
    #   sites quantize their activation rows too. dtype='w8a8'/'w4a8' sets it
    expert_parallel: int = 1   # JAX's expert-parallel degree; above 1 raises

    def __post_init__(self):
        # a quantized mode is storage, not a compute dtype: it computes in
        # bf16 (a string dtype must never reach cast_floating)
        mode = "int8" if self.dtype is torch.int8 else self.dtype
        if isinstance(mode, str) and mode in _QUANT_MODES:
            self.quantize_bits, a8 = _QUANT_MODES[mode]
            self.quantize_activations = self.quantize_activations or a8
            self.dtype = torch.bfloat16
        elif isinstance(self.dtype, str):
            if self.dtype not in _DTYPE_NAMES:
                raise ValueError(
                    f"unknown inference dtype '{self.dtype}' (use bf16/fp16/"
                    "fp32, or 'int8'/'int4'/'w8a8'/'w4a8' for quantized "
                    "weights)")
            self.dtype = _DTYPE_NAMES[self.dtype]
        if self.dtype not in (torch.bfloat16, torch.float16, torch.float32):
            raise NotImplementedError(f"inference dtype {self.dtype}")
        if self.quantize_bits not in (None, 4, 8):
            raise NotImplementedError(
                f"quantize_bits={self.quantize_bits}: 8 (per-channel) and "
                "4 (nibble-packed, groupwise) are supported")
        if self.quantize_groups is not None and self.quantize_bits != 4:
            raise ValueError("quantize_groups applies to int4 only")
        if self.prompt_bucket < 1:
            raise ValueError(f"prompt_bucket must be >= 1, got "
                             f"{self.prompt_bucket}")
        if self.quantize_activations and self.quantize_bits not in (4, 8):
            raise ValueError("quantize_activations (W8A8/W4A8) requires "
                             "int8 or int4 weights (dtype='w8a8'/'w4a8')")


def _bucket(n: int, mult: int = 64) -> int:
    """Prompt-length bucket: ``n`` rounded up to a multiple of ``mult``."""
    return max(mult, ((n + mult - 1) // mult) * mult)


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int, top_p: float = 1.0
            ) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling (JAX ``_sample``), the
    one rule for the first token and every decode step. Greedy is an fp32
    argmax (the first index on ties); otherwise a Gumbel-max draw from
    ``generator``, so nothing is read back to the host."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    neg = torch.full_like(logits, float("-inf"))
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        # nucleus: keep the smallest prefix of descending-prob tokens whose
        # cumulative mass reaches top_p (the top-1 token always survives)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits >= cutoff, logits, neg)
    gumbel = -torch.log(torch.empty_like(logits).exponential_(
        generator=generator))
    return torch.argmax(logits + gumbel, dim=-1)


class InferenceEngine:
    """Owns the model, its params (in ``config.dtype``), the device and the
    dense KV arena of ``generate``."""

    def __init__(self, model: Model, config: InferenceConfig,
                 params: Optional[Dict[str, Any]] = None,
                 device: Union[None, str, torch.device] = None):
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        if model.config is None:
            raise ValueError("model.config is required for inference (the "
                             "KV-cache arena is sized from it)")
        check_expert_parallel(config, model.config)
        check_quantized_compute(config, self.device)
        if config.quantize_activations:
            _a8_gate_preview(config, model.config)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = model.init(gen)
        # cast (quantized sites keep their fp32 scales), quantize, place: the
        # cast tree is this engine's own, so quantizing it in place frees
        # each dense leaf of a random init as its quantized form lands
        params = cast_floating(params, config.dtype)
        if config.quantize_bits:
            _check_quantized(params, config.quantize_bits)
            params = quantize_model_weights(
                params, bits=config.quantize_bits,
                group_size=config.quantize_groups, donate=True)
        self.params = tree_map(lambda t: t.to(self.device), params)
        del params
        # batch size -> dense arena, kept between generate() calls
        self._arena: Dict[int, Dict[str, torch.Tensor]] = {}
        quant = (f", weights int{config.quantize_bits}"
                 f"{' a8' if config.quantize_activations else ''}"
                 if config.quantize_bits else "")
        log_dist(f"inference engine ready: "
                 f"{param_count(self.params) / 1e6:.1f}M params, "
                 f"{tree_bytes(self.params) / 2 ** 30:.2f} GiB, "
                 f"dtype={config.dtype}{quant}, device={self.device}")

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, dtype)

    # -- plain forward -------------------------------------------------------
    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Full-sequence logits (B, S, V), no cache; ``attention_mask``
        (B, S) is key padding."""
        ids = self._tensor(input_ids, torch.long)
        mask = (None if attention_mask is None
                else self._tensor(attention_mask, torch.int32))
        logits, _ = model_forward(self.params, ids, self.model.config,
                                  attention_mask=mask)
        return logits

    __call__ = forward

    # -- generate ------------------------------------------------------------
    def _prefill(self, ids: torch.Tensor, valid: torch.Tensor,
                 cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Static prefill from position 0: logits (B, S_pad, V)."""
        logits, _ = model_forward(self.params, ids, self.model.config,
                                  cache=cache, attention_mask=valid,
                                  start_pos=0)
        return logits

    def _decode(self, tok: torch.Tensor, cache: Dict[str, torch.Tensor],
                valid: torch.Tensor, idx: int, pos: torch.Tensor,
                kpos: Optional[torch.Tensor]) -> torch.Tensor:
        """One decode step at arena column ``idx``: logits (B, V)."""
        logits, _ = model_forward(self.params, tok[:, None],
                                  self.model.config, cache=cache,
                                  attention_mask=valid, start_pos=idx,
                                  positions=pos[:, None],
                                  key_positions=kpos)
        return logits[:, -1]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, input_ids, attention_mask=None,
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 return_ttft: bool = False):
        """Prompt ids (B, S) -> generated ids (B, max_new_tokens), a tensor
        on the engine's device.

        Ragged prompts: pass ``attention_mask`` (B, S); prompts are treated
        as right-padded. Decoded tokens take each row's TRUE next positions
        (len_b, len_b + 1, ...), and alibi models bias keys by their true
        per-row positions, so a ragged batch generates what each prompt
        generates alone. After ``eos_token_id`` a row keeps emitting it.
        ``return_ttft``: also return the wall seconds of prefill plus
        first-token sampling (ending in a device sync)."""
        cfg = self.model.config
        dev = self.device
        ids = torch.as_tensor(input_ids).cpu().long()
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be (B, S), got "
                             f"{tuple(ids.shape)}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        B, S = ids.shape
        S_pad = _bucket(S, self.config.prompt_bucket)
        T_max = self.config.max_out_tokens
        if S_pad + max_new_tokens > T_max:
            raise ValueError(
                f"prompt ({S_pad} padded) + max_new_tokens ({max_new_tokens})"
                f" exceeds max_out_tokens={T_max} — raise InferenceConfig."
                "max_out_tokens")
        mask = (torch.ones(B, S, dtype=torch.int32) if attention_mask is None
                else torch.as_tensor(attention_mask).cpu().int())
        lengths_host = mask.sum(dim=-1)
        ragged = attention_mask is not None and bool(
            (lengths_host != S).any())
        ids_pad = torch.zeros(B, S_pad, dtype=torch.long)
        ids_pad[:, :S] = ids
        # valid-key mask over the whole arena, prompt part filled
        valid = torch.zeros(B, T_max, dtype=torch.int32)
        valid[:, :S] = mask
        ids_pad, valid = ids_pad.to(dev), valid.to(dev)
        lengths = lengths_host.to(dev)
        # one arena, reused while the batch size stays (JAX's single
        # workspace: another batch size frees it); stale keys stay masked
        # by `valid` and are overwritten as prefill and decode proceed
        cache = self._arena.pop(B, None)
        self._arena.clear()
        if cache is None:
            cache = kv_cache.init_cache(cfg, B, T_max, self.config.dtype, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        t0 = time.perf_counter()
        logits = self._prefill(ids_pad, valid, cache)
        last = logits[torch.arange(B, device=dev), lengths - 1]
        tok = _sample(last, gen, temperature, top_k, top_p)
        self._sync()
        ttft = time.perf_counter() - t0

        out = [tok]
        # the decode cursor rewinds from S_pad to S: decoded tokens take
        # arena columns S, S + 1, ... over prefill's padding keys
        kpos = None
        if ragged and cfg.position == "alibi":
            col = torch.arange(T_max, dtype=torch.float32, device=dev)[None]
            shift = (S - lengths.float())[:, None]
            kpos = col - shift * (col >= S).float()
        pos = lengths.long()
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in range(max_new_tokens - 1):
            valid[:, S + t] = 1
            nxt = _sample(self._decode(tok, cache, valid, S + t, pos, kpos),
                          gen, temperature, top_k, top_p)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id),
                                  nxt)
                done = done | (nxt == eos_token_id)
            out.append(nxt)
            tok, pos = nxt, pos + 1
        self._arena[B] = cache
        tokens = torch.stack(out, dim=1)
        return (tokens, ttft) if return_ttft else tokens


def check_expert_parallel(config: InferenceConfig, cfg) -> None:
    """JAX's ``ValueError`` gates of ``expert_parallel`` (JAX
    ``inference/engine.py:182-189``), then the port's refusal: it serves
    every expert on one device."""
    ep = int(config.expert_parallel)
    if ep <= 1:
        return
    if cfg.moe_num_experts <= 0:
        raise ValueError(f"expert_parallel={ep} requires an MoE model "
                         "(moe_num_experts > 0)")
    if cfg.moe_num_experts % ep != 0:
        raise ValueError(f"expert_parallel={ep} must divide "
                         f"moe_num_experts={cfg.moe_num_experts}")
    raise NotImplementedError(
        f"expert_parallel={ep} is not ported to deepspeed_tpu_torch yet: "
        "the port keeps every expert on one device")


def check_quantized_compute(config: InferenceConfig,
                            device: torch.device) -> None:
    """Refuse what the quantized decode kernels do not take, before any
    weight lands on the card: the W8A8 / W4A8 kernels take bf16 or fp32
    activations, so fp16 with ``quantize_activations`` on CUDA raises
    NotImplementedError; the weight-only kernels also take fp16, and a CPU
    engine runs the plain versions at any dtype."""
    if (config.quantize_bits and config.quantize_activations
            and config.dtype == torch.float16 and device.type == "cuda"):
        raise NotImplementedError(
            "fp16 compute with quantized activations (w8a8 / w4a8): the a8 "
            "decode kernels take bf16 or fp32 activations; weight-only int8 "
            "/ int4 take fp16")


def _a8_gate_preview(config: InferenceConfig, cfg) -> None:
    """W8A8 / W4A8 engage through the decode-kernel gate: warn about the
    sites where it can never pass (they serve the weight-only path), and
    set ``a8_decode`` on this engine's model config (JAX :190-225). JAX
    also rejects tensor parallelism here; the port has none."""
    mode = "w8a8" if config.quantize_bits == 8 else "w4a8"
    wo = "int8" if config.quantize_bits == 8 else "int4"
    # int8 sites need K, N % 128; int4 packs K/2, so its contraction dim
    # must be % 256 (output dims stay % 128)
    k_align = 128 if config.quantize_bits == 8 else 256
    H = cfg.hidden_size
    ND, F_, V = cfg.num_heads * cfg.head_dim, cfg.ffn_hidden_size, \
        cfg.vocab_size
    sites = {"attn qkv": (H, ND), "attn out": (ND, H), "mlp in": (H, F_),
             "mlp out": (F_, H)}
    if not cfg.tie_embeddings:
        sites["lm_head"] = (H, V)
    bad = [name for name, (kd, nd) in sites.items()
           if kd % k_align or nd % 128]
    if (config.quantize_bits == 4 and config.quantize_groups
            and config.quantize_groups % 128):
        bad = list(sites)
    if bad:
        groups = (f", groups {config.quantize_groups}"
                  if config.quantize_groups else "")
        log_dist(f"{mode}: the s8xs8 kernel gate will not engage for "
                 f"site(s) {bad} (K-alignment {k_align}, N-alignment 128"
                 f"{groups}) — those sites serve the weight-only {wo} path",
                 level=logging.WARNING)
    cfg.a8_decode = True


def _check_quantized(params: Dict[str, Any], bits: int) -> None:
    """Given params may be dense or already quantized, but not at other
    bits than the config's."""
    other = "q4" if bits == 8 else "q8"

    def walk(node):
        if is_quantized(node):
            if other in node:
                raise ValueError(f"params are quantized as {other}, the "
                                 f"config asks for {bits} bits")
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(params)


def init_inference(model=None, config: Optional[InferenceConfig] = None,
                   dtype=None, max_out_tokens: Optional[int] = None,
                   params: Optional[Dict[str, Any]] = None,
                   device: Union[None, str, torch.device] = None,
                   seed: Optional[int] = None,
                   expert_parallel: Optional[int] = None,
                   **model_overrides) -> InferenceEngine:
    """Counterpart of ``deepspeed_tpu.init_inference``. ``model``: a
    ``Model`` bundle or a preset name (e.g. "llama-7b"). ``dtype``: bf16 /
    fp16 / fp32 or a quantized mode, "int8", "int4", "w8a8", "w4a8".
    Weights: ``params`` (the port's tree, dense or already quantized at the
    config's bits, e.g. from ``models.convert.params_from_jax``), else
    random from ``seed``. ``model_overrides`` go to the preset's config
    (e.g. ``moe_capacity_factor``). ``expert_parallel`` above 1 raises.
    Runs on CUDA unless ``device="cpu"``."""
    if isinstance(config, dict):
        config = InferenceConfig(**config)
    cfg = config or InferenceConfig()
    if dtype is not None:
        cfg.dtype = dtype
        cfg.__post_init__()
    if max_out_tokens is not None:
        cfg.max_out_tokens = int(max_out_tokens)
    if seed is not None:
        cfg.seed = int(seed)
    if expert_parallel is not None:
        cfg.expert_parallel = int(expert_parallel)
    if isinstance(model, str):
        if model not in _SIZES:
            raise ValueError(f"unknown preset '{model}'")
        model = create_model(model, dtype=cfg.dtype,
                             max_seq_len=max(cfg.max_out_tokens, 128),
                             **model_overrides)
    if model is None:
        raise ValueError("model is required: a Model bundle or preset name")
    return InferenceEngine(model, cfg, params=params, device=device)
