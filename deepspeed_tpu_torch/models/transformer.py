"""Decoder-only transformer (GPT-2 / Llama / BLOOM families): the paged
serving forward, the dense-cache forward of ``generate()`` and the
cache-less forward.

Counterpart of ``deepspeed_tpu/models/transformer.py``: one functional
decoder covers the families through config switches —

  GPT-2 family : LayerNorm(+bias), learned positions, GELU MLP, tied embeddings
  Llama family : RMSNorm, RoPE, SwiGLU MLP, GQA (n_kv_heads < n_heads)
  BLOOM family : ALiBi, LayerNorm after the embedding

``forward`` takes the JAX ``forward``'s three cache modes:

* PAGED (``block_table`` given; JAX :1115 and :1271-1300): the KV cache is
  the shared block arena ``{"k","v": (L, NUM_BLOCKS, BLOCK, K, D)}`` and
  each row reaches its keys through a block table;
* DENSE (``cache`` without ``block_table``; JAX :930-1000): the arena
  ``{"k","v": (L, B, T_MAX, K, D)}`` is written at the host cursor
  ``start_pos``. One token (S == 1) is a decode step over the ``(B, T)``
  validity mask; ``start_pos == 0`` with S > 1 is the static prefill, the
  flash kernel over the whole arena with 0-based causality; any other
  ``start_pos`` takes the plain attention with an explicit (B, S, T) mask;
* CACHE-LESS (no ``cache``; JAX :1010-1015): causal flash attention over
  the sequence with an optional (B, S) key-padding mask, or the config's
  ``attention_impl`` (JAX :93), e.g. ``make_sparse_attention_impl`` of
  ``ops/sparse_attention.py``.

A custom ``attention_impl`` is called where JAX calls it: in the cache-less
forward as ``impl(q, k, v, mask, causal=cfg.causal)``, and in the dense and
paged modes on the dense view with a (B, S, T) mask and ``causal=False``
(JAX :888-909, :936-1000), which a unidirectional sparse impl refuses, as
in JAX. It gets ``alibi=`` only for alibi models (and must declare it, JAX
:855), and ``plain=`` when it declares that parameter by name.

Parameters keep the JAX tree layout (layer leaves stacked on a leading
layer axis); the layer loop is a Python loop over views of those stacks
where JAX scans.

Kernels route by the tensor's device: ``_norm`` calls ``fused_layer_norm``,
the paged read calls ``paged_decode_attention`` (S == 1) or
``paged_prefill_attention`` (chunked prefill), the dense decode calls
``decode_attention`` and the static prefill and cache-less forward call
``flash_attention``; each launches its CUDA kernel on a CUDA tensor and runs
its plain version on a CPU tensor. The weight sites go through ``_qeinsum``:
a dense weight is a plain matmul; a weight-only-quantized one
(``quantize_model_weights``) takes the quantized GEMM kernels on
decode-shaped calls and a dequantized ``torch.matmul`` otherwise.
``forward(..., plain=True)`` calls the plain versions on any device — the
reference the kernel path is held against. ``paged_impl='gather'`` keeps
the dense ``arena[block_table]`` view as the A/B baseline on both devices.

Training: the cache-less forward runs under autograd (the flash and norm
wrappers carry their backward), and ``build_model`` bundles the JAX
``loss_fn`` (``cross_entropy_loss`` over next-token labels, plus MoE's aux
term). The layer views of the stacked leaves are taken with one ``unbind``
per leaf, whose backward is one ``stack``.

MoE (``moe_num_experts > 0``, JAX :1054-1086): each layer's FFN is
``parallel.moe.moe_mlp`` over the layer's ``router`` and expert banks, with
PR-MoE's dense residual MLP mixed in when ``moe_use_residual``. Routing is
exact when a cache is given (dense arena or paged: C = T, no drops, no
RTS), capacity-limited otherwise (training and the eval loss).
``forward(..., with_aux=True)`` also returns the sum of the layers' aux
losses, which the loss adds as ``moe_aux_loss_coef * aux / num_layers``.
Beyond one rank the training engine passes ``moe_groups``: the gating spans
every rank's tokens and, with expert parallelism, a rank holds only its
banks of the ``expert_axes`` leaves.

Out of scope here (they raise): sliding windows and
custom attention scales, post-LN / bidirectional encoders, token types, and
the training features dropout, rematerialisation, progressive layer drop,
random-LTD and activation quantization (``TransformerConfig`` carries their
fields, default off, so JAX configs load).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from functools import lru_cache, partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.decode_attention import decode_attention, reference_decode_attention
from ..ops.flash_attention import flash_attention, reference_flash_attention
from ..ops.normalization import fused_layer_norm, reference_layer_norm
from ..ops.paged_decode_attention import (paged_decode_attention,
                                          paged_prefill_attention,
                                          reference_paged_attention)
from ..ops.quant_matmul import (int4_a8_matmul, int4_matmul, int8_a8_matmul,
                                int8_matmul, quantize_int4,
                                reference_int4_a8_matmul,
                                reference_int4_matmul,
                                reference_int8_a8_matmul,
                                reference_int8_matmul, unpack_int4)
from ..parallel.moe import moe_mlp
from .core import Model, is_quantized, tree_items, tree_map


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None      # None => MHA
    ffn_hidden_size: Optional[int] = None   # None => 4*hidden / llama rule
    max_seq_len: int = 1024
    norm: str = "layernorm"                 # layernorm | rmsnorm
    norm_position: str = "pre"              # pre | post (post: not served)
    position: str = "learned"               # learned | rope | alibi
    embed_norm: bool = False                # LayerNorm after embedding (BLOOM)
    activation: str = "gelu"    # gelu | gelu-exact | relu | quick_gelu | swiglu
    tie_embeddings: bool = True
    causal: bool = True
    parallel_residual: bool = False         # x + attn(ln1(x)) + mlp(ln2(x))
    attention_layers: tuple = ()            # sliding-window pattern (GPT-Neo)
    attention_window: int = 256
    attention_scale: Optional[float] = None
    rotary_dim: Optional[int] = None        # partial rotary (GPT-J/NeoX)
    type_vocab_size: int = 0
    final_norm: bool = True
    lm_head_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # MoE (JAX :95-107): > 0 experts turns every layer's FFN into a gated
    # expert bank with top-k routing and a load-balancing aux loss
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_drop_tokens: bool = True      # False => infinite capacity (C = T)
    moe_use_rts: bool = False         # random token selection (top-1 only)
    moe_dispatch: str = "sparse"      # 'sparse' gathers or 'einsum'
    moe_use_residual: bool = False    # PR-MoE: dense residual MLP mixed by
    #   a learned 2-way softmax coefficient
    dtype: torch.dtype = torch.float32
    # JAX training features, default off; any of them on raises
    # (check_servable) until the port has them
    dropout: float = 0.0
    dropout_enabled: bool = False
    remat: bool = False
    remat_policy: str = "full"
    pld_enabled: bool = False
    ltd_enabled: bool = False
    ltd_layers: Optional[Tuple[int, ...]] = None
    ltd_keep: int = 0
    act_quant_bits: int = 0
    a8_decode: bool = False     # W8A8 / W4A8: decode-shaped quantized sites
    #   quantize their activation rows (set by the inference engine)
    attention_impl: Optional[Callable] = None   # None => flash attention

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.ffn_hidden_size is None:
            if self.activation == "swiglu":
                self.ffn_hidden_size = int(
                    8 * self.hidden_size / 3 / 64 + 0.999) * 64
            else:
                self.ffn_hidden_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible "
                             f"by num_heads {self.num_heads}")
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"num_heads {self.num_heads} not divisible by "
                             f"num_kv_heads {self.num_kv_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def check_servable(cfg: TransformerConfig) -> None:
    """Raise for the configurations this slice of the port does not run."""
    if cfg.norm_position != "pre" or not cfg.causal:
        raise NotImplementedError(
            "post-LN / bidirectional encoders are not served by the port")
    if cfg.type_vocab_size > 0:
        raise NotImplementedError("token-type embeddings are not ported yet")
    if cfg.attention_layers or cfg.attention_scale is not None:
        raise NotImplementedError(
            "sliding-window / custom-scale attention (GPT-Neo family) is not "
            "served: the paged read path has no window operand")
    training = {"dropout_enabled": cfg.dropout_enabled, "remat": cfg.remat,
                "pld_enabled": cfg.pld_enabled,
                "ltd_enabled": cfg.ltd_enabled,
                "act_quant_bits": cfg.act_quant_bits}
    on = sorted(name for name, value in training.items() if value)
    if on:
        raise NotImplementedError(
            f"training features not ported yet: {', '.join(on)}")


def _require_impl_kwarg(impl: Callable, kwarg: str, why: str) -> None:
    """A custom attention_impl must DECLARE every kwarg a model feature
    needs (JAX ``_require_impl_kwarg``): failing loud beats silently
    dropping a bias."""
    sig = inspect.signature(impl)
    if (kwarg not in sig.parameters
            and not any(p.kind is inspect.Parameter.VAR_KEYWORD
                        for p in sig.parameters.values())):
        raise TypeError(
            f"custom attention_impl must accept a {kwarg}= kwarg for {why} "
            f"(signature is {sig})")


def active_attention_impl(cfg: TransformerConfig) -> str:
    """Which attention the cache-less forward runs: 'custom' (the config's
    ``attention_impl``) or 'flash_attention' (its kernel on a CUDA tensor,
    its plain version on a CPU tensor)."""
    return "custom" if cfg.attention_impl is not None else "flash_attention"


def _impl_call(impl: Callable, alibi: Optional[torch.Tensor], plain: bool,
               **extra) -> Callable[..., torch.Tensor]:
    """``impl`` with the keywords JAX passes (``alibi`` only when the model
    has it) and ``plain`` when the impl declares it by name."""
    kw = dict(extra)
    if alibi is not None:
        kw["alibi"] = alibi
    if "plain" in inspect.signature(impl).parameters:
        kw["plain"] = plain
    return partial(impl, **kw)


def eval_config(cfg: TransformerConfig) -> TransformerConfig:
    """Config copy with the training regularisers off (JAX ``eval_config``)."""
    return dataclasses.replace(cfg, dropout_enabled=False, ltd_keep=0)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def expert_axes(cfg: Any, params: Dict[str, Any]
                ) -> Dict[Tuple[str, ...], int]:
    """The leaves of ``params`` that hold MoE expert banks, each with the
    axis of its expert dim (1, after the layer axis): ``layers/mlp/*`` of an
    MoE model, the leaves JAX gives its ``expert`` logical axis. Empty for
    a dense model."""
    if not getattr(cfg, "moe_num_experts", 0):
        return {}
    return {path: 1 for path, _ in tree_items(params)
            if path[:2] == ("layers", "mlp")}


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                sink: Optional[Callable[..., Any]] = None,
                device: Any = None) -> Dict[str, Any]:
    """Random parameters on ``generator.device`` (or ``device``): the JAX
    init's shapes and scales (std 0.02; residual-writing projections 0.02 /
    sqrt(2 L); learned positions 0.01; norms at 1/0; biases 0). Draws come
    from the torch generator, so values differ from the JAX init of the same
    seed. ``sink``: where the layer stack goes (``init_layer_params``);
    ``device="meta"`` gives the shapes alone, drawing nothing."""
    check_servable(cfg)
    dev = generator.device if device is None else torch.device(device)
    H, V = cfg.hidden_size, cfg.vocab_size

    def normal(shape, s=0.02):
        return (torch.randn(shape, generator=generator, device=dev) * s
                ).to(cfg.dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=dev)

    params: Dict[str, Any] = {"embed": {"tokens": normal((V, H))}}
    if cfg.position == "learned":
        params["pos"] = normal((cfg.max_seq_len, H), 0.01)
    if cfg.embed_norm:
        params["embed_norm"] = {"scale": const((H,), 1.0),
                                "bias": const((H,), 0.0)}
    params["layers"] = init_layer_params(generator, cfg, sink, dev)
    if cfg.final_norm:
        params["final_norm"] = {"scale": const((H,), 1.0)}
        if cfg.norm == "layernorm":
            params["final_norm"]["bias"] = const((H,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((H, V))
        if cfg.lm_head_bias:
            params["lm_head_b"] = const((V,), 0.0)
    return params


def init_layer_params(generator: torch.Generator, cfg: TransformerConfig,
                      sink: Optional[Callable[..., Any]] = None,
                      device: Any = None) -> Dict[str, Any]:
    """Layer-stack params, leaves shaped (L, ...), drawn one layer at a time
    (an fp32 draw of a whole llama-7b stack would need 6 GB at once).
    ``sink(path, shape)``, when given, returns where the leaf at ``path``
    (below ``layers``) of layer shape ``shape`` goes: an object taking
    ``dst[li] = layer``, which receives each layer as it is drawn, in the
    same order and from the same draws as without it (parameter offload
    keeps the stack in host memory this way; its leaves are what ``sink``
    returned)."""
    dev = generator.device if device is None else torch.device(device)
    H, L = cfg.hidden_size, cfg.num_layers
    N, K, D, F_ = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                   cfg.ffn_hidden_size)
    std = 0.02
    resid_std = std / (2 * L) ** 0.5

    def rows(path, shape):
        if sink is None:
            return torch.empty((L, *shape), dtype=cfg.dtype, device=dev)
        return sink(path, shape)

    def stacked(path, shape, s=std):
        out = rows(path, shape)
        for li in range(L):
            out[li] = torch.randn(shape, generator=generator, device=dev) * s
        return out

    def const(path, shape, value):
        out = rows(path, shape)
        for li in range(L):
            out[li] = torch.full(shape, value, dtype=cfg.dtype, device=dev)
        return out

    layer: Dict[str, Any] = {
        "ln1": {"scale": const(("ln1", "scale"), (H,), 1.0)},
        "ln2": {"scale": const(("ln2", "scale"), (H,), 1.0)},
        "attn": {"wq": stacked(("attn", "wq"), (H, N * D)),
                 "wk": stacked(("attn", "wk"), (H, K * D)),
                 "wv": stacked(("attn", "wv"), (H, K * D)),
                 "wo": stacked(("attn", "wo"), (N * D, H), resid_std)},
    }
    E = cfg.moe_num_experts
    if E > 0:
        # JAX's key order: router, PR-MoE's residual MLP and coefficient,
        # then the expert banks (no biases)
        layer["router"] = stacked(("router",), (H, E))
        if cfg.moe_use_residual:
            layer["res_mlp"] = {
                "w_up": stacked(("res_mlp", "w_up"), (H, F_)),
                "b_up": const(("res_mlp", "b_up"), (F_,), 0.0),
                "w_down": stacked(("res_mlp", "w_down"), (F_, H),
                                  resid_std),
                "b_down": const(("res_mlp", "b_down"), (H,), 0.0)}
            layer["res_coef"] = {"w": stacked(("res_coef", "w"), (H, 2)),
                                 "b": const(("res_coef", "b"), (2,), 0.0)}
        layer["mlp"] = {}
        if cfg.activation == "swiglu":
            layer["mlp"]["w_gate"] = stacked(("mlp", "w_gate"), (E, H, F_))
        layer["mlp"]["w_up"] = stacked(("mlp", "w_up"), (E, H, F_))
        layer["mlp"]["w_down"] = stacked(("mlp", "w_down"), (E, F_, H),
                                         resid_std)
    elif cfg.activation == "swiglu":
        layer["mlp"] = {"w_gate": stacked(("mlp", "w_gate"), (H, F_)),
                        "w_up": stacked(("mlp", "w_up"), (H, F_)),
                        "w_down": stacked(("mlp", "w_down"), (F_, H),
                                          resid_std)}
    else:
        layer["mlp"] = {"w_up": stacked(("mlp", "w_up"), (H, F_)),
                        "b_up": const(("mlp", "b_up"), (F_,), 0.0),
                        "w_down": stacked(("mlp", "w_down"), (F_, H),
                                          resid_std),
                        "b_down": const(("mlp", "b_down"), (H,), 0.0)}
    if cfg.norm == "layernorm":
        for ln in ("ln1", "ln2"):
            layer[ln]["bias"] = const((ln, "bias"), (H,), 0.0)
        layer["attn"].update(
            bq=const(("attn", "bq"), (N * D,), 0.0),
            bk=const(("attn", "bk"), (K * D,), 0.0),
            bv=const(("attn", "bv"), (K * D,), 0.0),
            bo=const(("attn", "bo"), (H,), 0.0))
    return layer


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
          kind: str, eps: float, plain: bool = False) -> torch.Tensor:
    fn = reference_layer_norm if plain else fused_layer_norm
    return fn(x, scale, bias, eps, kind == "rmsnorm")


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given absolute positions, (..., head_dim/2)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, n, D); cos/sin: (S, D/2) shared or (B, S, D/2) per row."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes (HF BloomModel build_alibi_tensor formula)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    closest = 2 ** math.floor(math.log2(n_heads))
    slopes = pow2_slopes(closest)
    if closest != n_heads:
        extra = pow2_slopes(2 * closest)
        slopes += extra[0::2][: n_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


@lru_cache(maxsize=None)
def _alibi_table(n_heads: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes`` on ``device``, built once and only read: copying the
    slopes from the host on every forward would wait for the stream."""
    return alibi_slopes(n_heads, device=device)


# ---------------------------------------------------------------------------
# weight-only quantization (JAX :424-569)
# ---------------------------------------------------------------------------


def _quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel int8: JAX's ``_quant_math`` for 8 bits."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    s = torch.where(absmax == 0.0, torch.ones_like(absmax),
                    absmax / torch.full_like(absmax, 127.0))
    q = torch.clamp(torch.round(w32 / s), -127.0, 127.0).to(torch.int8)
    return {"q8": q, "s": s}


def _quantize_stacked(w: torch.Tensor, quant: Callable[[torch.Tensor], Any]
                      ) -> Dict[str, torch.Tensor]:
    """``quant`` of a 2-D site, or layer by layer of an (L, K, N) stack into
    preallocated outputs (the same values: each layer's scales depend on
    that layer alone), so only one layer's fp32 temporaries exist at once."""
    if w.dim() == 2:
        return quant(w)
    first = quant(w[0])
    out = {k: torch.empty((w.shape[0], *v.shape), dtype=v.dtype,
                          device=v.device) for k, v in first.items()}
    for li in range(w.shape[0]):
        part = first if li == 0 else quant(w[li])
        for k, v in part.items():
            out[k][li] = v
    return out


def quantize_model_weights(params: Dict[str, Any], bits: int = 8,
                           group_size: Optional[int] = None,
                           donate: bool = False) -> Dict[str, Any]:
    """Weight-only quantization (JAX ``quantize_model_weights``): the matmul
    weights (attention q/k/v/o, the dense MLP, an untied ``lm_head``)
    become ``{"q8": int8 (.., K, N), "s": fp32 (.., 1, N)}`` (8 bits, per
    output channel) or ``{"q4": uint8 (.., K/2, N), "s": fp32 (.., G, N)}``
    (4 bits, nibble-packed, ``group_size`` rows per group along K). The
    embedding, biases and norms stay dense. Computed leaf by leaf on the
    params' device; the values equal JAX's bit for bit (both round half to
    even after a true division). ``donate``: update the given dicts in
    place, so each dense leaf is released as its quantized form lands;
    otherwise the input tree is left as it is. A site that is already
    quantized is kept."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4:
        def quant(w):
            q4, s = quantize_int4(w, group_size)
            return {"q4": q4, "s": s}
    else:
        quant = _quantize_int8

    def site(node: Dict[str, Any], name: str) -> None:
        w = node[name]
        if not is_quantized(w):
            node[name] = _quantize_stacked(w, quant)

    if not donate:
        params = dict(params)
        params["layers"] = dict(params["layers"])
    layers = params["layers"]
    if not donate:
        layers["attn"] = dict(layers["attn"])
        layers["mlp"] = dict(layers["mlp"])
    for name in ("wq", "wk", "wv", "wo"):
        site(layers["attn"], name)
    if "router" not in layers:           # dense MLP only (MoE banks stay)
        for name in ("w_up", "w_gate", "w_down"):
            if name in layers["mlp"]:
                site(layers["mlp"], name)
    if "lm_head" in params:
        site(params, "lm_head")
    return params


def _dense(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """A (possibly weight-only-quantized) weight as a dense tensor."""
    if isinstance(w, dict) and "q8" in w:
        return (w["q8"].float() * w["s"]).to(dtype)
    if isinstance(w, dict) and "q4" in w:
        return unpack_int4(w["q4"], w["s"], dtype)
    return w


def _qeinsum(x: torch.Tensor, w: Any, dtype: torch.dtype, a8: bool = False,
             plain: bool = False) -> torch.Tensor:
    """``x (B, S, K) @ w`` at a weight site, ``w`` dense or quantized
    (JAX ``_qeinsum``, its gate verbatim). Decode-shaped calls (S * B <= 8)
    on a 2-D quantized weight with aligned shapes take the quantized GEMM
    (the a8 variant when ``a8``): its kernel on a CUDA tensor, its plain
    version on a CPU tensor or with ``plain``. JAX also requires a
    single-shard mesh there; the port has no tensor parallelism. Every other
    call dequantizes and leaves the product to ``torch.matmul``, with JAX's
    rounding: int8 scales cast to ``dtype`` and applied after the product,
    int4 scales applied in fp32 before it."""
    if isinstance(w, dict) and "q8" in w:
        q8, s = w["q8"], w["s"]
        B, S = x.shape[0], x.shape[1]
        if (S * B <= 8 and q8.dim() == 2
                and q8.shape[0] % 128 == 0 and q8.shape[1] % 128 == 0):
            if a8:
                fn = reference_int8_a8_matmul if plain else int8_a8_matmul
            else:
                fn = reference_int8_matmul if plain else int8_matmul
            out = fn(x.reshape(B * S, -1), q8, s, out_dtype=dtype)
            return out.reshape(*x.shape[:-1], q8.shape[1])
        out = torch.matmul(x, q8.to(dtype))
        return out * s[..., 0, :].to(dtype)
    if isinstance(w, dict) and "q4" in w:
        q4, s = w["q4"], w["s"]
        B, S = x.shape[0], x.shape[1]
        K2, N = q4.shape[-2:]
        G = s.shape[-2]
        gs = 2 * K2 // G
        if (S * B <= 8 and q4.dim() == 2
                and K2 % 128 == 0 and N % 128 == 0
                and (G == 1 or gs % 128 == 0)):
            if a8:
                fn = reference_int4_a8_matmul if plain else int4_a8_matmul
            else:
                fn = reference_int4_matmul if plain else int4_matmul
            out = fn(x.reshape(B * S, -1), q4, s, out_dtype=dtype)
            return out.reshape(*x.shape[:-1], N)
        return torch.matmul(x, unpack_int4(q4, s, dtype))
    return x @ w


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor], causal: bool = True,
                          alibi: Optional[torch.Tensor] = None,
                          key_positions: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention over a dense view (JAX ``dot_product_attention``).
    q (B, S, N, D); k/v (B, T, K, D) with GQA broadcast; ``mask`` (B, T)
    key padding or (B, S, T) — 1 where the key is visible. ``causal`` is
    END-aligned: query s sits at position T - S + s. Softmax in fp32;
    alibi adds slope[n] * key position (``key_positions`` (B, T), default
    the column index)."""
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if K != N:
        k = k.repeat_interleave(N // K, dim=2)
        v = v.repeat_interleave(N // K, dim=2)
    scale = D ** -0.5 if scale is None else scale
    scores = torch.einsum("bsnd,btnd->bnst", q, k).float() * scale
    if alibi is not None:
        kpos = (torch.arange(T, dtype=torch.float32, device=q.device)[None]
                if key_positions is None else key_positions.float())
        scores = scores + alibi[None, :, None, None] * kpos[:, None, None, :]
    neg = torch.finfo(torch.float32).min
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None] + (T - S)
        keep = torch.arange(T, device=q.device)[None, :] <= q_pos
        scores = torch.where(keep[None, None], scores,
                             torch.full_like(scores, neg))
    if mask is not None:
        m = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(m.bool(), scores, torch.full_like(scores, neg))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


@dataclasses.dataclass
class _PagedStep:
    """Per-forward paged bookkeeping, shared by every layer: where each
    token writes, and the read kernels' integer operands."""

    block_table: torch.Tensor            # (B, MAXB) int32
    positions: torch.Tensor              # (B, S) int64, -1 = pad query
    write_blk: torch.Tensor              # (B, S) int64
    write_off: torch.Tensor              # (B, S) int64
    lengths: Optional[torch.Tensor]      # (B,) int32, decode only
    start: Optional[torch.Tensor]        # (B,) int32, chunked prefill only
    n_valid: Optional[torch.Tensor]      # (B,) int32, chunked prefill only


def _paged_step(block_table: torch.Tensor, positions: torch.Tensor,
                block_size: int, write_mask: Optional[torch.Tensor],
                paged_chunk: bool) -> _PagedStep:
    B, S = positions.shape
    pos = positions.long()
    T_view = block_table.shape[1] * block_size
    wpos = pos.clamp(0, T_view - 1)       # pad writes stay in range
    blk = torch.gather(block_table, 1, wpos // block_size).long()
    off = wpos % block_size
    if write_mask is not None:
        # chunk padding writes to scratch block 0
        blk = torch.where(write_mask, blk, torch.zeros_like(blk))
        off = torch.where(write_mask, off, torch.zeros_like(off))
    lengths = start = n_valid = None
    if S == 1:
        lengths = (pos[:, 0] + 1).int()
    elif paged_chunk:
        # chunked-prefill contract: positions[b] = start_b + arange(S) for
        # the first n_valid_b queries, -1 for the trailing pads
        start = pos[:, 0].clamp(min=0).int()
        n_valid = (pos >= 0).sum(dim=1).int()
    return _PagedStep(block_table.int().contiguous(), pos, blk, off,
                      lengths, start, n_valid)


def _paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layer_cache: Dict[str, torch.Tensor], step: _PagedStep,
                     paged_impl: str, alibi: Optional[torch.Tensor],
                     plain: bool, impl: Optional[Callable] = None
                     ) -> torch.Tensor:
    """Scatter this step's K/V into the arena, then read through the block
    table. Scatter comes first: the chunk's own keys must be in the pool
    before attention runs. A custom ``impl`` reads the gathered dense view
    (JAX :888-909)."""
    ck, cv = layer_cache["k"], layer_cache["v"]
    B, S, N, D = q.shape
    K = ck.shape[2]
    # the arena is updated IN PLACE (ck/cv are views of the shared arena):
    # JAX donates the arena to the jitted program and writes .at[].set
    ck.index_put_((step.write_blk, step.write_off), k.to(ck.dtype))
    cv.index_put_((step.write_blk, step.write_off), v.to(cv.dtype))
    bt = step.block_table
    pos = step.positions
    if paged_impl == "gather" or impl is not None:
        T_view = bt.shape[1] * ck.shape[1]
        kk = ck[bt.long()].reshape(B, T_view, K, D)
        vv = cv[bt.long()].reshape(B, T_view, K, D)
        col = torch.arange(T_view, device=q.device)
        # zero v beyond each row's last position (0 x NaN = NaN: scratch/
        # recycled pages may hold non-finite residue)
        resident = col[None, :] <= pos.max(dim=1).values[:, None]
        vv = torch.where(resident[:, :, None, None], vv, torch.zeros_like(vv))
        full = col[None, None, :] <= pos[:, :, None]
        if impl is not None:
            return _impl_call(impl, alibi, plain)(q, kk, vv, full.int(),
                                                  causal=False)
        return dot_product_attention(q, kk, vv, full, causal=False,
                                     alibi=alibi)
    if plain:
        return reference_paged_attention(q, ck, cv, bt, pos, alibi=alibi)
    if step.lengths is not None:
        return paged_decode_attention(q[:, 0], ck, cv, bt, step.lengths,
                                      alibi=alibi)[:, None]
    if step.start is not None:
        return paged_prefill_attention(q, ck, cv, bt, step.start,
                                       alibi=alibi, n_valid=step.n_valid)
    return reference_paged_attention(q, ck, cv, bt, pos, alibi=alibi)


@dataclasses.dataclass
class _DenseStep:
    """Per-forward bookkeeping of the dense and cache-less modes, shared by
    every layer. ``mode``: 'none' (no cache), 'decode' (S == 1), 'prefill'
    (static prefill from position 0) or 'general' (any other start)."""

    mode: str
    start: int                           # the write cursor
    mask: Optional[torch.Tensor]         # (B, S) | (B, T) int32 | (B, S, T)
    kv_len: Optional[int]                # decode: columns < start + 1 live
    key_positions: Optional[torch.Tensor]


def _dense_step(S: int, B: int, cache: Optional[Dict[str, torch.Tensor]],
                attention_mask: Optional[torch.Tensor], start_pos: int,
                key_positions: Optional[torch.Tensor],
                device) -> _DenseStep:
    if cache is None:
        return _DenseStep("none", 0, attention_mask, None, None)
    T = cache["k"].shape[2]
    start = int(start_pos)
    if start < 0 or start + S > T:
        raise ValueError(f"dense cache write [{start}, {start + S}) outside "
                         f"the arena's {T} columns")
    if attention_mask is not None and attention_mask.shape != (B, T):
        raise ValueError(f"attention_mask must be ({B}, {T}) over the arena "
                         f"with a dense cache, got "
                         f"{tuple(attention_mask.shape)}")
    if S == 1:
        # valid * (col <= start) is valid over the columns < start + 1: the
        # kernel gets kv_len instead of a second mask
        valid = (attention_mask if attention_mask is not None
                 else torch.ones(B, T, dtype=torch.int32, device=device))
        return _DenseStep("decode", start, valid.int(), start + 1,
                          key_positions)
    col = torch.arange(T, device=device)
    if start == 0:
        valid = (attention_mask if attention_mask is not None
                 else (col < S).int()[None].expand(B, T))
        return _DenseStep("prefill", 0, valid.int(), None, None)
    q_pos = start + torch.arange(S, device=device)
    full = (col[None, :] <= q_pos[:, None])[None].expand(B, S, T)
    if attention_mask is not None:
        full = full & (attention_mask != 0)[:, None, :]
    return _DenseStep("general", start, full, None, key_positions)


def _impl_dense_mask(step: _DenseStep, S: int, T: int) -> torch.Tensor:
    """The (B, S, T) int32 mask JAX hands a custom impl over the arena:
    causal over absolute positions (query s at ``start + s``) and the
    (B, T) validity (JAX :970-983)."""
    if step.mode == "general":
        return step.mask.int()
    dev = step.mask.device
    q_pos = step.start + torch.arange(S, device=dev)
    causal = torch.arange(T, device=dev)[None, :] <= q_pos[:, None]
    return (causal[None] & (step.mask != 0)[:, None, :]).int()


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layer_cache: Optional[Dict[str, torch.Tensor]],
                     step: _DenseStep, alibi: Optional[torch.Tensor],
                     plain: bool, impl: Optional[Callable] = None,
                     causal: bool = True) -> torch.Tensor:
    """Write this step's K/V into the dense arena at the cursor (in place;
    JAX updates it with ``dynamic_update_slice``), then attend. A custom
    ``impl`` is called as JAX calls it (cache-less :1010-1015, over the
    arena :984-1000)."""
    flash = reference_flash_attention if plain else flash_attention
    if layer_cache is None:
        if impl is not None:
            return _impl_call(impl, alibi, plain)(q, k, v, step.mask,
                                                  causal=causal)
        return flash(q, k.contiguous(), v.contiguous(), step.mask,
                     causal=True, alibi=alibi)
    ck, cv = layer_cache["k"], layer_cache["v"]
    S = q.shape[1]
    ck[:, step.start:step.start + S] = k
    cv[:, step.start:step.start + S] = v
    if impl is not None:
        extra = {}
        if alibi is not None and step.key_positions is not None:
            _require_impl_kwarg(impl, "key_positions",
                                "ragged alibi decode")
            extra["key_positions"] = step.key_positions
        return _impl_call(impl, alibi, plain, **extra)(
            q, ck, cv, _impl_dense_mask(step, S, ck.shape[1]), causal=False)
    if step.mode == "decode":
        decode = reference_decode_attention if plain else decode_attention
        return decode(q[:, 0], ck, cv, step.mask, alibi=alibi,
                      key_positions=step.key_positions,
                      kv_len=step.kv_len)[:, None]
    if step.mode == "prefill":
        # queries sit at columns 0..S-1, so the kernel's 0-based causality
        # over the arena is exact; the (B, T) mask hides padding and
        # unwritten (stale) columns
        return flash(q, ck, cv, step.mask, causal=True, alibi=alibi)
    return dot_product_attention(q, ck, cv, step.mask, causal=False,
                                 alibi=alibi,
                                 key_positions=step.key_positions)


def _moe_ffn(cfg: TransformerConfig, h: torch.Tensor, layer: Dict[str, Any],
             infer: bool, rng: Optional[torch.Generator],
             groups: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of one layer and its aux loss (JAX :1054-1086). With a
    cache (``infer``) routing is exact: no capacity drops and no RTS, so a
    decode token is never dropped and chunk-padding queries steal no
    capacity. ``groups``: the rank's ``ExpertGroups`` when the batch and
    the banks span ranks (global gating, expert parallelism)."""
    out, aux = moe_mlp(h, layer["router"], layer["mlp"], cfg.activation,
                       top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       min_capacity=cfg.moe_min_capacity,
                       drop_tokens=cfg.moe_drop_tokens and not infer,
                       use_rts=cfg.moe_use_rts and not infer, rng=rng,
                       dispatch_impl=cfg.moe_dispatch, groups=groups)
    if cfg.moe_use_residual:
        # PR-MoE: a dense MLP beside the experts, mixed by a learned softmax
        # coefficient over (moe, dense)
        res = layer["res_mlp"]
        inner = F.gelu(h @ res["w_up"] + res["b_up"], approximate="tanh")
        res_out = inner @ res["w_down"] + res["b_down"]
        coef = torch.softmax((h @ layer["res_coef"]["w"]
                              + layer["res_coef"]["b"]).float(),
                             dim=-1).to(h.dtype)
        out = out * coef[..., 0:1] + res_out * coef[..., 1:2]
    return out, aux


def _layer_forward(cfg: TransformerConfig, x: torch.Tensor,
                   layer: Dict[str, Any],
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                   attend: Callable[..., torch.Tensor],
                   plain: bool, infer: bool = False,
                   rng: Optional[torch.Generator] = None,
                   groups: Any = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-LN decoder block -> (x, the MoE aux loss or None). ``rope``:
    the (cos, sin) tables of this step's positions, shared by every layer;
    ``attend(q, k, v)``: the layer's attention in the forward's cache mode;
    ``infer``: a cache is given (MoE routes exactly); ``rng``: RTS's
    draws; ``groups``: the rank's MoE process groups (``_moe_ffn``)."""
    B, S, H = x.shape
    N, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_p = layer["attn"]
    h = _norm(x, layer["ln1"]["scale"], layer["ln1"].get("bias"), cfg.norm,
              cfg.norm_eps, plain)
    qe = partial(_qeinsum, dtype=cfg.dtype, a8=cfg.a8_decode, plain=plain)
    q = qe(h, attn_p["wq"])
    k = qe(h, attn_p["wk"])
    v = qe(h, attn_p["wv"])
    if "bq" in attn_p:
        q = q + attn_p["bq"]
        k = k + attn_p["bk"]
        v = v + attn_p["bv"]
    q = q.view(B, S, N, D)
    k = k.view(B, S, K, D)
    v = v.view(B, S, K, D)
    if rope is not None:
        rd = cfg.rotary_dim or D
        cos, sin = rope
        if rd < D:
            # partial rotary (GPT-J/NeoX): rope on the first rd dims only
            q = torch.cat([apply_rope(q[..., :rd], cos, sin), q[..., rd:]],
                          dim=-1)
            k = torch.cat([apply_rope(k[..., :rd], cos, sin), k[..., rd:]],
                          dim=-1)
        else:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    attn = attend(q.contiguous(), k, v)
    attn_out = qe(attn.reshape(B, S, N * D), attn_p["wo"])
    if "bo" in attn_p:
        attn_out = attn_out + attn_p["bo"]
    if cfg.parallel_residual:
        # GPT-J/NeoX: the MLP reads the ORIGINAL x through its own norm
        h = _norm(x, layer["ln2"]["scale"], layer["ln2"].get("bias"),
                  cfg.norm, cfg.norm_eps, plain)
    else:
        x = x + attn_out
        h = _norm(x, layer["ln2"]["scale"], layer["ln2"].get("bias"),
                  cfg.norm, cfg.norm_eps, plain)
    mlp = layer["mlp"]
    aux = None
    if cfg.moe_num_experts > 0:
        mlp_out, aux = _moe_ffn(cfg, h, layer, infer, rng, groups)
    elif cfg.activation == "swiglu":
        inner = F.silu(qe(h, mlp["w_gate"])) * qe(h, mlp["w_up"])
        mlp_out = qe(inner, mlp["w_down"])
    else:
        inner = qe(h, mlp["w_up"]) + mlp["b_up"]
        if cfg.activation == "relu":
            inner = F.relu(inner)
        elif cfg.activation == "quick_gelu":
            inner = inner * torch.sigmoid(1.702 * inner)
        elif cfg.activation == "gelu-exact":
            inner = F.gelu(inner)
        elif cfg.activation == "gelu":
            inner = F.gelu(inner, approximate="tanh")
        else:
            raise NotImplementedError(f"activation '{cfg.activation}'")
        mlp_out = qe(inner, mlp["w_down"]) + mlp["b_down"]
    if cfg.parallel_residual:
        return x + attn_out + mlp_out, aux
    return x + mlp_out, aux


def _layer_views(layers: Dict[str, Any], num_layers: int
                 ) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked leaves, one ``unbind`` per leaf: its
    backward is one ``stack``, where indexing ``t[li]`` would add a
    zero-filled (L, ...) gradient into the leaf once per layer."""
    parts = tree_map(lambda t: t.unbind(0), layers)
    return [tree_map(lambda p, li=li: p[li], parts)
            for li in range(num_layers)]


def forward(params: Dict[str, Any], input_ids: torch.Tensor,
            cfg: TransformerConfig,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            positions: Optional[torch.Tensor] = None,
            block_table: Optional[torch.Tensor] = None,
            paged_write_mask: Optional[torch.Tensor] = None,
            paged_impl: str = "auto", paged_chunk: bool = False,
            plain: bool = False,
            attention_mask: Optional[torch.Tensor] = None,
            start_pos: int = 0,
            key_positions: Optional[torch.Tensor] = None,
            with_aux: bool = False,
            rng: Optional[torch.Generator] = None,
            moe_groups: Any = None) -> Tuple[Any, ...]:
    """Token ids (B, S) -> (logits (B, S, V), cache); the cache, if any, is
    written in place. ``plain`` runs the plain versions of the norm and
    attention kernels on any device. ``with_aux``: return (logits, cache,
    aux) as JAX does, aux the sum over the layers of the MoE load-balancing
    loss (an fp32 zero for a dense model); ``rng``: the generator of MoE's
    Random Token Selection (the device's default one when None);
    ``moe_groups``: the rank's ``parallel.topology.ExpertGroups`` when the
    batch and the expert banks span ranks (training beyond one rank).

    PAGED (``block_table`` (B, MAX_BLOCKS) int32 given): ``cache = {"k","v":
    (L, NUM_BLOCKS, BLOCK, K, D)}``; ``positions`` (B, S) per-row absolute
    positions (-1 marks a chunk-padding query) are required;
    ``paged_write_mask`` (B, S) sends masked-off tokens' writes to scratch
    block 0; ``paged_chunk`` asserts the chunked-prefill contract
    (``positions[b] = start_b + arange(S)`` over the valid prefix), which
    lets S > 1 take the paged prefill kernel; ``paged_impl='gather'`` reads
    the dense ``arena[block_table]`` view instead.

    DENSE (``cache = {"k","v": (L, B, T, K, D)}`` without a block table):
    the tokens are written at columns ``start_pos .. start_pos + S - 1``
    (a host int); ``attention_mask`` (B, T) marks the valid columns;
    ``key_positions`` (B, T) are the keys' true positions for alibi in
    decode. CACHE-LESS (no ``cache``): ``attention_mask`` (B, S) is key
    padding. In both, ``positions`` ((S,) shared or (B, S) per row)
    defaults to ``start_pos + arange(S)``."""
    check_servable(cfg)
    if paged_impl not in ("auto", "gather"):
        raise ValueError(f"paged_impl must be 'auto' or 'gather', "
                         f"got '{paged_impl}'")
    B, S = input_ids.shape
    paged = block_table is not None
    if paged and (cache is None or positions is None
                  or positions.dim() != 2):
        raise ValueError("paged mode (block_table) requires cache= and "
                         "explicit (B, S) positions")
    dev = input_ids.device
    if positions is None:
        positions = torch.arange(S, device=dev) + int(start_pos)
    x = embed(params, input_ids, positions, cfg, plain)
    alibi, impl = _alibi_and_impl(cfg, x.device)
    if paged:
        step = _paged_step(block_table, positions, cache["k"].shape[2],
                           paged_write_mask, paged_chunk)
        positions = step.positions
        attention = partial(_paged_attention, step=step,
                            paged_impl=paged_impl, alibi=alibi, plain=plain,
                            impl=impl)
    else:
        step = _dense_step(S, B, cache, attention_mask, start_pos,
                           key_positions, dev)
        attention = partial(_dense_attention, step=step, alibi=alibi,
                            plain=plain, impl=impl, causal=cfg.causal)
    rope = _rope(cfg, positions)
    auxes: List[torch.Tensor] = []

    def step(li: int, layer: Dict[str, Any], x: torch.Tensor):
        # the aux loss rides beside x: its backward reaches the layer's
        # params only through the router's product, which also waits for
        # the layer output's gradient, so stage 3's re-gather hook on that
        # output has run by then
        lc = (None if cache is None
              else {"k": cache["k"][li], "v": cache["v"][li]})
        x, aux = _layer_forward(cfg, x, layer, rope,
                                partial(attention, layer_cache=lc), plain,
                                infer=cache is not None, rng=rng,
                                groups=moe_groups)
        if aux is not None:
            auxes.append(aux)
        return x

    x = _run_layers(params["layers"], cfg.num_layers, x, step)
    logits = head_logits(params, x, cfg, plain)
    if with_aux:
        return logits, cache, _sum_aux(auxes, x.device)
    return logits, cache


def _sum_aux(auxes: List[torch.Tensor], device) -> torch.Tensor:
    """The layers' aux losses summed in layer order from an fp32 zero, as
    JAX's scan carries them."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for aux in auxes:
        total = total + aux
    return total


def embed(params: Dict[str, Any], input_ids: torch.Tensor,
          positions: torch.Tensor, cfg: TransformerConfig,
          plain: bool = False) -> torch.Tensor:
    """The first layer's input: the token embedding, plus the learned
    position embedding at ``positions``, then BLOOM's norm (JAX
    ``embed_fwd``). ``forward`` and the parameter-offload executor both
    call it."""
    x = params["embed"]["tokens"][input_ids].to(cfg.dtype)
    if cfg.position == "learned":
        x = x + params["pos"][positions.long()].to(cfg.dtype)
    if cfg.embed_norm:
        x = _norm(x, params["embed_norm"]["scale"],
                  params["embed_norm"].get("bias"), "layernorm",
                  cfg.norm_eps, plain)
    return x


def _alibi_and_impl(cfg: TransformerConfig, device
                    ) -> Tuple[Optional[torch.Tensor], Optional[Callable]]:
    """The alibi slopes (alibi models) and the custom attention impl, which
    must then take ``alibi=``."""
    alibi = (_alibi_table(cfg.num_heads, device)
             if cfg.position == "alibi" else None)
    impl = cfg.attention_impl
    if alibi is not None and impl is not None:
        _require_impl_kwarg(impl, "alibi",
                            "position='alibi' models (BLOOM) — silently "
                            "dropping the alibi bias would change the model")
    return alibi, impl


def _rope(cfg: TransformerConfig, positions: torch.Tensor
          ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    return (rope_table(positions, cfg.rotary_dim or cfg.head_dim,
                       cfg.rope_theta) if cfg.position == "rope" else None)


def layers_forward(layers: List[Dict[str, Any]], x: torch.Tensor,
                   cfg: TransformerConfig,
                   attention_mask: Optional[torch.Tensor] = None,
                   plain: bool = False, with_aux: bool = False) -> Any:
    """``x`` through ``layers`` (per-layer param dicts, in order) as the
    cache-less ``forward`` runs its layers: positions ``arange(S)``, the
    same rope table, attention (flash, or the config's impl) and causal
    mask. A block of parameter offload runs its layers through it (JAX
    ``block_fwd``), so a block launches the train path's kernels.
    ``with_aux``: return (x, the sum of the layers' MoE aux losses)."""
    B, S = x.shape[:2]
    alibi, impl = _alibi_and_impl(cfg, x.device)
    step = _dense_step(S, B, None, attention_mask, 0, None, x.device)
    attend = partial(_dense_attention, layer_cache=None, step=step,
                     alibi=alibi, plain=plain, impl=impl, causal=cfg.causal)
    rope = _rope(cfg, torch.arange(S, device=x.device))
    auxes = []
    for layer in layers:
        x, aux = _layer_forward(cfg, x, layer, rope, attend, plain)
        if aux is not None:
            auxes.append(aux)
    return (x, _sum_aux(auxes, x.device)) if with_aux else x


def _run_layers(layers: Any, num_layers: int, x: torch.Tensor,
                step: Callable[[int, Dict[str, Any], torch.Tensor],
                               torch.Tensor]) -> torch.Tensor:
    """``x = step(li, layer, x)`` for each layer. ``layers``: the stacked
    leaves, or an object with its own ``run(x, step)`` (ZeRO stage 3's
    ``parallel.zero.GatheredLayers``, which gathers each layer's params
    around its step)."""
    if not isinstance(layers, dict):
        return layers.run(x, step)
    for li, layer in enumerate(_layer_views(layers, num_layers)):
        x = step(li, layer, x)
    return x


def head_logits(params: Dict[str, Any], x: torch.Tensor,
                cfg: TransformerConfig, plain: bool = False) -> torch.Tensor:
    """Final norm + output projection."""
    if cfg.final_norm:
        x = _norm(x, params["final_norm"]["scale"],
                  params["final_norm"].get("bias"), cfg.norm, cfg.norm_eps,
                  plain)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tokens"].t()
    logits = _qeinsum(x, params["lm_head"], cfg.dtype, a8=cfg.a8_decode,
                      plain=plain)
    if "lm_head_b" in params:
        logits = logits + params["lm_head_b"]
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy in fp32 (JAX ``cross_entropy_loss``):
    labels == -100 and positions where ``mask`` is 0 are ignored; the mean
    is over the remaining positions."""
    valid = labels != -100
    if mask is not None:
        valid = valid & (mask != 0)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    token_loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return token_loss.sum() / valid.sum().clamp(min=1)


def build_model(cfg: TransformerConfig, name: str = "transformer") -> Model:
    """Bundle init, the training loss (JAX ``build_model``: labels default
    to ``input_ids`` shifted left, the last position ignored; an MoE model
    adds ``moe_aux_loss_coef * aux / num_layers``) and its eval variant.
    ``loss_fn(params, batch, plain=False, rng=None, moe_groups=None)``;
    ``plain`` runs the kernels' plain versions on any device, ``rng`` draws
    MoE's RTS, ``moe_groups`` are the rank's MoE process groups
    (``forward``)."""

    def make_loss(c: TransformerConfig):
        def loss_fn(params, batch, plain: bool = False,
                    rng: Optional[torch.Generator] = None,
                    moe_groups: Any = None):
            ids = batch["input_ids"]
            mask = batch.get("attention_mask")
            moe = c.moe_num_experts > 0
            out = forward(params, ids, c, attention_mask=mask, plain=plain,
                          with_aux=moe, rng=rng, moe_groups=moe_groups)
            labels = batch.get("labels")
            if labels is None:
                labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1],
                                                                -100)], 1)
            loss = cross_entropy_loss(out[0], labels, mask)
            if moe:
                loss = loss + c.moe_aux_loss_coef * out[2] / max(
                    c.num_layers, 1)
            return loss

        return loss_fn

    def eval_loss_fn(params, batch, plain: bool = False,
                     rng: Optional[torch.Generator] = None,
                     moe_groups: Any = None):
        with torch.no_grad():
            return make_loss(eval_config(cfg))(params, batch, plain, rng,
                                               moe_groups)

    return Model(init=lambda generator, **kw: init_params(generator, cfg,
                                                          **kw),
                 config=cfg, name=name, loss_fn=make_loss(cfg),
                 eval_loss_fn=eval_loss_fn, streams_layers=True)
