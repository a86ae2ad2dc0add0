"""Quantized decode GEMMs: weight-only int8 / int4 and W8A8 / W4A8.

Counterpart of ``deepspeed_tpu/ops/quant_matmul.py``. Each of
``int8_matmul``, ``int8_a8_matmul``, ``int4_matmul`` and ``int4_a8_matmul``
launches its CUDA kernel on a CUDA tensor (the weight-only ones
``csrc/quant_matmul.cu``, the a8 ones ``csrc/quant_matmul_a8.cu``) and runs
its plain version (``reference_*``, the JAX oracle's arithmetic) on a CPU
tensor. The kernels take what the decode path gives them: x (M <= 8, K),
the output in x's dtype; the weight-only ones take float32, bfloat16 or
float16 x (JAX casts the weight to x's dtype), the a8 ones float32 or
bfloat16. Which call reaches them is decided by
``models.transformer._qeinsum`` (JAX's gate); a CUDA call the kernel does
not take raises.

The weight-only wrappers route by x's dtype (``weight_only_kernel``):
bfloat16 and float16 run ``quant_matmul_tc_kernel`` on the tensor cores,
with the cluster split and ring stages of ``tc_plan``; float32 runs the
CUDA-core ``quant_matmul_kernel``. There is no fallback between them.

Layouts (the JAX package's):

* int8: ``q8`` (K, N) int8 and per-output-channel scales ``s`` (1, N) fp32,
  w = q8 * s;
* int4: ``q4`` (K/2, N) uint8, rows [0, K/2) in the LOW nibble and rows
  [K/2, K) in the HIGH nibble (not interleaved), values in [-7, 7] as 4-bit
  two's complement; scales ``s`` (G, N) fp32 per (group of K/G rows, output
  channel).

The a8 variants quantize each row of x on the fly (``quantize_activation_rows``:
absmax / 127, round half to even, clip to +-127) and multiply in integers.
They take what JAX's ``int8_a8_matmul`` / ``int4_a8_matmul`` take (K and N,
for int4 K/2 and N, multiples of 128), with 1..8 rows and int4 groups of a
multiple of 16 rows (``check_a8_operands``, device-free).

Every quantizer here divides by a tensor, never by a Python number: on a
CUDA tensor ATen turns a division by a scalar into a product with its
reciprocal, which moves some scales by one ulp from the CPU's and JAX's
eager IEEE division.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import registry

MAX_ROWS = 8              # activation rows the kernels take (decode-shaped)
COL_ALIGN = 32            # the weight-only kernels' N multiple
TC_COLS = 128             # quant_matmul_tc_kernel: output columns of a tile
TC_ROWS = 64              # its weight rows of one ring stage
TC_MAX_CLUSTER = 8        # its blocks a column tile (a portable cluster)
TC_BLOCKS_PER_SM = 3      # its resident blocks an SM (__launch_bounds__)
A8_ALIGN = 128            # JAX's a8 kernels' K / N (int4: K/2 / N) multiple
A8_GROUP = 16             # the a8 kernel's int4 groups: a multiple of 16 rows
A8_MAX_K = 32768          # the a8 kernel holds K/8 of x in shared memory

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_A8_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# quantizers and plain versions
# ---------------------------------------------------------------------------


def quantize_activation_rows(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> (int8 values, (M, 1) fp32 per-row scales)."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    s = torch.where(absmax == 0.0, torch.ones_like(absmax),
                    absmax / torch.full_like(absmax, 127.0))
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s


def quantize_int4(w: torch.Tensor, group_size: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float -> (q4 (..., K/2, N) uint8, s (..., G, N) fp32).
    Symmetric, qmax 7; ``group_size`` groups along K (None: one group)."""
    *lead, K, N = w.shape
    if K % 2:
        raise ValueError(f"int4 packing needs even K, got {K}")
    gs = group_size or K
    if K % gs or (group_size and (K // 2) % gs):
        raise ValueError(f"group_size {gs} must divide K/2 ({K // 2})")
    G = K // gs
    w32 = w.float().reshape(*lead, G, gs, N)
    absmax = w32.abs().amax(dim=-2)                        # (..., G, N)
    s = torch.where(absmax == 0.0, torch.ones_like(absmax),
                    absmax / torch.full_like(absmax, 7.0))
    q = torch.clamp(torch.round(w32 / s[..., None, :]), -7, 7).to(torch.int32)
    q = q.reshape(*lead, K, N)
    lo = q[..., :K // 2, :] & 0xF
    hi = (q[..., K // 2:, :] & 0xF) << 4
    return (lo | hi).to(torch.uint8), s


def _unpack_nibbles(q4: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) uint8 -> (..., K, N) int32 values in [-8, 7]."""
    q = q4.to(torch.int32)
    lo = ((q & 0xF) ^ 8) - 8            # sign-extend 4-bit two's complement
    hi = ((q >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2)


def unpack_int4(q4: torch.Tensor, s: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense dequant: (..., K/2, N) uint8 + (..., G, N) scales -> (..., K,
    N) in ``out_dtype`` (the scales applied in fp32)."""
    w = _unpack_nibbles(q4).float()
    *lead, K, N = w.shape
    G = s.shape[-2]
    w = w.reshape(*lead, G, K // G, N) * s[..., None, :].float()
    return w.reshape(*lead, K, N).to(out_dtype)


def reference_int8_matmul(x, q8, scale, out_dtype=None):
    """Plain version: dense dequant, then the product in fp32."""
    out_dtype = out_dtype or x.dtype
    w = q8.float() * scale.float()
    return (x.float() @ w).to(out_dtype)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product as fp32 (RN of the int32 sum, as JAX's
    ``acc.astype(float32)``): float64 holds every partial sum exactly and
    runs on both devices, where an int32 matmul does not."""
    return (a.double() @ b.double()).float()


def reference_int8_a8_matmul(x, q8, scale, out_dtype=None):
    """Plain version: explicit activation quantization, integer product,
    then ``acc * sx * s``."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_activation_rows(x)
    acc = _int_matmul(xq, q8)
    return (acc * sx * scale.float()).to(out_dtype)


def reference_int4_a8_matmul(x, q4, scale, out_dtype=None):
    """Plain version: activation quantization, per-group integer partial
    products (exact in fp32 at these sizes), each scaled by its group's
    scales, summed, then times ``sx``. With several groups on shapes the
    kernel takes, the scaled partials are summed in the kernel's order
    (``_a8_group_sum``), so the two agree bit for bit."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_activation_rows(x)
    w = _unpack_nibbles(q4)                                 # (K, N)
    K, N = w.shape
    G = scale.shape[0]
    gs = K // G
    if G > 1 and (K // 2) % 32 == 0 and gs % 16 == 0:
        out = _a8_group_sum(xq.float(), w.float(), scale.float(), gs)
    else:
        accs = torch.einsum("mgk,gkn->mgn",
                            xq.float().reshape(xq.shape[0], G, gs),
                            w.float().reshape(G, gs, N))
        out = (accs * scale.float()[None]).sum(dim=1)
    return (out * sx).to(out_dtype)


A8_CLUSTER = 8   # blocks that split K in csrc/quant_matmul_a8.cu (kCluster)


def _a8_group_sum(xq: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  gs: int) -> torch.Tensor:
    """sum_g (xq_g . w_g) * scale[g] in the grouped W4A8 kernel's order.
    The kernel cuts the K / 2 packed rows into A8_CLUSTER ranges of 32-row
    steps; each range walks its rows in 16-row units, keeping one exact
    integer partial for the current group of each nibble plane (low: logical
    rows < K / 2, high: the rest), and at each change of group (low before
    high) and at the range's end adds partial x scale into an fp32 sum
    (product, then sum, each rounded); the ranges' sums are added in rank
    order."""
    K2 = w.shape[0] // 2
    steps = K2 // 32
    tot = torch.zeros(xq.shape[0], w.shape[1], dtype=torch.float32,
                      device=xq.device)
    for r in range(A8_CLUSTER):
        lo, hi = 32 * (r * steps // A8_CLUSTER), \
            32 * ((r + 1) * steps // A8_CLUSTER)
        facc = torch.zeros_like(tot)
        # runs of rows in one group: (plane offset, first row, end row),
        # in the order the kernel flushes them
        runs, cur = [], {0: None, K2: None}
        for row in range(lo, hi, 16):
            for plane in (0, K2):
                g = (plane + row) // gs
                if cur[plane] is None or cur[plane][0] != g:
                    if cur[plane] is not None:
                        runs.append((plane, *cur[plane][1:], row))
                    cur[plane] = (g, row)
        for plane in (0, K2):
            if cur[plane] is not None:
                runs.append((plane, *cur[plane][1:], hi))
        for plane, a, b in runs:
            part = xq[:, plane + a:plane + b] @ w[plane + a:plane + b]
            facc = facc + part * scale[(plane + a) // gs]
        tot = tot + facc
    return tot


def reference_int4_matmul(x, q4, scale, out_dtype=None):
    """Plain version: dense unpack and dequant, then the product in fp32."""
    out_dtype = out_dtype or x.dtype
    return (x.float() @ unpack_int4(q4, scale, torch.float32)).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


# x, q, s, out, M, K, N, G, int4, dtype, stream (dstt_quant_matmul and the
# a8 entry); dstt_quant_matmul_tc adds x's high-plane column (int4), the
# cluster and the stages before the stream
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def weight_only_kernel(dtype: torch.dtype) -> str:
    """The CUDA kernel a weight-only call with x of ``dtype`` runs:
    ``quant_matmul_tc_kernel`` (tensor cores) for bfloat16 and float16,
    ``quant_matmul_kernel`` (CUDA cores) for float32."""
    if dtype == torch.float32:
        return "quant_matmul_kernel"
    if dtype in (torch.bfloat16, torch.float16):
        return "quant_matmul_tc_kernel"
    raise ValueError(f"weight-only quantized GEMMs take float32, bfloat16 "
                     f"or float16 x, not {dtype}")


def tc_plan(M: int, K: int, N: int, G: int, int4: bool,
            sms: int) -> Tuple[int, int]:
    """(cluster, stages) of ``quant_matmul_tc_kernel`` for x (M, K) times a
    (K, N) weight in G scale groups, on a card of ``sms`` SMs; no device
    needed. A column tile is TC_COLS wide and a ring stage TC_ROWS weight
    rows (``K / 2`` rows for int4); ``cluster`` blocks split a tile's
    stages, and a block whose share of K is empty still runs (it pushes
    zeros). The cluster is the largest power of two, at most
    TC_MAX_CLUSTER, whose grid fits in one wave of resident blocks
    (TC_BLOCKS_PER_SM an SM; timed on the H100, a second wave cost more
    than a smaller split); ``stages``: four, or fewer when a block has
    fewer stages of rows. M and G do not change it."""
    del M, G            # the weight's bytes set the split
    rows = K // 2 if int4 else K
    tiles = -(-N // TC_COLS)
    slots = TC_BLOCKS_PER_SM * sms
    cluster = TC_MAX_CLUSTER
    while cluster > 1 and tiles * cluster > slots:
        cluster //= 2
    steps = -(-rows // TC_ROWS)
    return cluster, max(1, min(4, -(-steps // cluster)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_common(name: str, x: torch.Tensor, out_dtype,
                  dtypes=tuple(_DTYPES)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: x must be one of "
                         f"{', '.join(str(d) for d in dtypes)}, got "
                         f"{x.dtype}")
    if out_dtype is not None and out_dtype != x.dtype:
        raise ValueError(f"{name}: the kernel writes x's dtype {x.dtype}, "
                         f"not {out_dtype}")


def _aligned(name: str, x: torch.Tensor, *others) -> torch.Tensor:
    """x contiguous and 16-byte aligned (copied if not); the weight and the
    scales must already be, on x's device."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous() if not x.is_contiguous() else x.clone()
    for label, t in zip(("weight", "scales"), others):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            # the kernels read 16-byte vectors of weight rows and scales
            raise ValueError(f"{name}: {label} must be contiguous and start "
                             "16-byte aligned")
    return x


def _launch(name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            out_dtype, int4: bool) -> torch.Tensor:
    """Check the operands of a weight-only CUDA call and launch the kernel
    of x's dtype (``weight_only_kernel``)."""
    _check_common(name, x, out_dtype)
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"{name}: x, the weight and the scales must be 2-D; "
                         f"got {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}")
    M, K = x.shape
    rows, N = q.shape
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_ROWS} rows, got "
                         f"{M}")
    want = torch.uint8 if int4 else torch.int8
    if q.dtype != want:
        raise ValueError(f"{name}: weight must be {want}, got {q.dtype}")
    if rows * (2 if int4 else 1) != K:
        raise ValueError(f"{name}: x has K={K}, the weight {rows} "
                         f"{'packed ' if int4 else ''}rows")
    G = scale.shape[0]
    if scale.dtype != torch.float32 or scale.shape[1] != N \
            or (not int4 and G != 1) or G < 1 or K % G:
        raise ValueError(f"{name}: scales must be float32 ({'G' if int4 else 1}"
                         f", {N}) with G dividing K; got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    gs = K // G
    if N % COL_ALIGN or K % 8 or gs % 4 or (int4 and G > 1 and rows % gs):
        raise ValueError(f"{name}: needs N % {COL_ALIGN} == 0, K % 8 == 0 and "
                         f"groups of a multiple of 4 rows inside each nibble "
                         f"plane; got K={K}, N={N}, G={G}")
    x = _aligned(name, x, q, scale)
    tc = weight_only_kernel(x.dtype) == "quant_matmul_tc_kernel"
    xh = -(-rows // 8) * 8 if int4 else K     # x's high-plane column (tc)
    if tc and int4 and xh != rows:
        # the kernel reads x's high plane in TMA boxes, which start on 16
        # bytes: move it to column xh, a multiple of 8 elements
        xp = x.new_zeros(M, 2 * xh)
        xp[:, :rows] = x[:, :rows]
        xp[:, xh:xh + rows] = x[:, rows:]
        x = xp
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, K, N, G, int(int4), _DTYPES[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tc:
        fn = registry.function("quant_matmul", "dstt_quant_matmul_tc",
                               _TC_ARGS)
        err = fn(*args, xh, *tc_plan(M, K, N, G, int4, _sms(x.device.index)),
                 stream)
    else:
        fn = registry.function("quant_matmul", "dstt_quant_matmul", _ARGS)
        err = fn(*args, stream)
    registry.check_launch(name, err)
    return out


def check_a8_operands(name: str, x_shape, q_shape, scale_shape
                      ) -> Tuple[int, int, int, int]:
    """The a8 kernels' shape rules, device-free: JAX's checks first, with
    its messages (int4: ``x K`` against the packed rows, then K/2 and N %
    128; int8: K and N % 128), then the kernel's own (1..8 rows, scales
    (G, N) with G == 1 for int8, int4 groups of a multiple of A8_GROUP
    rows). ``name`` is ``int8_a8_matmul`` or ``int4_a8_matmul``. Returns
    (M, K, N, G); raises ValueError. Beyond JAX: K <= A8_MAX_K."""
    int4 = name == "int4_a8_matmul"
    if len(x_shape) != 2 or len(q_shape) != 2 or len(scale_shape) != 2:
        raise ValueError(f"{name}: x, the weight and the scales must be 2-D; "
                         f"got {tuple(x_shape)}, {tuple(q_shape)}, "
                         f"{tuple(scale_shape)}")
    M, K = x_shape
    rows, N = q_shape
    if int4:
        if K != 2 * rows:
            raise ValueError(f"x K={K} vs packed K/2={rows}")
        if rows % A8_ALIGN or N % A8_ALIGN:
            raise ValueError(f"int4_a8_matmul needs K/2,N % 128 == 0, "
                             f"got {rows}x{N}")
    else:
        if K % A8_ALIGN or N % A8_ALIGN:
            raise ValueError(f"int8_a8_matmul needs K,N % 128 == 0, got "
                             f"{K}x{N}")
        if rows != K:
            raise ValueError(f"{name}: x has K={K}, the weight {rows} rows")
    if not 1 <= M <= MAX_ROWS or K > A8_MAX_K:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_ROWS} rows and K "
                         f"up to {A8_MAX_K}, got {M} x {K}")
    G = scale_shape[0]
    if scale_shape[1] != N or G < 1 or (not int4 and G != 1) or K % G:
        raise ValueError(f"{name}: scales must be ({'G' if int4 else 1}, {N})"
                         f" with G dividing K; got {tuple(scale_shape)}")
    if (K // G) % A8_GROUP:
        raise ValueError(f"{name}: groups of {K // G} rows; the kernel takes "
                         f"a multiple of {A8_GROUP}")
    return M, K, N, G


def _launch_a8(name: str, x: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor, out_dtype, int4: bool) -> torch.Tensor:
    """Check the operands of an a8 CUDA call and launch the kernel."""
    _check_common(name, x, out_dtype, _A8_DTYPES)
    M, K, N, G = check_a8_operands(name, x.shape, q.shape, scale.shape)
    want = torch.uint8 if int4 else torch.int8
    if q.dtype != want or scale.dtype != torch.float32:
        raise ValueError(f"{name}: weight must be {want} and the scales "
                         f"float32, got {q.dtype} and {scale.dtype}")
    x = _aligned(name, x, q, scale)
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    fn = registry.function("quant_matmul_a8", "dstt_quant_matmul_a8", _ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             M, K, N, G, int(int4), _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    registry.check_launch(name, err)
    return out


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x (M, K) @ (q8 (K, N) int8 * scale (1, N)) -> (M, N)."""
    if x.device.type == "cpu":
        return reference_int8_matmul(x, q8, scale, out_dtype)
    return _launch("int8_matmul", x, q8, scale, out_dtype, False)


def int8_a8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """W8A8: rows of x quantized to int8, s8 x s8 -> s32, then
    ``acc * sx * scale``."""
    if x.device.type == "cpu":
        return reference_int8_a8_matmul(x, q8, scale, out_dtype)
    return _launch_a8("int8_a8_matmul", x, q8, scale, out_dtype, False)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x (M, K) @ unpack_int4(q4 (K/2, N), scale (G, N)) -> (M, N)."""
    if x.device.type == "cpu":
        return reference_int4_matmul(x, q4, scale, out_dtype)
    return _launch("int4_matmul", x, q4, scale, out_dtype, True)


def int4_a8_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """W4A8: rows of x quantized to int8, times the unpacked int4 values in
    integers, group partials scaled by ``scale``, then times ``sx``."""
    if x.device.type == "cpu":
        return reference_int4_a8_matmul(x, q4, scale, out_dtype)
    return _launch_a8("int4_a8_matmul", x, q4, scale, out_dtype, True)
