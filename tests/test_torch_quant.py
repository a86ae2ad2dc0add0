"""Quantized inference: the port against the JAX package.

Both packages get the same numpy inputs (seeded) and, for the engines, the
same weights (the JAX init of a widened preset plus seeded numpy noise), in
fp32 throughout:

* ``quantize_model_weights``, ``quantize_int4``, ``unpack_int4`` and
  ``quantize_activation_rows`` give JAX's values bit for bit (all-zero
  columns and rows take scale 1);
* the four plain versions (what a CPU tensor runs) match the JAX oracles
  ``reference_int8_matmul`` / ``reference_int8_a8_matmul`` /
  ``reference_int4_matmul`` / ``reference_int4_a8_matmul`` within
  ``2e-5 + 2e-5 |ref|`` (the same fp32 arithmetic summed in another order;
  the a8 integer parts are exact), and with fp16 x within two fp16 ulps
  (each side rounds its fp32 result to fp16 once);
* ``tc_plan``, the tensor-core kernel's host plan, and the weight-only
  wrappers' route by x's dtype;
* the a8 kernels' shape rules (``check_a8_operands``) refuse exactly the
  shapes JAX's ``int8_a8_matmul`` / ``int4_a8_matmul`` refuse before their
  ``pallas_call``;
* ``_qeinsum`` at every route against JAX's: the kernel route with JAX's
  TPU semantics engaged on the CPU (``tpu_route`` below), the dequant route,
  and the gate's edges;
* engines on ``tiny-llama`` and ``tiny`` widened so that every weight site
  passes the kernel gate (H 256, FFN 512 / 1024, vocab 256): greedy
  ``generate`` tokens equal the JAX engine's for int8 and int4 (G = 1 and
  group 128; fp32, and fp16 on ``tiny-llama``), W8A8 / W4A8 teacher-forced decode logits equal JAX's
  TPU-route logits within 1e-4, and int8 ``ServingEngine`` streams equal
  the JAX ``ServingEngine``'s.

JAX's CPU route never reaches a quantized kernel (``_kernels_active`` is
False off the TPU), so there a quantized decode is the weight-only dequant:
for int8 / int4 that is the same function as the port's plain kernel route
(the scale applied before or after the sum), for W8A8 / W4A8 it is not, so
those are compared with JAX's kernel route engaged by ``tpu_route``.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models.transformer as jt
import deepspeed_tpu.ops.quant_matmul as jq
from deepspeed_tpu.inference import kv_cache as jax_kv_cache
from deepspeed_tpu.inference.engine import InferenceConfig as JaxInfConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInfEngine
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu_torch.inference import (InferenceConfig, init_cache,
                                           init_inference)
from deepspeed_tpu_torch.inference.engine import check_quantized_compute
from deepspeed_tpu_torch.models import (params_from_jax, params_to_numpy,
                                        transformer_config)
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops import quant_matmul as pq

RTOL = ATOL = 2e-5         # op level: fp32, the same sums in another order
# op level with fp16 x: both sides sum in fp32 and round once to fp16, so
# they sit at most one fp16 ulp (2^-10 relative) apart; two for margin
FP16_RTOL, FP16_ATOL = 2.0 ** -9, 1e-6
LOGIT_TOL = 1e-4           # two layers of fp32 in two frameworks
T_MAX = 128
# every weight site passes the kernel gate (K, N and K/2 multiples of 128)
WIDE = {"tiny-llama": dict(hidden_size=256, ffn_hidden_size=512),
        "tiny": dict(hidden_size=256)}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@contextlib.contextmanager
def tpu_route():
    """JAX's quantized kernel route on the CPU: ``_kernels_active`` is True
    only inside ``_qeinsum`` (the Pallas attention and norm kernels, which
    cannot run here, stay off), the mesh counts as single-shard, and the
    four Pallas GEMMs are their ``reference_*`` oracles."""
    mp = pytest.MonkeyPatch()
    inside = [False]
    orig_active, orig_q = jt._kernels_active, jt._qeinsum

    def active():
        return inside[0] or orig_active()

    def qeinsum(*args, **kw):
        inside[0] = True
        try:
            return orig_q(*args, **kw)
        finally:
            inside[0] = False

    mp.setattr(jt, "_kernels_active", active)
    mp.setattr(jt, "_qeinsum", qeinsum)
    mp.setattr(jt, "_tp_world", lambda: 1)
    for name in ("int8_matmul", "int8_a8_matmul", "int4_matmul",
                 "int4_a8_matmul"):
        mp.setattr(jq, name, getattr(jq, "reference_" + name))
    try:
        yield
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def wide_weights(preset, seed=0):
    """(jax model, numpy weights) of the widened ``preset``: the JAX init
    plus seeded numpy noise on every leaf (read only: copy to edit)."""
    model = jax_create_model(preset, dtype=jnp.float32, max_seq_len=T_MAX,
                             **WIDE[preset])
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32),
        model.init(jax.random.PRNGKey(seed)))
    return model, tree


def weight(rng, K, N, zero_col=True):
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0                    # an all-zero column: scale 1
    return w


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


class TestQuantizers:
    def test_activation_rows_bit_identical(self):
        rng = np.random.default_rng(0)
        x = rng.normal(0, 2.0, (5, 384)).astype(np.float32)
        x[2] = 0.0                                    # zero row: scale 1
        # exact half-integers of x / s: round half to even in both
        x[3, :4] = np.float32(127.0) / np.float32(2.0) * np.asarray(
            [1.0, 0.01, 0.03, -0.05], np.float32)
        q, s = pq.quantize_activation_rows(torch.from_numpy(x))
        qj, sj = jq.quantize_activation_rows(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(_np(q), np.asarray(qj))
        np.testing.assert_array_equal(_np(s), np.asarray(sj))
        assert _np(s)[2, 0] == 1.0 and (_np(q)[2] == 0).all()

    @pytest.mark.parametrize("group_size", [None, 32, 128])
    def test_int4_pack_unpack_bit_identical(self, group_size):
        rng = np.random.default_rng(1)
        w = rng.normal(0, 0.05, (3, 256, 384)).astype(np.float32)
        w[1, :, 5] = 0.0
        q4, s = pq.quantize_int4(torch.from_numpy(w), group_size)
        q4j, sj = jq.quantize_int4(jnp.asarray(w), group_size)
        assert q4.dtype == torch.uint8 and tuple(q4.shape) == (3, 128, 384)
        np.testing.assert_array_equal(_np(q4), np.asarray(q4j))
        np.testing.assert_array_equal(_np(s), np.asarray(sj))
        np.testing.assert_array_equal(
            _np(pq.unpack_int4(q4, s)),
            np.asarray(jq.unpack_int4(q4j, sj, jnp.float32)))

    def test_int4_rejects_bad_groups(self):
        with pytest.raises(ValueError):
            pq.quantize_int4(torch.zeros(256, 128), 96)
        with pytest.raises(ValueError):
            pq.quantize_int4(torch.zeros(255, 128))

    @pytest.mark.parametrize("bits,group_size", [(8, None), (4, None),
                                                 (4, 32), (4, 128)])
    def test_model_weights_bit_identical(self, bits, group_size):
        """Against JAX's function as written (eager: a true division by
        127 / 7). Under ``jax.jit`` XLA turns the division by the constant
        into a product with its reciprocal, which moves ~5% of the scales
        by one ulp; the JAX engine's jitted load does that, the port does
        not."""
        _, tree = wide_weights("tiny-llama")
        tree = jax.tree.map(np.copy, tree)
        tree["layers"]["mlp"]["w_up"][1, :, 7] = 0.0
        want = jt.quantize_model_weights(jax.tree.map(jnp.asarray, tree),
                                         bits=bits, group_size=group_size)
        cfg = transformer_config("tiny-llama", **WIDE["tiny-llama"])
        dense = params_from_jax(tree, cfg)
        got = pt.quantize_model_weights(dense, bits=bits,
                                        group_size=group_size)
        assert not isinstance(dense["layers"]["attn"]["wq"], dict)
        got = params_to_numpy(got)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, a in flat_w:
            b = flat_g[path]
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        key = "q8" if bits == 8 else "q4"
        assert key in got["lm_head"] and "embed" in got
        assert not isinstance(got["embed"]["tokens"], dict)

    def test_donate_updates_in_place_and_keeps_quantized_sites(self):
        cfg = transformer_config("tiny-llama", **WIDE["tiny-llama"])
        params = pt.init_params(torch.Generator().manual_seed(0), cfg)
        out = pt.quantize_model_weights(params, bits=8, donate=True)
        assert out is params and "q8" in params["layers"]["attn"]["wq"]
        again = pt.quantize_model_weights(out, bits=8)
        assert again["lm_head"]["q8"] is out["lm_head"]["q8"]

    def test_conversion_carries_quantized_sites(self):
        _, dense = wide_weights("tiny")
        tree = jax.tree.map(np.asarray, jt.quantize_model_weights(
            jax.tree.map(jnp.asarray, dense), bits=4, group_size=128))
        cfg = transformer_config("tiny", dtype=torch.bfloat16, **WIDE["tiny"])
        p = params_from_jax(tree, cfg)
        site = p["layers"]["attn"]["wq"]
        assert site["q4"].dtype == torch.uint8
        assert site["s"].dtype == torch.float32      # scales stay fp32
        assert p["layers"]["ln1"]["scale"].dtype == torch.bfloat16
        back = params_to_numpy(p)
        np.testing.assert_array_equal(back["layers"]["attn"]["wq"]["q4"],
                                      tree["layers"]["attn"]["wq"]["q4"])
        np.testing.assert_array_equal(back["layers"]["attn"]["wq"]["s"],
                                      tree["layers"]["attn"]["wq"]["s"])


# ---------------------------------------------------------------------------
# the four GEMMs' plain versions against the JAX oracles
# ---------------------------------------------------------------------------


# every K and N of 128, 256 and 384 at least once, square and not
SHAPES = [(128, 256), (256, 384), (384, 128), (256, 256)]


def gemm_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (M, K)).astype(np.float32)
    if M > 1:
        x[1] = 0.0                           # a zero activation row
    return x, weight(rng, K, N)


# x's dtype (numpy, so that both frameworks get the same values) and the
# tolerance (atol, rtol) of the comparison
X_DTYPES = {"float32": (np.float32, ATOL, RTOL),
            "float16": (np.float16, FP16_ATOL, FP16_RTOL)}


def assert_ops_match(pairs, xt, xj, q, s, qj, sj, atol, rtol):
    for mine, oracle in pairs:
        got = mine(xt, q, s)
        want = np.asarray(oracle(xj, qj, sj))
        assert got.dtype == xt.dtype and str(want.dtype) == str(
            xt.dtype).split(".")[-1]
        np.testing.assert_allclose(_np(got).astype(np.float32),
                                   want.astype(np.float32), atol=atol,
                                   rtol=rtol)


def with_x_dtypes(cases):
    """``cases`` (values, id) once for each x dtype; the fp16 ids end in
    ``-float16``, the fp32 ones keep the bare id."""
    return [pytest.param(*values, xd,
                         id=ident + ("" if xd == "float32" else f"-{xd}"))
            for xd in X_DTYPES for values, ident in cases]


@pytest.mark.parametrize("K,N,M,xdtype", with_x_dtypes(
    [((K, N, M), f"{K}-{N}-{M}") for K, N in SHAPES for M in (1, 3, 8)]))
def test_int8_ops_match_jax_oracles(M, K, N, xdtype):
    npdt, atol, rtol = X_DTYPES[xdtype]
    x, w = gemm_inputs(M, K, N, seed=M * 1000 + K + N)
    x = x.astype(npdt)
    q8, s = pt._quantize_int8(torch.from_numpy(w)).values()
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    qj, sj = jnp.asarray(_np(q8)), jnp.asarray(_np(s))
    assert_ops_match(((pq.int8_matmul, jq.reference_int8_matmul),
                      (pq.int8_a8_matmul, jq.reference_int8_a8_matmul)),
                     xt, xj, q8, s, qj, sj, atol, rtol)
    # the a8 integer part is exact
    xq, _ = pq.quantize_activation_rows(xt)
    np.testing.assert_array_equal(
        _np(pq._int_matmul(xq, q8)),
        (_np(xq).astype(np.int64) @ _np(q8).astype(np.int64)).astype(
            np.float32))


@pytest.mark.parametrize("grouped,K,N,M,xdtype", with_x_dtypes(
    [((grouped, K, N, M), f"{grouped}-{K}-{N}-{M}")
     for grouped in (False, True) for K, N in SHAPES for M in (1, 3, 8)]))
def test_int4_ops_match_jax_oracles(M, K, N, grouped, xdtype):
    # G = K / 128 where the groups fit the nibble planes (K / 2 % 128 == 0),
    # else groups of 64
    npdt, atol, rtol = X_DTYPES[xdtype]
    group = (128 if (K // 2) % 128 == 0 else 64) if grouped else None
    x, w = gemm_inputs(M, K, N, seed=M * 1000 + K + N + 7)
    x = x.astype(npdt)
    q4, s = pq.quantize_int4(torch.from_numpy(w), group)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    qj, sj = jnp.asarray(_np(q4)), jnp.asarray(_np(s))
    assert_ops_match(((pq.int4_matmul, jq.reference_int4_matmul),
                      (pq.int4_a8_matmul, jq.reference_int4_a8_matmul)),
                     xt, xj, q4, s, qj, sj, atol, rtol)


# (name, M, K, N, G): aligned and unaligned K / N (int4: K/2), int4 groups
# of 16, 32 and 128 rows and one group, 1..8 rows
A8_SHAPES = [("int8_a8_matmul", 8, 4096, 11008, 1),
             ("int8_a8_matmul", 1, 256, 128, 1),
             ("int8_a8_matmul", 3, 384, 96, 1),
             ("int8_a8_matmul", 2, 200, 128, 1),
             ("int8_a8_matmul", 2, 256, 160, 1),
             ("int4_a8_matmul", 8, 4096, 11008, 1),
             ("int4_a8_matmul", 8, 4096, 11008, 32),
             ("int4_a8_matmul", 1, 256, 128, 16),
             ("int4_a8_matmul", 5, 512, 384, 16),
             ("int4_a8_matmul", 3, 512, 128, 32),
             ("int4_a8_matmul", 2, 384, 256, 1),
             ("int4_a8_matmul", 2, 384, 256, 3),
             ("int4_a8_matmul", 2, 256, 96, 1),
             ("int4_a8_matmul", 2, 1024, 256, 8)]


def jax_a8_refuses(name, M, K, N, G) -> bool:
    """Whether JAX's a8 function raises ValueError on these shapes. It
    checks before its ``pallas_call``, so an accepted shape gets past its
    checks and fails on the Pallas TPU parameters here (or runs)."""
    rows = K // 2 if name.startswith("int4") else K
    dtype = jnp.uint8 if name.startswith("int4") else jnp.int8
    try:
        getattr(jq, name)(jnp.zeros((M, K), jnp.float32),
                          jnp.zeros((rows, N), dtype),
                          jnp.ones((G, N), jnp.float32))
    except ValueError:
        return True
    except Exception:            # past its checks: the Pallas call itself
        pass
    return False


def port_a8_refuses(name, M, K, N, G) -> bool:
    rows = K // 2 if name.startswith("int4") else K
    try:
        got = pq.check_a8_operands(name, (M, K), (rows, N), (G, N))
    except ValueError:
        return True
    assert got == (M, K, N, G)
    return False


@pytest.mark.parametrize("name,M,K,N,G", A8_SHAPES)
def test_a8_shape_rules_match_jax(name, M, K, N, G):
    """``check_a8_operands`` raises ValueError exactly where JAX's a8
    function does."""
    assert port_a8_refuses(name, M, K, N, G) == jax_a8_refuses(name, M, K,
                                                               N, G)


@pytest.mark.parametrize("name,M,K,N,G", [("int4_a8_matmul", 3, 512, 128, 64),
                                          ("int4_a8_matmul", 2, 768, 256, 5)])
def test_a8_refuses_groups_jax_passes(name, M, K, N, G):
    """Groups of 8 rows, or a G that does not divide K, get past JAX's
    checks (its kernel tiles by the largest power of two dividing the
    group); the kernel here takes groups of a multiple of 16 rows."""
    assert not jax_a8_refuses(name, M, K, N, G)
    assert port_a8_refuses(name, M, K, N, G)


def test_wrappers_keep_dtype_and_route_cpu_to_plain():
    x = torch.randn(2, 256, dtype=torch.bfloat16)
    w = torch.randn(256, 128) * 0.05
    q8, s = pt._quantize_int8(w).values()
    q4, s4 = pq.quantize_int4(w)
    for fn, q, sc in ((pq.int8_matmul, q8, s), (pq.int8_a8_matmul, q8, s),
                      (pq.int4_matmul, q4, s4), (pq.int4_a8_matmul, q4, s4)):
        out = fn(x, q, sc)
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 128)
        ref = getattr(pq, "reference_" + fn.__name__)(x, q, sc)
        assert torch.equal(out, ref)
        assert fn(x, q, sc, out_dtype=torch.float32).dtype == torch.float32


def test_weight_only_route_by_dtype():
    """bf16 / fp16 x run the tensor-core kernel, fp32 x the CUDA-core one
    (the card tests hold the launches); nothing else is taken."""
    assert pq.weight_only_kernel(torch.bfloat16) == "quant_matmul_tc_kernel"
    assert pq.weight_only_kernel(torch.float16) == "quant_matmul_tc_kernel"
    assert pq.weight_only_kernel(torch.float32) == "quant_matmul_kernel"
    with pytest.raises(ValueError, match="float16"):
        pq.weight_only_kernel(torch.float64)


# (K, N): llama-7b's decode sites, a 7B lm_head of 50k columns, and small
# shapes with a partial ring stage, a partial column tile or one stage
PLAN_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
               (4096, 50304), (64, 96), (392, 416), (768, 384)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
@pytest.mark.parametrize("int4,grouped", [(False, False), (True, False),
                                          (True, True)])
@pytest.mark.parametrize("sms", [132, 16])
def test_tc_plan(K, N, int4, grouped, sms):
    """The tensor-core kernel's host plan: a cluster the kernel takes (a
    power of two up to TC_MAX_CLUSTER), the largest whose grid fits in one
    wave of resident blocks (one cluster when none does), and 1..4 ring
    stages, no more than a block has stages of rows; the same for every
    M and G."""
    G = K // 8 if grouped else 1
    cluster, stages = pq.tc_plan(8, K, N, G, int4, sms)
    tiles = -(-N // pq.TC_COLS)
    slots = pq.TC_BLOCKS_PER_SM * sms
    steps = -(-(K // 2 if int4 else K) // pq.TC_ROWS)
    assert cluster in (1, 2, 4, 8) and cluster <= pq.TC_MAX_CLUSTER
    assert tiles * cluster <= slots or cluster == 1
    assert cluster == pq.TC_MAX_CLUSTER or tiles * 2 * cluster > slots
    assert 1 <= stages <= 4 and stages <= max(1, -(-steps // cluster))
    for M in (1, 3):
        for G2 in (1, K // 4):
            assert pq.tc_plan(M, K, N, G2, int4, sms) == (cluster, stages)


def test_tc_plan_at_llama_7b():
    """The plans the H100 (132 SMs) runs at llama-7b's decode sites."""
    plans = {(K, N): [pq.tc_plan(8, K, N, G, int4, 132)
                      for int4, G in ((False, 1), (True, 1), (True, K // 128))]
             for K, N in ((4096, 4096), (4096, 11008), (11008, 4096),
                          (4096, 32000))}
    assert plans == {(4096, 4096): [(8, 4)] * 3,
                     (4096, 11008): [(4, 4)] * 3,
                     (11008, 4096): [(8, 4)] * 3,
                     (4096, 32000): [(1, 4)] * 3}


# ---------------------------------------------------------------------------
# _qeinsum at every route
# ---------------------------------------------------------------------------


def site(kind, K, N, seed):
    """A quantized weight site in both packages: (port dict, jax dict)."""
    w = weight(np.random.default_rng(seed), K, N)
    if kind == "q8":
        p = pt._quantize_int8(torch.from_numpy(w))
    else:
        q4, s = pq.quantize_int4(torch.from_numpy(w),
                                 128 if kind == "q4g" else None)
        p = {"q4": q4, "s": s}
    return p, {k: jnp.asarray(_np(v)) for k, v in p.items()}


@pytest.mark.parametrize("kind", ["q8", "q4", "q4g"])
def test_dense_matches_jax(kind):
    """``_dense`` materialises a quantized site as JAX's does, bit for bit
    in fp32 and in bf16 (one round to nearest even of the fp32 product)."""
    p, j = site(kind, 256, 128, seed=3)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = pt._dense(p, dt)
        assert got.dtype == dt and tuple(got.shape) == (256, 128)
        np.testing.assert_array_equal(
            _np(got.float()), np.asarray(jt._dense(j, jdt), np.float32))
    w = torch.ones(4, 4)
    assert pt._dense(w, torch.float32) is w


# (B, S, K, N): decode-shaped and aligned (kernel route), S * B = 9 (the
# dequant route), K not a multiple of 128 for int8 / of 256 for int4
GATE = [(8, 1, 256, 128, True), (2, 4, 256, 384, True), (1, 1, 512, 256, True),
        (9, 1, 256, 128, False), (3, 3, 256, 128, False),
        (1, 1, 192, 128, False), (4, 2, 384, 256, None)]


# int4 groups of 128 need K / 2 % 128 == 0
ROUTES = [(kind, *g) for kind in ("q8", "q4", "q4g") for g in GATE
          if kind != "q4g" or g[2] % 256 == 0]


@pytest.mark.parametrize("kind,B,S,K,N,kernel", ROUTES)
@pytest.mark.parametrize("a8", [False, True])
def test_qeinsum_matches_jax_at_every_route(kind, B, S, K, N, kernel, a8):
    """Against JAX's ``_qeinsum`` under its TPU-route semantics. K 384 is
    aligned for int8 but not for int4 (K/2 = 192), and K 192 for neither."""
    p, j = site(kind, K, N, seed=B * 100 + S * 10 + K)
    x = np.random.default_rng(B + S).normal(0, 1, (B, S, K)).astype(
        np.float32)
    spec = "bsh,hd->bsd"
    with tpu_route():
        want = np.asarray(jt._qeinsum(spec, jnp.asarray(x), j, jnp.float32,
                                      a8=a8))
    got = _np(pt._qeinsum(torch.from_numpy(x), p, torch.float32, a8=a8))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # plain=True is the CPU route; the dequant route equals JAX unpatched
    plain = _np(pt._qeinsum(torch.from_numpy(x), p, torch.float32, a8=a8,
                            plain=True))
    np.testing.assert_array_equal(plain, got)
    if kernel is False or (kernel is None and kind != "q8"):
        unpatched = np.asarray(jt._qeinsum(spec, jnp.asarray(x), j,
                                           jnp.float32, a8=a8))
        np.testing.assert_allclose(got, unpatched, atol=ATOL, rtol=RTOL)


def test_qeinsum_routes_by_the_gate(monkeypatch):
    """The kernel route is taken exactly where JAX's gate passes."""
    calls = []
    for name in ("int8_matmul", "int8_a8_matmul", "int4_matmul",
                 "int4_a8_matmul"):
        fn = getattr(pt, name)
        monkeypatch.setattr(pt, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    p8, _ = site("q8", 256, 128, 0)
    p4, _ = site("q4", 256, 128, 0)
    pt._qeinsum(torch.randn(8, 1, 256), p8, torch.float32)
    pt._qeinsum(torch.randn(2, 4, 256), p8, torch.float32, a8=True)
    pt._qeinsum(torch.randn(9, 1, 256), p8, torch.float32)      # S*B 9
    pt._qeinsum(torch.randn(1, 1, 256), p4, torch.float32)
    pt._qeinsum(torch.randn(1, 1, 256), p4, torch.float32, a8=True)
    pt._qeinsum(torch.randn(1, 1, 256), p4, torch.float32, plain=True)
    assert calls == ["int8_matmul", "int8_a8_matmul", "int4_matmul",
                     "int4_a8_matmul"]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def jax_engine(preset, bits, groups=None, a8=False, dtype="float32"):
    """A JAX engine quantizing the widened preset's dense weights itself
    (a fresh model: an a8 engine sets ``a8_decode`` on its config)."""
    _, tree = wide_weights(preset)
    model = jax_create_model(preset, dtype=getattr(jnp, dtype),
                             max_seq_len=T_MAX, **WIDE[preset])
    return JaxInfEngine(model, JaxInfConfig(
        dtype=getattr(jnp, dtype), max_out_tokens=T_MAX, compile_cache=False,
        quantize_bits=bits, quantize_groups=groups,
        quantize_activations=a8), params=tree)


def port_engine(preset, params, bits, groups=None, a8=False,
                dtype="float32"):
    return init_inference(preset, config=InferenceConfig(
        dtype=getattr(torch, dtype), max_out_tokens=T_MAX,
        quantize_bits=bits, quantize_groups=groups,
        quantize_activations=a8), params=params, device="cpu",
        **WIDE[preset])


def dense_params(preset):
    cfg = transformer_config(preset, max_seq_len=T_MAX, **WIDE[preset])
    return params_from_jax(wide_weights(preset)[1], cfg)


def ragged_batch(seed, S, lens):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (len(lens), S)).astype(np.int64)
    mask = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("preset,bits,groups,dtype", [
    pytest.param(preset, bits, groups, dtype,
                 id=f"{preset}-{bits}-{groups}"
                 + ("" if dtype == "float32" else f"-{dtype}"))
    for preset, bits, groups, dtype in [
        ("tiny-llama", 8, None, "float32"), ("tiny-llama", 4, None, "float32"),
        ("tiny-llama", 4, 128, "float32"), ("tiny", 8, None, "float32"),
        ("tiny", 4, 128, "float32"), ("tiny-llama", 8, None, "float16"),
        ("tiny-llama", 4, None, "float16")]])
def test_greedy_generate_matches_jax(preset, bits, groups, dtype):
    """fp32: both engines quantize the same dense weights. fp16: the port
    takes the JAX engine's quantized weights (JAX's jitted quantizer
    multiplies by 1 / qmax, so its scales sit an ulp off the port's IEEE
    division, and on fp16 weights some int4 values flip with them). The
    port's decode runs the plain kernel route on every site (8 rows). JAX's
    runs the dequant in fp32, the same function; in fp16 the dequant rounds
    each scaled weight to fp16 before the product where the kernels (JAX's
    Pallas ones and the port's) scale the fp32 sum, so there JAX runs its
    kernel route (``tpu_route``)."""
    jax_eng = jax_engine(preset, bits, groups, dtype=dtype)
    if dtype == "float32":
        params = dense_params(preset)
    else:
        params = params_from_jax(
            jax.tree.map(np.asarray, jax_eng.params),
            transformer_config(preset, dtype=torch.float16,
                               max_seq_len=T_MAX, **WIDE[preset]))
    port = port_engine(preset, params, bits, groups, dtype=dtype)
    site = port.params["layers"]["attn"]["wq"]
    assert ("q8" if bits == 8 else "q4") in site
    assert site["s"].dtype == torch.float32
    assert port.params["embed"]["tokens"].dtype == getattr(torch, dtype)
    ids, mask = ragged_batch(3, 21, (21, 9, 15, 4, 21, 12, 17, 8))
    with (tpu_route() if dtype == "float16" else contextlib.nullcontext()):
        want = np.asarray(jax_eng.generate(ids, attention_mask=mask,
                                           max_new_tokens=6))
    got = _np(port.generate(ids, attention_mask=mask, max_new_tokens=6))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset,bits,groups", [
    ("tiny-llama", 8, None), ("tiny-llama", 4, 128), ("tiny", 4, None)])
def test_a8_decode_logits_match_jax_tpu_route(preset, bits, groups):
    """W8A8 / W4A8: a dense prefill (S * B > 8: weight-only dequant in both)
    then 4 teacher-forced decode steps of 3 ragged rows (the a8 route), on
    the JAX engine's quantized weights, against JAX's TPU-route semantics
    (``tpu_route``). The two frameworks' activations differ in the last
    fp32 bits, so an element of x / sx within ~1e-5 of a half-integer can
    round to the other side: that moves one quantized element by 1, and the
    site's output by sx * s * |q|, and the logits by up to ~2e-2, far past
    LOGIT_TOL (the teacher-forced tokens of seed 6 do that on tiny-llama
    int4 / group 128 and on tiny). None does on these inputs."""
    jax_eng = jax_engine(preset, bits, groups, a8=True)
    port = port_engine(preset, params_from_jax(
        jax.tree.map(np.asarray, jax_eng.params),
        transformer_config(preset, **WIDE[preset])), bits, groups, a8=True)
    cfg_j, cfg_p = jax_eng.model.config, port.model.config
    assert cfg_j.a8_decode and cfg_p.a8_decode
    params_j = jax_eng.params
    ids, mask = ragged_batch(5, 13, (13, 5, 9))
    B, S = ids.shape
    S_pad, T = 64, 96
    ids_pad = np.zeros((B, S_pad), np.int64)
    ids_pad[:, :S] = ids
    valid = np.zeros((B, T), np.int32)
    valid[:, :S] = mask
    lens = mask.sum(-1)
    cj = jax_kv_cache.init_cache(cfg_j, B, T, jnp.float32)
    cp = init_cache(cfg_p, B, T, torch.float32, "cpu")
    rng = np.random.default_rng(7)
    with tpu_route():
        lj, cj, _ = jt.forward(params_j, jnp.asarray(ids_pad), cfg_j,
                               attention_mask=jnp.asarray(valid), cache=cj,
                               start_pos=0)
        lp, _ = pt.forward(port.params, torch.from_numpy(ids_pad), cfg_p,
                           cache=cp, attention_mask=torch.from_numpy(valid),
                           start_pos=0)
        live = np.arange(S_pad)[None] < lens[:, None]
        np.testing.assert_allclose(_np(lp)[live], np.asarray(lj)[live],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        cj = {**cj, "index": jnp.full_like(cj["index"], S)}
        for t in range(4):
            valid[:, S + t] = 1
            tok = rng.integers(0, 256, (B, 1))
            pos = (lens + t)[:, None]
            lj, cj, _ = jt.forward(
                params_j, jnp.asarray(tok), cfg_j,
                attention_mask=jnp.asarray(valid), cache=cj, start_pos=S + t,
                positions=jnp.asarray(pos))
            lp, _ = pt.forward(
                port.params, torch.from_numpy(tok), cfg_p, cache=cp,
                attention_mask=torch.from_numpy(valid), start_pos=S + t,
                positions=torch.from_numpy(pos))
            np.testing.assert_allclose(_np(lp), np.asarray(lj),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the a8 route really differs from the weight-only one
    wo, _ = pt.forward(port.params, torch.from_numpy(tok), dataclasses.replace(
        cfg_p, a8_decode=False), cache=init_cache(cfg_p, B, T, torch.float32,
                                                  "cpu"),
        attention_mask=torch.from_numpy(valid), start_pos=S + 3,
        positions=torch.from_numpy(pos))
    assert not np.allclose(_np(wo), _np(lp), atol=LOGIT_TOL, rtol=0)


def test_a8_config_is_per_engine():
    """tests/unit/test_inference.py TestW8A8: the mode sets ``a8_decode`` on
    that engine's model config only; w8a8 serves an int8 tree as it is."""
    e8 = init_inference("tiny-llama", dtype="int8", max_out_tokens=T_MAX,
                        device="cpu", **WIDE["tiny-llama"])
    ea = init_inference("tiny-llama", dtype="w8a8", max_out_tokens=T_MAX,
                        device="cpu", params=e8.params,
                        **WIDE["tiny-llama"])
    assert ea.model.config.a8_decode is True
    assert e8.model.config.a8_decode is False
    assert ea.params["lm_head"]["q8"] is e8.params["lm_head"]["q8"]
    assert e8.config.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="q8"):
        init_inference("tiny-llama", dtype="int4", max_out_tokens=T_MAX,
                       device="cpu", params=e8.params, **WIDE["tiny-llama"])


class TestConfig:
    def test_fp16_quantized_refused_on_cuda(self, monkeypatch):
        """fp16 compute with quantized activations (w8a8 / w4a8) is refused
        on CUDA before anything lands on the card: the a8 kernels take bf16
        / fp32 activations. Weight-only int8 / int4 with fp16 is taken
        there (its kernel takes fp16), and on the CPU (plain versions)
        every mode runs."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for bits in (8, 4):
            cfg = InferenceConfig(dtype=torch.float16, quantize_bits=bits,
                                  quantize_activations=True,
                                  max_out_tokens=T_MAX)
            with pytest.raises(NotImplementedError, match="fp16"):
                init_inference("tiny", config=cfg, device="cuda")
            weight_only = dataclasses.replace(cfg, quantize_activations=False)
            check_quantized_compute(weight_only, torch.device("cuda"))
            with pytest.raises(NotImplementedError, match="w8a8 / w4a8"):
                check_quantized_compute(cfg, torch.device("cuda"))
        monkeypatch.undo()
        for a8 in (False, True):
            eng = init_inference("tiny", config=InferenceConfig(
                dtype=torch.float16, quantize_bits=8, quantize_activations=a8,
                max_out_tokens=T_MAX), device="cpu")
            site = eng.params["layers"]["attn"]["wq"]
            assert site["q8"].dtype == torch.int8
            assert eng.model.config.a8_decode is a8

    def test_modes_normalise_like_jax(self):
        for mode in ("int8", "int4", "w8a8", "w4a8"):
            mine, ref = InferenceConfig(dtype=mode), JaxInfConfig(dtype=mode)
            assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
            assert (mine.quantize_bits, mine.quantize_activations) == (
                ref.quantize_bits, ref.quantize_activations)
        assert InferenceConfig(dtype=torch.int8).quantize_bits == 8
        cfg = InferenceConfig(dtype=torch.float32, quantize_bits=4,
                              quantize_groups=128)
        assert cfg.dtype == torch.float32

    @pytest.mark.parametrize("kw,err", [
        (dict(dtype="bf16", quantize_activations=True), "W8A8/W4A8"),
        (dict(dtype="int8", quantize_groups=128), "int4 only"),
        (dict(quantize_bits=3), "quantize_bits"),
        (dict(dtype="int3"), "unknown inference dtype")])
    def test_rejects_like_jax(self, kw, err):
        with pytest.raises((ValueError, NotImplementedError), match=err):
            InferenceConfig(**kw)
        with pytest.raises((ValueError, NotImplementedError)):
            JaxInfConfig(**kw)


SERVE = dict(block_size=8, num_blocks=24, max_seqs=4, max_model_len=64,
             prefill_chunk=16, max_queue=64)


def test_int8_serving_streams_match_jax():
    """Greedy streams over the int8 engines: chunked prefill dequantizes,
    decode over 4 rows takes the port's plain int8 kernel route."""
    from deepspeed_tpu.config.config import ServingConfig as JaxServingConfig
    from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
    from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine

    preset = "tiny-llama"
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n) for n in (5, 23, 40, 17, 9, 30)]
    streams = []
    for srv in (ServingEngine(port_engine(preset, dense_params(preset), 8),
                              ServingConfig(**SERVE)),
                JaxServingEngine(jax_engine(preset, 8),
                                 JaxServingConfig(**SERVE))):
        hs = [srv.submit(p, max_new_tokens=6 + i % 3)
              for i, p in enumerate(prompts)]
        srv.run()
        streams.append([list(h.tokens) for h in hs])
    assert streams[0] == streams[1]
    assert all(len(s) == 6 + i % 3 for i, s in enumerate(streams[0]))
