"""Mixture-of-Experts: the port against the JAX package, on the CPU.

* Gating (``top1_plan`` / ``top2_plan`` / ``_densify``) on identical fp32
  logits: the routing decisions (experts, queue slots, kept assignments,
  capacity, counts, the dense dispatch mask) bit for bit; the combine
  weights and the aux loss within ``GATE_ULPS`` fp32 ulps, since XLA's and
  PyTorch's ``exp`` differ in the last bit on about one element in ten.
  Drops, no-drop, ``min_capacity``, and the cases of JAX's ``TestGating`` /
  ``TestMoEV2`` (``tests/unit/test_moe_tp_sp.py``) on the port.
* Random Token Selection, distributionally: exactly C kept per over-full
  expert, not the first C, reproducible for a generator seed.
* ``moe_mlp``: values and the gradients of x, router and expert banks
  against ``jax.grad``, sparse and einsum dispatch, top-1 and top-2, within
  1e-5; in the port sparse equals einsum.
* The model (``moe-tiny``, plain, PR-MoE, top-1 / einsum): ``forward``
  logits and aux, and the loss, against JAX's on converted weights, with
  the routing margin guarded (a near-tie would route differently).
* Training: 3 AdamW steps at ZeRO stages 0-3 against JAX's engine (ep 1,
  one device), rtol 1e-4.
* Greedy ``generate`` (fp32, and int8 over JAX's quantized weights) and
  serving streams equal to JAX's.
* A format-2 checkpoint: JAX's key set, and a round trip bit for bit.
* The refusals: MoE with parameter offload at world 2, expert parallelism
  at ZeRO stage 3, optimizer offload, LAMB and the 1-bit optimizers
  (``tests/test_torch_moe_ep.py`` trains MoE beyond one rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.engine import InferenceConfig as JaxInfConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInfEngine
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.models.transformer import forward as jax_forward
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch import comm, initialize, init_inference
from deepspeed_tpu_torch.inference import InferenceConfig
from deepspeed_tpu_torch.models import (Model, create_model, params_from_jax,
                                        transformer_config)
from deepspeed_tpu_torch.inference import init_cache
from deepspeed_tpu_torch.models.transformer import (_layer_views, embed,
                                                    forward, layers_forward)
from deepspeed_tpu_torch.parallel import moe as pmoe
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine

GATE_ULPS = 4
ATOL = 1e-5
SEQ = 32
# the smallest gap between a token's chosen and next expert's gate that the
# model-level comparisons accept: the two frameworks' router logits differ
# by ~1e-7, so a gap above this cannot flip
MARGIN = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _logits(T, E, seed, skew=0.0):
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(T, E)).astype(np.float32)
    lg[:, 0] += skew
    return lg


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------

# (k, T, E, capacity_factor, min_capacity, drop_tokens, skew)
GATE_CASES = [(1, 64, 8, 1.0, 4, True, 0.0), (1, 128, 8, 0.5, 4, True, 1.5),
              (1, 64, 4, 1.0, 4, False, 5.0), (1, 64, 8, 1.0, 12, True, 0.0),
              (2, 64, 8, 1.0, 4, True, 0.0), (2, 128, 8, 0.5, 4, True, 1.5),
              (2, 64, 4, 0.5, 4, False, 5.0), (2, 64, 4, 1.25, 48, True, 0.0),
              (2, 128, 8, 1.25, 4, True, 0.5)]


def _plans(k, lg, cf, mc, drop):
    if k == 1:
        return (jmoe.top1_plan(jnp.asarray(lg), cf, mc, drop_tokens=drop),
                pmoe.top1_plan(torch.tensor(lg), cf, mc, drop_tokens=drop))
    return (jmoe.top2_plan(jnp.asarray(lg), cf, mc, drop_tokens=drop),
            pmoe.top2_plan(torch.tensor(lg), cf, mc, drop_tokens=drop))


def _ulp_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GATE_ULPS * float(np.spacing(
                                   np.maximum(np.abs(want).max(), 1e-30))))


@pytest.mark.parametrize("k,T,E,cf,mc,drop,skew", GATE_CASES)
def test_plans_match_jax(k, T, E, cf, mc, drop, skew):
    lg = _logits(T, E, T + E + k, skew)
    want, got = _plans(k, lg, cf, mc, drop)
    assert got.capacity == want.capacity
    for name in ("expert_idx", "slot_pos", "valid", "expert_counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    _ulp_close(_np(got.weight), want.weight)
    _ulp_close(_np(got.aux_loss), want.aux_loss)
    jd, pd = jmoe._densify(want, E), pmoe._densify(got, E)
    np.testing.assert_array_equal(_np(pd.dispatch), np.asarray(jd.dispatch))
    _ulp_close(_np(pd.combine), jd.combine)
    if drop and skew:
        assert not _np(got.valid).all()           # the case drops
    if not drop:
        assert got.capacity == T and _np(got.valid).all()


def test_capacity():
    for args, want in (((64, 8, 1.0), 8), ((64, 8, 1.25), 10),
                       ((4, 8, 1.0), 4)):
        assert pmoe._capacity(*args) == jmoe._capacity(*args) == want
    assert pmoe._capacity(10, 8, 1.0, min_capacity=0) == 1


def _gating_conservation():
    out = pmoe.top1gating(torch.tensor(_logits(64, 8, 0)),
                          capacity_factor=2.0)
    per_token = out.dispatch.sum(dim=(1, 2))
    assert (per_token <= 1).all() and int(per_token.sum()) == 64
    assert (out.dispatch.sum(dim=0) <= 1).all()


def _gating_capacity_drops():
    lg = torch.zeros(64, 8)
    lg[:, 0] = 10.0
    out = pmoe.top1gating(lg, capacity_factor=1.0)
    assert int(out.dispatch.sum()) == pmoe._capacity(64, 8, 1.0)
    balanced = pmoe.top1gating(torch.tensor(_logits(64, 8, 0)))
    assert float(out.aux_loss) > float(balanced.aux_loss)


def _gating_top2_two_experts():
    out = pmoe.top2gating(torch.tensor(_logits(64, 8, 1)),
                          capacity_factor=2.0)
    per_token = out.dispatch.sum(dim=(1, 2))
    assert (per_token <= 2).all() and int(per_token.sum()) > 64
    assert (out.combine.sum(dim=(1, 2)) <= 1.0 + 1e-5).all()


def _gating_values_match_softmax():
    lg = torch.tensor(_logits(16, 4, 2))
    out = pmoe.top1gating(lg, capacity_factor=4.0)
    np.testing.assert_allclose(_np(out.combine.sum(dim=(1, 2))),
                               _np(torch.softmax(lg, -1).max(-1).values),
                               rtol=1e-5)


def _gating_no_drop():
    lg = torch.tensor(_logits(64, 4, 0, skew=5.0))
    assert int(pmoe.top1gating(lg, 1.0, drop_tokens=False).dispatch.sum()) \
        == 64
    assert int(pmoe.top1gating(lg, 1.0, drop_tokens=True).dispatch.sum()) \
        < 64
    assert int(pmoe.top2gating(lg, 0.5, drop_tokens=False).dispatch.sum()) \
        == 128


def _gating_rts_top2_rejected():
    experts = {"w_up": torch.zeros(4, 16, 32), "w_down": torch.zeros(4, 32,
                                                                      16)}
    with pytest.raises(ValueError, match="top-1 only"):
        pmoe.moe_mlp(torch.zeros(1, 8, 16), torch.zeros(16, 4), experts,
                     "gelu", top_k=2, use_rts=True)
    with pytest.raises(ValueError, match="dispatch_impl"):
        pmoe.moe_mlp(torch.zeros(1, 8, 16), torch.zeros(16, 4), experts,
                     "gelu", dispatch_impl="dense")


@pytest.mark.parametrize("case", [
    _gating_conservation, _gating_capacity_drops, _gating_top2_two_experts,
    _gating_values_match_softmax, _gating_no_drop,
    _gating_rts_top2_rejected], ids=lambda f: f.__name__[8:])
def test_gating_cases_of_jax_suite(case):
    case()


@pytest.mark.parametrize("seed", [3, 4])
def test_rts_keeps_a_random_capacity_subset(seed):
    lg = torch.zeros(64, 2)
    lg[:, 0] = 1.0                          # every token wants expert 0
    seq = pmoe.top1gating(lg, capacity_factor=1.0)

    def rts(s):
        g = torch.Generator().manual_seed(s)
        return pmoe.top1gating(lg, capacity_factor=1.0, use_rts=True, rng=g)

    a, b, other = rts(seed), rts(seed), rts(seed + 100)
    C = 32
    assert int(seq.dispatch.sum()) == int(a.dispatch.sum()) == C
    assert int(a.dispatch[:, 0].sum()) == C     # exactly C on the full one
    kept_seq = seq.dispatch.sum(dim=(1, 2))
    kept = a.dispatch.sum(dim=(1, 2))
    assert bool((kept_seq[:C] == 1).all())
    assert not bool((kept[:C] == 1).all())      # not sequence order
    assert torch.equal(a.dispatch, b.dispatch)  # reproducible
    assert not torch.equal(a.dispatch, other.dispatch)
    # the aux loss is taken on the pre-RTS mask
    assert torch.equal(a.aux_loss, seq.aux_loss)


# ---------------------------------------------------------------------------
# moe_mlp values and gradients
# ---------------------------------------------------------------------------

def _mlp_inputs(act, E=4, H=16, Fd=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 24, H)).astype(np.float32)
    router = (rng.normal(size=(H, E)) * 0.5).astype(np.float32)
    experts = {"w_up": (rng.normal(size=(E, H, Fd)) * 0.2).astype(np.float32),
               "w_down": (rng.normal(size=(E, Fd, H)) * 0.2
                          ).astype(np.float32)}
    if act == "swiglu":
        experts["w_gate"] = (rng.normal(size=(E, H, Fd)) * 0.2
                             ).astype(np.float32)
    return x, router, experts


MLP_CASES = [(k, impl, drop, act) for k in (1, 2)
             for impl in ("sparse", "einsum")
             for drop, act in ((True, "gelu"), (False, "swiglu"))]


@pytest.mark.parametrize("k,impl,drop,act", MLP_CASES)
def test_moe_mlp_values_and_grads_match_jax(k, impl, drop, act):
    x, router, experts = _mlp_inputs(act, seed=k)
    kw = dict(top_k=k, capacity_factor=1.0, min_capacity=2,
              drop_tokens=drop, dispatch_impl=impl)
    rng = np.random.default_rng(9)
    dout = rng.normal(size=x.shape).astype(np.float32)

    def jloss(x_, r_, e_):
        out, aux = jmoe.moe_mlp(x_, r_, e_, act, **kw)
        return jnp.sum(out * dout) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(router),
        {n: jnp.asarray(w) for n, w in experts.items()})

    tx, tr = torch.tensor(x, requires_grad=True), torch.tensor(
        router, requires_grad=True)
    te = {n: torch.tensor(w, requires_grad=True) for n, w in experts.items()}
    out, aux = pmoe.moe_mlp(tx, tr, te, act, **kw)
    (torch.sum(out * torch.tensor(dout)) + 3.0 * aux).backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(_np(aux), np.asarray(jaux), rtol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgrads[0]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_np(tr.grad), np.asarray(jgrads[1]),
                               atol=ATOL, rtol=ATOL)
    for n in experts:
        np.testing.assert_allclose(_np(te[n].grad), np.asarray(jgrads[2][n]),
                                   atol=ATOL, rtol=ATOL, err_msg=n)
    if drop:
        plan = pmoe.top2_plan(tx.detach().reshape(-1, 16) @ tr.detach(),
                              1.0, 2) if k == 2 else pmoe.top1_plan(
            tx.detach().reshape(-1, 16) @ tr.detach(), 1.0, 2)
        assert not bool(plan.valid.all())       # the case drops tokens


@pytest.mark.parametrize("k", [1, 2])
def test_sparse_equals_einsum(k):
    x, router, experts = _mlp_inputs("gelu", seed=5 + k)
    res = []
    for impl in ("sparse", "einsum"):
        tx = torch.tensor(x, requires_grad=True)
        tr = torch.tensor(router, requires_grad=True)
        te = {n: torch.tensor(w, requires_grad=True)
              for n, w in experts.items()}
        out, aux = pmoe.moe_mlp(tx, tr, te, "gelu", top_k=k,
                                capacity_factor=1.0, dispatch_impl=impl)
        (out.square().sum() + aux).backward()
        res.append([out, tx.grad, tr.grad] + [te[n].grad for n in experts])
    # JAX's own bars (TestSparseDispatch): values 1e-5 / 1e-6, grads (sums
    # over T that cancel) 2e-4 / 1e-5
    np.testing.assert_allclose(_np(res[0][0]), _np(res[1][0]), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(res[0][1:], res[1][1:]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=1e-5)


def test_plan_log_records_without_host_reads():
    x, router, experts = _mlp_inputs("gelu")
    pmoe.PLAN_LOG = []
    try:
        pmoe.moe_mlp(torch.tensor(x), torch.tensor(router),
                     {n: torch.tensor(w) for n, w in experts.items()},
                     "gelu", capacity_factor=1.0)
        (entry,) = pmoe.PLAN_LOG
    finally:
        pmoe.PLAN_LOG = None
    assert entry["assigned"] == 96 and entry["capacity"] == 24
    assert float(entry["expert_load"].sum()) == float(entry["kept"])
    assert float(entry["expert_load"].max()) <= 24


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _weights(preset="moe-tiny", seed=0, max_seq_len=128, **over):
    """(jax model, numpy weights): JAX's init plus seeded numpy noise."""
    model = jax_create_model(preset, dtype=jnp.float32,
                             max_seq_len=max_seq_len, **over)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32),
        model.init(jax.random.PRNGKey(seed)))
    return model, tree


class _RouterLogits:
    """Records the router logits every gating call sees (the port's)."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("top1_plan", "top2_plan"):
            real = getattr(pmoe, name)

            def spy(logits, *a, real=real, **kw):
                self.seen.append(logits.detach().clone())
                return real(logits, *a, **kw)

            monkeypatch.setattr(pmoe, name, spy)

    def margin(self, k: int) -> float:
        """The smallest gap between consecutive ranks 1..k+1 of a token's
        gates (top-1: chosen vs next; top-2: also second vs third)."""
        worst = np.inf
        for lg in self.seen:
            g = torch.softmax(lg.float(), -1).sort(-1, descending=True).values
            gaps = g[:, :k] - g[:, 1:k + 1]
            worst = min(worst, float(gaps.min()))
        return worst


MODEL_CASES = {"top2": {}, "pr_moe_top1": dict(moe_use_residual=True,
                                               moe_top_k=1),
               "einsum_cf05": dict(moe_dispatch="einsum",
                                   moe_capacity_factor=0.5)}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_forward_aux_and_loss_match_jax(case, monkeypatch):
    over = MODEL_CASES[case]
    jmodel, tree = _weights(**over)
    cfg = transformer_config("moe-tiny", dtype=torch.float32,
                             max_seq_len=128, **over)
    params = params_from_jax(tree, cfg)
    assert [("res_mlp" in params["layers"]), ("res_coef" in params["layers"])
            ] == [case == "pr_moe_top1"] * 2
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (3, 40))
    mask = np.ones((3, 40), np.int32)
    mask[1, 30:] = 0
    jl, _, jaux = jax_forward(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(ids), jmodel.config,
                              attention_mask=jnp.asarray(mask))
    spy = _RouterLogits(monkeypatch)
    logits, cache, aux = forward(params, torch.tensor(ids), cfg,
                                 attention_mask=torch.tensor(mask),
                                 with_aux=True)
    assert cache is None and len(spy.seen) == cfg.num_layers
    assert spy.margin(cfg.moe_top_k) > MARGIN, "a routing near-tie"
    np.testing.assert_allclose(_np(logits), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(aux), np.asarray(jaux), rtol=1e-5)
    batch = {"input_ids": ids, "attention_mask": mask}
    jloss = jmodel.loss_fn(jax.tree.map(jnp.asarray, tree),
                           jax.tree.map(jnp.asarray, batch))
    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=128,
                         **over)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(model.loss_fn(params, tb)),
                               float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(model.eval_loss_fn(params, tb)),
                               float(jloss), rtol=1e-5)
    # the two-value return stays for every other caller
    assert len(forward(params, torch.tensor(ids), cfg)) == 2
    # a block of layers (parameter offload's unit) returns the same aux
    x = embed(params, torch.tensor(ids), torch.arange(40), cfg)
    views = _layer_views(params["layers"], cfg.num_layers)
    _, block_aux = layers_forward(views, x, cfg,
                                  attention_mask=torch.tensor(mask),
                                  with_aux=True)
    np.testing.assert_allclose(_np(block_aux), _np(aux), rtol=1e-6)


def test_rts_in_the_model_draws_from_the_generator():
    """Training with RTS (top-1, an over-full expert): the loss is
    reproducible for a generator seed and the draws change with it; with a
    cache (inference) there is no RTS and no drop."""
    model = create_model("moe-tiny", dtype=torch.float32, moe_top_k=1,
                         moe_use_rts=True, moe_capacity_factor=0.25)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"input_ids": torch.tensor(
        np.random.default_rng(2).integers(0, 256, (2, 64)))}

    def loss(seed):
        return float(model.loss_fn(params, batch,
                                   rng=torch.Generator().manual_seed(seed)))

    assert loss(1) == loss(1)
    assert len({loss(s) for s in (1, 2, 3)}) > 1
    pmoe.PLAN_LOG = []
    try:
        cache = init_cache(model.config, 2, 64, torch.float32, "cpu")
        forward(params, batch["input_ids"], model.config, cache=cache,
                attention_mask=torch.ones(2, 64, dtype=torch.int32))
        log = pmoe.PLAN_LOG
    finally:
        pmoe.PLAN_LOG = None
    assert all(e["capacity"] == 128 and int(e["kept"]) == 128 for e in log)


def test_init_matches_jax_tree():
    for over in ({}, dict(moe_use_residual=True, activation="swiglu")):
        jtree = jax_create_model("moe-tiny", dtype=jnp.float32,
                                 **over).init(jax.random.PRNGKey(0))
        g = torch.Generator().manual_seed(0)
        params = create_model("moe-tiny", dtype=torch.float32,
                              **over).init(g)
        jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jl}
        got = {}

        def walk(node, prefix=""):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}['{k}']")
                else:
                    got[f"{prefix}['{k}']"] = tuple(v.shape)

        walk(params)
        assert got == want
        assert list(params["layers"])[:4] == ["ln1", "ln2", "attn", "router"]
        assert "b_up" not in params["layers"]["mlp"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_config(stage, **extra):
    cfg = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 1000,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 200}}
    cfg.update(extra)
    return cfg


def _train_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 250, (1, 4, SEQ))}
            for _ in range(n)]


def _port_model(np_params, **over):
    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=SEQ,
                         **over)
    params = params_from_jax(np_params, model.config)
    return Model(init=lambda generator: params, config=model.config,
                 name="moe-tiny", loss_fn=model.loss_fn,
                 eval_loss_fn=model.eval_loss_fn)


@pytest.fixture(scope="module")
def jax_run():
    model = jax_create_model("moe-tiny", dtype=jnp.float32, max_seq_len=SEQ)
    eng, *_ = deepspeed_tpu.initialize(
        model=model, config=_train_config(0),
        mesh=build_mesh(devices=jax.devices()[:1]))
    start = jax.tree.map(np.asarray, jax.device_get(eng.params))
    losses = [float(eng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
              for b in _train_batches(3)]
    final = jax.tree.map(np.asarray, jax.device_get(eng.params))
    return start, losses, final


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_train_trajectory_matches_jax(jax_run, stage):
    start, want, final = jax_run
    eng, *_ = initialize(model=_port_model(start),
                         config=_train_config(stage), device="cpu")
    got = [float(eng.train_batch(batch=b)) for b in _train_batches(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    params = eng.params
    for path in (("layers", "router"), ("layers", "mlp", "w_up"),
                 ("layers", "mlp", "w_down"), ("layers", "attn", "wq")):
        p, f = params, final
        for k in path:
            p, f = p[k], f[k]
        np.testing.assert_allclose(_np(p), f, atol=1e-4, err_msg=str(path))
    if stage == 3:
        assert eng.zero.peak_live <= 2


# ---------------------------------------------------------------------------
# generate and serve
# ---------------------------------------------------------------------------

T_MAX = 128
# int8: widened so the attention sites pass the quantized kernel's gate
INT8_WIDE = dict(hidden_size=128, ffn_hidden_size=256)


def _ragged(seed, S, lens):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (len(lens), S)).astype(np.int64)
    mask = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_greedy_generate_matches_jax(mode):
    over = INT8_WIDE if mode == "int8" else {}
    jmodel, tree = _weights(max_seq_len=T_MAX, **over)
    bits = 8 if mode == "int8" else None
    jeng = JaxInfEngine(jmodel, JaxInfConfig(
        dtype=jnp.float32, max_out_tokens=T_MAX, compile_cache=False,
        quantize_bits=bits), params=tree)
    tcfg = transformer_config("moe-tiny", max_seq_len=T_MAX, **over)
    # int8: JAX's quantized weights (the expert banks stay dense in both)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params)
                             if bits else tree, tcfg)
    peng = init_inference("moe-tiny", config=InferenceConfig(
        dtype=torch.float32, max_out_tokens=T_MAX, quantize_bits=bits),
        params=params, device="cpu", **over)
    layers = peng.params["layers"]
    if bits:
        assert "q8" in layers["attn"]["wq"]
    assert isinstance(layers["mlp"]["w_up"], torch.Tensor)
    ids, mask = _ragged(3, 21, (21, 9, 15, 4, 21, 12))
    want = np.asarray(jeng.generate(ids, attention_mask=mask,
                                    max_new_tokens=6))
    got = _np(peng.generate(ids, attention_mask=mask, max_new_tokens=6))
    np.testing.assert_array_equal(got, want)


def test_generate_overrides_pass_through():
    eng = init_inference("moe-tiny", dtype=torch.float32, device="cpu",
                         moe_drop_tokens=False, moe_capacity_factor=0.5)
    cfg = eng.model.config
    assert (cfg.moe_drop_tokens, cfg.moe_capacity_factor) == (False, 0.5)
    ids, mask = _ragged(1, 9, (9, 5))
    out = eng.generate(ids, attention_mask=mask, max_new_tokens=4)
    assert out.shape == (2, 4) and int(out.max()) < cfg.vocab_size


SERVE = dict(block_size=8, num_blocks=24, max_seqs=4, max_model_len=64,
             prefill_chunk=16, max_queue=64)


def test_serving_streams_match_jax():
    """Chunked prefill with padded queries (position -1) and ragged decode
    rows: routing is exact (C = T), so pads steal no capacity."""
    jmodel, tree = _weights(max_seq_len=T_MAX)
    jeng = JaxInfEngine(jmodel, JaxInfConfig(
        dtype=jnp.float32, max_out_tokens=64, compile_cache=False),
        params=tree)
    peng = init_inference("moe-tiny", dtype=torch.float32, max_out_tokens=64,
                          params=params_from_jax(tree, transformer_config(
                              "moe-tiny", max_seq_len=T_MAX)), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n) for n in (5, 23, 40, 17, 9, 30)]
    streams = []
    for srv in (ServingEngine(peng, ServingConfig(**SERVE)),
                JaxServingEngine(jeng, JaxServingConfig(**SERVE))):
        hs = [srv.submit(p, max_new_tokens=6 + i % 3)
              for i, p in enumerate(prompts)]
        srv.run()
        streams.append([list(h.tokens) for h in hs])
    assert streams[0] == streams[1]
    assert all(len(s) == 6 + i % 3 for i, s in enumerate(streams[0]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_keys_match_jax_and_round_trip(tmp_path, jax_run):
    import json

    start = jax_run[0]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_create_model("moe-tiny", dtype=jnp.float32,
                               max_seq_len=SEQ),
        config=_train_config(2), mesh=build_mesh(devices=jax.devices()[:1]))
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="ref")
    a = initialize(model=_port_model(start), config=_train_config(2),
                   device="cpu")[0]
    batches = _train_batches(3, seed=4)
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path / "port"), tag="t")
    meta = json.loads((tmp_path / "port" / "t" / "metadata.json"
                       ).read_text())
    jmeta = json.loads((tmp_path / "jax" / "ref" / "metadata.json"
                        ).read_text())
    assert {k: (v["shape"], v["dtype"]) for k, v in meta["arrays"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in jmeta["arrays"].items()}
    assert any("router" in k for k in meta["arrays"])
    b = initialize(model=_port_model(start), config=_train_config(3),
                   device="cpu")[0]
    b.load_checkpoint(str(tmp_path / "port"), tag="t")
    for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)):
        assert torch.equal(x, y)
    la, lb = (e.train_batch(batch=batches[2]) for e in (a, b))
    assert torch.equal(la, lb)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSALS = [
    ("world", {"zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}},
     "MoE with zero_optimization.offload_param"),
    ("offload_param", {"zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}},
     "offload_param"),
    ("offload_optimizer", {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}},
     "offload_optimizer"),
    ("lamb", {"optimizer": {"type": "lamb", "params": {"lr": 1e-3}}},
     "optimizer 'lamb'"),
    ("onebitadam", {"optimizer": {"type": "onebitadam",
                                  "params": {"lr": 1e-3}}},
     "optimizer 'onebitadam'"),
    ("expert_parallel", {"parallel": {"expert_parallel_size": 2},
                         "zero_optimization": {"stage": 3}},
     "expert_parallel_size=2 at ZeRO stage 3"),
]


@pytest.mark.parametrize("what,extra,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_name_themselves(what, extra, match, monkeypatch):
    """MoE at world 2 with parameter offload, and expert parallelism at
    ZeRO stage 3 (a world of 2 that ep 2 divides), still raise by name, as
    do the combinations MoE does not train with at any world."""
    if what in ("world", "expert_parallel"):
        monkeypatch.setattr(comm, "get_world_size", lambda group=None: 2)
    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=SEQ)
    cfg = dict(_train_config(0), **extra)
    with pytest.raises(NotImplementedError, match=match):
        initialize(model=model, config=cfg, device="cpu")


def test_expert_counts_the_parallel_degree_does_not_divide():
    model = create_model("moe-tiny", dtype=torch.float32, max_seq_len=SEQ,
                         moe_num_experts=6)
    with pytest.raises(ValueError, match="divisible"):
        initialize(model=model, config=dict(
            _train_config(0), parallel={"expert_parallel_size": 4}),
            device="cpu")
    with pytest.raises(NotImplementedError, match="expert_parallel=2"):
        init_inference("moe-tiny", dtype=torch.float32, device="cpu",
                       expert_parallel=2)
    with pytest.raises(ValueError, match="requires an MoE model"):
        init_inference("tiny", dtype=torch.float32, device="cpu",
                       expert_parallel=2)
