"""Single-device training: the port against the JAX package, on the CPU.

* The flash-attention backward: the port's ``reference_flash_attention_bwd``
  (the dq / dkv kernels' plain version), its two wrappers, and autograd
  through ``flash_attention`` against ``jax.vjp`` of JAX
  ``dot_product_attention`` at S == T (where its end-aligned causality is
  the kernel's 0-based one): causal, key padding, alibi, GQA; fp32 at
  2e-5.
* The norm backward (``layer_norm_bwd``, the body of the CUDA path's
  backward, and autograd through ``fused_layer_norm``) against ``jax.vjp``
  of JAX ``fused_layer_norm(interpret=True)``: LayerNorm with bias and
  RMSNorm.
* ``cross_entropy_loss`` and the model's ``loss_fn`` against JAX's.
* ``initialize(...).train_batch`` against the JAX engine, 20 fp32 steps on
  ``tiny`` (right-padded attention mask), ``tiny-llama`` (gas 2, GQA) and
  ``tiny-bloom`` (gradient clipping, alibi), from the same initial params
  (the JAX engine's, converted with ``params_from_jax``) and the same
  global batches (JAX on a one-device mesh, so the micro batches agree):
  losses per step within rtol 1e-4, final params within atol 1e-4.
* The port alone: the staged forward / backward / step equals
  ``train_batch``; ZeRO stages 0-3 give one trajectory; the flat grad
  buffer is written in place; inference outputs carry no autograd graph;
  bf16 and fp16 training (the overflow skip and the loss scale); entry
  points need CUDA unless given ``device="cpu"``; unported features raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.models.transformer import \
    cross_entropy_loss as jax_cross_entropy
from deepspeed_tpu.models.transformer import \
    dot_product_attention as jax_attention
from deepspeed_tpu.ops.normalization import \
    fused_layer_norm as jax_layer_norm
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize, init_inference
from deepspeed_tpu_torch.models import (Model, create_model,
                                        cross_entropy_loss, params_from_jax,
                                        params_to_numpy)
from deepspeed_tpu_torch.models.core import tree_leaves
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                     fused_layer_norm, launch_counts,
                                     layer_norm_bwd,
                                     reference_flash_attention,
                                     reference_flash_attention_bwd)
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine

ATOL = 2e-5


# ---------------------------------------------------------------------------
# flash-attention backward
# ---------------------------------------------------------------------------

# (B, S, N, K, D, causal, masked, alibi)
BWD_CASES = [(2, 24, 4, 4, 16, True, False, False),
             (2, 33, 4, 4, 32, True, True, False),
             (2, 20, 8, 8, 16, False, True, True),
             (2, 29, 8, 2, 16, True, True, False),
             (1, 40, 4, 2, 32, True, False, True)]


@pytest.mark.parametrize("B,S,N,K,D,causal,masked,use_alibi", BWD_CASES)
def test_flash_backward_matches_jax_vjp(B, S, N, K, D, causal, masked,
                                        use_alibi):
    rng = np.random.default_rng(S + N + D)
    q = rng.normal(size=(B, S, N, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, K, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, S, N, D)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, S), np.int32)
        mask[0, S - 7:] = 0
        mask[-1, 5::4] = 0
    slopes = alibi_slopes(N).numpy() if use_alibi else None

    def jfn(q_, k_, v_):
        return jax_attention(q_, k_, v_,
                             None if mask is None else jnp.asarray(mask),
                             causal=causal,
                             alibi=None if slopes is None
                             else jnp.asarray(slopes))

    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    tm = None if mask is None else torch.tensor(mask)
    al = None if slopes is None else torch.tensor(slopes)
    o, lse = reference_flash_attention(tq, tk, tv, tm, causal, None, al,
                                       return_lse=True)
    plain = reference_flash_attention_bwd(tq, tk, tv, o, lse, tdo, tm,
                                          causal, None, al)
    wrapped = flash_attention_bwd(tq, tk, tv, o, lse, tdo, tm, causal, None,
                                  al)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    flash_attention(*leaves, tm, causal=causal, alibi=al).backward(tdo)
    for got in (plain, wrapped, [x.grad for x in leaves]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("B,S,N,K,D,causal,masked,use_alibi", BWD_CASES)
def test_flash_bwd_on_cpu_is_the_plain_version(B, S, N, K, D, causal, masked,
                                               use_alibi):
    """On CPU tensors ``flash_attention_bwd`` launches nothing and returns
    exactly what ``reference_flash_attention_bwd`` returns."""
    rng = np.random.default_rng(S * N + D)
    q, do = (torch.tensor(rng.normal(size=(B, S, N, D)), dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(B, S, K, D)), dtype=torch.float32)
            for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones(B, S, dtype=torch.int32)
        mask[0, S - 5:] = 0
    al = alibi_slopes(N) if use_alibi else None
    o, lse = reference_flash_attention(q, k, v, mask, causal, None, al,
                                       return_lse=True)
    before = launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, mask, causal, None, al)
    assert launch_counts() == before
    want = reference_flash_attention_bwd(q, k, v, o, lse, do, mask, causal,
                                         None, al)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# norm backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rms", [False, True])
def test_norm_backward_matches_jax_vjp(rms):
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 2.0, (3, 7, 64)) + 0.5).astype(np.float32)
    scale = rng.normal(1.0, 0.3, 64).astype(np.float32)
    bias = rng.normal(0, 0.3, 64).astype(np.float32)
    g = rng.normal(size=(3, 7, 64)).astype(np.float32)
    jb = None if rms else jnp.asarray(bias)

    def jfn(x_, s_, b_):
        return jax_layer_norm(x_, s_, b_, 1e-5, rms, True)

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale), jb)
    want = [None if w is None else np.asarray(w) for w in vjp(jnp.asarray(g))]
    tb = None if rms else torch.tensor(bias)
    got = layer_norm_bwd(torch.tensor(x), torch.tensor(scale), tb,
                         torch.tensor(g), 1e-5, rms)
    leaves = [torch.tensor(a).requires_grad_() for a in (x, scale, bias)]
    fused_layer_norm(leaves[0], leaves[1], None if rms else leaves[2], 1e-5,
                     rms).backward(torch.tensor(g))
    auto = [leaves[0].grad, leaves[1].grad, None if rms else leaves[2].grad]
    for result in (got, auto):
        for a, w in zip(result, want):
            if w is None:
                assert a is None
            else:
                np.testing.assert_allclose(a.numpy(), w, atol=1e-5,
                                           rtol=1e-5)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3.0, (3, 9, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 9))
    labels[0, 2] = labels[2, 8] = -100
    mask = np.ones((3, 9), np.int32)
    mask[1, 6:] = 0
    for m in (None, mask):
        want = float(jax_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m)))
        got = float(cross_entropy_loss(torch.tensor(logits),
                                       torch.tensor(labels),
                                       None if m is None else torch.tensor(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    none = torch.full((1, 3), -100)
    assert float(cross_entropy_loss(torch.zeros(1, 3, 5), none)) == 0.0


# ---------------------------------------------------------------------------
# the trainer against the JAX engine
# ---------------------------------------------------------------------------

SEQ = 32


def _config(gas=1, clip=0.0, lr=1e-3, **extra):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": gas, "steps_per_print": 1000,
           "gradient_clipping": clip,
           "optimizer": {"type": "adamw",
                         "params": {"lr": lr, "weight_decay": 0.01}}}
    cfg.update(extra)
    return cfg


def _batches(steps, gas, masked, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = {"input_ids": rng.integers(0, 250, (gas, 4, SEQ))}
        if masked:
            lens = rng.integers(SEQ // 2, SEQ + 1, (gas, 4))
            b["attention_mask"] = (np.arange(SEQ)[None, None]
                                   < lens[..., None]).astype(np.int32)
            b["input_ids"] = b["input_ids"] * b["attention_mask"]
        out.append(b)
    return out


def _jax_engine(preset, cfg):
    model = jax_create_model(preset, dtype=jnp.float32, max_seq_len=SEQ)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, config=cfg, mesh=build_mesh(devices=jax.devices()[:1]))
    return engine


def _port_model(preset, np_params=None, dtype=torch.float32):
    """The preset's Model, whose init returns ``np_params`` converted if
    given."""
    model = create_model(preset, dtype=dtype, max_seq_len=SEQ)
    if np_params is None:
        return model
    params = params_from_jax(np_params, model.config)
    return Model(init=lambda generator: params, config=model.config,
                 name=preset, loss_fn=model.loss_fn,
                 eval_loss_fn=model.eval_loss_fn)


TRAJECTORIES = [("tiny", dict(masked=True)),
                ("tiny-llama", dict(gas=2)),
                ("tiny-bloom", dict(clip=0.05))]


@pytest.mark.parametrize("preset,case", TRAJECTORIES)
def test_train_trajectory_matches_jax(preset, case):
    gas, clip, masked = case.get("gas", 1), case.get("clip", 0.0), \
        case.get("masked", False)
    cfg = _config(gas=gas, clip=clip)
    jeng = _jax_engine(preset, cfg)
    start = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    peng, *_ = initialize(model=_port_model(preset, start), config=cfg,
                          device="cpu")
    for b in _batches(20, gas, masked):
        want = float(jeng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
        got = peng.train_batch(batch=b)
        assert got.dim() == 0 and got.grad_fn is None
        np.testing.assert_allclose(float(got), want, rtol=1e-4)
    final = jax.tree.map(np.asarray, jax.device_get(jeng.params))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-4),
                 params_to_numpy(peng.params), final)
    assert peng.global_steps == jeng.global_steps == 20
    assert peng.micro_steps == 20 * gas
    assert peng.get_lr() == pytest.approx(jeng.get_lr())


def test_fp16_loss_scale_and_skips_match_jax():
    """fp16 with a scale far too large: the first steps overflow and are
    skipped while the scale backs off, exactly as in the JAX engine."""
    cfg = _config(fp16={"enabled": True, "initial_scale_power": 32,
                        "hysteresis": 1, "loss_scale_window": 4})
    model = jax_create_model("tiny", dtype=jnp.float16, max_seq_len=SEQ)
    jeng, *_ = deepspeed_tpu.initialize(
        model=model, config=cfg, mesh=build_mesh(devices=jax.devices()[:1]))
    start = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         jax.device_get(jeng.params))
    peng, *_ = initialize(model=_port_model("tiny", start, torch.float16),
                          config=cfg, device="cpu")
    scales = []
    for b in _batches(14, 1, False, seed=2):
        jl = float(jeng.train_batch(batch=jax.tree.map(jnp.asarray, b)))
        pl = float(peng.train_batch(batch=b))
        scales.append((peng.cur_scale, jeng.cur_scale))
        np.testing.assert_allclose(pl, jl, rtol=2e-3)
    assert [p for p, _ in scales] == [j for _, j in scales]
    assert peng.skipped_steps == jeng.skipped_steps > 0
    assert scales[-1][0] < 2.0 ** 32


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def _engine(preset="tiny", dtype=torch.float32, **kw):
    cfg = kw.pop("config", None) or _config(**kw)
    return initialize(model=_port_model(preset, dtype=dtype), config=cfg,
                      device="cpu")[0]


def test_staged_protocol_equals_train_batch():
    a, b = _engine(gas=2), _engine(gas=2)
    for batch in _batches(3, 2, True, seed=4):
        want = a.train_batch(batch=batch)
        losses = []
        for i in range(2):
            losses.append(b.forward({k: v[i] for k, v in batch.items()}))
            b.backward(losses[-1])
            assert b.is_gradient_accumulation_boundary() == (i == 1)
            b.step()
        torch.testing.assert_close(torch.stack(losses).mean().detach(),
                                   want, atol=0, rtol=0)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    assert a.global_steps == b.global_steps == 3
    with pytest.raises(RuntimeError, match="before forward"):
        b.backward()


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_match_stage0(stage):
    """World size 1: every ZeRO stage does stage 0's math."""
    trajectories = []
    for s in (0, stage):
        eng = _engine(config=_config(zero_optimization={"stage": s}))
        losses = [float(eng.train_batch(batch=b)) for b in _batches(3, 1, 0)]
        trajectories.append((losses, params_to_numpy(eng.params)))
        assert eng.zero_optimization_stage() == s
    assert trajectories[0][0] == trajectories[1][0]
    jax.tree.map(np.testing.assert_array_equal, trajectories[0][1],
                 trajectories[1][1])


def test_grads_accumulate_in_the_flat_buffer():
    eng = _engine()
    leaves = list(tree_leaves(eng.params))
    ptrs = [p.grad.data_ptr() for p in leaves]
    eng.forward({k: v[0] for k, v in _batches(1, 1, False)[0].items()})
    eng.backward()
    assert [p.grad.data_ptr() for p in leaves] == ptrs
    flat = eng.opt_state.grad_flat
    assert float(flat.abs().sum()) > 0
    assert sum(p.grad.numel() for p in leaves) == flat.numel()
    eng.step()
    assert float(flat.abs().sum()) == 0        # zeroed for the next step


def test_bf16_training_keeps_master_weights():
    eng = _engine(config=_config(bf16={"enabled": True}, gas=2),
                  preset="tiny-llama", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        _engine(config=_config(bf16={"enabled": True}))
    assert eng.compute_dtype == torch.bfloat16 and eng.bfloat16_enabled()
    assert eng.opt_state.master.dtype == torch.float32
    assert eng._grad_acc is not None      # gas 2: fp32 accumulation
    losses = [float(eng.train_batch(batch=b))
              for b in _batches(6, 2, False)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    torch.testing.assert_close(eng.opt_state.master.bfloat16(),
                               eng.opt_state.param_flat, atol=0, rtol=0)


def test_dataloader_and_accessors():
    data = [{"input_ids": np.arange(SEQ) % 250 + i} for i in range(12)]
    cfg = _config(scheduler={"type": "WarmupLR",
                             "params": {"warmup_num_steps": 5,
                                        "warmup_max_lr": 1e-3}})
    eng, opt, loader, sched = initialize(model=_port_model("tiny"),
                                         config=cfg, training_data=data,
                                         device="cpu")
    assert opt is eng.optimizer and sched is eng.lr_scheduler
    assert eng.train_batch_size() == 4 and len(loader.loader) == 3
    for _ in range(4):                          # wraps around an epoch
        assert np.isfinite(float(eng.train_batch(data_iter=loader)))
    assert eng.get_lr() == sched.get_lr() and eng.get_global_step() == 4
    assert eng.cur_scale == 1.0 and eng.skipped_steps == 0
    assert not eng.fp16_enabled() and eng.gradient_clipping() == 0.0
    assert np.isfinite(float(eng.eval_loss({"input_ids": data[0]["input_ids"]
                                            [None]})))


def test_inference_outputs_carry_no_graph():
    eng = initialize(model=create_model("tiny", dtype=torch.float32,
                                        max_seq_len=128),
                     config=_config(), device="cpu")[0]
    inf = init_inference("tiny", dtype=torch.float32, max_out_tokens=128,
                         params=eng.params, device="cpu")
    assert any(p.requires_grad for p in tree_leaves(inf.params))
    ids = np.arange(10)[None] % 250
    assert inf.forward(ids).grad_fn is None
    assert inf.generate(ids, max_new_tokens=3).grad_fn is None
    srv = ServingEngine(inf, ServingConfig(block_size=8, max_seqs=2,
                                           max_model_len=64,
                                           prefill_chunk=16))
    outs = []
    for name in ("_prefill", "_decode"):
        real = getattr(srv, name)

        def spy(*args, real=real):
            out = real(*args)
            outs.extend(out)
            return out

        setattr(srv, name, spy)
    h = srv.submit(ids[0], max_new_tokens=3)
    srv.run()
    assert len(h.result()) == 3 and len(outs) >= 4
    assert all(t.grad_fn is None for t in outs)


def test_entry_point_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize(model=_port_model("tiny"), config=_config())
    eng = _engine()
    assert all(p.device.type == "cpu" for p in tree_leaves(eng.params))


@pytest.mark.parametrize("overrides,what", [
    (dict(remat=True), "remat"),
    (dict(pld_enabled=True), "pld_enabled"),
    (dict(ltd_enabled=True), "ltd_enabled"),
    (dict(act_quant_bits=8), "act_quant_bits"),
])
def test_unported_model_features_raise(overrides, what):
    with pytest.raises(NotImplementedError, match=what):
        initialize(model=create_model("tiny", dtype=torch.float32,
                                      **overrides),
                   config=_config(), device="cpu")


def test_unported_engine_features_raise():
    with pytest.raises(NotImplementedError, match="dropout"):
        initialize(model=create_model("tiny", dtype=torch.float32,
                                      dropout=0.1),
                   config=_config(), device="cpu")
    for extra in ({"optimizer": {"type": "lion"}},
                  {"parallel": {"tensor_parallel_size": 2}},
                  {"zero_optimization": {"stage": 2, "offload_optimizer":
                                         {"device": "cpu"}},
                   "optimizer": {"type": "lamb"}},
                  {"progressive_layer_drop": {"enabled": True}}):
        with pytest.raises(NotImplementedError):
            initialize(model=_port_model("tiny"), config=_config(**extra),
                       device="cpu")
    for opt in ("onebitadam", "onebitlamb", "zerooneadam"):
        # ported at stages 0-1 (test_torch_onebit.py); above, refused
        with pytest.raises(NotImplementedError, match=opt):
            initialize(model=_port_model("tiny"),
                       config=_config(optimizer={"type": opt},
                                      zero_optimization={"stage": 2}),
                       device="cpu")
    eng = _engine()
    with pytest.raises(ValueError, match="leading dim"):
        eng.train_batch(batch={"input_ids": np.zeros((2, 4, SEQ), np.int64)})
