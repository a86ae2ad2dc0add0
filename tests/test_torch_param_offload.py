"""ZeRO-3 parameter offload on the CPU (``runtime/param_offload.py``).

The executor keeps the layer stack and all of its fp32 state off the card
(host memory, or NVMe files for the 16-bit params) and runs the step as a
host-driven loop over blocks of layers. Held here, at 4 layers of ``tiny``
(GPT-2, tied embeddings) and ``tiny-llama`` (untied, GQA), fp32:

* against the JAX engine's ``offload_param`` (a 1-device mesh, one layer a
  block, built once per module): losses and final params within rtol 1e-4
  / atol 1e-4, with one layer a block and with blocks of 3 (a remainder
  block of 1; JAX's trajectory does not depend on the split);
* against the port's resident stage-3 engine, bit for bit: the fused path
  (gas 1, no clipping), tied embeddings too (the embedding's grad is the
  head's part plus the lookup's, one addition either way); the deferred
  path (gas 2, clipping); fp16 with an overflow skip (its scale and skip
  pattern also JAX's); the eval loss;
* ``create_model``'s streamed init (each layer to the host or its file as
  it is drawn) bit for bit with the resident engine's draws, both tiers;
* the nvme tier bit for bit with the cpu tier, one file a block; at most
  two blocks on the device at once; the bytes moved as the loop counts
  them;
* the gates, each by its message, and world 2 over gloo refused;
* checkpoints in JAX's layout: resumed bit for bit on both tiers,
  cross-loaded with the resident stage-3 engine both ways, a JAX
  checkpoint loaded, and ``consolidate_checkpoint`` pairing every
  ``opt##layer_master##<i>`` with its own leaf where same-shaped leaves
  hold different values.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import Model, create_model, params_from_jax
from deepspeed_tpu_torch.models.core import tree_items
from deepspeed_tpu_torch.runtime.checkpoint import (consolidate_checkpoint,
                                                    load_flat_weights)
from deepspeed_tpu_torch.utils import tensor_fragment as tf
from torch_dist_workers import (GLOBAL_ROWS, SEQ, param_offload_refusal,
                                spawn, token_batches)

LAYERS = 4
STEPS = 3
PRESETS = ("tiny", "tiny-llama")
# lr 1e-3, as the optimizer-offload tests' AdamW: against JAX, an element
# whose grad is near zero moves by up to lr a step on the last bits of the
# two frameworks' grads (Adam divides by sqrt(v) + eps), and 3 steps at
# 5e-3 came within 1.3x of TOL
ADAMW = {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
FP16 = {"enabled": True, "initial_scale_power": 36, "hysteresis": 1}


def config(tier=None, swap="", buffer_size=1, gas=1, **extra):
    zero = {"stage": 3}
    if tier is not None:
        zero["offload_param"] = {"device": tier, "nvme_path": swap,
                                 "buffer_size": buffer_size}
    cfg = {"train_micro_batch_size_per_gpu": GLOBAL_ROWS,
           "gradient_accumulation_steps": gas, "steps_per_print": 1000,
           "optimizer": ADAMW, "zero_optimization": zero}
    cfg.update(extra)
    return cfg


def block_bytes(preset, layers):
    """``buffer_size`` for blocks of ``layers`` fp32 layers of ``preset``."""
    tree = create_model(preset, num_layers=1).init(torch.Generator(),
                                                   device="meta")
    return layers * sum(t.numel() * 4 for _, t in tree_items(tree["layers"]))


def jax_engine(preset, dtype, cfg):
    model = jax_create_model(preset, dtype=DTYPES[dtype][1],
                             max_seq_len=SEQ, num_layers=LAYERS)
    return deepspeed_tpu.initialize(
        model=model, config=cfg,
        mesh=build_mesh(devices=jax.devices()[:1]))[0]


def jax_params(eng):
    return jax.tree.map(lambda a: np.array(a, np.float32), jax.device_get(
        eng._param_offload.params_for_checkpoint()))


def jax_batch(b):
    return jax.tree.map(jnp.asarray, b)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny models take thousands of small ops,
    which several workers' thread pools on shared cores slow tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per preset the JAX offload engine's init, per-step losses and final
    params (fp32, one layer a block, STEPS steps; ``tiny`` also saved after
    2 steps), and ``tiny`` in fp16 from an overflowing scale: losses,
    scales and skipped steps."""
    out = {"ckpt": str(tmp_path_factory.mktemp("jax_ckpt"))}
    for preset in PRESETS:
        eng = jax_engine(preset, "float32", config("cpu"))
        init = jax_params(eng)
        losses = []
        for i, b in enumerate(token_batches(STEPS, 1, seed=1)):
            losses.append(float(eng.train_batch(batch=jax_batch(b))))
            if preset == "tiny" and i == 1:
                eng.save_checkpoint(out["ckpt"], tag="step2")
        out[preset] = dict(init=init, losses=losses, params=jax_params(eng))
    eng = jax_engine("tiny", "float16", config("cpu", fp16=FP16))
    init = jax.tree.map(np.array, jax.device_get(
        eng._param_offload.params_for_checkpoint()))
    runs = []
    for b in token_batches(4, 1, seed=2):
        loss = float(eng.train_batch(batch=jax_batch(b)))
        runs.append((loss, float(eng.scaler_state.scale),
                     int(eng.skipped_steps)))
    out["fp16"] = dict(init=init, runs=runs)
    return out


def port_engine(preset, init, cfg, dtype="float32"):
    """``initialize`` on the CPU over ``preset`` at LAYERS layers whose init
    is ``init`` (numpy, the JAX layout)."""
    model = create_model(preset, dtype=DTYPES[dtype][0], max_seq_len=SEQ,
                         num_layers=LAYERS)
    mdl = Model(init=lambda g: params_from_jax(init, model.config,
                                               device=g.device),
                config=model.config, name=preset, loss_fn=model.loss_fn,
                eval_loss_fn=model.eval_loss_fn)
    return initialize(model=mdl, config=cfg, device="cpu")[0]


def train(eng, batches):
    return [float(eng.train_batch(batch=b)) for b in batches]


def paths(eng):
    return ["/".join(p) for p, _ in tree_items(eng.params)]


def state(eng):
    """Every leaf's param, fp32 master and moments, and the counters."""
    out = {}
    for p in paths(eng):
        out[p] = (tf.safe_get_full_param(eng, p),
                  tf.safe_get_full_fp32_param(eng, p),
                  tf.safe_get_full_optimizer_state(eng, p, "exp_avg"),
                  tf.safe_get_full_optimizer_state(eng, p, "exp_avg_sq"))
    return out, (eng.global_steps, eng.skipped_steps, eng.cur_scale)


def assert_same(a, b):
    assert a[1] == b[1]
    assert a[0].keys() == b[0].keys()
    for p in a[0]:
        for x, y in zip(a[0][p], b[0][p]):
            np.testing.assert_array_equal(x, y, err_msg=p)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers_per_block", [1, 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_trajectory_matches_jax_and_fused_path_equals_resident(
        jax_runs, preset, layers_per_block):
    ref = jax_runs[preset]
    batches = token_batches(STEPS, 1, seed=1)
    eng = port_engine(preset, ref["init"], config(
        "cpu", buffer_size=block_bytes(preset, layers_per_block)))
    ex = eng._param_offload
    assert ex.num_blocks == -(-LAYERS // layers_per_block)
    assert ex.bounds[-1] == ((LAYERS - 1) // layers_per_block
                             * layers_per_block, LAYERS)
    losses = train(eng, batches)
    np.testing.assert_allclose(losses, ref["losses"], **TOL)
    got = dict(tree_items(eng.params))
    for path, want in tree_items(ref["params"]):
        np.testing.assert_allclose(got[path].numpy(), want, **TOL,
                                   err_msg="/".join(path))
    res = port_engine(preset, ref["init"], config())
    assert train(res, batches) == losses
    assert_same(state(eng), state(res))


@pytest.mark.parametrize("preset", PRESETS)
def test_deferred_path_equals_resident(jax_runs, preset):
    """gas 2 and a clip that clips (the deferred path: host fp32
    accumulators, then the norm, then a sweep of the blocks' updates) bit
    for bit with the resident engine: both take the grad norm's squares in
    float64 on the CPU (``optimizer.grad_norm``; this executor block by
    block, the resident engine over its flat shard), so the clip
    coefficients round to the same fp32."""
    init = jax_runs[preset]["init"]
    extra = dict(gas=2, gradient_clipping=0.05)
    off = port_engine(preset, init, config("cpu", **extra))
    res = port_engine(preset, init, config(**extra))
    batches = token_batches(STEPS, 2, seed=3)
    assert train(off, batches) == train(res, batches)
    assert_same(state(off), state(res))
    assert off._param_offload.fused is False


def test_fp16_overflow_skip(jax_runs):
    """A scale of 2^36 overflows: the step is skipped before any state
    commits and the scale backs off; losses, scales and the skip pattern
    equal the resident engine's bit for bit, and the scales and skips
    JAX's offload engine's, its losses within JAX's own bar (2e-3)."""
    ref = jax_runs["fp16"]
    batches = token_batches(4, 1, seed=2)
    runs = {}
    for name, cfg in (("offload", config("cpu", fp16=FP16)),
                      ("resident", config(fp16=FP16))):
        eng = port_engine("tiny", ref["init"], cfg, dtype="float16")
        runs[name] = [(float(eng.train_batch(batch=b)), eng.cur_scale,
                       eng.skipped_steps) for b in batches]
        if name == "offload":
            off = eng
        else:
            assert_same(state(off), state(eng))
    assert runs["offload"] == runs["resident"]
    assert runs["offload"][0][2] >= 1
    for (lp, sp, kp), (lj, sj, kj) in zip(runs["offload"], ref["runs"]):
        assert (sp, kp) == (sj, kj)
        np.testing.assert_allclose(lp, lj, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("preset", PRESETS)
def test_eval_equals_resident(jax_runs, preset):
    init = jax_runs[preset]["init"]
    b = token_batches(1, 1, seed=9)[0]
    mb = {"input_ids": b["input_ids"][0]}
    engines = [port_engine(preset, init, cfg) for cfg in (config("cpu"),
                                                           config())]
    for e in engines:
        train(e, token_batches(1, 1, seed=4))
    off, res = (float(e.eval_loss(mb)) for e in engines)
    assert off == res


@pytest.mark.parametrize("tier,dtype", [("cpu", "float32"),
                                        ("cpu", "bfloat16"),
                                        ("nvme", "bfloat16")])
@pytest.mark.parametrize("preset", PRESETS)
def test_streamed_init_equals_resident_draws(tmp_path, preset, tier, dtype):
    """``create_model``'s models stream their init: each layer of the stack
    goes to the host (or its block file) as the engine's generator draws
    it. Params, fp32 masters (a bf16 param's float) and the zero moments
    equal the resident stage-3 engine's draws from the same seed bit for
    bit; the loss of one step too."""
    extra = {"bf16": {"enabled": True}} if dtype == "bfloat16" else {}
    model = create_model(preset, dtype=DTYPES[dtype][0], max_seq_len=SEQ,
                         num_layers=LAYERS)
    assert model.streams_layers
    off, res = (initialize(model=model, config=cfg, device="cpu")[0]
                for cfg in (config(tier, str(tmp_path), **extra),
                            config(**extra)))
    assert_same(state(off), state(res))
    batches = token_batches(1, 1, seed=12)
    assert train(off, batches) == train(res, batches)


# ---------------------------------------------------------------------------
# tiers and streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gas", [1, 2])
def test_nvme_equals_cpu_with_a_file_a_block(jax_runs, tmp_path, gas):
    init = jax_runs["tiny-llama"]["init"]
    extra = dict(gas=gas, buffer_size=block_bytes("tiny-llama", 3))
    if gas == 2:
        extra["gradient_clipping"] = 0.05
    cpu = port_engine("tiny-llama", init, config("cpu", **extra))
    nvme = port_engine("tiny-llama", init, config(
        "nvme", str(tmp_path), **extra))
    batches = token_batches(STEPS, gas, seed=5)
    assert train(cpu, batches) == train(nvme, batches)
    assert_same(state(cpu), state(nvme))
    ex = nvme._param_offload
    swap = os.path.join(str(tmp_path), "dstpu_param_swap_p0")
    assert sorted(os.listdir(swap)) == ["params.block0000.bin",
                                        "params.block0001.bin"]
    assert [os.path.getsize(os.path.join(swap, f)) for f in sorted(
        os.listdir(swap))] == [4 * n for n in ex.block_numel]
    assert ex.params is None and ex.last_step_stats["read_bytes"] > 0
    stats = ex.last_step_stats
    assert stats["write_bytes"] == 4 * sum(ex.block_numel)


@pytest.mark.parametrize("gas", [1, 2])
def test_two_blocks_on_the_device_and_the_bytes_moved(jax_runs, gas):
    eng = port_engine("tiny", jax_runs["tiny"]["init"], config(
        "cpu", gas=gas, **({"gradient_clipping": 1.0} if gas > 1 else {})))
    train(eng, token_batches(2, gas, seed=6))
    ex = eng._param_offload
    assert ex.num_blocks == LAYERS and ex.peak_live == 2 and ex.live == 0
    st = ex.last_step_stats
    assert (st["h2d_bytes"], st["d2h_bytes"]) == ex.stream_bytes_per_step()
    assert st["peak_live_blocks"] == 2 and st["wall_s"] > 0
    # device time is taken by CUDA events; a CPU step copies without pinned
    # buffers
    assert st["device_busy_s"] is None and st["host_copy_s"] == 0.0
    peak = ex.measure_stream_peak(sweeps=1)
    rep = ex.overlap_report([{"input_ids": torch.as_tensor(
        b["input_ids"][0]).long()} for b in token_batches(1, gas, seed=7)])
    assert peak > 0 and 0.0 <= rep["overlap_efficiency"] <= 1.0
    assert ex.peak_live == 2


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change,error,match", [
    ({"zero_optimization": {"stage": 1, "offload_param": {
        "device": "cpu"}}}, ValueError, "requires ZeRO stage 3"),
    ({"optimizer": {"type": "lamb", "params": {"lr": 1e-3}}}, ValueError,
     "Adam family only, got 'lamb'"),
    ({"optimizer": {"type": "onebitadam", "params": {"lr": 1e-3}}},
     ValueError, "incompatible with 1-bit"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"},
                            "offload_optimizer": {"device": "cpu"}}},
     ValueError, "subsumes optimizer-state offload"),
    ({"parallel": {"pipeline_parallel_size": 2}}, NotImplementedError,
     r"offload_param \+ pipeline parallelism is not supported"),
    ({"data_efficiency": {"enabled": True, "data_routing": {
        "random_ltd": {"enabled": True}}}}, NotImplementedError,
     r"offload_param \+ random_ltd is not supported"),
    ({"compression_training": {"sparse_pruning": {"shared_parameters": {
        "enabled": True}}}}, NotImplementedError,
     r"offload_param \+ pruning compression is not supported"),
], ids=["stage", "not_adam", "onebit", "subsumes", "pipeline", "random_ltd",
        "pruning"])
def test_gates(change, error, match):
    cfg = dict(config("cpu"), **change)
    with pytest.raises(error, match=match):
        initialize(model=create_model("tiny", max_seq_len=SEQ), config=cfg,
                   device="cpu")


def test_world_two_refused_over_gloo():
    out = spawn(param_offload_refusal, 2)
    for msg in out:
        assert msg.startswith("NotImplementedError: offload_param at world "
                              "2 is not ported yet")


def test_staged_protocol_raises(jax_runs):
    eng = port_engine("tiny", jax_runs["tiny"]["init"], config("cpu"))
    with pytest.raises(RuntimeError, match="staged forward/backward/step"):
        eng.forward({"input_ids": np.zeros((GLOBAL_ROWS, SEQ), np.int64)})


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_checkpoint_resumes_bit_for_bit(jax_runs, tmp_path, tier):
    init = jax_runs["tiny-llama"]["init"]
    batches = token_batches(3, 1, seed=8)
    a = port_engine("tiny-llama", init, config(tier, str(tmp_path / "a")))
    train(a, batches[:2])
    a.save_checkpoint(str(tmp_path / "ck"), tag="step2")
    saved = state(a)
    # another init: the load overwrites it
    b = port_engine("tiny-llama", jax.tree.map(lambda x: x * 0.5, init),
                    config(tier, str(tmp_path / "b")))
    b.load_checkpoint(str(tmp_path / "ck"))
    assert_same(state(b), saved)
    assert b.global_steps == 2 and b._param_offload.step_count == 2
    assert train(a, batches[2:]) == train(b, batches[2:])
    assert_same(state(a), state(b))


@pytest.mark.parametrize("src,dst", [("cpu", None), (None, "cpu")],
                         ids=["offload_to_resident", "resident_to_offload"])
def test_checkpoints_cross_load_with_the_resident_engine(jax_runs, tmp_path,
                                                         src, dst):
    """bf16 (a 16-bit master): the state arrives bit for bit, and the next
    step's loss and state are equal."""
    init = jax_runs["tiny"]["init"]
    batches = token_batches(3, 1, seed=10)
    a = port_engine("tiny", init, config(src, bf16={"enabled": True}),
                    dtype="bfloat16")
    train(a, batches[:2])
    a.save_checkpoint(str(tmp_path), tag="step2")
    b = port_engine("tiny", jax.tree.map(lambda x: x * 0.5, init),
                    config(dst, bf16={"enabled": True}), dtype="bfloat16")
    b.load_checkpoint(str(tmp_path))
    assert_same(state(a), state(b))
    assert train(a, batches[2:]) == train(b, batches[2:])
    assert_same(state(a), state(b))


def test_jax_checkpoint_loads_into_the_port(jax_runs):
    """JAX's offload engine saved after 2 steps; the port loads it and
    its third step agrees with JAX's within the trajectory tolerance."""
    ref = jax_runs["tiny"]
    eng = port_engine("tiny", ref["init"], config("cpu"))
    eng.load_checkpoint(jax_runs["ckpt"])
    assert eng.global_steps == 2 and eng._param_offload.step_count == 2
    loss = train(eng, token_batches(STEPS, 1, seed=1)[2:])
    np.testing.assert_allclose(loss, ref["losses"][2:], **TOL)
    got = dict(tree_items(eng.params))
    for path, want in tree_items(ref["params"]):
        np.testing.assert_allclose(got[path].float().numpy(), want, **TOL,
                                   err_msg="/".join(path))


def test_consolidate_pairs_each_layer_master_with_its_leaf(jax_runs,
                                                           tmp_path):
    """``tiny`` in bf16 (wq / wk / wv, bq / bk / bv and the norms are
    same-shaped and, after two steps, differ): the consolidated fp32 leaf
    of every param is its own master, which differs from its bf16 param, so
    a master paired with another same-shaped leaf would show."""
    eng = port_engine("tiny", jax_runs["tiny"]["init"], config(
        "cpu", bf16={"enabled": True}), dtype="bfloat16")
    train(eng, token_batches(2, 1, seed=11))
    eng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    flat = load_flat_weights(consolidate_checkpoint(str(tmp_path / "ck"),
                                                    str(tmp_path / "fp32")))
    masters = {p: tf.safe_get_full_fp32_param(eng, p) for p in paths(eng)}
    assert sorted(flat) == sorted(p.replace("/", "##") for p in masters)
    for p, m in masters.items():
        np.testing.assert_array_equal(flat[p.replace("/", "##")].numpy(), m,
                                      err_msg=p)
    layer = [p for p in masters if p.startswith("layers/")]
    for i, p in enumerate(layer):
        for q in layer[i + 1:]:
            if masters[p].shape == masters[q].shape:
                assert not np.array_equal(masters[p], masters[q]), (p, q)
    bf16 = tf.safe_get_full_param(eng, "layers/attn/wq")
    assert not np.array_equal(bf16, masters["layers/attn/wq"])
