"""Format-2 checkpoints of the port on the CPU, against the JAX package's.

* ``range_boxes`` (a contiguous range of a C-order array as boxes), by
  property: the boxes tile exactly the range, in order, each contiguous.
* A JAX engine's checkpoint (``tiny``, ZeRO 3 over 4 devices) loads into
  the port: params, fp32 master, both moments and counts equal JAX's, bit
  for bit, and the next step agrees with JAX's next step.
* The port's checkpoint loads into the JAX engine: JAX's
  ``verify_checkpoint`` finds no problem, the params and the optimizer
  state arrive bit for bit, and the next step agrees.
* Resume on the plain path is bit for bit, also into another stage; the
  client state (counters, loss scale, schedule) comes back.
* A staging directory left by a crashed save is never published; a
  truncated or bit-flipped shard fails verification and ``verify=True``
  falls back to the previous good tag; ``async_save`` moves ``latest`` only
  after its writes land.
* ``consolidate_checkpoint``, ``save_16bit_model`` and the
  ``safe_get_full_*`` accessors against the JAX package's.

(Checkpoints across world sizes: ``test_torch_zero.py``.)
"""

import json
import math
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import deepspeed_tpu
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime import checkpoint as jax_ckpt
from deepspeed_tpu.utils import tensor_fragment as jax_tf
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import Model, create_model, params_from_jax
from deepspeed_tpu_torch.runtime import checkpoint as ckpt
from deepspeed_tpu_torch.utils import tensor_fragment as tf

SEQ = 32
ROWS = 4


# ---------------------------------------------------------------------------
# the splitter
# ---------------------------------------------------------------------------

@st.composite
def _ranges(draw):
    shape = tuple(draw(st.lists(st.integers(1, 5), min_size=0, max_size=4)))
    n = math.prod(shape)
    lo = draw(st.integers(0, n))
    hi = draw(st.integers(lo, n))
    return shape, lo, hi


@settings(max_examples=300, deadline=None)
@given(_ranges())
def test_range_boxes_tile_the_range(case):
    shape, lo, hi = case
    boxes = ckpt.range_boxes(shape, lo, hi)
    index = np.arange(math.prod(shape)).reshape(shape)
    got = [index[tuple(slice(a, b) for a, b in box)].reshape(-1)
           for box in boxes]
    flat = np.concatenate(got) if got else np.zeros(0, int)
    np.testing.assert_array_equal(flat, np.arange(lo, hi))
    for part in got:            # each box is one contiguous run
        assert part.size > 0
        np.testing.assert_array_equal(part, np.arange(part[0],
                                                      part[0] + part.size))
    assert len(boxes) <= max(1, 2 * len(shape) - 1)


# ---------------------------------------------------------------------------
# engines of both packages
# ---------------------------------------------------------------------------

def _config(stage, dtype, **extra):
    cfg = {"train_micro_batch_size_per_gpu": ROWS, "steps_per_print": 1000,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 200}}
    if dtype == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    cfg.update(extra)
    return cfg


def _jax_engine(stage, dtype, devices=4, **extra):
    cfg = _config(stage, dtype, **extra)
    cfg["train_micro_batch_size_per_gpu"] = ROWS // devices
    model = jax_create_model("tiny", dtype=getattr(jnp, dtype),
                             max_seq_len=SEQ)
    eng, *_ = deepspeed_tpu.initialize(
        model=model, config=cfg, mesh=build_mesh(devices=jax.devices()[
            :devices]))
    return eng


def _port_engine(stage, dtype, init=None, **extra):
    tdt = getattr(torch, dtype)
    model = create_model("tiny", dtype=tdt, max_seq_len=SEQ)
    if init is not None:
        params = params_from_jax(init, model.config)
        model = Model(init=lambda g: params, config=model.config,
                      name="tiny", loss_fn=model.loss_fn)
    return initialize(model=model, config=_config(stage, dtype, **extra),
                      device="cpu")[0]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 250, (1, ROWS, SEQ))}
            for _ in range(n)]


def _bits(x):
    """Comparable bits of a JAX / numpy / torch array."""
    if isinstance(x, torch.Tensor):
        x = ckpt._to_numpy(x)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _jax_init(eng):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(eng.params))


def _paths(tree):
    return ["/".join(str(k.key) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_state(jeng, peng, exact=True):
    """Params, fp32 master and both moments of a JAX and a port engine."""
    def close(a, b, moment=False):
        # JAX's reductions run in XLA's order: params within atol 1e-4 (as
        # test_torch_training holds trajectories), moments within 1e-3 of
        # the leaf's largest magnitude
        scale = float(np.abs(b).max()) if moment else 1.0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3 * scale
                                   if moment else 1e-4)

    cmp = ((lambda a, b, moment=False: np.testing.assert_array_equal(a, b))
           if exact else close)
    jp = jax.device_get(jeng.params)
    pp = peng.params
    for path in _paths(jp):
        if not exact and path == "layers/attn/bk":
            # the key bias shifts each query's scores by one constant: its
            # grads are 0 in exact arithmetic and rounding noise here
            continue
        keys = path.split("/")
        j, p = jp, pp
        for k in keys:
            j, p = j[k], p[k]
        cmp(_bits(p), _bits(j))
        cmp(tf.safe_get_full_fp32_param(peng, path),
            jax_tf.safe_get_full_fp32_param(jeng, path))
        for name in ("exp_avg", "exp_avg_sq"):
            cmp(tf.safe_get_full_optimizer_state(peng, path, name),
                jax_tf.safe_get_full_optimizer_state(jeng, path, name),
                moment=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, dtype):
    jeng = _jax_engine(3, dtype)
    init = _jax_init(jeng)
    batches = _batches(3)
    for b in batches[:2]:
        jeng.train_batch(batch=jax.tree.map(jnp.asarray, b))
    jeng.save_checkpoint(str(tmp_path), tag="jax2")
    peng = _port_engine(2, dtype, init)
    path, client = peng.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path) and client["_checkpoint_tag"] == "jax2"
    assert peng.global_steps == 2 and peng.opt_state.count == 2
    assert peng.opt_state.inner_count == 2
    _same_state(jeng, peng)
    want = float(jeng.train_batch(batch=jax.tree.map(jnp.asarray,
                                                     batches[2])))
    got = float(peng.train_batch(batch=batches[2]))
    np.testing.assert_allclose(got, want, rtol=1e-4 if dtype == "float32"
                               else 1e-2)


@pytest.mark.parametrize("dtype,stage", [("float32", 3), ("bfloat16", 3),
                                         ("bfloat16", 1)])
def test_port_checkpoint_loads_into_jax(tmp_path, dtype, stage):
    jeng = _jax_engine(2, dtype)
    peng = _port_engine(stage, dtype, _jax_init(jeng))
    batches = _batches(3, seed=1)
    for b in batches[:2]:
        peng.train_batch(batch=b)
    peng.save_checkpoint(str(tmp_path), tag="port2")
    assert jax_ckpt.verify_checkpoint(str(tmp_path), "port2") == []
    meta = json.loads((tmp_path / "port2" / "metadata.json").read_text())
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="ref")
    jmeta = json.loads((tmp_path / "jax" / "ref" / "metadata.json"
                        ).read_text())
    # JAX's key set, shapes and dtype strings
    assert {k: (v["shape"], v["dtype"]) for k, v in meta["arrays"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in jmeta["arrays"].items()}
    assert meta["format"] == 2 and meta["client_state"]["global_steps"] == 2
    jeng.load_checkpoint(str(tmp_path), tag="port2")
    assert jeng.global_steps == 2
    assert int(jeng.opt_state.count) == 2
    _same_state(jeng, peng)
    want = float(peng.train_batch(batch=batches[2]))
    got = float(jeng.train_batch(batch=jax.tree.map(jnp.asarray,
                                                    batches[2])))
    np.testing.assert_allclose(got, want, rtol=1e-4 if dtype == "float32"
                               else 1e-2)


# ---------------------------------------------------------------------------
# resume and client state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("save_stage,load_stage", [(0, 0), (2, 3), (3, 1)])
def test_resume_is_bit_for_bit(tmp_path, save_stage, load_stage):
    extra = dict(scheduler={"type": "WarmupLR",
                            "params": {"warmup_num_steps": 4,
                                       "warmup_max_lr": 1e-3}})
    a = _port_engine(save_stage, "bfloat16", **extra)
    batches = _batches(3, seed=2)
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path))
    assert (tmp_path / "latest").read_text() == "global_step2"
    b = _port_engine(load_stage, "bfloat16", **extra)
    b.load_checkpoint(str(tmp_path))
    assert b.lr_scheduler.state_dict() == a.lr_scheduler.state_dict()
    assert (b.global_steps, b.micro_steps, b.skipped_steps) == (2, 2, 0)
    for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)):
        assert torch.equal(x, y)
    la, lb = (e.train_batch(batch=batches[2]) for e in (a, b))
    assert torch.equal(la, lb)
    for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)):
        assert torch.equal(x, y)
    for buf in ("master", "exp_avg", "exp_avg_sq"):
        assert torch.equal(
            torch.cat([t.reshape(-1) for t in jax.tree.leaves(
                a.zero.full_tree(getattr(a.opt_state, buf)))]),
            torch.cat([t.reshape(-1) for t in jax.tree.leaves(
                b.zero.full_tree(getattr(b.opt_state, buf)))]))


def test_fp16_loss_scale_and_params_only_load(tmp_path):
    extra = dict(fp16={"enabled": True, "initial_scale_power": 32,
                       "hysteresis": 1})
    a = _port_engine(2, "float16", **extra)
    for b in _batches(3, seed=3):
        a.train_batch(batch=b)
    assert a.skipped_steps > 0
    a.save_checkpoint(str(tmp_path), tag="fp16")
    b = _port_engine(3, "float16", **extra)
    b.load_checkpoint(str(tmp_path))
    assert b.cur_scale == a.cur_scale < 2.0 ** 32
    assert b.skipped_steps == a.skipped_steps
    c = _port_engine(2, "float16", **extra)
    c.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert c.opt_state.count == 0 and c.global_steps == 3
    assert float(c.opt_state.exp_avg.abs().sum()) == 0
    assert torch.equal(c.opt_state.master.half(), c.zero.shard)


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def test_staging_left_by_a_crashed_save_is_never_published(tmp_path):
    eng = _port_engine(3, "float32")
    eng.save_checkpoint(str(tmp_path), tag="good")
    crashed = tmp_path / ".next.tmp" / "arrays"
    crashed.mkdir(parents=True)
    (crashed / "junk.s0.npy").write_bytes(b"torn")
    (tmp_path / ".next.tmp" / "metadata.json").write_text("{}")
    assert ckpt.list_tags(str(tmp_path)) == ["good"]
    assert ckpt.read_latest_tag(str(tmp_path)) == "good"
    assert eng.load_checkpoint(str(tmp_path))[1]["_checkpoint_tag"] == "good"
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path), tag="next")
    assert not (tmp_path / ".next.tmp").exists()
    assert "junk.s0.npy" not in os.listdir(tmp_path / "next" / "arrays")
    assert ckpt.verify_checkpoint(str(tmp_path), "next") == []
    assert ckpt.read_latest_tag(str(tmp_path)) == "next"


def _shard_file(tmp_path, tag, key_part):
    meta = json.loads((tmp_path / tag / "metadata.json").read_text())
    key = next(k for k in meta["arrays"] if key_part in k)
    return tmp_path / tag / "arrays" / meta["arrays"][key]["shards"][0][
        "file"]


@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_damaged_shard_fails_verification_and_falls_back(tmp_path, damage):
    eng = _port_engine(2, "bfloat16")
    batches = _batches(2, seed=4)
    eng.train_batch(batch=batches[0])
    eng.save_checkpoint(str(tmp_path), tag="t1")
    eng.train_batch(batch=batches[1])
    eng.save_checkpoint(str(tmp_path), tag="t2")
    f = _shard_file(tmp_path, "t2", "params##embed")
    raw = bytearray(f.read_bytes())
    if damage == "bitflip":
        raw[-3] ^= 0x10
    else:
        raw = raw[:len(raw) // 2]
    f.write_bytes(bytes(raw))
    for verify in (ckpt.verify_checkpoint, jax_ckpt.verify_checkpoint):
        problems = verify(str(tmp_path), "t2")
        assert len(problems) == 1
        assert ("checksum" if damage == "bitflip" else "unreadable") \
            in problems[0]
        assert verify(str(tmp_path), "t1") == []
    fresh = _port_engine(2, "bfloat16")
    _, client = fresh.load_checkpoint(str(tmp_path), verify=True)
    assert client["_checkpoint_tag"] == "t1" and fresh.global_steps == 1
    (tmp_path / "t1" / "metadata.json").write_text("not json")
    with pytest.raises(ckpt.CheckpointCorruption):
        fresh.load_checkpoint(str(tmp_path), verify=True)


def test_async_save_publishes_latest_after_its_writes(tmp_path,
                                                       monkeypatch):
    eng = _port_engine(3, "bfloat16")
    eng.save_checkpoint(str(tmp_path), tag="before")
    gate, started = threading.Event(), threading.Event()
    real_save = ckpt.np.save

    def slow_save(*args, **kw):
        started.set()
        assert gate.wait(30)
        return real_save(*args, **kw)

    monkeypatch.setattr(ckpt.np, "save", slow_save)
    eng.train_batch(batch=_batches(1)[0])
    path = eng.save_checkpoint(str(tmp_path), tag="after", async_save=True)
    assert started.wait(30)
    assert (tmp_path / "latest").read_text() == "before"
    assert not os.path.exists(path)
    # the state was copied at the call: a step now does not reach the files
    saved = [t.clone() for t in jax.tree.leaves(eng.params)]
    eng.train_batch(batch=_batches(2)[1])
    gate.set()
    ckpt.wait_pending()
    assert (tmp_path / "latest").read_text() == "after"
    assert ckpt.verify_checkpoint(str(tmp_path), "after") == []
    fresh = _port_engine(3, "bfloat16")
    fresh.load_checkpoint(str(tmp_path))
    for x, y in zip(saved, jax.tree.leaves(fresh.params)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# exports and accessors against JAX
# ---------------------------------------------------------------------------

def test_consolidate_matches_jax(tmp_path):
    peng = _port_engine(3, "bfloat16")
    peng.train_batch(batch=_batches(1)[0])
    peng.save_checkpoint(str(tmp_path / "port"))
    jeng = _jax_engine(3, "bfloat16")
    jeng.save_checkpoint(str(tmp_path / "jax"))
    for src in ("port", "jax"):
        ours = ckpt.load_flat_weights(ckpt.consolidate_checkpoint(
            str(tmp_path / src), str(tmp_path / f"{src}_ours")))
        theirs = jax_ckpt.load_flat_weights(jax_ckpt.consolidate_checkpoint(
            str(tmp_path / src), str(tmp_path / f"{src}_theirs")))
        assert set(ours) == set(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    master = tf.safe_get_full_fp32_param(peng, "layers/attn/wq")
    np.testing.assert_array_equal(
        ckpt.load_flat_weights(str(tmp_path / "port_ours.npz"))[
            "layers##attn##wq"].numpy(), master)


def test_save_16bit_model_matches_jax(tmp_path):
    peng = _port_engine(3, "bfloat16")
    path = peng.save_16bit_model(str(tmp_path))
    theirs = jax_ckpt.load_flat_weights(path)
    jeng = _jax_engine(3, "bfloat16")
    jpath = jeng.save_16bit_model(str(tmp_path / "jax"))
    ours_of_jax = ckpt.load_flat_weights(jpath)
    params = peng.params
    assert set(theirs) == set(ours_of_jax) == {
        "##".join(p.split("/")) for p in _paths(params)}
    for p in _paths(params):
        key = "##".join(p.split("/"))
        leaf = params
        for k in p.split("/"):
            leaf = leaf[k]
        assert theirs[key].dtype == jnp.bfloat16
        np.testing.assert_array_equal(theirs[key].view(np.uint16),
                                      _bits(leaf))
        assert ours_of_jax[key].dtype == torch.bfloat16
    flat = ckpt.load_flat_weights(path)
    for p in _paths(params):
        leaf = params
        for k in p.split("/"):
            leaf = leaf[k]
        assert torch.equal(flat["##".join(p.split("/"))], leaf)


def test_safe_get_full_matches_jax():
    """Same init, same two steps (JAX on 4 devices, the port at stage 3):
    the fp32 params, params, moments and staged grads agree."""
    jeng = _jax_engine(3, "float32", gradient_accumulation_steps=2)
    peng = _port_engine(3, "float32", _jax_init(jeng),
                        gradient_accumulation_steps=2)
    batches = _batches(3, seed=6)
    for b in batches[:2]:
        b = {"input_ids": np.concatenate([b["input_ids"]] * 2)}
        jeng.train_batch(batch=jax.tree.map(jnp.asarray, b))
        peng.train_batch(batch=b)
    assert tf.safe_get_full_grad(peng, "pos") is None
    for e, mb in ((jeng, jnp.asarray(batches[2]["input_ids"][0])),
                  (peng, batches[2]["input_ids"][0])):
        e.backward(e.forward({"input_ids": mb}))
    _same_state(jeng, peng, exact=False)
    for path in _paths(jax.device_get(jeng.params)):
        if path == "layers/attn/bk":
            continue
        want = jax_tf.safe_get_full_grad(jeng, path)
        np.testing.assert_allclose(tf.safe_get_full_grad(peng, path), want,
                                   rtol=1e-4,
                                   atol=1e-3 * float(np.abs(want).max()))
