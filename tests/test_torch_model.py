"""PyTorch port vs JAX package: weights conversion, the paged forward, and
the port's import and device rules.

Both packages get the same weights (the JAX init perturbed with seeded numpy
noise, so norms and biases are not trivially 1/0) and the same inputs. The
paged forward runs one prefill chunk (two chunks for a row, ragged valid
lengths, out-of-order block tables) plus 4 decode steps with an inactive
row, over an arena whose never-written slots hold NaN. fp32 logits must
agree at ``atol=1e-4`` (the two frameworks sum matmuls in different orders;
observed differences are ~1e-6).
"""

import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.models.transformer import forward as jax_forward
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.models import (params_from_jax, params_to_numpy,
                                        transformer_config)
from deepspeed_tpu_torch.models.transformer import forward

BS, NB, MAXB = 8, 16, 6
PRESETS = ["tiny-llama", "tiny", "tiny-bloom", "tiny-gptj", "tiny-opt"]


def perturbed_params(preset, seed=0):
    """JAX init of ``preset`` (fp32) plus seeded numpy noise on every leaf;
    returns (jax config, numpy tree)."""
    model = jax_create_model(preset, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32),
        model.init(jax.random.PRNGKey(seed)))
    return model.config, tree


def nan_arena_np(cfg):
    """(L, NB, BS, K, D) arena: scratch block 0 zero, every other block
    NaN until written."""
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    a = np.full(shape, np.nan, np.float32)
    a[:, 0] = 0.0
    return a


def paged_schedule():
    """(ids, positions, write_mask, block_table, chunk?) for a prefill of
    two rows in two chunks, then 4 decode steps with an inactive third row.
    Positions of chunk pads are -1 (the serving programs' convention)."""
    rng = np.random.default_rng(7)
    tables = np.zeros((3, MAXB), np.int32)
    tables[0, :4] = [5, 1, 12, 7]
    tables[1, :5] = [3, 14, 2, 9, 11]
    C = 16
    calls = []
    lengths = np.zeros(2, np.int64)
    for n_valid in ([16, 11], [7, 16]):
        ids = rng.integers(0, 256, (2, C))
        offs = np.arange(C)
        mask = offs[None] < np.asarray(n_valid)[:, None]
        pos = np.where(mask, lengths[:, None] + offs[None], -1)
        calls.append((ids, pos, mask, tables[:2], True))
        lengths += n_valid
    for _ in range(4):
        ids = rng.integers(0, 256, (3, 1))
        pos = np.concatenate([lengths, [0]])[:, None]   # row 2 inactive
        calls.append((ids, pos, None, tables, False))
        lengths += 1
    return calls


def run_jax(cfg, tree, calls, paged_impl):
    params = jax.tree.map(jnp.asarray, tree)
    arena = nan_arena_np(cfg)
    cache = {"k": jnp.asarray(arena), "v": jnp.asarray(arena)}
    fns = {chunk: jax.jit(partial(jax_forward, cfg=cfg,
                                  paged_impl=paged_impl, paged_chunk=chunk))
           for chunk in (False, True)}
    outs = []
    for ids, pos, mask, bt, chunk in calls:
        logits, cache, _ = fns[chunk](
            params, jnp.asarray(ids), cache=cache,
            positions=jnp.asarray(pos, jnp.int32),
            block_table=jnp.asarray(bt),
            paged_write_mask=None if mask is None else jnp.asarray(mask))
        outs.append(np.asarray(logits))
    return outs


def run_torch(preset, tree, calls, paged_impl, plain=False):
    cfg = transformer_config(preset, dtype=torch.float32)
    params = params_from_jax(tree, cfg, "cpu")
    arena = nan_arena_np(cfg)
    cache = {"k": torch.from_numpy(arena.copy()),
             "v": torch.from_numpy(arena.copy())}
    outs = []
    for ids, pos, mask, bt, chunk in calls:
        logits, _ = forward(
            params, torch.from_numpy(ids), cfg, cache,
            positions=torch.from_numpy(pos),
            block_table=torch.from_numpy(bt),
            paged_write_mask=None if mask is None else torch.from_numpy(mask),
            paged_impl=paged_impl, paged_chunk=chunk, plain=plain)
        outs.append(logits.numpy())
    return outs


def live(call):
    """Boolean (B, S) mask of the logits that a serving program reads."""
    _, pos, mask, _, chunk = call
    if chunk:
        return mask
    live_rows = np.zeros(pos.shape, bool)
    live_rows[:2] = True
    return live_rows


@pytest.fixture(scope="module", params=PRESETS)
def preset_case(request):
    cfg, tree = perturbed_params(request.param)
    calls = paged_schedule()
    return request.param, cfg, tree, calls, run_jax(cfg, tree, calls, "auto")


class TestParamsConversion:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_round_trip_exact(self, preset):
        _, tree = perturbed_params(preset, seed=1)
        cfg = transformer_config(preset, dtype=torch.float32)
        back = params_to_numpy(params_from_jax(tree, cfg, "cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, a in flat_a:
            b = flat_b[path]
            assert b.dtype == a.dtype and b.shape == a.shape, path
            np.testing.assert_array_equal(a, b)

    def test_bf16_round_trip_exact(self):
        _, tree = perturbed_params("tiny-llama", seed=2)
        cfg = transformer_config("tiny-llama", dtype=torch.bfloat16)
        bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          tree)
        back = params_to_numpy(params_from_jax(bf, cfg, "cpu"))
        for a, b in zip(jax.tree.leaves(bf), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a.astype(np.float32), b)

    def test_init_shapes_match_jax(self):
        """The port's random init has the JAX init's tree and shapes."""
        cfg = transformer_config("tiny-llama", dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        from deepspeed_tpu_torch.models.transformer import init_params

        ours = params_to_numpy(init_params(gen, cfg))
        _, tree = perturbed_params("tiny-llama")
        assert (jax.tree.map(np.shape, ours)
                == jax.tree.map(np.shape, tree))


class TestPagedForwardParity:
    def test_kernel_path_matches_jax(self, preset_case):
        preset, cfg, tree, calls, ref = preset_case
        got = run_torch(preset, tree, calls, "auto")
        for call, a, b in zip(calls, got, ref):
            m = live(call)
            assert np.isfinite(a[m]).all()
            np.testing.assert_allclose(a[m], b[m], atol=1e-4, rtol=1e-4)

    def test_gather_path_matches_jax(self, preset_case):
        preset, cfg, tree, calls, _ = preset_case
        ref = run_jax(cfg, tree, calls, "gather")
        got = run_torch(preset, tree, calls, "gather")
        for call, a, b in zip(calls, got, ref):
            m = live(call)
            np.testing.assert_allclose(a[m], b[m], atol=1e-4, rtol=1e-4)

    def test_plain_flag_is_the_cpu_path(self, preset_case):
        """On the CPU the wrappers run their plain versions, so forcing
        them changes nothing (on the card this is the kernels' reference)."""
        preset, _, tree, calls, _ = preset_case
        a = run_torch(preset, tree, calls, "auto")
        b = run_torch(preset, tree, calls, "auto", plain=True)
        for call, x, y in zip(calls, a, b):
            m = live(call)
            np.testing.assert_array_equal(x[m], y[m])


class TestPortRules:
    def test_import_pulls_in_no_jax(self):
        code = ("import sys; import deepspeed_tpu_torch; "
                "import deepspeed_tpu_torch.serving, "
                "deepspeed_tpu_torch.models.convert, "
                "deepspeed_tpu_torch.inference, "
                "deepspeed_tpu_torch.ops.flash_attention, "
                "deepspeed_tpu_torch.ops.decode_attention, "
                "deepspeed_tpu_torch.ops.fused_adam, "
                "deepspeed_tpu_torch.ops.quant_matmul, "
                "deepspeed_tpu_torch.ops.spatial, "
                "deepspeed_tpu_torch.ops.quantization, "
                "deepspeed_tpu_torch.models.spatial, "
                "deepspeed_tpu_torch.runtime, "
                "deepspeed_tpu_torch.config, "
                "deepspeed_tpu_torch.comm, "
                "deepspeed_tpu_torch.parallel, "
                "deepspeed_tpu_torch.runtime.checkpoint, "
                "deepspeed_tpu_torch.runtime.offload, "
                "deepspeed_tpu_torch.runtime.swap, "
                "deepspeed_tpu_torch.comm.compressed, "
                "deepspeed_tpu_torch.comm.benchmark, "
                "deepspeed_tpu_torch.ops.aio, "
                "deepspeed_tpu_torch.utils.tensor_fragment, "
                "deepspeed_tpu_torch.models.simple; "
                "import chip_smoke; "
                "bad = [m for m in sys.modules if m == 'jax' "
                "or m.startswith('jax.') or m == 'deepspeed_tpu' "
                "or m.startswith('deepspeed_tpu.')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        # from the checkout's root, where chip_smoke.py lives
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120,
                             cwd=Path(__file__).resolve().parents[1])
        assert res.returncode == 0, res.stdout + res.stderr

    def test_entry_points_need_cuda_unless_cpu(self, monkeypatch):
        from deepspeed_tpu_torch.serving import init_serving

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_inference("tiny", dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_serving("tiny", dtype=torch.float32)
        eng = init_inference("tiny", dtype=torch.float32, device="cpu")
        assert eng.device.type == "cpu"
        assert all(p.device.type == "cpu"
                   for p in jax.tree.leaves(eng.params))

    @pytest.mark.parametrize("section,what", [
        ({"parallel": {"tensor_parallel_size": 2}}, "tensor_parallel_size"),
        ({"parallel": {"pipeline_parallel_size": 2}},
         "pipeline_parallel_size"),
        ({"parallel": {"sequence_parallel_size": 2}},
         "sequence_parallel_size"),
        ({"parallel": {"expert_parallel_size": 2},
          "zero_optimization": {"stage": 3}},
         "expert_parallel_size=2 at ZeRO stage 3"),
        ({"zero_optimization": {"stage": 2, "offload_optimizer": {
            "device": "cpu"}}, "optimizer": {"type": "lamb"}},
         "offload_optimizer"),
        ({"zero_optimization": {"stage": 3, "offload_param": {
            "device": "nvme"}}, "parallel": {"pipeline_parallel_size": 2}},
         "offload_param"),
        ({"optimizer": {"type": "onebitadam"},
          "zero_optimization": {"stage": 2}}, "onebitadam"),
        ({"optimizer": {"type": "onebitlamb"},
          "zero_optimization": {"stage": 3}}, "onebitlamb"),
        ({"optimizer": {"type": "zerooneadam"}, "fp16": {"enabled": True}},
         "zerooneadam"),
        ({"zero_optimization": {"offload_optimizer": {"device": "nvme"}},
          "fp16": {"enabled": True}}, "'nvme' with fp16"),
    ])
    def test_check_ported_still_refuses(self, section, what):
        """Data parallelism, expert parallelism at stages 0-2, optimizer
        and parameter offload, the 1-bit optimizers at stages 0-1 and LAMB
        at any world are ported; the other degrees, expert parallelism at
        stage 3, parameter offload beside pipeline parallelism and
        the combinations the port does not run still raise, naming
        themselves."""
        from deepspeed_tpu_torch.config import load_config

        cfg = dict({"train_micro_batch_size_per_gpu": 1}, **section)
        with pytest.raises(NotImplementedError, match=what):
            load_config(cfg).check_ported()
        for ok in ({"parallel": {"data_parallel_size": 4}},
                   {"parallel": {"expert_parallel_size": 2}},
                   {"optimizer": {"type": "lamb"},
                    "parallel": {"data_parallel_size": 4}},
                   {"optimizer": {"type": "onebitlamb"},
                    "zero_optimization": {"stage": 1}},
                   {"zero_optimization": {"offload_optimizer": {
                       "device": "nvme"}}, "aio": {"queue_depth": 4}},
                   {"zero_optimization": {"stage": 3, "offload_param": {
                       "device": "nvme"}}}):
            load_config(dict({"train_micro_batch_size_per_gpu": 1},
                             **ok)).check_ported()

    def test_lamb_at_world_above_one_raises(self, monkeypatch):
        """LAMB at a world of 2 and under stage 3 is accepted (its segments
        are the shard's parts of leaves, each with its leaf id); LAMB with
        optimizer offload still raises."""
        from deepspeed_tpu_torch import comm, initialize
        from deepspeed_tpu_torch.models import create_model

        cfg = {"train_micro_batch_size_per_gpu": 1,
               "optimizer": {"type": "lamb"}}
        model = create_model("tiny", dtype=torch.float32)
        monkeypatch.setattr(comm, "get_world_size", lambda group=None: 2)
        eng = initialize(model=model, config=cfg, device="cpu")[0]
        assert eng.world == 2 and eng.opt_state.segments.leaf is None
        monkeypatch.undo()
        eng = initialize(model=model, config=dict(
            cfg, zero_optimization={
                "stage": 3, "stage3_param_persistence_threshold": 0}),
            device="cpu")[0]
        seg = eng.opt_state.segments
        assert seg.leaf is not None
        assert seg.n_leaves == len(list(eng.partition.leaf_pieces()))
        with pytest.raises(NotImplementedError, match="offload_optimizer"):
            initialize(model=model, config=dict(
                cfg, zero_optimization={"offload_optimizer": {
                    "device": "cpu"}}), device="cpu")

    def test_out_of_scope_raises(self):
        with pytest.raises(NotImplementedError):
            init_inference("moe-tiny", dtype=torch.float32, device="cpu",
                           expert_parallel=2)
        with pytest.raises(NotImplementedError):
            init_inference("tiny-bert", dtype=torch.float32, device="cpu")
        # quantized inference is in scope: the mode computes in bf16
        eng = init_inference("tiny", dtype="int8", device="cpu")
        assert eng.config.dtype == torch.bfloat16
        assert eng.config.quantize_bits == 8
        assert "q8" in eng.params["layers"]["attn"]["wq"]
