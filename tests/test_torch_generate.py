"""Offline generation: the port's ``InferenceEngine`` against the JAX one.

On five tiny presets (``tiny``: GPT-2, learned positions, LayerNorm with
bias; ``tiny-llama``: GQA 4/2, RoPE, SwiGLU, RMSNorm; ``tiny-bloom``:
alibi, embed_norm; ``tiny-gptj``: partial rotary, parallel residual,
untied head with bias; ``tiny-opt``: ReLU) both packages get the same
weights (the JAX init plus seeded numpy noise) and the same prompts:

* the cache-less ``forward`` logits agree at 1e-4;
* a dense-cache prefill plus teacher-forced decode steps (ragged rows,
  per-row positions, alibi key positions, arena slots outside ``valid``
  holding large finite values) agree at 1e-4;
* greedy ``generate`` gives the JAX engine's tokens exactly: uniform and
  ragged masks, a prompt crossing the 64-token bucket, and EOS;
* greedy ``generate`` equals the port's own ``ServingEngine`` streams.

Then the cases of ``tests/unit/test_inference.py`` on the port alone:
positions not shifted by the bucket, ragged equals solo, the arena
allocated once and reused, EOS sticky, seeded sampling reproducible,
``return_ttft``, top_p restricting the support and top_p = 0 being greedy.
fp32 throughout; 1e-4 covers the two frameworks' different summation
orders over a few layers (observed differences are ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kv_cache as jax_kv_cache
from deepspeed_tpu.inference.engine import InferenceConfig as JaxInfConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInfEngine
from deepspeed_tpu.models.presets import create_model as jax_create_model
from deepspeed_tpu.models.transformer import forward as jax_forward
from deepspeed_tpu_torch.inference import (InferenceConfig, init_cache,
                                           init_inference, kv_cache)
from deepspeed_tpu_torch.inference.engine import _bucket, _sample
from deepspeed_tpu_torch.models import params_from_jax, transformer_config
from deepspeed_tpu_torch.models.transformer import forward
from deepspeed_tpu_torch.serving import ServingConfig, ServingEngine

PRESETS = ["tiny", "tiny-llama", "tiny-bloom", "tiny-gptj", "tiny-opt"]
T_MAX = 256
ATOL = 1e-4
STALE = 1e3      # arena slots outside `valid`: large and finite


def weights(preset, seed=0):
    """(jax model, numpy weights) with max_seq_len = T_MAX, as the port's
    ``init_inference(max_out_tokens=T_MAX)`` sizes the model."""
    model = jax_create_model(preset, dtype=jnp.float32, max_seq_len=T_MAX)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)
                   ).astype(np.float32),
        model.init(jax.random.PRNGKey(seed)))
    return model, tree


def port_engine(preset, tree):
    tcfg = transformer_config(preset, dtype=torch.float32,
                              max_seq_len=T_MAX)
    return init_inference(preset, dtype=torch.float32, max_out_tokens=T_MAX,
                          params=params_from_jax(tree, tcfg), device="cpu")


def jax_engine(model, tree):
    return JaxInfEngine(model, JaxInfConfig(dtype=jnp.float32,
                                            max_out_tokens=T_MAX,
                                            compile_cache=False),
                        params=tree)


def ragged_batch(seed=3, S=10, lens=(10, 6, 8)):
    """Right-padded prompts (pads are token 0) and their (B, S) mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 250, (len(lens), S)).astype(np.int64)
    mask = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.fixture(scope="module", params=PRESETS)
def engines(request):
    model, tree = weights(request.param)
    return dict(preset=request.param, model=model, tree=tree,
                port=port_engine(request.param, tree),
                jax=jax_engine(model, tree))


def np_tokens(out):
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


class TestForwardParity:
    def test_cacheless_forward_matches_jax(self, engines):
        ids, mask = ragged_batch(S=21, lens=(21, 9, 15))
        want = np.asarray(engines["jax"].forward(ids, attention_mask=mask))
        got = engines["port"].forward(ids, attention_mask=mask).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
        want = np.asarray(engines["jax"].forward(ids))
        got = engines["port"](ids).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)

    def test_dense_prefill_and_decode_match_jax(self, engines):
        """Prefill of a ragged bucketed batch from position 0, then 4
        teacher-forced decode steps at the true per-row positions, exactly
        as ``generate`` drives the model."""
        cfg_j = engines["model"].config
        cfg_p = engines["port"].model.config
        params_j = jax.tree.map(jnp.asarray, engines["tree"])
        params_p = engines["port"].params
        ids, mask = ragged_batch(S=13, lens=(13, 5, 9))
        B, S = ids.shape
        S_pad, T = 64, 96
        ids_pad = np.zeros((B, S_pad), np.int64)
        ids_pad[:, :S] = ids
        valid = np.zeros((B, T), np.int32)
        valid[:, :S] = mask
        lens = mask.sum(-1)
        stale = np.full((cfg_p.num_layers, B, T, cfg_p.num_kv_heads,
                         cfg_p.head_dim), STALE, np.float32)
        cj = dict(jax_kv_cache.init_cache(cfg_j, B, T, jnp.float32),
                  k=jnp.asarray(stale), v=jnp.asarray(-stale))
        cp = init_cache(cfg_p, B, T, torch.float32, "cpu")
        cp["k"][:], cp["v"][:] = torch.from_numpy(stale), -torch.from_numpy(
            stale)
        lj, cj, _ = jax_forward(params_j, jnp.asarray(ids_pad), cfg_j,
                                attention_mask=jnp.asarray(valid), cache=cj,
                                start_pos=0)
        lp, _ = forward(params_p, torch.from_numpy(ids_pad), cfg_p, cache=cp,
                        attention_mask=torch.from_numpy(valid), start_pos=0)
        live = np.arange(S_pad)[None] < lens[:, None]
        np.testing.assert_allclose(lp.numpy()[live], np.asarray(lj)[live],
                                   atol=ATOL, rtol=ATOL)
        kpos = None
        if cfg_p.position == "alibi":
            col = np.arange(T, dtype=np.float32)[None]
            kpos = col - (S - lens[:, None]) * (col >= S)
            kpos = kpos.astype(np.float32)
        cj = {**cj, "index": jnp.full_like(cj["index"], S)}
        rng = np.random.default_rng(5)
        for t in range(4):
            idx = S + t
            valid[:, idx] = 1
            tok = rng.integers(0, 250, (B, 1))
            pos = (lens + t)[:, None]
            lj, cj, _ = jax_forward(
                params_j, jnp.asarray(tok), cfg_j,
                attention_mask=jnp.asarray(valid), cache=cj, start_pos=idx,
                positions=jnp.asarray(pos),
                key_positions=None if kpos is None else jnp.asarray(kpos))
            lp, _ = forward(
                params_p, torch.from_numpy(tok), cfg_p, cache=cp,
                attention_mask=torch.from_numpy(valid), start_pos=idx,
                positions=torch.from_numpy(pos),
                key_positions=None if kpos is None else torch.from_numpy(
                    kpos))
            assert np.isfinite(lp.numpy()).all()
            np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=ATOL,
                                       rtol=ATOL)

    def test_general_start_matches_jax(self, engines):
        """A multi-token forward at a later cursor takes the plain attention
        with an explicit (B, S, T) mask in both packages."""
        cfg_j, cfg_p = engines["model"].config, engines["port"].model.config
        params_j = jax.tree.map(jnp.asarray, engines["tree"])
        B, T = 2, 32
        ids = np.random.default_rng(8).integers(0, 250, (B, 12))
        valid = np.ones((B, T), np.int32)
        cj = jax_kv_cache.init_cache(cfg_j, B, T, jnp.float32)
        cp = init_cache(cfg_p, B, T, torch.float32, "cpu")
        for lo, hi in ((0, 7), (7, 12)):
            lj, cj, _ = jax_forward(params_j, jnp.asarray(ids[:, lo:hi]),
                                    cfg_j, attention_mask=jnp.asarray(valid),
                                    cache=cj, start_pos=lo)
            lp, _ = forward(engines["port"].params,
                            torch.from_numpy(ids[:, lo:hi]), cfg_p, cache=cp,
                            attention_mask=torch.from_numpy(valid),
                            start_pos=lo)
            np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=ATOL,
                                       rtol=ATOL)


class TestGenerateParity:
    def test_greedy_uniform_matches_jax(self, engines):
        prompt = np.random.default_rng(1).integers(0, 250, (2, 12))
        want = np_tokens(engines["jax"].generate(prompt, max_new_tokens=6))
        got = np_tokens(engines["port"].generate(prompt, max_new_tokens=6))
        np.testing.assert_array_equal(got, want)

    def test_greedy_ragged_matches_jax(self, engines):
        ids, mask = ragged_batch()
        want = np_tokens(engines["jax"].generate(ids, attention_mask=mask,
                                                 max_new_tokens=6))
        got = np_tokens(engines["port"].generate(ids, attention_mask=mask,
                                                 max_new_tokens=6))
        np.testing.assert_array_equal(got, want)

    def test_prompt_crossing_the_bucket_matches_jax(self, engines):
        ids, mask = ragged_batch(seed=4, S=70, lens=(70, 66))
        assert _bucket(70) == 128
        want = np_tokens(engines["jax"].generate(ids, attention_mask=mask,
                                                 max_new_tokens=5))
        got = np_tokens(engines["port"].generate(ids, attention_mask=mask,
                                                 max_new_tokens=5))
        np.testing.assert_array_equal(got, want)

    def test_eos_matches_jax(self, engines):
        ids, mask = ragged_batch(seed=6)
        probe = np_tokens(engines["port"].generate(ids, attention_mask=mask,
                                                   max_new_tokens=8))
        eos = int(probe[0, 2])
        want = np_tokens(engines["jax"].generate(
            ids, attention_mask=mask, max_new_tokens=8, eos_token_id=eos))
        got = np_tokens(engines["port"].generate(
            ids, attention_mask=mask, max_new_tokens=8, eos_token_id=eos))
        np.testing.assert_array_equal(got, want)
        assert (got[0, 2:] == eos).all()

    def test_greedy_equals_the_port_serving_streams(self, engines):
        ids, mask = ragged_batch(seed=7, S=30, lens=(30, 11, 23, 17))
        eng = engines["port"]
        got = np_tokens(eng.generate(ids, attention_mask=mask,
                                     max_new_tokens=7))
        srv = ServingEngine(eng, ServingConfig(block_size=8, max_seqs=4,
                                               max_model_len=64,
                                               prefill_chunk=16))
        hs = [srv.submit(ids[b, :mask[b].sum()], max_new_tokens=7)
              for b in range(len(ids))]
        srv.run()
        srv.close()
        for b, h in enumerate(hs):
            assert h.result().tolist() == got[b].tolist(), b


# ---------------------------------------------------------------------------
# the port's engine alone (the cases of tests/unit/test_inference.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    return init_inference("tiny", dtype=torch.float32, max_out_tokens=128,
                          device="cpu")


class TestGenerateSemantics:
    def test_positions_not_bucket_shifted(self):
        """Decoded tokens take positions from the TRUE prompt length, not
        the bucket; amplified position embeddings make any offset flip the
        argmax."""
        eng = init_inference("tiny", dtype=torch.float32, max_out_tokens=128,
                             device="cpu")
        eng.params["pos"] = eng.params["pos"] * 50.0
        prompt = np.random.RandomState(7).randint(0, 250, (1, 12))
        got = np_tokens(eng.generate(prompt, max_new_tokens=5))
        ids = torch.from_numpy(prompt)
        want = []
        for _ in range(5):
            nxt = int(eng.forward(ids)[0, -1].argmax())
            want.append(nxt)
            ids = torch.cat([ids, torch.tensor([[nxt]])], dim=1)
        np.testing.assert_array_equal(got[0], want)

    @pytest.mark.parametrize("preset", ["tiny", "tiny-llama", "tiny-bloom"])
    def test_ragged_matches_solo_prompt(self, preset):
        eng = init_inference(preset, dtype=torch.float32, max_out_tokens=128,
                             device="cpu")
        full = np.random.RandomState(3).randint(0, 250, (2, 10))
        mask = np.ones((2, 10), np.int32)
        mask[1, 6:] = 0
        full[1, 6:] = 0
        got = np_tokens(eng.generate(full, attention_mask=mask,
                                     max_new_tokens=4))
        solo = np_tokens(eng.generate(full[1:2, :6], max_new_tokens=4))
        np.testing.assert_array_equal(got[1:2], solo)

    def test_arena_allocated_once_and_reused(self, tiny, monkeypatch):
        calls = []
        orig = kv_cache.init_cache

        def counting(*a, **kw):
            calls.append(a)
            return orig(*a, **kw)

        monkeypatch.setattr(kv_cache, "init_cache", counting)
        tiny._arena.clear()
        prompt = np.arange(8)[None]
        outs = [np_tokens(tiny.generate(prompt, max_new_tokens=4))
                for _ in range(3)]
        assert len(calls) == 1, f"arena allocated {len(calls)} times"
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[1], outs[2])
        assert 1 in tiny._arena
        arena = tiny._arena[1]["k"]
        tiny.generate(prompt, max_new_tokens=2)
        assert tiny._arena[1]["k"] is arena
        tiny.generate(np.arange(16).reshape(2, 8), max_new_tokens=2)
        assert list(tiny._arena) == [2]       # one workspace at a time

    def test_eos_is_sticky(self, tiny):
        prompt = np.arange(8)[None]
        eos = int(np_tokens(tiny.generate(prompt, max_new_tokens=12))[0, 0])
        toks = np_tokens(tiny.generate(prompt, max_new_tokens=12,
                                       eos_token_id=eos))
        hit = np.where(toks[0] == eos)[0]
        assert hit.size > 0
        assert (toks[0, hit[0]:] == eos).all()

    def test_temperature_reproducible(self, tiny):
        prompt = np.arange(8)[None]
        a = np_tokens(tiny.generate(prompt, max_new_tokens=6,
                                    temperature=0.8, top_k=20, seed=3))
        b = np_tokens(tiny.generate(prompt, max_new_tokens=6,
                                    temperature=0.8, top_k=20, seed=3))
        np.testing.assert_array_equal(a, b)
        assert a.shape == (1, 6)
        c = np_tokens(tiny.generate(prompt, max_new_tokens=6,
                                    temperature=0.8, top_p=0.9, seed=1))
        assert c.shape == (1, 6) and ((c >= 0) & (c < 256)).all()

    def test_ttft_reported(self, tiny):
        out, ttft = tiny.generate(np.arange(8)[None], max_new_tokens=2,
                                  return_ttft=True)
        assert ttft > 0.0 and tuple(out.shape) == (1, 2)

    def test_budget_overflow_raises(self, tiny):
        with pytest.raises(ValueError, match="max_out_tokens"):
            tiny.generate(np.zeros((1, 70), np.int64), max_new_tokens=1)

    def test_top_p_restricts_support(self):
        def picks(logits, temperature, top_p, n):
            out = set()
            for i in range(n):
                g = torch.Generator().manual_seed(i)
                out.add(int(_sample(torch.tensor([logits]), g, temperature,
                                    0, top_p)[0]))
            return out

        assert picks([5.0, 2.0, 1.0, 0.0], 1.0, 0.5, 20) == {0}
        assert picks([2.0, 1.9, 1.8, -5.0], 1.0, 0.95, 200) == {0, 1, 2}
        assert len(picks([2.0, 1.9, 1.8, -5.0], 5.0, 1.0, 50)) > 1

    def test_top_p_zero_is_greedy(self):
        for i in range(20):
            g = torch.Generator().manual_seed(i)
            assert int(_sample(torch.tensor([[5.0, 2.0, 1.0, 0.0]]), g, 5.0,
                               0, 0.0)[0]) == 0

    def test_greedy_takes_the_first_index_on_ties(self):
        assert int(_sample(torch.tensor([[1.0, 3.0, 3.0, 0.0]]), None, 0.0,
                           0)[0]) == 1

    def test_config_rejects(self):
        with pytest.raises(ValueError):
            InferenceConfig(prompt_bucket=0)
        with pytest.raises(ValueError):
            InferenceConfig(dtype="int3")
        # a quantized mode is accepted and computes in bf16
        cfg = InferenceConfig(dtype="int8")
        assert cfg.dtype == torch.bfloat16 and cfg.quantize_bits == 8
