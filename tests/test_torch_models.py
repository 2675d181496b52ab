"""Port of the models held against the JAX package, with the reference's
parameters carried over by ``repro_torch.weights``: embeddings, prefill
logits and decode logits allclose in fp32, greedy tokens identical for the
reduced qwen3 through both ModelEngines.

Tolerances: embeddings are unit vectors, atol 1e-5; logits of the reduced
LM (|logit| < ~1 at init scale 0.02), atol 1e-4 — fp32 matmuls and
softmaxes summed in another order drift by a few ulps per layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import embedder as JE, lm as JLM
from repro.serving.engine import ModelEngine as JEngine
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.models import embedder as TE, layers as TL, lm as TLM
from repro_torch.serving.engine import ModelEngine as TEngine

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

CPU = "cpu"


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    jcfg = j_get_config("qwen3-14b").reduced().replace(dtype="float32")
    jp = JLM.init_params(jax.random.PRNGKey(2), jcfg)
    tp = weights.convert_lm(_np_tree(jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


def test_configs_carried_over():
    for name in ("qwen3-14b", "siso-embedder"):
        assert get_config(name).__dict__ == j_get_config(name).__dict__
        assert get_config(name).reduced().__dict__ \
            == j_get_config(name).reduced().__dict__
    assert get_config("qwen3-14b").total_params \
        == j_get_config("qwen3-14b").total_params


def test_embedder_matches_jax():
    cfg = get_config("siso-embedder").reduced().replace(dtype="float32")
    jcfg = j_get_config("siso-embedder").reduced().replace(dtype="float32")
    jp = JE.init_params(jax.random.PRNGKey(1), jcfg)
    tp = weights.convert_embedder(_np_tree(jp), device=CPU)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (3, 24)).astype(np.int32)
    toks[0, 10:] = 0                         # padding: pooled out, attended
    mask = toks > 0
    je = np.asarray(JE.encode(jp, jcfg, jnp.asarray(toks), jnp.asarray(mask)))
    te = TE.encode(tp, cfg, torch.from_numpy(toks),
                   torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(te, je, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), 1.0, atol=1e-5)


def test_prefill_and_decode_logits_match_jax(qwen):
    cfg, jcfg, jp, tp = qwen
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jc = JLM.init_cache(jcfg, 2, 16)
    jl, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tc = TLM.init_cache(cfg, 2, 16, device=CPU)
    tl, tc = TLM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    jd, _ = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                            jnp.int32(10))
    td, _ = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc, 10)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    # padded vocab columns are masked in both
    assert cfg.padded_vocab == cfg.vocab_size or \
        td.numpy()[:, cfg.vocab_size:].max() < -1e30


def test_greedy_tokens_identical_through_engines(qwen):
    cfg, jcfg, jp, tp = qwen
    je = JEngine(jp, jcfg, n_slots=3, max_len=48)
    te = TEngine(tp, cfg, n_slots=3, max_len=48, device=CPU)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    outs = []
    for eng in (je, te):
        toks = np.zeros(3, np.int64)
        out = [[] for _ in prompts]
        for slot, p in enumerate(prompts[:2]):        # two slots live
            toks[slot] = eng.prefill_into(slot, p)
            out[slot].append(int(toks[slot]))
        for step in range(8):
            if step == 3:                            # third joins late
                toks[2] = eng.prefill_into(2, prompts[2])
                out[2].append(int(toks[2]))
            nxt = eng.decode_active(toks)
            for s in np.flatnonzero(eng.active):
                out[s].append(int(nxt[s]))
            toks = np.asarray(nxt, np.int64)
            if step == 5:
                eng.release(0)
        outs.append(out)
    assert outs[0] == outs[1]
    assert len(outs[1][2]) == 6


def test_bf16_weights_convert_bit_for_bit():
    cfg = j_get_config("qwen3-14b").reduced()          # bf16 default
    jp = _np_tree(JLM.init_params(jax.random.PRNGKey(0), cfg))
    tp = weights.convert_lm(jp, get_config("qwen3-14b").reduced(),
                            device=CPU)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["blocks"][1]["attn"]["wq"].view(torch.int16).numpy(),
        jp["blocks"]["attn"]["wq"][1].view(np.int16))


def test_attention_masks_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    kvl = np.asarray([9, 5], np.int32)
    from repro.models import layers as JL
    for kw in ({"causal": True, "q_offset": 3},
               {"causal": True, "window": 4, "q_offset": 3},
               {"causal": False, "prefix_len": 2},
               {"causal": True, "q_offset": 3, "kv_valid_len": kvl}):
        jkw = dict(kw)
        tkw = dict(kw)
        if "kv_valid_len" in kw:
            jkw["kv_valid_len"] = jnp.asarray(kvl)
            tkw["kv_valid_len"] = torch.from_numpy(kvl)
        ja = JL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **jkw)
        ta = TL.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **tkw)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    jd = JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                             jnp.asarray(v), kv_len=jnp.asarray(kvl))
    td = TL.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_len=torch.from_numpy(kvl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


DENSE_ATOL = 1e-5


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "command-r-35b"])
def test_dense_config_logits_match_jax(arch):
    """Dense configs beside qwen3: qwen2.5's qkv biases, command-r's tied
    embeddings. Reduced, fp32: prefill and two decode steps' logits within
    1e-5 (|logit| < ~1; a few ulps of drift per layer)."""
    cfg = get_config(arch).reduced().replace(dtype="float32")
    jcfg = j_get_config(arch).reduced().replace(dtype="float32")
    assert cfg.qkv_bias or cfg.tie_embeddings
    jp = JLM.init_params(jax.random.PRNGKey(4), jcfg)
    tp = weights.convert_lm(_np_tree(jp), cfg, device=CPU)
    assert ("lm_head" in tp) != cfg.tie_embeddings
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc = JLM.init_cache(jcfg, 2, 16)
    jl, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tc = TLM.init_cache(cfg, 2, 16, device=CPU)
    tl, tc = TLM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DENSE_ATOL)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for pos in (9, 10):
        jd, jc = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                                 jnp.int32(pos))
        td, tc = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc,
                                 pos)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   atol=DENSE_ATOL, err_msg=f"pos {pos}")
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)


def test_decode_step_hands_attention_an_int32_kv_len(qwen, monkeypatch):
    """Every layer's attention gets kv_len as int32, whatever the caller
    passed (an int pos, an int64 kv_len, the engine's step), so the K3
    wrapper converts nothing per layer; the logits do not change."""
    cfg, _, _, tp = qwen
    seen = []
    real = TL.decode_attention

    def recording(q, k_cache, v_cache, *, kv_len, **kw):
        seen.append(kv_len.dtype)
        return real(q, k_cache, v_cache, kv_len=kv_len, **kw)

    monkeypatch.setattr(TL, "decode_attention", recording)
    toks = torch.tensor([[3], [7]])
    cache = TLM.init_cache(cfg, 2, 16, device=CPU)
    pos = torch.tensor([4, 9])
    by_default, _ = TLM.decode_step(tp, cfg, toks, cache, pos)
    given_int64, _ = TLM.decode_step(tp, cfg, toks, cache, pos,
                                     kv_len=pos + 1)
    torch.testing.assert_close(by_default, given_int64, atol=0, rtol=0)
    eng = TEngine(tp, cfg, n_slots=2, max_len=16, device=CPU)
    eng.prefill_into(0, np.array([5, 6, 7]))
    eng.decode_active(np.array([1, 0]))
    assert len(seen) == 3 * cfg.n_layers
    assert set(seen) == {torch.int32}
