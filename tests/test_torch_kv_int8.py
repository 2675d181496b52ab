"""The int8 KV cache of the dense LM held against the JAX package:
``kv_quant`` bit for bit, then a reduced qwen3 in fp32 with
``kv_dtype="int8"`` (prefill and decode logits allclose, the cache's
codes and scales, greedy tokens identical through both ModelEngines).

Tolerances: logits atol 1e-4, as for the f32 cache
(tests/test_torch_models.py): |logit| < ~1 at init scale 0.02, and fp32
matmuls summed in another order drift by a few ulps per layer. A k or v
value that lands within an ulp of a rounding boundary may round to the
neighbouring code in the two frameworks, so cached codes may differ by 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import lm as JLM
from repro.serving.engine import ModelEngine as JEngine
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.models import lm as TLM
from repro_torch.serving.engine import ModelEngine as TEngine

torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(scope="module")
def qwen_int8():
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                    kv_dtype="int8")
    jcfg = j_get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                       kv_dtype="int8")
    jp = JLM.init_params(jax.random.PRNGKey(3), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # amax 0: scale 1
    x[0, 0, 1, :4] = [127.0, 0.5, 1.5, 2.5]        # half-way: to even
    x[0, 0, 1, 4:] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = JLM.kv_quant(jx)
    tq, ts = TLM.kv_quant(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int16),
                                  np.asarray(js).view(np.int16))
    assert list(tq[0, 0, 1, :4]) == [127, 0, 2, 2]
    dq = TLM.kv_dequant(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        dq.numpy(), np.asarray(JLM.kv_dequant(jq, js, jnp.float32)))


def test_int8_cache_layout(qwen_int8):
    cfg = qwen_int8[0]
    c = TLM.init_cache(cfg, 2, 16, device=CPU)
    shape = (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.head_dim)
    assert set(c) == {"k", "v", "k_scale", "v_scale"}
    assert c["k"].shape == shape and c["k"].dtype == torch.int8
    assert c["v_scale"].shape == shape[:-1]
    assert c["v_scale"].dtype == torch.float16


def test_int8_prefill_and_decode_logits_match_jax(qwen_int8):
    cfg, jcfg, jp, tp = qwen_int8
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jc = JLM.init_cache(jcfg, 2, 16)
    jl, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tc = TLM.init_cache(cfg, 2, 16, device=CPU)
    tl, tc = TLM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for key in ("k", "v"):
        diff = np.abs(tc[key].numpy().astype(np.int32)
                      - np.asarray(jc[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99, key
        np.testing.assert_allclose(tc[f"{key}_scale"].float().numpy(),
                                   np.asarray(jc[f"{key}_scale"], np.float32),
                                   rtol=1e-3)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    jd, _ = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                            jnp.int32(10))
    td, _ = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc, 10)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


def test_int8_greedy_tokens_identical_through_engines(qwen_int8):
    cfg, jcfg, jp, tp = qwen_int8
    je = JEngine(jp, jcfg, n_slots=3, max_len=40)
    te = TEngine(tp, cfg, n_slots=3, max_len=40, device=CPU)
    assert set(te.cache) == {"k", "v", "k_scale", "v_scale"}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 11, 4)]
    outs = []
    for eng in (je, te):
        toks = np.zeros(3, np.int64)
        out = [[] for _ in prompts]
        for slot, p in enumerate(prompts[:2]):
            toks[slot] = eng.prefill_into(slot, p)
            out[slot].append(int(toks[slot]))
        for step in range(8):
            if step == 2:                            # third joins late
                toks[2] = eng.prefill_into(2, prompts[2])
                out[2].append(int(toks[2]))
            nxt = eng.decode_active(toks)
            for s in np.flatnonzero(eng.active):
                out[s].append(int(nxt[s]))
            toks = np.asarray(nxt, np.int64)
        outs.append(out)
    assert outs[0] == outs[1]
    assert len(outs[1][2]) == 7
    # the slot copy placed the prompt's scales too
    assert float(te.cache["k_scale"][:, 1, :11].float().min()) > 0
