"""The MoE + sliding-window kind (mixtral-8x7b) and the VLM prefix-LM
(paligemma-3b) of the port's LM held against the JAX package, the
reference's parameters carried over by ``repro_torch.weights``: prefill and
decode logits, the ring-placed KV cache, bf16 weight conversion, and greedy
tokens through both packages' ModelEngines with MoE drops possible.

Tolerances: logits atol 1e-4 (|logit| < ~1 at init scale 0.02; fp32
matmuls and softmaxes summed in another order drift by a few ulps per
layer); cached f32 k/v atol 1e-5 (one projection and a rotation from the
same inputs); cached int8 codes within 1 (a value within an ulp of a
rounding boundary may round to the neighbouring code), and for the same
reason their f16 scales within one f16 ulp (rtol 2^-10).
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
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
SCALE_RTOL = 2.0 ** -10


def _models(arch: str, seed: int, **kw):
    cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
    jcfg = j_get_config(arch).reduced().replace(dtype="float32", **kw)
    jp = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


def _batches(cfg, B: int, L: int, seed: int):
    """The same prompt (and the VLM's patch embeddings) for both."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        pe = rng.normal(size=(B, cfg.prefix_len, cfg.d_model)).astype(
            np.float32)
        jb["patch_embed"], tb["patch_embed"] = jnp.asarray(pe), \
            torch.from_numpy(pe)
    return jb, tb


def _run_both(cfg, jcfg, jp, tp, B: int, L: int, steps: int, max_len: int):
    """Prefill then ``steps`` greedy decode steps through both packages;
    every step's logits compared. Returns both final caches."""
    jb, tb = _batches(cfg, B, L, seed=1)
    jc = JLM.init_cache(jcfg, B, max_len)
    tc = TLM.init_cache(cfg, B, max_len, device=CPU)
    jl, jc = JLM.prefill(jp, jcfg, jb, jc)
    tl, tc = TLM.prefill(tp, cfg, tb, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    caches = [(jax.tree.map(np.asarray, jc),
               {k: v.clone() for k, v in tc.items()})]
    pos = L + (cfg.prefix_len if cfg.family == "vlm" else 0)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(steps):
        jd, jc = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                                 jnp.int32(pos + step))
        td, tc = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc,
                                 pos + step)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)
    caches.append((jax.tree.map(np.asarray, jc), tc))
    return caches


def _assert_cache(jc: dict, tc: dict) -> None:
    assert set(jc) == set(tc)
    for key, t in tc.items():
        t, j = t.float().numpy(), np.asarray(jc[key]).astype(np.float32)
        if key in ("k", "v") and tc[key].dtype == torch.int8:
            assert np.abs(t - j).max() <= 1, key
        elif key.endswith("_scale"):
            np.testing.assert_allclose(t, j, rtol=SCALE_RTOL, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(t, j, atol=KV_ATOL, err_msg=key)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_mixtral_prefill_and_decode_past_the_window(kv_dtype):
    """A 48-token prompt over window 32: the ring wraps in prefill (the
    trailing 32 positions, token t at slot t % 32) and decode writes 4 more
    slots of it; logits at every step and the cache after prefill and after
    decode equal the reference's."""
    cfg, jcfg, jp, tp = _models("mixtral-8x7b", 0, kv_dtype=kv_dtype)
    assert cfg.window == 32 and cfg.n_experts == 4
    caches = _run_both(cfg, jcfg, jp, tp, B=2, L=48, steps=4, max_len=64)
    assert caches[0][1]["k"].shape[2] == cfg.window
    for jc, tc in caches:
        _assert_cache(jc, tc)


def test_paligemma_prefill_with_patches_and_decode():
    """Patch embeddings before the text, attended bidirectionally
    (prefix_len), sqrt(d)-scaled text embeddings, the gated gelu MLP, MQA,
    tied unembedding."""
    cfg, jcfg, jp, tp = _models("paligemma-3b", 1)
    assert cfg.family == "vlm" and cfg.n_kv_heads == 1
    assert "w_gate" in tp["blocks"][0]["mlp"] and "lm_head" not in tp
    caches = _run_both(cfg, jcfg, jp, tp, B=2, L=12, steps=2, max_len=32)
    _assert_cache(*caches[-1])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "paligemma-3b"])
def test_bf16_weights_convert_bit_for_bit(arch):
    jcfg = j_get_config(arch).reduced()                 # bf16 default
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = weights.convert_lm(jp, get_config(arch).reduced(), device=CPU)
    pairs = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":     # stacked (n, ...) -> one per layer
            pairs += [(_at(tp["blocks"][i], keys[1:]), leaf[i], keys)
                      for i in range(jcfg.n_layers)]
        else:
            pairs.append((_at(tp, keys), leaf, keys))
    assert len(pairs) == len(jax.tree.leaves(tp))
    for t, a, keys in pairs:
        assert t.dtype == torch.bfloat16 and t.shape == a.shape, keys
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=str(keys))


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _biased(jp: dict, d: int, scale: float = 0.005, bias: float = 8.0):
    """Every embedding row shifted along one direction, and every layer's
    router column 0 along it: each token's hidden state leans the same way
    and expert 0 draws most of the assignments."""
    u = np.random.default_rng(5).choice([-1.0, 1.0], d).astype(np.float32)
    jp = jax.tree.map(np.array, jp)
    jp["embed"] += scale * u
    jp["blocks"]["mlp"]["router"][:, :, 0] += bias * u / np.sqrt(d)
    return jp


def _engine_tokens(eng, prompts, steps: int) -> list:
    toks = np.zeros(len(prompts), np.int64)
    out = [[] for _ in prompts]
    for slot, p in enumerate(prompts):
        toks[slot] = eng.prefill_into(slot, p)
        out[slot].append(int(toks[slot]))
    for _ in range(steps):
        toks = np.asarray(eng.decode_active(toks), np.int64)
        for s in range(len(prompts)):
            out[s].append(int(toks[s]))
    return out


def test_engine_greedy_tokens_with_per_slot_moe_capacity(monkeypatch):
    """16 slots, capacity_factor 1.0, a biased router: the reference
    engine's decode vmaps over slots, so each slot's MoE sees one token and
    never drops (C = 8 >= k); the port's batched decode must give the same
    tokens. Batch-level capacity (C = 8 for 16 tokens x 2 choices, most to
    expert 0) drops assignments and changes them, which the last check
    shows."""
    cfg, jcfg, jp, _ = _models("mixtral-8x7b", 2, capacity_factor=1.0)
    jp = _biased(jax.tree.map(np.asarray, jp), cfg.d_model)
    tp = weights.convert_lm(jp, cfg, device=CPU)
    jp = jax.tree.map(jnp.asarray, jp)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(4, 12, 16)]
    je = JEngine(jp, jcfg, n_slots=16, max_len=48)
    te = TEngine(tp, cfg, n_slots=16, max_len=48, device=CPU)
    ref = _engine_tokens(je, prompts, steps=5)
    assert _engine_tokens(te, prompts, steps=5) == ref

    x = TLM.embed_tokens(tp, cfg, torch.tensor([[int(p[0])] for p in prompts]))
    from repro_torch.models import layers as TL
    h = TL.rmsnorm(tp["blocks"][0]["ln1"], x).reshape(16, -1)
    _, idx, _ = TL.moe_gating(h @ tp["blocks"][0]["mlp"]["router"], 2)
    assert int((idx == 0).sum()) > TL.moe_capacity(cfg, 16), \
        "the router bias must overfill expert 0 at batch-level capacity"
    real = TLM.decode_step
    monkeypatch.setattr(TLM, "decode_step", lambda *a, moe_groups=1, **kw:
                        real(*a, **kw))
    batch_level = TEngine(tp, cfg, n_slots=16, max_len=48, device=CPU)
    assert _engine_tokens(batch_level, prompts, steps=5) != ref
