"""The encoder-decoder kind (whisper-base) of the port's LM held against the
JAX package, the reference's parameters carried over by
``repro_torch.weights``: the encoder over stub frame embeddings
(bidirectional self-attention, LayerNorm, the ungated gelu MLP, enc_norm),
prefill with ``frames`` (causal self-attention, cross-attention over the
encoder's output), the self-attention and cross-attention (``xk``/``xv``)
caches, 4 decode steps, and bf16 weight conversion.

Tolerances: logits within 1e-4 of the largest |logit| (fp32 matmuls and
softmaxes summed in another order drift by a few ulps per layer); the
encoder's output and the cached k/v/xk/xv atol 1e-5 (LayerNorm'd
activations of order 1, a few ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import lm as JLM
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.models import lm as TLM

torch.set_num_threads(2)

CPU = "cpu"
ARCH = "whisper-base"
LOGIT_RTOL = 1e-4       # of the largest |logit|
ACT_ATOL = 1e-5


@pytest.fixture(scope="module")
def whisper():
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    jcfg = j_get_config(ARCH).reduced().replace(dtype="float32")
    jp = JLM.init_params(jax.random.PRNGKey(7), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


def _frames(cfg, B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _assert_logits(t: torch.Tensor, j, what: str) -> None:
    j = np.asarray(j)
    err = np.abs(t.numpy() - j).max()
    assert err <= LOGIT_RTOL * np.abs(j).max(), (what, err, np.abs(j).max())


def test_params_carry_the_encoder_and_cross_attention(whisper):
    cfg, _, _, tp = whisper
    assert cfg.is_encoder_decoder and cfg.family == "audio"
    assert len(tp["enc_blocks"]) == cfg.enc_layers == 2
    assert len(tp["blocks"]) == cfg.n_layers
    blk = tp["blocks"][0]
    assert {"xattn", "ln_x"} <= set(blk) and "bias" in blk["ln1"]
    assert "w_gate" not in blk["mlp"] and "lm_head" not in tp
    assert "xattn" not in tp["enc_blocks"][0] and "bias" in tp["enc_norm"]


def test_encoder_matches_jax(whisper):
    """``_encode`` over 32 stub frames (B = 2)."""
    cfg, jcfg, jp, tp = whisper
    fr = _frames(cfg, 2, seed=1)
    je = np.asarray(JLM._encode(jp, jcfg, jnp.asarray(fr)))
    te = TLM._encode(tp, cfg, torch.from_numpy(fr))
    np.testing.assert_allclose(te.numpy(), je, atol=ACT_ATOL)


def test_prefill_with_frames_and_decode_match_jax(whisper):
    """Prefill of 9 text tokens after the encoder (B = 2), then 4 greedy
    decode steps: logits at every step; the self-attention cache and the
    cross-attention ``xk``/``xv`` after prefill and after decode."""
    cfg, jcfg, jp, tp = whisper
    B, Lp, max_len = 2, 9, 20
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, Lp)).astype(np.int32)
    fr = _frames(cfg, B, seed=3)
    jc = JLM.init_cache(jcfg, B, max_len)
    tc = TLM.init_cache(cfg, B, max_len, device=CPU)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
    assert tc["xk"].shape == (cfg.n_layers, B, cfg.enc_len, cfg.n_heads,
                              cfg.head_dim)
    jl, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(fr)}, jc)
    tl, tc = TLM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(fr)}, tc)
    _assert_logits(tl, jl, "prefill")
    caches = [(jax.tree.map(np.asarray, jc),
               {k: v.clone() for k, v in tc.items()})]
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(4):
        jd, jc = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                                 jnp.int32(Lp + step))
        td, tc = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc,
                                 Lp + step)
        _assert_logits(td, jd, f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)
    caches.append((jax.tree.map(np.asarray, jc), tc))
    for jcache, tcache in caches:
        for key in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(tcache[key].numpy(), jcache[key],
                                       atol=ACT_ATOL, err_msg=key)
    # decode wrote its four positions and left xk/xv as prefill put them
    assert np.abs(caches[1][1]["k"][:, :, Lp:Lp + 4].numpy()).max() > 0
    assert torch.equal(caches[0][1]["xk"], caches[1][1]["xk"])


def test_bf16_weights_convert_bit_for_bit():
    """Every leaf: ``blocks`` and ``enc_blocks`` stacked in the reference,
    one a layer here; ``enc_norm`` and the LayerNorms' biases."""
    jcfg = j_get_config(ARCH).reduced()                 # bf16 default
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = weights.convert_lm(jp, cfg, device=CPU)
    n_tp = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("blocks", "enc_blocks"):
            layers = [(tp[keys[0]][i], leaf[i]) for i in range(leaf.shape[0])]
            keys = keys[1:]
        else:
            layers = [(tp, leaf)]
        for tree, a in layers:
            for k in keys:
                tree = tree[k]
            assert tree.dtype == torch.bfloat16 and tree.shape == a.shape
            np.testing.assert_array_equal(tree.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=str(keys))
            n_tp += 1
    assert n_tp == len(jax.tree.leaves(tp))
