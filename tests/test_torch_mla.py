"""The MLA kind (minicpm3-4b; deepseek-v2-236b with its leading dense layer
and 2 shared + routed experts) of the port's LM held against the JAX
package, the reference's parameters carried over by ``repro_torch.weights``:
prefill and decode logits with ``mla_absorb`` off (K/V materialised, the
attention's Dv mode) and on (absorbed f32 products over the latent cache),
the latent and k_rope cache, bf16 weight conversion, greedy tokens through
both packages' ModelEngines, and the plain attention with a value head dim
other than the q/k one against the reference model layer's jnp attention.

Tolerances: logits within 1e-4 of the largest |logit| (fp32 matmuls and
softmaxes summed in another order drift by a few ulps per layer); the
cached latent and k_rope atol 1e-5 (one projection, a norm and a rotation
from the same inputs); the plain attention atol 1e-5 (the reference's own
for fp32 attention summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving.engine import ModelEngine as JEngine
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serving.engine import ModelEngine as TEngine

torch.set_num_threads(2)

CPU = "cpu"
LOGIT_RTOL = 1e-4       # of the largest |logit|
CACHE_ATOL = 1e-5
ATT_ATOL = 1e-5
MLA_ARCHS = ["minicpm3-4b", "deepseek-v2-236b"]


def _models(arch: str, seed: int, **kw):
    cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
    jcfg = j_get_config(arch).reduced().replace(dtype="float32", **kw)
    jp = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


def _assert_logits(t: torch.Tensor, j, what: str) -> None:
    j = np.asarray(j)
    err = np.abs(t.numpy() - j).max()
    assert err <= LOGIT_RTOL * np.abs(j).max(), (what, err, np.abs(j).max())


def _assert_cache(jc: dict, tc: dict) -> None:
    assert set(jc) == set(tc) == {"latent", "krope"}
    for key, t in tc.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[key]),
                                   atol=CACHE_ATOL, err_msg=key)


@pytest.mark.parametrize("absorb", [False, True], ids=["materialised",
                                                       "absorbed"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_prefill_and_decode_match_jax(arch, absorb):
    """Prefill of a 10-token prompt (B = 2), then 4 greedy decode steps:
    logits at every step, and the latent/k_rope cache after prefill and
    after decode, equal the reference's."""
    cfg, jcfg, jp, tp = _models(arch, 0, mla_absorb=absorb)
    assert cfg.attn_kind == "mla" and cfg.qk_nope_dim + cfg.qk_rope_dim \
        != cfg.v_head_dim
    assert len(tp.get("dense0", [])) == cfg.first_dense_layers
    B, Lp, max_len = 2, 10, 24
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, Lp)).astype(np.int32)
    jc = JLM.init_cache(jcfg, B, max_len)
    tc = TLM.init_cache(cfg, B, max_len, device=CPU)
    jl, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = TLM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, tc)
    _assert_logits(tl, jl, "prefill")
    _assert_cache(jc, tc)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(4):
        jd, jc = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                                 jnp.int32(Lp + step))
        td, tc = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc,
                                 Lp + step)
        _assert_logits(td, jd, f"decode step {step}")
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)
    _assert_cache(jc, tc)
    assert tc["latent"].dtype == torch.float32


@pytest.mark.parametrize("absorb", [False, True], ids=["materialised",
                                                       "absorbed"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_kv_max_reads_only_the_valid_prefix(arch, absorb):
    """``kv_max`` (the host's largest kv_len) cuts the cache that MLA
    decode reads to its first kv_max positions: the same output as all
    Lmax of them, ragged kv lengths included."""
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             mla_absorb=absorb)
    g = torch.Generator().manual_seed(3)
    p = TL.mla_init(g, cfg, torch.float32, CPU)
    B, Lmax = 3, 40
    x = torch.randn((B, 1, cfg.d_model), generator=g)
    lat = torch.randn((B, Lmax, cfg.kv_lora_rank), generator=g)
    kr = torch.randn((B, Lmax, cfg.qk_rope_dim), generator=g)
    kv_len = torch.tensor([17, 5, 12], dtype=torch.int32)
    pos = (kv_len - 1).long()[:, None]
    full = TL.mla_decode(p, cfg, x, lat, kr, kv_len, pos)
    cut = TL.mla_decode(p, cfg, x, lat, kr, kv_len, pos, kv_max=17)
    torch.testing.assert_close(cut, full, atol=1e-6, rtol=0)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_bf16_weights_convert_bit_for_bit(arch):
    """Every leaf, the stacked ``blocks`` one a layer and deepseek's
    ``dense0`` list, carried bit for bit."""
    jcfg = j_get_config(arch).reduced()                 # bf16 default
    cfg = get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = weights.convert_lm(jp, cfg, device=CPU)
    n_blocks = cfg.n_layers - cfg.first_dense_layers
    pairs = []
    for path, leaf in _leaves(jp):
        if path[0] == "blocks":     # stacked (n, ...) -> one per layer
            pairs += [(_at(tp["blocks"][i], path[1:]), leaf[i], path)
                      for i in range(n_blocks)]
        else:
            pairs.append((_at(tp, path), leaf, path))
    assert len(pairs) == len(list(_leaves(tp)))
    assert "wq_a" in tp["blocks"][0]["attn"]
    for t, a, path in pairs:
        assert t.dtype == torch.bfloat16 and t.shape == a.shape, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=str(path))


def _engine_tokens(eng, prompts, steps: int, late: int = 2) -> list:
    """Slots 0-2 prefilled at once, slot 3 after ``late`` steps; slot 0
    released after step 3 (its token list ends there)."""
    n = len(prompts)
    toks = np.zeros(n, np.int64)
    out = [[] for _ in prompts]
    for slot in range(n - 1):
        toks[slot] = eng.prefill_into(slot, prompts[slot])
        out[slot].append(int(toks[slot]))
    for step in range(steps):
        if step == late:
            toks[n - 1] = eng.prefill_into(n - 1, prompts[n - 1])
            out[n - 1].append(int(toks[n - 1]))
        toks = np.asarray(eng.decode_active(toks), np.int64)
        for s in np.flatnonzero(eng.active):
            out[s].append(int(toks[s]))
        if step == 3:
            eng.release(0)
    return out


@pytest.mark.parametrize("absorb", [False, True], ids=["materialised",
                                                       "absorbed"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_engine_greedy_tokens_identical(arch, absorb):
    """4 slots of ragged prompts, one joining late and one released: the
    port's batched decode (per-slot positions, ``kv_max`` from the host,
    each slot's MoE on its own) gives the reference engine's tokens."""
    cfg, jcfg, jp, tp = _models(arch, 2, mla_absorb=absorb)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (5, 11, 8, 6)]
    je = JEngine(jp, jcfg, n_slots=4, max_len=32)
    te = TEngine(tp, cfg, n_slots=4, max_len=32, device=CPU)
    ref = _engine_tokens(je, prompts, steps=6)
    assert _engine_tokens(te, prompts, steps=6) == ref
    assert len(ref[3]) == 5 and len(ref[0]) == 5


def _np(*shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


DV_SHAPES = {"minicpm-like": (4, 4, 24, 16),      # H, Hkv, Dq, Dv
             "deepseek-like": (4, 4, 48, 32),
             "gqa": (6, 2, 40, 24)}


@pytest.mark.parametrize("kw", [
    {"causal": True},
    {"causal": False},
    {"causal": True, "q_offset": 4},
    {"causal": True, "kv_valid_len": [11, 6]}], ids=[
    "causal", "bidirectional", "offset", "ragged"])
@pytest.mark.parametrize("shape", sorted(DV_SHAPES))
def test_plain_flash_attention_dv_matches_reference(shape, kw):
    """K4's plain version with Dv != Dq (q/k (B, L, H[kv], Dq), v (B, L,
    Hkv, Dv)) against the reference model layer's jnp flash_attention."""
    H, Hkv, Dq, Dv = DV_SHAPES[shape]
    B, Lq, Lkv = 2, 7, 11
    q, k, v = _np(B, Lq, H, Dq, seed=1), _np(B, Lkv, Hkv, Dq, seed=2), \
        _np(B, Lkv, Hkv, Dv, seed=3)
    jkw, tkw = dict(kw), dict(kw)
    if "kv_valid_len" in kw:
        kvl = np.asarray(kw["kv_valid_len"], np.int32)
        jkw["kv_valid_len"], tkw["kv_valid_len"] = jnp.asarray(kvl), \
            torch.from_numpy(kvl)
    ja = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **jkw)
    ta = TL.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **tkw)
    assert ta.shape == (B, Lq, H, Dv)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATT_ATOL)


# K3 cases: (H, Hkv, Dq, Dv), the cache length and the kv lengths; the
# narrow shapes over ragged lengths (one of them the whole cache), and
# MLA's full head dims (minicpm3-4b, deepseek-v2-236b) at the fast
# kernel's tile and chunk edges in a 65-position cache
DV_DECODE = {**{name: (shape, 19, [19, 1, 9])
                for name, shape in DV_SHAPES.items()},
             **{name: (shape, 65, [1, 15, 16, 17, 63, 64, 65])
                for name, shape in (("minicpm3", (4, 4, 96, 64)),
                                    ("deepseek-v2", (4, 4, 192, 128)))}}


@pytest.mark.parametrize("shape", sorted(DV_DECODE))
def test_plain_decode_attention_dv_matches_reference(shape):
    """K3's plain version with Dv != Dq against the reference model layer's
    jnp decode_attention, at 1e-5."""
    (H, Hkv, Dq, Dv), Lc, lens = DV_DECODE[shape]
    B = len(lens)
    q, k, v = _np(B, 1, H, Dq, seed=4), _np(B, Lc, Hkv, Dq, seed=5), \
        _np(B, Lc, Hkv, Dv, seed=6)
    kvl = np.asarray(lens, np.int32)
    ja = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_len=jnp.asarray(kvl))
    ta = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_len=torch.from_numpy(kvl))
    assert ta.shape == (B, 1, H, Dv)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATT_ATOL)
