"""The port's attention-free mixers (``repro_torch.models.ssm``) and the SSM
kind (rwkv6-7b) held against the JAX package: every function of the module
on the same numpy inputs as ``repro/models/ssm.py``, the WKV6 kernel's
wrapper on CPU tensors (its plain step loop), then reduced rwkv6 through
``lm.prefill``/``decode_step`` and both packages' ModelEngines, the
reference's parameters carried over by ``repro_torch.weights``.

Tolerances (f32): the WKV6 recurrence, the SSD and the Mamba2 step within
1e-5 of the largest |output| (f32 sums of K or N terms taken in another
order, a few ulps that the decay keeps from growing); the conv exactly
(the same products summed in the same order); logits and the state cache
within 1e-5 of the largest |value|. In bf16 the two frameworks round
intermediates differently (XLA sums matmuls in another order and fuses
elementwise chains), which moves logits by 1-2% of the largest for the
kinds ported before (qwen3, mixtral). Here, over ``run_both``'s prompt
and 8 steps at seeds 0-4, the largest bf16 difference of any logit or
state leaf read 0.0518 of the largest |value| for rwkv6 (0.0419 at seed
0) and 0.0439 for zamba2 (seed 0): each kind is held to BF16_RTOL, about
1.5 times its largest reading, and bf16 weights convert bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro.serving.engine import ModelEngine as JEngine
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS
from repro_torch.serving.engine import ModelEngine as TEngine

torch.set_num_threads(2)

CPU = "cpu"
RTOL = 1e-5             # of the largest |value|, f32
BF16_RTOL = {"rwkv6-7b": 0.08, "zamba2-7b": 0.066}
                        # of the largest |value|, bf16 (see above)
ARCH = "rwkv6-7b"


def _close(t, j, rtol: float = RTOL, what: str = "") -> None:
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = np.abs(t - j).max() if j.size else 0.0
    assert err <= rtol * max(np.abs(j).max(), 1e-30), \
        (what, err, np.abs(j).max())


def _wkv_inputs(B, L, H, K, seed, w_lo=0.3, w_hi=0.99):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, L, H, K)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, size=(B, L, H, K)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s = rng.normal(size=(B, H, K, K)).astype(np.float32)
    return r, k, v, w, u, s


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 40])
def test_rwkv6_linear_attention_matches_the_chunked_scan(L, carried):
    """The port runs the L real steps; the reference pads L to a multiple
    of chunk 16 with w = 1, k = 0 steps. y and the final state agree, so
    the padded steps left the state as it was."""
    r, k, v, w, u, s = _wkv_inputs(2, L, 3, 8, seed=L)
    if not carried:
        s = np.zeros_like(s)
    jy, jS = JS.rwkv6_linear_attention(*map(jnp.asarray, (r, k, v, w, u, s)),
                                       chunk=16)
    ty, tS = TS.rwkv6_linear_attention(*map(torch.from_numpy,
                                            (r, k, v, w, u, s)), chunk=16)
    assert ty.dtype == tS.dtype == torch.float32
    _close(ty, jy, what="y")
    _close(tS, jS, what="state")


def test_chunk_padding_leaves_the_state_unchanged():
    """The reference's state after L = 17 steps in chunks of 16 (15 padded
    steps) equals its state in one chunk of 17 (no padding), and the
    port's, which runs 17 steps whatever the chunk."""
    r, k, v, w, u, s = map(jnp.asarray, _wkv_inputs(1, 17, 2, 8, seed=3))
    _, padded = JS.rwkv6_linear_attention(r, k, v, w, u, s, chunk=16)
    _, exact = JS.rwkv6_linear_attention(r, k, v, w, u, s, chunk=17)
    np.testing.assert_allclose(np.asarray(padded), np.asarray(exact),
                               rtol=0, atol=1e-6)
    _, tS = TS.rwkv6_linear_attention(
        *(torch.from_numpy(np.array(a)) for a in (r, k, v, w, u, s)),
        chunk=16)
    _close(tS, exact, what="state")


def test_wkv6_wrapper_runs_the_plain_loop_on_the_cpu():
    """On CPU tensors the wrapper runs ``ref.py`` (bf16 r/k/v widened to
    f32), leaves the state it was given as it was and counts no launch."""
    r, k, v, w, u, s = _wkv_inputs(2, 9, 2, 16, seed=4)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s)]
    for i in range(3):
        args[i] = args[i].to(torch.bfloat16)
    before, n = args[5].clone(), wkv6_ops.wkv6.launches
    y, S = wkv6_ops.wkv6(*args)
    assert wkv6_ops.wkv6.launches == n
    torch.testing.assert_close(args[5], before, rtol=0, atol=0)
    jy, jS = JS.rwkv6_linear_attention(
        *(jnp.asarray(a.float().numpy()) for a in args), chunk=16)
    _close(y, jy, what="y")
    _close(S, jS, what="state")


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_ssd_chunked_matches_the_reference(carried):
    """L = 37 over chunks of 16 (padded to 48), 4 heads of 8, state 6."""
    rng = np.random.default_rng(5)
    B, L, H, P, N = 2, 37, 4, 8, 6
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, L, H)).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, L, N)).astype(np.float32) for _ in "BC")
    D = rng.normal(size=(H,)).astype(np.float32)
    s = (rng.normal(size=(B, H, N, P)) if carried
         else np.zeros((B, H, N, P))).astype(np.float32)
    args = (x, dt, A_log, Bm, Cm, D, s)
    jy, jS = JS.ssd_chunked(*map(jnp.asarray, args), chunk=16)
    ty, tS = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=16)
    _close(ty, jy, what="y")
    _close(tS, jS, what="state")


@pytest.mark.parametrize("L,carried", [(9, False), (9, True), (2, False),
                                       (1, True)])
def test_causal_depthwise_conv_matches_the_reference(L, carried):
    """With and without a carried state; L = 2 and 1 are shorter than
    k - 1 = 3, so the new state keeps padding rows (zeros without a
    state)."""
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    s = rng.normal(size=(2, 3, 5)).astype(np.float32) if carried else None
    jy, jst = JS._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if s is None else jnp.asarray(s))
    ty, tst = TS._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if s is None else torch.from_numpy(s))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tst.shape == (2, 3, 5)
    if L < 3 and not carried:
        assert not tst[:, :3 - L].any()


def test_mamba2_block_and_decode_step_match_the_reference():
    """A reduced zamba2 Mamba2 layer: the block over a 21-token prompt
    (zero state), then three decode steps carrying its state."""
    cfg = get_config("zamba2-7b").reduced().replace(dtype="float32")
    jcfg = j_get_config("zamba2-7b").reduced().replace(dtype="float32")
    jp = JS.mamba2_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = weights.to_torch(jax.tree.map(np.asarray, jp), CPU)
    assert tp["A_log"].dtype == tp["D"].dtype == torch.float32
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    jx, jst = JS.mamba2_block(jp, jcfg, jnp.asarray(x), None,
                              cfg.chunk_size)
    tx, tst = TS.mamba2_block(tp, cfg, torch.from_numpy(x), None,
                              cfg.chunk_size)
    _close(tx, jx, what="block")
    for key in ("s", "conv"):
        _close(tst[key], jst[key], what=key)
    for step in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jx, jst = JS.mamba2_decode_step(jp, jcfg, jnp.asarray(xt), jst)
        tx, tst = TS.mamba2_decode_step(tp, cfg, torch.from_numpy(xt), tst)
        _close(tx, jx, what=f"step {step}")
        for key in ("s", "conv"):
            _close(tst[key], jst[key], what=f"step {step} {key}")


def test_rwkv6_block_carries_the_normalised_inputs():
    """``tm_x``/``cm_x`` are the last positions of ln1(x) and ln2(x + time
    mix), not of x; the block with a carried state matches the
    reference's."""
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    jcfg = j_get_config(ARCH).reduced().replace(dtype="float32")
    jp = JS.rwkv6_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    jp = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(7)
    jp["u"] = rng.normal(size=jp["u"].shape).astype(np.float32)  # not 0
    jp["ln1"]["scale"] = rng.uniform(0.5, 2.0, cfg.d_model).astype(
        np.float32)
    tp = weights.to_torch(jp, CPU)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    jx, jst = JS.rwkv6_block(jp, jcfg, jnp.asarray(x), None, 16)
    tx, tst = TS.rwkv6_block(tp, cfg, torch.from_numpy(x), None, 16)
    _close(tx, jx, what="x")
    h = TS.L.layernorm(tp["ln1"], torch.from_numpy(x))
    torch.testing.assert_close(tst["tm_x"], h[:, -1], rtol=0, atol=0)
    for key in ("s", "tm_x", "cm_x"):
        _close(tst[key], jst[key], what=key)
    x2 = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    jx, jst = JS.rwkv6_block(jp, jcfg, jnp.asarray(x2), jst, 16)
    tx, tst = TS.rwkv6_block(tp, cfg, torch.from_numpy(x2), tst, 16)
    _close(tx, jx, what="carried x")
    for key in ("s", "tm_x", "cm_x"):
        _close(tst[key], jst[key], what=f"carried {key}")


# ---------------------------------------------------------------------------
# the SSM kind through lm and the engines
# ---------------------------------------------------------------------------


def _models(arch: str, seed: int, dtype: str = "float32"):
    cfg = get_config(arch).reduced().replace(dtype=dtype)
    jcfg = j_get_config(arch).reduced().replace(dtype=dtype)
    jp = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


def run_both(arch: str, dtype: str, seed: int, B: int = 2, Lp: int = 37,
             steps: int = 8, max_len: int = 64) -> None:
    """Prefill of a (B, Lp) prompt then ``steps`` greedy decode steps
    through both packages: logits at every step and every cache leaf
    after prefill and after decode, key for key. Shared with
    ``tests/test_torch_hybrid.py``."""
    rtol = RTOL if dtype == "float32" else BF16_RTOL[arch]
    cfg, jcfg, jp, tp = _models(arch, seed, dtype)
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, Lp)).astype(np.int32)
    jc = JLM.init_cache(jcfg, B, max_len)
    tc = TLM.init_cache(cfg, B, max_len, device=CPU)
    jl, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = TLM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, rtol, "prefill logits")

    def same_cache(what):
        assert set(tc) == set(jc), (set(tc), set(jc))
        for key, t in tc.items():
            assert t.dtype == getattr(torch, str(jc[key].dtype)), key
            _close(t, jc[key], rtol, f"{what} {key}")
    same_cache("prefill")
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(steps):
        jd, jc = JLM.decode_step(jp, jcfg, jnp.asarray(nxt)[:, None], jc,
                                 jnp.int32(Lp + step))
        td, tc = TLM.decode_step(tp, cfg, torch.from_numpy(nxt)[:, None], tc,
                                 Lp + step)
        _close(td, jd, rtol, f"step {step} logits")
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)
    same_cache("decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_prefill_and_decode_match_jax(dtype):
    run_both(ARCH, dtype, seed=0)


def test_rwkv6_prefill_ignores_the_cache_it_is_given():
    """Prefill starts every layer from zero state, as the reference's does,
    whatever the cache holds."""
    cfg, _, _, tp = _models(ARCH, 1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 10)))
    clean, _ = TLM.prefill(tp, cfg, {"tokens": toks},
                           TLM.init_cache(cfg, 1, 16, device=CPU))
    dirty = TLM.init_cache(cfg, 1, 16, device=CPU)
    for t in dirty.values():
        t.fill_(3.0)
    again, dirty = TLM.prefill(tp, cfg, {"tokens": toks}, dirty)
    torch.testing.assert_close(again, clean, rtol=0, atol=0)


def bf16_converts_bit_for_bit(arch: str) -> None:
    """bf16 reference params -> the port's: every leaf bit for bit, the
    stacked layers one per layer; f32 leaves (Mamba2's A_log, D, dt_bias)
    stay f32. Shared with ``tests/test_torch_hybrid.py``."""
    jcfg = j_get_config(arch).reduced()                 # bf16 default
    jp = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = weights.convert_lm(jp, get_config(arch).reduced(), device=CPU)
    pairs = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            pairs += [(_at(tp["blocks"][i], keys[1:]), leaf[i], keys)
                      for i in range(jcfg.n_layers)]
        else:
            pairs.append((_at(tp, keys), leaf, keys))
    assert len(pairs) == len(jax.tree.leaves(tp))
    n_f32 = 0
    for t, a, keys in pairs:
        assert t.shape == a.shape and str(t.dtype)[6:] == a.dtype.name, keys
        n_f32 += t.dtype == torch.float32
        bits = np.int16 if a.dtype.name == "bfloat16" else np.int32
        np.testing.assert_array_equal(
            t.view(getattr(torch, bits.__name__)).numpy(), a.view(bits),
            err_msg=str(keys))
    return n_f32


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_rwkv6_bf16_weights_convert_bit_for_bit():
    assert bf16_converts_bit_for_bit(ARCH) == 0


def engine_tokens(arch: str, seed: int, lengths, steps: int = 6,
                  max_len: int = 64) -> None:
    """Greedy tokens through both packages' ModelEngines (f32), prompts of
    unequal lengths, the last slot joining after two steps. Shared with
    ``tests/test_torch_hybrid.py``."""
    cfg, jcfg, jp, tp = _models(arch, seed)
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    n = len(prompts)
    outs = []
    for eng in (JEngine(jp, jcfg, n_slots=n, max_len=max_len),
                TEngine(tp, cfg, n_slots=n, max_len=max_len, device=CPU)):
        toks = np.zeros(n, np.int64)
        out = [[] for _ in prompts]
        for slot, p in enumerate(prompts[:-1]):
            toks[slot] = eng.prefill_into(slot, p)
            out[slot].append(int(toks[slot]))
        for step in range(steps):
            if step == 2:
                toks[n - 1] = eng.prefill_into(n - 1, prompts[-1])
                out[n - 1].append(int(toks[n - 1]))
            nxt = eng.decode_active(toks)
            for s in np.flatnonzero(eng.active):
                out[s].append(int(nxt[s]))
            toks = np.asarray(nxt, np.int64)
        outs.append((out, eng))
    (ref, je), (got, te) = outs
    assert got == ref
    assert set(te.cache) == set(je.cache)
    for key, t in te.cache.items():
        _close(t, je.cache[key], RTOL, f"engine cache {key}")


def test_rwkv6_engine_greedy_tokens_match_jax():
    engine_tokens(ARCH, 4, (9, 17, 5))
