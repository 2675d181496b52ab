"""The saved LSE of the attention backward at minicpm3's MLA class (bf16,
Dq in (64, 96], Dv <= 64) on the CPU: ``ref.attention_lse`` (the plain
version of the rows' LSE that K4's training forward writes, log2 units
with the scale folded, +inf where a row sees no key and past Lq) against
``jax.nn.logsumexp`` over the masked scores, built with the mask of the
reference layer (``repro/models/layers.py`` ``flash_attention``), and
2^(log2(e) S - LSE) V against that layer's output, in every mask mode,
ragged ``kv_valid_len`` included; ``ref.attention_bwd_ref`` from a saved
LSE against ``jax.grad`` of the reference layer at (96, 64) and (80, 48);
``FlashAttentionFn`` saving the LSE at that class (bf16 on CPU tensors),
also when ``torch.utils.checkpoint`` recomputes the forward; and the
routes: ``ops.saves_lse`` holds exactly where ``ops.fwd_route`` names
``flash_bf16_persistent<96, 64, 192>`` in bf16 and ``ops.bwd_route``
names ``"tiled_exact"``.

Tolerances: f32 within 1e-5 of the largest |value| (sums in another
order); LSE within 1e-5 of its largest |LSE| (natural units); bf16
gradients of the two backward forms within 2^-7 of the largest
|gradient| (one bf16 rounding of an f32 result apart).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

torch.set_num_threads(2)

RTOL = 1e-5

# (Lq, Lkv, causal, window, prefix_len, q_offset)
MODES = {
    "causal": (24, 24, True, None, 0, 0),
    "bidirectional": (24, 24, False, None, 0, 0),
    "window": (40, 40, True, 7, 0, 0),
    "prefix": (30, 30, True, None, 9, 0),
    "cross": (13, 37, False, None, 0, 0),
    "q_offset": (10, 31, True, None, 0, 21),
    "masked_row": (12, 12, True, None, 0, -3),
}
# minicpm3-4b's MLA pair and another of its class
WIDTHS = ((96, 64), (80, 48))


def _inputs(B, Lq, Lkv, H, Hkv, Dq, Dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, Dq)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, Hkv, Dq)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, Hkv, Dv)).astype(np.float32)
    do = rng.normal(size=(B, Lq, H, Dv)).astype(np.float32)
    return q, k, v, do


def _ragged(B, Lkv):
    """A full row, about half of it, and a row of 0 (no key seen)."""
    return np.array([Lkv, Lkv // 2 + 1, 0][:B], dtype=np.int32)


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= RTOL * np.abs(want).max(), (err, np.abs(want).max())


def _jax_lse(q, k, *, causal, window, prefix_len, q_offset, kvl):
    """logsumexp over the scores the reference layer masks: its mask, as
    ``repro/models/layers.py`` ``flash_attention`` builds it (the kv
    padding, causal, window, prefix, kv_valid_len); -inf where a row sees
    no key. (B, H, Lq), natural units."""
    B, Lq, H, Dq = q.shape
    _, Lkv, Hkv, _ = k.shape
    qg = jnp.asarray(q).reshape(B, Lq, Hkv, H // Hkv, Dq)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k)) / math.sqrt(Dq)
    qpos = q_offset + jnp.arange(Lq)[:, None]
    kpos = jnp.arange(Lkv)[None, :]
    mask = kpos < Lkv
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if prefix_len:
        mask = mask | ((kpos < prefix_len) & (kpos < Lkv))
    mask = mask[None, None, None]
    if kvl is not None:
        mask = mask & (kpos[None, :] < jnp.asarray(kvl)[:, None, None]
                       )[:, None, None]
    s = jnp.where(mask, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, Lq)


CASES = [(m, G, r) for m in MODES for G in (1, 4) for r in (False, True)]


def _case(mode, G, ragged, dims=(96, 64), seed=0):
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    B = 3 if ragged else 2
    Hkv = 2 if G == 1 else 1
    H = Hkv * G
    q, k, v, do = _inputs(B, Lq, Lkv, H, Hkv, *dims, seed=seed)
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset)
    return q, k, v, do, kw, _ragged(B, Lkv) if ragged else None


@pytest.mark.parametrize("mode,G,ragged", CASES,
                         ids=[f"{m}-{G}" + ("-ragged" if r else "")
                              for m, G, r in CASES])
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(mode, G, ragged):
    """``ref.attention_lse`` against ``jax.nn.logsumexp`` over the
    reference layer's masked scores: log2 units with the scale folded
    (x ln 2 gives the natural LSE), +inf exactly where a row sees no key
    (-inf there in JAX), and +inf in the rows past Lq up to the next
    multiple of 64 (the backward's scratch)."""
    q, k, _, _, kw, kvl = _case(mode, G, ragged, seed=G)
    got = fa_ref.attention_lse(
        torch.from_numpy(q), torch.from_numpy(k),
        kv_valid_len=None if kvl is None else torch.from_numpy(kvl), **kw)
    B, Lq, H, _ = q.shape
    assert got.dtype == torch.float32
    assert got.shape == (B, H, fa_ref.lse_rows(Lq)) and Lq <= 64
    assert bool(torch.isposinf(got[..., Lq:]).all())
    want = _jax_lse(q, k, kvl=kvl, **kw)
    seen = np.isfinite(want)
    assert (np.isposinf(got[..., :Lq].numpy()) == ~seen).all()
    assert seen.any()
    _close(got[..., :Lq].numpy()[seen] * math.log(2.0), want[seen])


@pytest.mark.parametrize("mode,G,ragged", CASES,
                         ids=[f"{m}-{G}" + ("-ragged" if r else "")
                              for m, G, r in CASES])
def test_plain_lse_normalises_the_reference_layer(mode, G, ragged):
    """P = 2^(log2(e) S - LSE) from the plain LSE, times V, is the reference
    layer's output (every row's P sums to 1, or to 0 where the row sees no
    key and the layer gives 0), within 1e-5 of the largest |output|."""
    q, k, v, _, kw, kvl = _case(mode, G, ragged, seed=10 + G)
    want = np.asarray(JL.flash_attention(
        q, k, v, kv_valid_len=None if kvl is None else jnp.asarray(kvl),
        **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkvl = None if kvl is None else torch.from_numpy(kvl)
    lse = fa_ref.attention_lse(tq, tk, kv_valid_len=tkvl, **kw)
    B, Lq, H, Dq = q.shape
    Hkv = k.shape[2]
    qg = tq.reshape(B, Lq, Hkv, H // Hkv, Dq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, tk) / math.sqrt(Dq)
    mask = fa_ref.attention_mask(Lq, k.shape[1], kv_valid_len=tkvl,
                                 device="cpu", **kw)[:, None, None]
    l2 = lse[..., :Lq].reshape(B, Hkv, H // Hkv, Lq, 1)
    p = torch.where(mask, torch.exp2(s * fa_ref.LOG2E - l2), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, tv).reshape(want.shape)
    _close(out.numpy(), want)


BWD_CASES = [(m, d, r) for m in MODES for d in WIDTHS for r in (False, True)]


@pytest.mark.parametrize("mode,dims,ragged", BWD_CASES,
                         ids=[f"{m}-{d[0]}x{d[1]}" + ("-ragged" if r else "")
                              for m, d, r in BWD_CASES])
def test_backward_from_a_saved_lse_matches_jax(mode, dims, ragged):
    """``attention_bwd_ref`` from the saved LSE (``attention_lse``) against
    ``jax.grad`` of the reference layer, at one kv head for four query
    heads, within 1e-5 of the largest |gradient| (the tolerance of
    ``test_flash_attention_fn_grads_match_jax``); the row that sees no key
    has no gradient."""
    q, k, v, do, kw, kvl = _case(mode, 4, ragged, dims, seed=sum(dims))
    jkvl = None if kvl is None else jnp.asarray(kvl)

    def j_loss(q, k, v):
        return jnp.sum(JL.flash_attention(q, k, v, kv_valid_len=jkvl, **kw)
                       * do)
    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tkvl = None if kvl is None else torch.from_numpy(kvl)
    o = fa_ref.attention_ref(tq, tk, tv, kv_valid_len=tkvl, **kw)
    lse = fa_ref.attention_lse(tq, tk, kv_valid_len=tkvl, **kw)
    got = fa_ref.attention_bwd_ref(tq, tk, tv, o, tdo, kv_valid_len=tkvl,
                                   lse=lse, **kw)
    for a, b in zip(got, jg):
        _close(a.numpy(), b)
    if ragged:
        assert all(bool((a[2] == 0).all()) for a in got)


def _bf16_case(dims, seed):
    q, k, v, do, kw, kvl = _case("prefix", 4, True, dims, seed=seed)
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    return xs, torch.from_numpy(do).to(torch.bfloat16), kw, \
        torch.from_numpy(kvl)


def _spy_bwd(monkeypatch):
    """Records the ``lse`` each ``attention_bwd_ref`` call gets."""
    seen, real = [], fa_ref.attention_bwd_ref

    def spy(*a, lse=None, **kw):
        seen.append(lse)
        return real(*a, lse=lse, **kw)
    spy.calls = real.calls          # the counter the plain version bumps
    monkeypatch.setattr(fa_ref, "attention_bwd_ref", spy)
    return seen


@pytest.mark.parametrize("dims", WIDTHS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_flash_attention_fn_saves_the_lse_at_the_class(dims, monkeypatch):
    """Under grad, bf16 at the class: the forward saves the plain LSE (on
    the card the kernel's) and the backward reads it; the gradients equal
    those of the backward that recomputes it within 2^-7 of each
    gradient's largest |value|."""
    seen = _spy_bwd(monkeypatch)
    (q, k, v), do, kw, kvl = _bf16_case(dims, seed=5)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa_ops.flash_attention(*xs, kv_valid_len=kvl, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, xs, do)
    assert len(seen) == 1 and seen[0] is not None
    assert torch.equal(seen[0], fa_ref.attention_lse(q, k, kv_valid_len=kvl,
                                                     **kw))
    want = fa_ref.attention_bwd_ref(q, k, v, out.detach(), do,
                                    kv_valid_len=kvl, **kw)
    for a, b in zip(got, want):
        top = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2 ** -7 * top


def test_flash_attention_fn_saves_no_lse_elsewhere(monkeypatch):
    """f32 at (96, 64) and bf16 at (104, 64) and (24, 16) save none: their
    backward recomputes the LSE."""
    seen = _spy_bwd(monkeypatch)
    for dtype, dims in ((torch.float32, (96, 64)),
                        (torch.bfloat16, (104, 64)),
                        (torch.bfloat16, (24, 16))):
        (q, k, v), do, kw, kvl = _bf16_case(dims, seed=6)
        xs = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        out = fa_ops.flash_attention(*xs, kv_valid_len=kvl, **kw)
        torch.autograd.grad(out, xs, do.to(dtype))
    assert seen == [None, None, None]


def test_recomputed_forward_saves_the_lse(monkeypatch):
    """Under ``torch.utils.checkpoint`` (the per-layer remat of
    ``lm.forward_features``) the forward runs twice and the backward gets
    the LSE that the recompute wrote, with the gradients of the call
    without remat, bit for bit."""
    seen = _spy_bwd(monkeypatch)
    (q, k, v), do, kw, kvl = _bf16_case((96, 64), seed=7)
    calls, real = [], fa_ref.attention_lse

    def lse_spy(*a, **k_):
        calls.append(1)
        return real(*a, **k_)
    monkeypatch.setattr(fa_ref, "attention_lse", lse_spy)

    def layer(q, k, v):
        return fa_ops.flash_attention(q, k, v, kv_valid_len=kvl, **kw)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(checkpoint(layer, *xs, use_reentrant=False),
                              xs, do)
    assert len(calls) == 2 and len(seen) == 1 and seen[0] is not None
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(layer(*ys), ys, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_saves_lse_is_the_class_both_routes_name():
    """Over every (Dq, Dv) the forward takes in bf16 (multiples of 8 up to
    256), ``saves_lse`` holds exactly where ``fwd_route`` names the
    instance with the LSE write's twin, ``flash_bf16_persistent<96, 64,
    192>``, at Dq over 64, and where ``bwd_route`` names "tiled_exact";
    never in f32."""
    bf16 = torch.bfloat16
    for Dq in range(8, 257, 8):
        for Dv in range(8, 257, 8):
            if not fa_ops.dv_supported(Dq, Dv):
                continue
            lse = fa_ops.saves_lse(bf16, Dq, Dv)
            assert lse == (Dq > 64 and fa_ops.fwd_route(bf16, Dq, Dv)
                           == "flash_bf16_persistent<96, 64, 192>"), (Dq, Dv)
            assert lse == (fa_ops.bwd_route(bf16, 4096, 4096, Dq, Dv)
                           == "tiled_exact"), (Dq, Dv)
            assert not fa_ops.saves_lse(torch.float32, Dq, Dv)
    assert fa_ops.saves_lse(bf16, 96, 64) and fa_ops.saves_lse(bf16, 80, 48)
    assert not fa_ops.saves_lse(bf16, 24, 16)

