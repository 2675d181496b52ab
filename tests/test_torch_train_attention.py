"""The attention backward on the CPU: ``FlashAttentionFn`` (the route
``kernels.flash_attention.ops.flash_attention`` takes under grad) held
against ``jax.grad`` of the reference model layer's ``flash_attention``
(also at the embedder's layout: 12 heads of 64, 24 tokens,
bidirectional; and at the MLA pairs (96, 64), (192, 128) and the reduced
(24, 16), and at paligemma's head dim 256 with its bidirectional prefix
and 8 query heads a kv head), the route ``ops.bwd_route`` gives a call on
the card (the one-pass kernel, the tiled pair or the wide bf16 pair),
a ragged ``kv_valid_len`` (a full row, a short row and a row of 0, whose
gradients are 0 in both packages) in every mask mode at G 1, 4 and 8 and
at every width, and its plain version ``attention_bwd_ref`` against
autograd through ``attention_ref``, in every mask mode (causal,
bidirectional, window, prefix, cross attention with Lq != Lkv, an
explicit q_offset, a fully masked row) with GQA (1 and 4 query heads a kv
head), with and without a ragged ``kv_valid_len``; the route by which the
bf16 kernels take a head dim that is not a multiple of 8 (a zero-padded
copy, ``ops.bwd_operands``) against the unpadded one, and the aligned
copy it makes of a misaligned view; the wrappers of the kernels without a
backward refuse inputs that require grad (``refuse_grad``, on CUDA
tensors only: on the CPU their plain versions differentiate).

Tolerance: f32 gradients within 1e-5 of the largest |gradient| (f32 sums
in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops

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


def _inputs(B, Lq, Lkv, H, Hkv, D, seed, Dv=None):
    Dv = D if Dv is None else Dv
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, Hkv, Dv)).astype(np.float32)
    do = rng.normal(size=(B, Lq, H, Dv)).astype(np.float32)
    return q, k, v, do


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= RTOL * np.abs(want).max(), (err, np.abs(want).max())


# the embedder's attention (launch.train_embedder --full): 24 tokens,
# bidirectional, 12 heads of 64; on the card its backward is the one-pass
# kernel
EMBED_MODE = (24, 24, False, None, 0, 0)
# the backward's other widths (Dq, Dv): minicpm3-4b's and deepseek-v2-236b's
# MLA pairs, the reduced MLA's, paligemma-3b's 256
WIDTHS = ((96, 64), (192, 128), (24, 16), (256, 256))
FN_CASES = ([(m, G, None) for m in MODES for G in (1, 4)]
            + [("embedder", 1, None)]
            + [(m, 1, d) for d in WIDTHS for m in MODES]
            + [("prefix", 8, d) for d in WIDTHS])


def _ragged(B, Lkv):
    """kv_valid_len of B rows: the full length, about half of it, 0 (a row
    that sees no key, whose gradients are 0 in both packages), and again."""
    return np.array([Lkv, Lkv // 2 + 1, 0, Lkv][:B], dtype=np.int32)


def _fn_grads_match(mode, G, dims, ragged):
    """``FlashAttentionFn`` on CPU tensors (its backward the plain
    ``attention_bwd_ref``, called once) against ``jax.grad`` of the
    reference layer at the same inputs: head dim 16 (64 at the embedder's
    layout) with Dv = Dq, or (Dq, Dv) = ``dims``, one kv head for G query
    heads past G = 1; with ``ragged``, B 3 and ``_ragged``'s
    kv_valid_len."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES.get(mode, EMBED_MODE)
    H, Hkv, D = (12, 12, 64) if mode == "embedder" else (2 * G, 2, 16)
    Dv = D
    if dims:
        (D, Dv), Hkv, H = dims, 2 if G == 1 else 1, 2 if G == 1 else G
    B = 3 if ragged else 2
    q, k, v, do = _inputs(B, Lq, Lkv, H, Hkv, D, seed=G, Dv=Dv)
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset)
    kvl = _ragged(B, Lkv) if ragged else None

    def j_loss(q, k, v):
        return jnp.sum(JL.flash_attention(
            q, k, v, kv_valid_len=None if kvl is None else jnp.asarray(kvl),
            **kw) * do)
    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    assert all(bool(np.isfinite(np.asarray(x)).all()) for x in jg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    calls = fa_ref.attention_bwd_ref.calls
    out = fa_ops.flash_attention(
        tq, tk, tv, kv_valid_len=None if kvl is None
        else torch.from_numpy(kvl), **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert fa_ref.attention_bwd_ref.calls == calls + 1
    for a, b in zip(tg, jg):
        _close(a.numpy(), b)
    if ragged:          # the row that sees no key has no gradient
        assert all(bool((a[2] == 0).all()) for a in tg)


@pytest.mark.parametrize(
    "mode,G,dims", FN_CASES,
    ids=[f"{m}-{G}" + (f"-{d[0]}x{d[1]}" if d else "")
         for m, G, d in FN_CASES])
def test_flash_attention_fn_grads_match_jax(mode, G, dims):
    """Head dim 16 (64 at the embedder's layout) with Dv = Dq, and the
    widths of ``WIDTHS``: q/k of Dq with v of Dv, the scale 1 / sqrt(Dq);
    at G = 8 one kv head serves 8 query heads, as paligemma's MQA."""
    _fn_grads_match(mode, G, dims, ragged=False)


RAGGED_CASES = ([(m, G, None) for m in MODES for G in (1, 4, 8)]
                + [(m, 1, d) for d in WIDTHS for m in MODES]
                + [("prefix", 8, d) for d in WIDTHS])


@pytest.mark.parametrize(
    "mode,G,dims", RAGGED_CASES,
    ids=[f"{m}-{G}" + (f"-{d[0]}x{d[1]}" if d else "")
         for m, G, d in RAGGED_CASES])
def test_flash_attention_fn_ragged_grads_match_jax(mode, G, dims):
    """A ragged ``kv_valid_len`` under grad, in every mask mode at G 1, 4
    and 8 and at every width of ``WIDTHS``: the batch rows see all their
    keys, about half, and none (zero gradients, finite in both)."""
    _fn_grads_match(mode, G, dims, ragged=True)


@pytest.mark.parametrize("dtype,Lq,Lkv,Dh,route", [
    (torch.float32, 24, 24, 64, "one_pass"),        # the embedder's call
    (torch.float32, 1, 1, 16, "one_pass"),
    (torch.float32, 32, 32, 128, "one_pass"),
    (torch.float32, 33, 24, 100, "one_pass"),
    (torch.float32, 64, 64, 112, "one_pass"),
    (torch.float32, 65, 64, 64, "tiled"),
    (torch.float32, 64, 65, 64, "tiled"),
    (torch.float32, 1024, 1024, 128, "tiled"),
    (torch.bfloat16, 24, 24, 64, "tiled"),
    (torch.bfloat16, 1, 1, 16, "tiled"),
    (torch.float32, 24, 24, 129, "one_pass"),
    (torch.float32, 32, 32, 256, "one_pass"),
    (torch.float32, 33, 33, 129, "tiled"),
    (torch.float32, 4096, 4096, 256, "tiled"),
    (torch.bfloat16, 4096, 4096, 128, "tiled"),
    (torch.bfloat16, 24, 24, 129, "tiled_wide"),
    (torch.bfloat16, 4096, 4096, 256, "tiled_wide"),
    (torch.float32, 24, 24, 257, ValueError),
    (torch.float32, 24, 24, 0, ValueError),
], ids=lambda x: str(x).replace("torch.", "") if not isinstance(x, type)
   else x.__name__)
def test_bwd_route(dtype, Lq, Lkv, Dh, route):
    """f32 calls with both lengths at most 64 (32 past head dim 128) take
    the one-pass kernel, every other call a pair: the tiled pair, or in
    bf16 past head dim 128 the wide wgmma pair ("tiled_wide"); a head dim no
    backward kernel takes (outside [1, 256]) raises."""
    if isinstance(route, type):
        with pytest.raises(route):
            fa_ops.bwd_route(dtype, Lq, Lkv, Dh)
    else:
        assert fa_ops.bwd_route(dtype, Lq, Lkv, Dh) == route


@pytest.mark.parametrize("dtype,Lq,Lkv,Dq,Dv,route", [
    (torch.bfloat16, 4096, 4096, 96, 64, "tiled_exact"),  # minicpm3-4b
    (torch.bfloat16, 600, 600, 80, 48, "tiled_exact"),
    (torch.bfloat16, 300, 300, 72, 8, "tiled_exact"),
    (torch.bfloat16, 300, 300, 104, 64, "tiled"),
    (torch.bfloat16, 300, 300, 96, 72, "tiled"),
    (torch.bfloat16, 300, 300, 64, 64, "tiled"),
    (torch.bfloat16, 300, 300, 128, 128, "tiled"),      # qwen3-14b
    (torch.bfloat16, 128, 128, 24, 16, "tiled"),        # --reduced MLA
    (torch.bfloat16, 300, 300, 64, 128, "tiled"),
    (torch.bfloat16, 4096, 4096, 192, 128, "tiled_wide"),  # deepseek-v2
    (torch.bfloat16, 4096, 4096, 256, 256, "tiled_wide"),  # paligemma-3b
    (torch.float32, 64, 64, 96, 64, "one_pass"),
    (torch.float32, 65, 65, 96, 64, "tiled"),
    (torch.float32, 64, 64, 192, 128, "tiled"),
    (torch.float32, 32, 32, 192, 128, "one_pass"),
    (torch.float32, 65, 65, 24, 16, "tiled"),
    # the f32 tiled pair past the one-pass band at each instance: DP 64,
    # 128 and 256 (which a call in (128, 192] takes)
    (torch.float32, 65, 64, 48, 64, "tiled"),
    (torch.float32, 64, 65, 64, 48, "tiled"),
    (torch.float32, 100, 100, 128, 96, "tiled"),
    (torch.float32, 33, 32, 192, 128, "tiled"),
    (torch.float32, 32, 33, 160, 160, "tiled"),
    (torch.float32, 33, 33, 200, 256, "tiled"),
    (torch.float32, 32, 32, 200, 256, "one_pass"),
    (torch.float32, 24, 24, 64, 257, ValueError),
    (torch.bfloat16, 24, 24, 0, 64, ValueError),
], ids=lambda x: str(x).replace("torch.", "") if not isinstance(x, type)
   else x.__name__)
def test_bwd_route_of_q_and_v_widths(dtype, Lq, Lkv, Dq, Dv, route):
    """The route of a call whose v head dim differs from the q/k one: the
    larger of the two decides the one-pass band (64 tokens up to 128, 32
    past it) and, in bf16, the wgmma pair (both up to 128; at the exact
    widths <96, 64> for Dq in (64, 96] with Dv <= 64, "tiled_exact") or
    the wide wgmma pair."""
    if isinstance(route, type):
        with pytest.raises(route):
            fa_ops.bwd_route(dtype, Lq, Lkv, Dq, Dv)
    else:
        assert fa_ops.bwd_route(dtype, Lq, Lkv, Dq, Dv) == route


@pytest.mark.parametrize("Dq,Dv", [(16, 16), (96, 64), (192, 128),
                                   (24, 16), (256, 256)])
@pytest.mark.parametrize("ragged", [False, True])
def test_bwd_check_refuses_only_kv_valid_len(Dq, Dv, ragged):
    """Named for the refusal it once held (kept so that its cases carry on
    under one name); it now checks the opposite. Every width the forward
    takes has a backward, with and without a ragged ``kv_valid_len``:
    under grad the call trains through ``FlashAttentionFn`` and matches
    ``jax.grad`` of the reference layer, at one kv head for two query
    heads, causal, with a short row (3 keys of 12) beside a full one."""
    q, k, v, do = _inputs(2, 12, 12, 2, 1, Dq, seed=Dq + Dv, Dv=Dv)
    kvl = np.array([12, 3], dtype=np.int32) if ragged else None

    def j_loss(q, k, v):
        return jnp.sum(JL.flash_attention(
            q, k, v, causal=True,
            kv_valid_len=None if kvl is None else jnp.asarray(kvl)) * do)
    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa_ops.flash_attention(
        *xs, causal=True, q_offset=0,
        kv_valid_len=None if kvl is None else torch.from_numpy(kvl))
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    for a, b in zip(torch.autograd.grad(out, xs, torch.from_numpy(do)), jg):
        _close(a.numpy(), b)


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_bwd_ref_is_the_autograd_of_attention_ref(mode):
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(1, Lq, Lkv, 6, 2, 8, seed=7))
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa_ref.attention_ref(*xs, **kw)
    want = torch.autograd.grad(out, xs, do)
    got = fa_ref.attention_bwd_ref(q, k, v, out.detach(), do, **kw)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy())
    # the error scale of the bf16 limit: 0 exactly where nothing is
    # attended, positive wherever a gradient has a term
    rss = fa_ref.attention_bwd_rss(q, k, v, out.detach(), do, **kw)
    mask = fa_ref.attention_mask(Lq, Lkv, causal=causal, window=window,
                                 prefix_len=prefix, q_offset=q_offset,
                                 kv_valid_len=None, device="cpu")[0]
    for r, seen in zip(rss, (mask.any(1), mask.any(0), mask.any(0))):
        assert bool((r.amax(dim=(0, 2, 3)) > 0).eq(seen).all())


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_bwd_ref_ragged_is_the_autograd_of_attention_ref(mode):
    """``attention_bwd_ref`` and ``attention_bwd_rss`` with a ragged
    ``kv_valid_len`` (``_ragged``: a full row, a short one, one of 0): the
    gradients of ``attention_ref`` under the same mask, zero past each
    row's keys, and the rss 0 exactly where nothing is attended."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(3, Lq, Lkv, 6, 2, 8, seed=9))
    kvl = torch.from_numpy(_ragged(3, Lkv))
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset, kv_valid_len=kvl)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa_ref.attention_ref(*xs, **kw)
    want = torch.autograd.grad(out, xs, do)
    got = fa_ref.attention_bwd_ref(q, k, v, out.detach(), do, **kw)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy())
    for b, n in enumerate(kvl.tolist()):
        assert bool((got[1][b, n:] == 0).all() and (got[2][b, n:] == 0).all())
    rss = fa_ref.attention_bwd_rss(q, k, v, out.detach(), do, **kw)
    mask = fa_ref.attention_mask(Lq, Lkv, causal=causal, window=window,
                                 prefix_len=prefix, q_offset=q_offset,
                                 kv_valid_len=kvl, device="cpu")
    for r, seen in zip(rss, (mask.any(2), mask.any(1), mask.any(1))):
        assert bool((r.amax(dim=(2, 3)) > 0).eq(seen).all())


@pytest.mark.parametrize("mode", list(MODES))
def test_padded_head_dim_route_of_the_backward(mode):
    """The route by which the bf16 kernels take a head dim that is not a
    multiple of 8 (``ops.bwd_operands``: every operand zero-padded to the
    next multiple, the scale the unpadded head dim's), held on the plain
    version: ``attention_bwd_ref`` of the padded operands, sliced back,
    equals it on the unpadded ones, and the padded columns of each
    gradient are 0."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(2, Lq, Lkv, 4, 2, 100, seed=3))
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset)
    o = fa_ref.attention_ref(q, k, v, **kw)
    padded = fa_ops.bwd_operands(q, k, v, o, do)
    assert all(t.shape[-1] == 104 and t.data_ptr() % 16 == 0
               for t in padded)
    got = fa_ref.attention_bwd_ref(*padded, scale=1 / math.sqrt(100), **kw)
    want = fa_ref.attention_bwd_ref(q, k, v, o, do, **kw)
    for a, b in zip(got, want):
        assert bool((a[..., 100:] == 0).all())
        _close(a[..., :100].numpy(), b.numpy())


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_bwd_operands_align_a_view_at_a_storage_offset(offset):
    """A contiguous bf16 view ``offset`` elements (2 bytes each) into its
    storage: a 16-byte aligned one passes as it is, a misaligned one is
    copied to an aligned tensor of the same values."""
    x = torch.randn(2 * 5 * 3 * 16 + offset).to(torch.bfloat16)
    view = x[offset:].view(2, 5, 3, 16)
    (out,) = fa_ops.bwd_operands(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)
    assert (out.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)


def test_without_grad_serving_takes_the_plain_forward():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 1, 8, 0))
    out = fa_ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        out = fa_ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


@pytest.mark.parametrize("case", ["dv", "dh", "kv_valid_len"])
def test_backward_modes_it_does_not_take_raise_under_grad(case):
    """Named for the error it once expected (kept so that its cases carry
    on under one name); it now checks the opposite. A ragged
    ``kv_valid_len`` under grad trains at
    the MLA pair (96, 64) ("dv"), at head dim 256 ("dh") and at 16: the
    call goes through ``FlashAttentionFn``, and its gradients equal
    autograd through ``ref.attention_ref`` with the same mask, within 1e-5
    of the largest |gradient|; serving, without grad, takes it too."""
    Dq, Dv = {"dv": (96, 64), "dh": (256, 256)}.get(case, (16, 16))
    g = torch.Generator().manual_seed(len(case))
    q = torch.randn(2, 4, 2, Dq, generator=g, requires_grad=True)
    k = torch.randn(2, 4, 2, Dq, generator=g, requires_grad=True)
    v = torch.randn(2, 4, 2, Dv, generator=g, requires_grad=True)
    do = torch.randn(2, 4, 2, Dv, generator=g)
    kvl = torch.tensor([3, 1])
    out = fa_ops.flash_attention(q, k, v, kv_valid_len=kvl)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(
        fa_ref.attention_ref(q, k, v, kv_valid_len=kvl), (q, k, v), do)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy())
    assert bool((got[1][:, 3:] == 0).all() and (got[2][1, 1:] == 0).all())
    with torch.no_grad():                 # serving takes them all
        fa_ops.flash_attention(q, k, v, kv_valid_len=kvl)


def test_refuse_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", None, x)
    refuse_grad("k", x.detach(), None)
    with torch.no_grad():
        refuse_grad("k", x)


def test_wkv6_plain_version_differentiates_on_the_cpu():
    """On CPU tensors under grad the WKV6 wrapper runs ``WKV6Fn``: its
    plain loop forward and the plain reverse recurrence
    (``wkv6_bwd_ref``) backward, which reach every input."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 5, 2, 4, generator=g, requires_grad=True)
               for _ in range(3))
    w = torch.rand(1, 5, 2, 4, generator=g)
    u = torch.randn(2, 4, generator=g)
    y, s = wkv6_ops.wkv6(r, k, v, w, u, torch.zeros(1, 2, 4, 4))
    assert type(y.grad_fn).__name__ == "WKV6FnBackward"
    grads = torch.autograd.grad((y.sum() + s.sum()), (r, k, v))
    assert all(bool(x.abs().sum() > 0) for x in grads)
