"""The training path on the card: the attention backward's kernels
(``csrc/flash_attention_bwd.cu``: the tiled pair (a) dQ, (b) dK/dV, the
wide bf16 pair past head dim 128, and the f32 one-pass kernel that
``ops.bwd_route`` sends f32 calls with Lq and Lkv at most 64 to) against
their plain version ``attention_bwd_ref`` in f32 and bf16, head dims 16, 64, 100, 112 and 128, GQA with 1, 5 and 8
query heads a kv head, every mask mode (causal, bidirectional, window,
prefix, cross attention with Lq != Lkv, an explicit q_offset, fully masked
rows), bf16 at the edges of the pair's 64-row tiles (L 1 to 4,095), the
one-pass kernel at its 32- and 64-row tiles' edges (L 1 to 64; 65 goes to
the pair), a misaligned bf16 view, a planted fault in each kernel that the
limit must catch, bit-identical repeats and the launch count by route;
the widths past Dq = Dv <= 128 (the MLA pairs (96, 64), (192, 128) and
(24, 16), and head dim 256 with paligemma's MQA) in every mask mode, at L
1 to 4,095, with planted faults and repeats; the wide pair at paligemma's
8 query heads of 256 with its 256-token prefix, a dropped 32-key tile of
(a) and a dropped 64-key CTA of (b); a ragged ``kv_valid_len`` (a full
row, a short one, one of 0) on every kernel family, against the plain
version with it and, as a planted fault, without it; the f32 tiled pair
at every instance (DP 64, 128, 256; equal and unequal head dims) around
its tiles (T - 1, T, T + 1, 2 T + 1), G 1, 5 and 8, in every mask mode,
with a ragged kv_valid_len and planted faults, each call repeated bit for
bit; ``FlashAttentionFn`` on CUDA
tensors (the backward kernels run, the plain backward does not); the
WKV6 backward kernel (K5-bwd) against ``wkv6_bwd_ref`` at K 16 and 64
with a carried state and a final-state cotangent, its planted fault and
repeats, and ``WKV6Fn`` on CUDA tensors; the checkpoints K5 writes for it
(y and the final state the same bits with and without them, the
checkpoints against ``wkv6_ckpt_ref``, K5-bwd from saved ones and from
none the same bits, checkpoints of other inputs caught) and K5-bwd's
cp.async staging of views the tensor maps cannot take; the kernels without a backward
(K1, K2, K3) refusing inputs that require grad; and one reduced train step
on the card against the same step on the CPU. The kernels have no CPU
mode, so these tests are marked ``gpu`` and skip without a CUDA device:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_train.py

Tolerances: f32 gradients within 1e-5 of the plain version's largest
|gradient| (fp32 FMAs summed in another order); bf16 within 2^-7 |plain|
+ 2^-5 x the row's rms of the root sum of squares of the gradient's terms
(``ref.attention_bwd_rss``: P and dS are bf16 operands of the
tensor-core products, and a gradient row can cancel to 0 where its terms
do not); the reduced f32 train step's loss at 1e-5 and each gradient leaf
within 1e-4 of its largest |gradient|; K5-bwd in f32 within 1e-5 of each
gradient's largest |gradient|, and in bf16 (dr, dk and dv rounded to bf16
by both) within 2^-7 |plain| more; K5's checkpoints within 1e-6 of the
largest |state| (an FMA against a product and a sum a step).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import BF16_RTOL, bf16_excess
from repro_torch.kernels.cosine_topk import ops as ctk_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref

pytestmark = pytest.mark.gpu

DEV = "cuda"
F32_RTOL = 1e-5
BF16_ROW_RTOL = 2.0 ** -5

# (Lq, Lkv, causal, window, prefix_len, q_offset)
MODES = {
    "causal": (200, 200, True, None, 0, None),
    "bidirectional": (150, 150, False, None, 0, None),
    "window": (300, 300, True, 70, 0, None),
    "prefix": (260, 260, True, None, 96, None),
    "cross": (77, 190, False, None, 0, None),
    "q_offset": (100, 230, True, None, 0, 40),
    "masked_rows": (90, 90, True, None, 0, -20),
}


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _inputs(B, Lq, Lkv, H, Hkv, D, dtype, seed, Dv=None, **kw):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=DEV).to(dtype)
               for shape in ((B, Lq, H, D), (B, Lkv, Hkv, D),
                             (B, Lkv, Hkv, D if Dv is None else Dv)))
    o = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    do = torch.randn(o.shape, generator=g, device=DEV).to(dtype)
    return q, k, v, o, do


def bwd_excess(got, plain, rss, dtype, exact_zero=()) -> float:
    """The largest error of the three gradients over its limit. In f32 a
    gradient whose index is in ``exact_zero`` (0 in exact arithmetic, so
    that its plain value is rounding noise: dq and dk where every row sees
    one key) is held to the largest |plain| of the three instead of its
    own."""
    if dtype == torch.float32:
        top = max(float(b.abs().max()) for b in plain)
        return max(float((a - b).abs().max()) / (F32_RTOL * (
            top if i in exact_zero else float(b.abs().max())))
            for i, (a, b) in enumerate(zip(got, plain)))
    return max(bf16_excess(a, b, BF16_ROW_RTOL, scale=m)
               for a, b, m in zip(got, plain, rss))


def _launches():
    fa = fa_ops.flash_attention
    return (fa.launches_bwd, fa.launches_bwd_f32,
            fa.launches_bwd_f32_one_pass)


def _new_launches():
    fa = fa_ops.flash_attention
    return fa.launches_bwd_dv, fa.launches_bwd_wide


def _check(B, Lq, Lkv, H, Hkv, D, dtype, seed, exact_zero=(), Dv=None,
           **kw):
    q, k, v, o, do = _inputs(B, Lq, Lkv, H, Hkv, D, dtype, seed, Dv, **kw)
    route = fa_ops.bwd_route(dtype, Lq, Lkv, D, Dv)
    one_pass = route == "one_pass"
    n = 1 if one_pass else 2          # launches: one kernel, or (a) and (b)
    bf16 = dtype == torch.bfloat16
    before, new = _launches(), _new_launches()
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + n,
                           before[1] + n * (dtype == torch.float32),
                           before[2] + one_pass)
    assert _new_launches() == (
        new[0] + n * (route in ("tiled", "tiled_exact") and bf16
                      and Dv not in (None, D)),
        new[1] + n * (route == "tiled_wide"))
    plain = fa_ref.attention_bwd_ref(q, k, v, o, do, **kw)
    rss = fa_ref.attention_bwd_rss(q, k, v, o, do, **kw)
    assert bwd_excess(got, plain, rss, dtype, exact_zero) <= 1.0
    return q, k, v, o, do, got, plain, rss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_backward_kernels_every_mask_mode(mode, dtype):
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    _check(2, Lq, Lkv, 10, 2, 64, dtype, seed=len(mode), causal=causal,
           window=window, prefix_len=prefix, q_offset=q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 64, 100, 112, 128])
@pytest.mark.parametrize("G", [1, 5, 8])
def test_backward_kernels_head_dims_and_groups(G, D, dtype):
    """Head dims padded to 64 or 128 in shared memory (16, 100 and 112 not
    multiples of the pad; 100 not of 8: its f32 rows take the element-wise
    loads, and its bf16 ones go to the kernels as a copy zero-padded to
    104, whose gradients are sliced back), G query heads a kv head summed
    into dk and dv."""
    _check(1, 129, 129, 2 * G, 2, D, dtype, seed=D + G, causal=True)


@pytest.mark.parametrize("D", [16, 64, 112, 128])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129, 4095])
def test_bf16_backward_at_tile_edges(L, G, D):
    """The bf16 kernels' 64-row tiles (a consumer's; a CTA takes two) at
    and around their edges, causal: the last tile ragged or whole, the
    diagonal tile shared by the two consumers or not, with the padded head
    dims 16 and 112 beside 64 and 128."""
    _check(1, L, L, 2 * G, 2, D, torch.bfloat16, seed=L + 10 * G + D,
           causal=True)


@pytest.mark.parametrize("mode", ["causal", "cross", "masked_rows"])
def test_bf16_backward_of_a_misaligned_view(mode):
    """q, k, v, o and do as contiguous views one element past a 16-byte
    boundary: the wrapper copies each to an aligned tensor for the tensor
    maps, and the gradients equal those of aligned copies bit for bit."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset)
    xs = _inputs(2, Lq, Lkv, 8, 2, 128, torch.bfloat16, 21, **kw)
    views = []
    for x in xs:
        base = torch.empty(x.numel() + 1, dtype=x.dtype, device=DEV)
        view = base[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16
        views.append(view)
    got = fa_ops.flash_attention_bwd(*views, **kw)
    want = fa_ops.flash_attention_bwd(*xs, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = fa_ref.attention_bwd_ref(*xs, **kw)
    rss = fa_ref.attention_bwd_rss(*xs, **kw)
    assert bwd_excess(got, plain, rss, torch.bfloat16) <= 1.0


def test_backward_at_qwen3_prefill_width():
    """qwen3-14b's heads (40 q, 8 kv, Dh 128) at a 1,024-token causal
    prefill in bf16; chip_smoke holds L = 4,096."""
    _check(1, 1024, 1024, 40, 8, 128, torch.bfloat16, seed=3, causal=True)


@pytest.mark.parametrize("shape,dtype,causal", [
    ((48, 24, 24, 12, 12, 64), torch.float32, False),    # the embedder
    ((8, 128, 128, 4, 4, 16), torch.bfloat16, True)],    # reduced qwen3
    ids=["embedder_f32", "reduced_qwen3_bf16"])
def test_backward_at_the_trainers_shapes(shape, dtype, causal):
    """The calls ``launch.train_embedder --full`` and ``launch.train
    --reduced`` make on the card."""
    _check(*shape, dtype, seed=7, causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_planted_faults_exceed_the_limit(dtype):
    """(a) without one 64-key tile in pass 2 and (b) without one kv tile's
    CTA: the plain version made so must fail the limit against the right
    kernel output."""
    kw = dict(causal=True)
    q, k, v, o, do, got, plain, rss = _check(1, 256, 256, 8, 2, 64, dtype,
                                              seed=11, **kw)
    t0, t1 = 64, 128
    p, dp, dsum, _, _, scale = fa_ref._bwd_terms(q, k, v, o, do, True, None,
                                                 0, None)
    ds = (p * (dp - dsum))[..., t0:t1]
    part = torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, t0:t1].float())
    dq_fault = (plain[0].float() - part.reshape(q.shape) * scale).to(dtype)
    dk_fault = plain[1].clone()
    dk_fault[:, t0:t1] = 0
    assert bwd_excess(got, (dq_fault, plain[1], plain[2]), rss, dtype) > 1
    assert bwd_excess(got, (plain[0], dk_fault, plain[2]), rss, dtype) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_is_deterministic(dtype):
    q, k, v, o, do = _inputs(1, 300, 300, 8, 2, 128, dtype, 5, causal=True)
    a = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=True)
    b = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=True)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert x.data_ptr() != y.data_ptr() and torch.equal(x, y)


# one-tile calls, which f32 sends to the one-pass kernel: (Lq, Lkv, causal,
# window, prefix_len, q_offset); the 32-row tile where both lengths are at
# most 32, else the 64-row one
SHORT_MODES = {
    "causal": (24, 24, True, None, 0, None),
    "bidirectional": (24, 24, False, None, 0, None),
    "causal_64": (57, 57, True, None, 0, None),
    "window": (60, 60, True, 9, 0, None),
    "window_32": (30, 30, True, 5, 0, None),
    "prefix": (40, 40, True, None, 13, None),
    "cross": (13, 37, False, None, 0, None),
    "cross_long_q": (50, 20, False, None, 0, None),
    "q_offset": (10, 31, True, None, 0, 21),
    "masked_rows": (30, 30, True, None, 0, -7),
    "masked_rows_64": (64, 48, True, 16, 0, -20),
}


@pytest.mark.parametrize("mode", list(SHORT_MODES))
def test_one_pass_every_mask_mode(mode):
    Lq, Lkv, causal, window, prefix, q_offset = SHORT_MODES[mode]
    assert fa_ops.bwd_route(torch.float32, Lq, Lkv, 64) == "one_pass"
    _check(3, Lq, Lkv, 10, 2, 64, torch.float32, seed=40 + len(mode),
           causal=causal, window=window, prefix_len=prefix,
           q_offset=q_offset)


@pytest.mark.parametrize("D", [16, 64, 100, 112, 128])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("L", [1, 24, 31, 32, 33, 64, 65])
def test_f32_backward_at_the_one_pass_edges(L, G, D):
    """f32 at and around the one-pass kernel's tiles (32 rows and keys up
    to 32, else 64; 65 goes to the tiled pair), causal, G query heads a kv
    head summed into dk and dv in the one CTA, head dims padded to 64 or
    128 (16, 100 and 112 short of their pad). At L = 1 the one key a row
    makes dS = 0, so dq and dk are 0 in exact arithmetic and are held to
    the largest |gradient| of the three."""
    _check(2, L, L, 2 * G, 2, D, torch.float32, seed=L + 10 * G + D,
           exact_zero=(0, 1) if L == 1 else (), causal=True)


def test_one_pass_is_deterministic_and_catches_planted_faults():
    """At the embedder's call (B 48 x 24, 12 heads of 64, bidirectional):
    two calls bit-identical with fresh outputs; dQ without 8 keys of its
    sum and dK with 8 rows zeroed must each fail the limit against the
    right output."""
    kw = dict(causal=False)
    q, k, v, o, do, got, plain, rss = _check(48, 24, 24, 12, 12, 64,
                                              torch.float32, seed=13, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert x.data_ptr() != y.data_ptr() and torch.equal(x, y)
    t0, t1 = 8, 16
    p, dp, dsum, _, _, scale = fa_ref._bwd_terms(q, k, v, o, do, False, None,
                                                 0, None)
    ds = (p * (dp - dsum))[..., t0:t1]
    part = torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, t0:t1].float())
    dq_fault = got[0] - part.reshape(q.shape) * scale
    dk_fault = got[1].clone()
    dk_fault[:, t0:t1] = 0
    f32 = torch.float32
    assert bwd_excess((dq_fault, got[1], got[2]), plain, rss, f32) > 1
    assert bwd_excess((got[0], dk_fault, got[2]), plain, rss, f32) > 1


@pytest.mark.parametrize("D", [30, 64])
def test_one_pass_with_four_byte_copies(D):
    """Views one element past a 16-byte boundary, and a head dim of 30 (not
    a multiple of 4), take the one-pass kernel's 4-byte copies and scalar
    stores; the gradients of the misaligned views equal those of aligned
    copies bit for bit."""
    kw = dict(causal=True, q_offset=3)
    xs = _inputs(2, 20, 23, 8, 4, D, torch.float32, 17, **kw)
    views = []
    for x in xs:
        base = torch.empty(x.numel() + 1, dtype=x.dtype, device=DEV)
        view = base[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16
        views.append(view)
    before = _launches()
    got = fa_ops.flash_attention_bwd(*views, **kw)
    want = fa_ops.flash_attention_bwd(*xs, **kw)
    torch.cuda.synchronize()
    assert _launches()[2] == before[2] + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = fa_ref.attention_bwd_ref(*xs, **kw)
    rss = fa_ref.attention_bwd_rss(*xs, **kw)
    assert bwd_excess(got, plain, rss, torch.float32) <= 1.0


def test_flash_attention_fn_takes_the_one_pass_kernel():
    """The embedder's route: f32 attention of 24 tokens under autograd runs
    K4 forward and one one-pass backward launch, never the plain
    backward."""
    q, k, v, _, do = _inputs(4, 24, 24, 12, 12, 64, torch.float32, 8,
                             causal=False)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_calls = fa_ref.attention_bwd_ref.calls
    before = _launches()
    out = fa_ops.flash_attention(*xs, causal=False)
    grads = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert _launches() == tuple(x + 1 for x in before)
    assert fa_ref.attention_bwd_ref.calls == plain_calls
    want = fa_ops.flash_attention_bwd(q, k, v, out.detach(), do,
                                      causal=False)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


def test_flash_attention_fn_runs_the_backward_kernels():
    q, k, v, _, do = _inputs(2, 96, 96, 8, 4, 64, torch.bfloat16, 6,
                             causal=True)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_calls = fa_ref.attention_bwd_ref.calls
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.launches_bwd)
    out = fa_ops.flash_attention(*xs, causal=True)
    grads = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before[0] + 1
    assert fa_ops.flash_attention.launches_bwd == before[1] + 2
    assert fa_ref.attention_bwd_ref.calls == plain_calls
    want = fa_ops.flash_attention_bwd(q, k, v, out.detach(), do)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


# the widths past Dq = Dv <= 128 (Dq, Dv): minicpm3-4b's and deepseek-v2's
# MLA pairs, launch.train --reduced's MLA, paligemma-3b's 256
WIDTHS = {"96x64": (96, 64), "192x128": (192, 128), "24x16": (24, 16),
          "256": (256, 256)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("mode", list(MODES))
def test_new_widths_every_mask_mode(mode, width, dtype):
    """q/k of Dq with v of Dv, and head dim 256, in every mask mode: the
    bf16 wgmma pair at (96, 64) and (24, 16), the bf16 wide pair at (192,
    128) and 256, the f32 tiled pair at all four."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    Dq, Dv = WIDTHS[width]
    _check(2, Lq, Lkv, 8, 2, Dq, dtype, seed=len(mode) + Dq, Dv=Dv,
           causal=causal, window=window, prefix_len=prefix,
           q_offset=q_offset)


# every mask mode at L queries: (keys past L, mask)
EDGE_MODES = {"causal": (0, dict(causal=True)),
              "bidirectional": (0, dict(causal=False)),
              "window": (0, dict(causal=True, window=37)),
              "prefix": (0, dict(causal=True, prefix_len=40)),
              "cross": (37, dict(causal=False)),
              "q_offset": (40, dict(causal=True, q_offset=40)),
              "masked_rows": (0, dict(causal=True, q_offset=-20))}


@pytest.mark.parametrize("mode", list(EDGE_MODES))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("L", [1, 31, 33, 63, 64, 65, 97, 127, 128, 129,
                               4095])
def test_new_widths_bf16_at_tile_edges(L, width, mode):
    """bf16 at the new widths around the pairs' tiles (64 rows; the wide
    pair's (a) at 256 takes keys 32 at a time, its (b) 64 keys a CTA), in
    every mask mode, one kv head for 8 query heads (paligemma's MQA); at
    4,095 tokens two heads only."""
    Dq, Dv = WIDTHS[width]
    extra, kw = EDGE_MODES[mode]
    H = 2 if L == 4095 else 8
    _check(1, L, L + extra, H, 1, Dq, torch.bfloat16, seed=L + Dq, Dv=Dv,
           **kw)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("L", [1, 24, 31, 32, 33, 64, 65])
def test_new_widths_f32_at_the_one_pass_edges(L, width):
    """f32 at the one-pass band's edges (64 tokens up to head dim 128, 32
    past it) at the new widths; at L = 1 dq and dk are 0 in exact
    arithmetic and are held to the largest |gradient| of the three."""
    Dq, Dv = WIDTHS[width]
    _check(2, L, L, 10, 2, Dq, torch.float32, seed=L + Dq, Dv=Dv,
           exact_zero=(0, 1) if L == 1 else (), causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_new_widths_planted_faults_and_repeats(width, dtype):
    """A dQ without one 64-key tile and a dK with those rows zeroed must
    each fail the limit against the right output; a second call repeats
    the first bit for bit."""
    Dq, Dv = WIDTHS[width]
    kw = dict(causal=True)
    q, k, v, o, do, got, plain, rss = _check(1, 256, 256, 8, 2, Dq, dtype,
                                              seed=19, Dv=Dv, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert x.data_ptr() != y.data_ptr() and torch.equal(x, y)
    t0, t1 = 64, 128
    p, dp, dsum, _, _, scale = fa_ref._bwd_terms(q, k, v, o, do, True, None,
                                                 0, None)
    ds = (p * (dp - dsum))[..., t0:t1]
    part = torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, t0:t1].float())
    dq_fault = (got[0].float() - part.reshape(q.shape) * scale).to(dtype)
    dk_fault = got[1].clone()
    dk_fault[:, t0:t1] = 0
    assert bwd_excess((dq_fault, got[1], got[2]), plain, rss, dtype) > 1
    assert bwd_excess((got[0], dk_fault, got[2]), plain, rss, dtype) > 1


@pytest.mark.parametrize("width", ["192x128", "256"])
def test_wide_pair_at_paligemmas_layout(width):
    """The wide pair at paligemma-3b's 8 query heads for one kv head with
    its 256-token prefix, 600 tokens (not a multiple of 64): within the
    limit, two calls bit-identical, and (a) without one of its key tiles
    (32 keys at 256, 64 at (192, 128)) or (b) without one 64-key CTA's dK
    or dV (at 256 a CTA there writes half the columns) must fail it."""
    Dq, Dv = WIDTHS[width]
    kw = dict(causal=True, prefix_len=256)
    q, k, v, o, do, got, plain, rss = _check(1, 600, 600, 8, 1, Dq,
                                              torch.bfloat16, seed=23, Dv=Dv,
                                              **kw)
    assert fa_ops.bwd_route(torch.bfloat16, 600, 600, Dq, Dv) == "tiled_wide"
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert x.data_ptr() != y.data_ptr() and torch.equal(x, y)
    bk = 32 if Dq > 192 else 64
    p, dp, dsum, _, _, scale = fa_ref._bwd_terms(q, k, v, o, do, True, None,
                                                 256, None)
    t0, t1 = 288, 288 + bk          # past the prefix, on the diagonal band
    ds = (p * (dp - dsum))[..., t0:t1]
    part = torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, t0:t1].float())
    dq_fault = (got[0].float() - part.reshape(q.shape) * scale).to(q.dtype)
    dk_fault, dv_fault = got[1].clone(), got[2].clone()
    dk_fault[:, 320:384, :, :Dq // 2] = 0
    dv_fault[:, 320:384, :, :Dv // 2] = 0
    for fault in ((dq_fault, got[1], got[2]), (got[0], dk_fault, got[2]),
                  (got[0], got[1], dv_fault)):
        assert bwd_excess(fault, plain, rss, torch.bfloat16) > 1


@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 8)], ids=["split", "whole"])
def test_wide_dkv_whole_and_split_columns(B, Hkv):
    """The wide pair's (b) at 256: one kv head (10 CTAs of 64 keys, at most
    one an SM) splits dK's and dV's columns across two CTAs, 4 x 8 kv
    heads (160 CTAs, more than an H100's 132 SMs) keep them whole; both
    within the limit, with a prefix, and two calls bit-identical."""
    kw = dict(causal=True, prefix_len=40)
    q, k, v, o, do, got, _, _ = _check(B, 600 if B == 1 else 300,
                                       600 if B == 1 else 300, 2 * Hkv, Hkv,
                                       256, torch.bfloat16, seed=29, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y)


# the f32 tiled pair's instances: (Dq, Dv) at DP 64, 128 and 256 (a call
# in (128, 192] runs at 256), equal and unequal widths
F32_TILED_WIDTHS = {"64": (64, 64), "48x64": (48, 64), "128": (128, 128),
                    "96x64": (96, 64), "64x128": (64, 128),
                    "192x128": (192, 128), "256": (256, 256),
                    "200x256": (200, 256)}


def _f32_tiled(B, L, H, Hkv, width, seed, **kw):
    """``_check`` of an f32 call that takes the tiled pair (L query rows;
    keys L, or L + 64 where L alone would take the one-pass kernel, the
    queries right-aligned), and a second call bit for bit."""
    Dq, Dv = F32_TILED_WIDTHS[width]
    Lkv = L
    if fa_ops.bwd_route(torch.float32, L, L, Dq, Dv) != "tiled":
        Lkv = L + 64
        kw.setdefault("q_offset", 64)
    assert fa_ops.bwd_route(torch.float32, L, Lkv, Dq, Dv) == "tiled"
    out = _check(B, L, Lkv, H, Hkv, Dq, torch.float32, seed, Dv=Dv, **kw)
    q, k, v, o, do, got = out[:6]
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert x.data_ptr() != y.data_ptr() and torch.equal(x, y)
    return out


@pytest.mark.parametrize("width", list(F32_TILED_WIDTHS))
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("L", [31, 32, 33, 63, 64, 65, 127, 128, 129])
def test_f32_tiled_pair_at_tile_edges(L, G, width):
    """The f32 tiled pair around its tiles (T - 1, T, T + 1 and 2 T + 1 of
    (a)'s 64 q rows and keys a step, 32 past head dim 128, and of (b)'s 32
    keys a CTA), causal, G query heads a kv head, every instance with equal
    and unequal head dims: within the limit and bit-identical twice."""
    _f32_tiled(1, L, 2 * G, 2, width, seed=L + 10 * G + len(width),
               causal=True)


@pytest.mark.parametrize("width", list(F32_TILED_WIDTHS))
@pytest.mark.parametrize("mode", list(MODES))
def test_f32_tiled_pair_every_mask_mode(mode, width):
    """The f32 tiled pair in every mask mode (heavy-first grids: (a)'s last
    q tile first, (b)'s first key tile first) at every instance."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    Dq, Dv = F32_TILED_WIDTHS[width]
    _check(2, Lq, Lkv, 8, 2, Dq, torch.float32, seed=len(mode) + Dq, Dv=Dv,
           causal=causal, window=window, prefix_len=prefix,
           q_offset=q_offset)


@pytest.mark.parametrize("mask", ["causal", "prefix", "window"])
@pytest.mark.parametrize("width", list(F32_TILED_WIDTHS))
def test_f32_tiled_pair_ragged(width, mask):
    """A ragged kv_valid_len (a full row, one that ends inside a 32-key
    tile, one of 0) on every instance: within the limit, zero dk and dv at
    and past each row's end; the plain version without it must fail."""
    L = 200
    kvl = torch.tensor([L, L // 2 + 5, 0], device=DEV)
    kw = dict(RAGGED_MASKS[mask], kv_valid_len=kvl)
    q, k, v, o, do, got, plain, rss = _f32_tiled(3, L, 8, 2, width,
                                                 seed=L + len(width), **kw)
    for b, n in enumerate(kvl.tolist()):
        assert bool((got[1][b, n:] == 0).all() and (got[2][b, n:] == 0).all())
    assert all(bool((g[2] == 0).all()) for g in got)
    kw.pop("kv_valid_len")
    ignored = fa_ref.attention_bwd_ref(q, k, v, o, do, **kw)
    assert bwd_excess(got, ignored, rss, torch.float32) > 1


@pytest.mark.parametrize("width", list(F32_TILED_WIDTHS))
def test_f32_tiled_pair_planted_faults(width):
    """(a) without one of its key tiles (64 keys a step, 32 past head dim
    128) and (b) without one 32-key CTA's dK or dV: each made from the
    kernel's output must fail the limit."""
    Dq, Dv = F32_TILED_WIDTHS[width]
    kw = dict(causal=True)
    q, k, v, o, do, got, plain, rss = _f32_tiled(1, 256, 8, 2, width,
                                                 seed=31, **kw)
    bk = 32 if max(Dq, Dv) > 128 else 64
    p, dp, dsum, _, _, scale = fa_ref._bwd_terms(q, k, v, o, do, True, None,
                                                 0, None)
    ds = (p * (dp - dsum))[..., 64:64 + bk]
    part = torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, 64:64 + bk].float())
    dq_fault = got[0] - part.reshape(q.shape) * scale
    dk_fault, dv_fault = got[1].clone(), got[2].clone()
    dk_fault[:, 96:128] = 0
    dv_fault[:, 96:128] = 0
    for fault in ((dq_fault, got[1], got[2]), (got[0], dk_fault, got[2]),
                  (got[0], got[1], dv_fault)):
        assert bwd_excess(fault, plain, rss, torch.float32) > 1


# a ragged kv_valid_len on each kernel family: (dtype, B, L, H, Hkv, Dq, Dv)
RAGGED_FAMILIES = {
    "one_pass": (torch.float32, 3, 40, 8, 2, 64, 64),
    "one_pass_256": (torch.float32, 3, 24, 4, 1, 256, 256),
    "tiled_f32": (torch.float32, 3, 200, 8, 2, 64, 64),
    "tiled_f32_192x128": (torch.float32, 3, 150, 4, 2, 192, 128),
    "tiled_bf16": (torch.bfloat16, 3, 300, 8, 2, 128, 128),
    "tiled_bf16_96x64": (torch.bfloat16, 3, 300, 8, 2, 96, 64),
    "wide_192x128": (torch.bfloat16, 3, 300, 8, 2, 192, 128),
    "wide_256": (torch.bfloat16, 3, 300, 8, 1, 256, 256),
}
RAGGED_MASKS = {"causal": dict(causal=True),
                "bidirectional": dict(causal=False),
                "prefix": dict(causal=True, prefix_len=19),
                "window": dict(causal=True, window=29)}


@pytest.mark.parametrize("mask", list(RAGGED_MASKS))
@pytest.mark.parametrize("family", list(RAGGED_FAMILIES))
def test_ragged_kv_valid_len_every_family(family, mask):
    """Each kernel family with kv_valid_len (a full row, one that ends
    inside a tile, one of 0) against ``attention_bwd_ref`` with it: within
    the limit, zero dk and dv at and past each row's end, zero gradients
    in the row of 0; the plain version without kv_valid_len (a kernel that
    ignored it) must fail the limit."""
    dtype, B, L, H, Hkv, Dq, Dv = RAGGED_FAMILIES[family]
    kvl = torch.tensor([L, L // 2 + 5, 0], device=DEV)
    kw = dict(RAGGED_MASKS[mask], kv_valid_len=kvl)
    q, k, v, o, do, got, plain, rss = _check(B, L, L, H, Hkv, Dq, dtype,
                                              seed=L + Dq, Dv=Dv, **kw)
    for b, n in enumerate(kvl.tolist()):
        assert bool((got[1][b, n:] == 0).all() and (got[2][b, n:] == 0).all())
    assert all(bool((g[2] == 0).all()) for g in got)
    kw.pop("kv_valid_len")
    ignored = fa_ref.attention_bwd_ref(q, k, v, o, do, **kw)
    assert bwd_excess(got, ignored, rss, dtype) > 1


def test_flash_attention_fn_ragged_on_the_card():
    """Under autograd a ragged kv_valid_len runs K4 and the backward
    kernels with it, never the plain backward, and the gradients equal a
    direct ``flash_attention_bwd`` call."""
    kvl = torch.tensor([200, 77], device=DEV)
    q, k, v, _, do = _inputs(2, 200, 200, 8, 1, 256, torch.bfloat16, 31,
                             causal=True, kv_valid_len=kvl)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_calls = fa_ref.attention_bwd_ref.calls
    before = fa_ops.flash_attention.launches_bwd_wide
    out = fa_ops.flash_attention(*xs, causal=True, kv_valid_len=kvl)
    grads = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches_bwd_wide == before + 2
    assert fa_ref.attention_bwd_ref.calls == plain_calls
    want = fa_ops.flash_attention_bwd(q, k, v, out.detach(), do,
                                      causal=True, kv_valid_len=kvl)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", ["96x64", "256"])
def test_flash_attention_fn_at_the_new_widths(width):
    """Under autograd the MLA pair and head dim 256 run K4's forward and
    the backward kernels, never the plain backward; at (96, 64) the
    forward writes the LSE (flash_bf16_persistent_lse) and the backward is
    the exact-width pair from it, the same bits as a direct call given
    that LSE."""
    Dq, Dv = WIDTHS[width]
    q, k, v, _, do = _inputs(1, 200, 200, 8, 1, Dq, torch.bfloat16, 9, Dv,
                             causal=True, prefix_len=30)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    f = fa_ops.flash_attention
    plain_calls = fa_ref.attention_bwd_ref.calls
    before = (f.launches_bwd, f.launches_bwd_exact, f.launches_lse)
    out = fa_ops.flash_attention(*xs, causal=True, prefix_len=30)
    grads = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    exact = width == "96x64"
    assert (f.launches_bwd, f.launches_bwd_exact, f.launches_lse) == (
        before[0] + 2, before[1] + 2 * exact, before[2] + exact)
    assert fa_ref.attention_bwd_ref.calls == plain_calls
    lse = None
    if exact:
        o, lse = fa_ops._forward(q, k, v, True, None, 30, 0, None,
                                 with_lse=True)
        assert torch.equal(o, out.detach())
    want = fa_ops.flash_attention_bwd(q, k, v, out.detach(), do,
                                      causal=True, prefix_len=30, lse=lse)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


# -- the exact-width pair <96, 64> from the LSE K4's training forward writes
LSE_WIDTHS = {"96x64": (96, 64), "80x48": (80, 48)}
LSE_ATOL = 2.0 ** -10   # the kernel's LSE against the plain one, log2 units:
                        # f32 sums of f32 products of the same bf16 values
                        # in another order, ex2 on the SFU (2^-22 relative)


def _lse_inputs(B, Lq, Lkv, H, Hkv, Dq, Dv, seed, **kw):
    """Seeded bf16 q, k, v and do, and K4's training forward on them: o and
    the LSE it wrote."""
    q, k, v, _, do = _inputs(B, Lq, Lkv, H, Hkv, Dq, torch.bfloat16, seed,
                             Dv, **kw)
    if kw.get("q_offset") is None:
        kw["q_offset"] = Lkv - Lq
    o, lse = fa_ops._forward(q, k, v, kw.get("causal", True),
                             kw.get("window"), kw.get("prefix_len", 0),
                             kw["q_offset"], kw.get("kv_valid_len"),
                             with_lse=True)
    return q, k, v, o, do, lse


def _lse_check(B, Lq, Lkv, H, Hkv, Dq, Dv, seed, **kw):
    """K4-Dv's training forward and the exact-width pair from its LSE: the
    forward's o the same bits as the serving kernel's, its LSE within
    LSE_ATOL of ``ref.attention_lse`` (+inf exactly where the plain one
    is), and the backward from it and the one with pass 1 (no saved LSE)
    each within the bf16 limit of the plain backward, with their
    launches counted."""
    if kw.get("q_offset") is None:
        kw["q_offset"] = Lkv - Lq
    q, k, v, o, do, lse = _lse_inputs(B, Lq, Lkv, H, Hkv, Dq, Dv, seed, **kw)
    served = fa_ops._forward(q, k, v, kw.get("causal", True),
                             kw.get("window"), kw.get("prefix_len", 0),
                             kw["q_offset"], kw.get("kv_valid_len"))
    torch.cuda.synchronize()
    assert torch.equal(o, served)
    plain_lse = fa_ref.attention_lse(q, k, **kw)
    inf = torch.isposinf(plain_lse)
    assert torch.equal(torch.isposinf(lse), inf)
    diff = (lse - plain_lse)[~inf].abs()
    assert diff.numel() == 0 or float(diff.max()) <= LSE_ATOL
    f = fa_ops.flash_attention
    before = (f.launches_bwd, f.launches_bwd_dv, f.launches_bwd_exact)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    one_pass1 = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert (f.launches_bwd, f.launches_bwd_dv, f.launches_bwd_exact) == (
        before[0] + 4, before[1] + 4, before[2] + 3)
    plain = fa_ref.attention_bwd_ref(q, k, v, o, do, **kw)
    rss = fa_ref.attention_bwd_rss(q, k, v, o, do, **kw)
    assert bwd_excess(got, plain, rss, torch.bfloat16) <= 1.0
    assert bwd_excess(one_pass1, plain, rss, torch.bfloat16) <= 1.0
    return q, k, v, o, do, lse, got, plain, rss


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("width", list(LSE_WIDTHS))
@pytest.mark.parametrize("mode", list(MODES))
def test_exact_pair_from_saved_lse_every_mask_mode(mode, width, ragged):
    """Every mask mode at (96, 64) and (80, 48), one kv head for four
    query heads, without and with a ragged kv_valid_len (a full row, one
    that ends inside a tile, one of 0): ``_lse_check``."""
    Lq, Lkv, causal, window, prefix, q_offset = MODES[mode]
    Dq, Dv = LSE_WIDTHS[width]
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              q_offset=q_offset)
    B = 3 if ragged else 2
    if ragged:
        kw["kv_valid_len"] = torch.tensor([Lkv, Lkv // 2 + 5, 0][:B],
                                          device=DEV)
    *_, got, _, _ = _lse_check(B, Lq, Lkv, 8, 2, Dq, Dv, seed=len(mode) + Dq,
                               **kw)
    if ragged:
        assert all(bool((g[2] == 0).all()) for g in got)


@pytest.mark.parametrize("mode", list(EDGE_MODES))
@pytest.mark.parametrize("L", [1, 31, 33, 63, 64, 65, 97, 127, 128, 129,
                               191, 192, 193, 255, 257, 1000, 4095])
def test_exact_pair_from_saved_lse_at_tile_edges(L, mode):
    """(96, 64) around the forward's 128-row q tiles and 192-key kv tiles
    and the backward's 64-row and 64-key tiles, in every mask mode, one
    kv head for 8 query heads (2 at 4,095 tokens): ``_lse_check``."""
    extra, kw = EDGE_MODES[mode]
    _lse_check(1, L, L + extra, 2 if L == 4095 else 8, 1, 96, 64, seed=L,
               **dict(kw))


@pytest.mark.parametrize("width", list(LSE_WIDTHS))
def test_exact_pair_planted_faults_and_repeats(width):
    """From a saved LSE: two calls bit-identical; a dQ without one 64-key
    tile, a dK with those rows zeroed, and the backward from the LSE of
    other inputs (q moved by one in its fifth column) must each fail the
    limit; a kernel LSE that lost one 64-key tile's terms must fail
    LSE_ATOL."""
    Dq, Dv = LSE_WIDTHS[width]
    kw = dict(causal=True)
    q, k, v, o, do, lse, got, plain, rss = _lse_check(
        1, 256, 256, 8, 2, Dq, Dv, seed=37, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert x.data_ptr() != y.data_ptr() and torch.equal(x, y)
    t0, t1 = 64, 128
    p, dp, dsum, _, _, scale = fa_ref._bwd_terms(q, k, v, o, do, True, None,
                                                 0, None)
    ds = (p * (dp - dsum))[..., t0:t1]
    part = torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, t0:t1].float())
    dq_fault = (got[0].float() - part.reshape(q.shape) * scale).to(q.dtype)
    dk_fault = got[1].clone()
    dk_fault[:, t0:t1] = 0
    assert bwd_excess((dq_fault, got[1], got[2]), plain, rss,
                      torch.bfloat16) > 1
    assert bwd_excess((got[0], dk_fault, got[2]), plain, rss,
                      torch.bfloat16) > 1
    q2 = q.clone()
    q2[..., 4] += 1
    other = fa_ops._forward(q2, k, v, True, None, 0, 0, None,
                            with_lse=True)[1]
    wrong = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=other, **kw)
    assert bwd_excess(wrong, plain, rss, torch.bfloat16) > 1
    # the plain LSE without the tile's keys, on the rows that see them
    B, L, H, _ = q.shape
    Hkv = k.shape[2]
    sc = torch.einsum("bqhgd,bkhd->bhgqk",
                      q.float().reshape(B, L, Hkv, H // Hkv, Dq),
                      k.float()) * scale
    mask = fa_ref.attention_mask(L, L, causal=True, window=None,
                                 prefix_len=0, q_offset=0, kv_valid_len=None,
                                 device=DEV)[:, None, None].clone()
    mask[..., t0:t1] = False
    cut = torch.logsumexp(sc.masked_fill(~mask, float("-inf")), dim=-1) \
        * fa_ref.LOG2E
    assert float((lse[..., t1:L] - cut.reshape(B, H, L)[..., t1:])
                 .abs().max()) > LSE_ATOL


def test_saved_lse_refused_off_the_class():
    """A saved LSE on another route, or of the wrong shape, raises before
    any launch; the forward writes none off the class."""
    q, k, v, o, do = _inputs(1, 100, 100, 4, 2, 128, torch.bfloat16, 3,
                             causal=True)
    lse = torch.zeros((1, 4, 128), device=DEV)
    with pytest.raises(ValueError, match="tiled_exact"):
        fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    with pytest.raises(ValueError, match="writes the LSE"):
        fa_ops._forward(q, k, v, True, None, 0, 0, None, with_lse=True)
    q, k, v, o, do, lse = _lse_inputs(1, 100, 100, 4, 2, 96, 64, 3,
                                      causal=True)
    with pytest.raises(ValueError, match="lse must be"):
        fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse[..., :100])


def _wkv6_inputs(B, L, H, K, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    r, k, v = (torch.randn((B, L, H, K), generator=g, device=DEV).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((B, L, H, K), generator=g,
                                        device=DEV) * 4 - 3))
    u = torch.randn((H, K), generator=g, device=DEV)
    s = torch.randn((B, H, K, K), generator=g, device=DEV)
    dy = torch.randn((B, L, H, K), generator=g, device=DEV)
    ds = torch.randn((B, H, K, K), generator=g, device=DEV)
    return (r, k, v, w, u, s), dy, ds


def wkv6_excess(got, plain) -> float:
    """The largest error of the six gradients over its limit: 1e-5 of the
    gradient's largest |plain|, plus 2^-7 |plain| where both round it to
    bf16."""
    out = 0.0
    for a, b in zip(got, plain):
        lim = F32_RTOL * float(b.float().abs().max()) + (
            BF16_RTOL * b.float().abs() if a.dtype == torch.bfloat16 else 0)
        d = (a.float() - b.float()).abs()
        out = max(out, float((d / lim).max()) if float(d.max()) else 0.0)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [16, 33, 64])
@pytest.mark.parametrize("L", [1, 17, 100])
@pytest.mark.parametrize("cot", [False, True], ids=["y", "y_and_state"])
def test_wkv6_backward_kernel_matches_plain(cot, L, K, dtype):
    """K5-bwd against ``wkv6_bwd_ref`` with a carried state, the cotangent
    of y alone or also of the final state: one launch, every gradient
    within the limit, and a second call bit-identical."""
    xs, dy, ds = _wkv6_inputs(2, L, 3, K, dtype, seed=L + K)
    ds = ds if cot else None
    n = wkv6_ops.wkv6.launches_bwd
    got = wkv6_ops.wkv6_bwd(*xs, dy, ds)
    again = wkv6_ops.wkv6_bwd(*xs, dy, ds)
    torch.cuda.synchronize()
    assert wkv6_ops.wkv6.launches_bwd == n + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    plain = wkv6_ref.wkv6_bwd_ref(*xs, dy, ds)
    assert [g.dtype for g in got] == [g.dtype for g in plain]
    assert wkv6_excess(got, plain) <= 1.0


def test_wkv6_backward_kernel_catches_a_planted_fault():
    """The plain backward with one step's dy dropped must fail the limit
    against the kernel's output."""
    xs, dy, ds = _wkv6_inputs(1, 300, 4, 64, torch.float32, seed=3)
    got = wkv6_ops.wkv6_bwd(*xs, dy, ds)
    faulty = dy.clone()
    faulty[:, 150] = 0
    plain = wkv6_ref.wkv6_bwd_ref(*xs, faulty, ds)
    assert wkv6_excess(got, plain) > 1.0


def test_wkv6_fn_runs_the_backward_kernel():
    """Under autograd WKV6 runs K5 forward (with its checkpoint writes)
    and K5-bwd once each; the gradients equal a direct ``wkv6_bwd`` call,
    u's cast back to bf16."""
    xs, dy, _ = _wkv6_inputs(1, 40, 2, 64, torch.bfloat16, seed=4)
    r, k, v, w, u, s = xs
    u = u.to(torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    f = wkv6_ops.wkv6
    before = (f.launches, f.launches_ckpt, f.launches_bwd)
    y, _ = wkv6_ops.wkv6(*leaves, s)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_ckpt, f.launches_bwd) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    want = wkv6_ops.wkv6_bwd(r, k, v, w, u.float(), s, dy)
    for a, b in zip(grads, want):
        assert torch.equal(a, b.to(a.dtype))


WKV6_CKPT_RTOL = 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 1, 3, 64), (2, 17, 3, 64),
                                   (1, 100, 2, 16), (2, 33, 2, 40),
                                   (3, 50, 2, 24), (2, 33, 2, 17)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wkv6_checkpoints_leave_the_forward_as_it_was(shape, dtype):
    """K5 with checkpoint writes (the decode kernel at L 1, the split
    kernel past it): y and the final state the same bits as without them,
    one counted checkpointing launch, and the checkpoints (each state
    transposed) within 1e-6 of the largest |state| of the plain ones."""
    xs, _, _ = _wkv6_inputs(*shape, dtype, seed=sum(shape))
    y0, s0 = wkv6_ops.wkv6(*xs)
    n = wkv6_ops.wkv6.launches_ckpt
    y1, s1, ck = wkv6_ops._forward(*xs, ckpt=True)
    torch.cuda.synchronize()
    assert wkv6_ops.wkv6.launches_ckpt == n + 1
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    want = wkv6_ref.wkv6_ckpt_ref(xs[1], xs[2], xs[3], xs[5])
    assert ck.shape == want.shape
    assert float((ck - want).abs().max()) <= \
        WKV6_CKPT_RTOL * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [1, 17, 100])
def test_wkv6_bwd_from_saved_checkpoints_is_bit_identical(L, dtype):
    """K5-bwd given the checkpoints K5 wrote and given none (the call runs
    the checkpointing K5 itself) gives the same bits."""
    xs, dy, ds = _wkv6_inputs(2, L, 3, 64, dtype, seed=7 * L)
    ck = wkv6_ops._forward(*xs, ckpt=True)[2]
    saved = wkv6_ops.wkv6_bwd(*xs, dy, ds, ckpt=ck)
    n = wkv6_ops.wkv6.launches_ckpt
    none = wkv6_ops.wkv6_bwd(*xs, dy, ds)
    torch.cuda.synchronize()
    assert wkv6_ops.wkv6.launches_ckpt == n + 1
    for a, b in zip(saved, none):
        assert torch.equal(a, b)


def test_wkv6_bwd_catches_checkpoints_of_other_inputs():
    """K5-bwd restarts its states at the checkpoints: given those of other
    inputs (the state carried in moved by 1) it must fail the limit
    against the plain backward."""
    xs, dy, ds = _wkv6_inputs(1, 300, 4, 64, torch.float32, seed=5)
    other = wkv6_ops._forward(*xs[:5], xs[5] + 1.0, ckpt=True)[2]
    got = wkv6_ops.wkv6_bwd(*xs, dy, ds, ckpt=other)
    plain = wkv6_ref.wkv6_bwd_ref(*xs, dy, ds)
    assert wkv6_excess(got, plain) > 1.0


@pytest.mark.parametrize("view", ["K20", "K36", "offset"])
def test_wkv6_bwd_stages_views_the_tensor_maps_cannot_take(view):
    """bf16 rows of 40 or 72 bytes, and r, k, v one element off their
    allocations, go through K5-bwd's cp.async staging: against the plain
    backward, and bit-identical from saved checkpoints and from none."""
    K = {"K20": 20, "K36": 36}.get(view, 64)
    xs, dy, ds = _wkv6_inputs(2, 33, 3, K, torch.bfloat16, seed=K)
    if view == "offset":
        xs = tuple(torch.cat([x, x[..., :1]], -1)[..., 1:] if i < 3 else x
                   for i, x in enumerate(xs))
    got = wkv6_ops.wkv6_bwd(*xs, dy, ds)
    ck = wkv6_ops._forward(*xs, ckpt=True)[2]
    again = wkv6_ops.wkv6_bwd(*xs, dy, ds, ckpt=ck)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert wkv6_excess(got, wkv6_ref.wkv6_bwd_ref(*xs, dy, ds)) <= 1.0


def test_kernels_without_a_backward_refuse_grad():
    g = torch.Generator(device=DEV).manual_seed(0)
    q = torch.randn((4, 64), generator=g, device=DEV, requires_grad=True)
    rows = torch.randn((300, 64), generator=g, device=DEV)
    with pytest.raises(RuntimeError, match="no backward"):
        ctk_ops.cosine_topk(q, rows)
    with pytest.raises(RuntimeError, match="no backward"):
        ctk_ops.cosine_top1_local(q, rows)
    codes = torch.randint(-127, 128, (300, 64), generator=g, device=DEV,
                          dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no backward"):
        ctk_ops.cosine_topk_q8(q, codes, torch.ones(300, device=DEV))
    qd = torch.randn((2, 8, 64), generator=g, device=DEV,
                     dtype=torch.bfloat16, requires_grad=True)
    cache = torch.randn((2, 32, 2, 64), generator=g, device=DEV,
                        dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        da_ops.decode_attention(qd, cache, cache,
                                torch.full((2,), 20, device=DEV))
    with torch.no_grad():                 # serving is unchanged
        ctk_ops.cosine_topk(q, rows)


def test_reduced_train_step_on_the_card_matches_the_cpu():
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.training.optimizer import tree_leaves, tree_map
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    card = tree_map(lambda x: x.to(DEV), cpu)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    before = _launches()
    def grads(params, b):
        return steps.value_and_grad(
            lambda p: steps.chunked_ce_loss(p, cfg, b, 16)[0], params)
    l_card, g_card = grads(card, {k: v.to(DEV) for k, v in batch.items()})
    # 64 tokens in f32: one one-pass launch a layer
    assert fa_ops.bwd_route(torch.float32, 64, 64, cfg.head_dim) == "one_pass"
    assert _launches() == tuple(x + cfg.n_layers for x in before)
    l_cpu, g_cpu = grads(cpu, batch)
    np.testing.assert_allclose(float(l_card), float(l_cpu), atol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), path
