"""The training path on the card: the attention backward's two kernels
(``csrc/flash_attention_bwd.cu``: (a) dQ, (b) dK/dV) against their plain
version ``attention_bwd_ref`` in f32 and bf16, head dims 16, 64, 100,
112 and 128, GQA with 1, 5 and 8 query heads a kv head, every mask mode
(causal, bidirectional, window, prefix, cross attention with Lq != Lkv,
an explicit q_offset, fully masked rows), bf16 at the edges of the
kernels' 64-row tiles (L 1 to 4,095) and from a misaligned view, a
planted fault in each kernel that the limit must catch, bit-identical
repeats and the launch count;
``FlashAttentionFn`` on CUDA tensors (the backward kernels run, the plain
backward does not); the kernels without a backward (K1, K2, K3, K5)
refusing inputs that require grad; and one reduced train step on the card
against the same step on the CPU. The kernels have no CPU mode, so these
tests are marked ``gpu`` and skip without a CUDA device:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_train.py

Tolerances: f32 gradients within 1e-5 of the plain version's largest
|gradient| (fp32 FMAs summed in another order); bf16 within 2^-7 |plain|
+ 2^-5 x the row's rms of the root sum of squares of the gradient's terms
(``ref.attention_bwd_rss``: P and dS are bf16 operands of the
tensor-core products, and a gradient row can cancel to 0 where its terms
do not); the reduced f32 train step's loss at 1e-5 and each gradient leaf
within 1e-4 of its largest |gradient|.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bf16_excess
from repro_torch.kernels.cosine_topk import ops as ctk_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops

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


def _inputs(B, Lq, Lkv, H, Hkv, D, dtype, seed, **kw):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=DEV).to(dtype)
               for shape in ((B, Lq, H, D), (B, Lkv, Hkv, D),
                             (B, Lkv, Hkv, D)))
    o = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    do = torch.randn(o.shape, generator=g, device=DEV).to(dtype)
    return q, k, v, o, do


def bwd_excess(got, plain, rss, dtype) -> float:
    """The largest error of the three gradients over its limit."""
    if dtype == torch.float32:
        return max(float((a - b).abs().max()) / (F32_RTOL * float(
            b.abs().max())) for a, b in zip(got, plain))
    return max(bf16_excess(a, b, BF16_ROW_RTOL, scale=m)
               for a, b, m in zip(got, plain, rss))


def _check(B, Lq, Lkv, H, Hkv, D, dtype, seed, **kw):
    q, k, v, o, do = _inputs(B, Lq, Lkv, H, Hkv, D, dtype, seed, **kw)
    before = (fa_ops.flash_attention.launches_bwd,
              fa_ops.flash_attention.launches_bwd_f32)
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches_bwd == before[0] + 2
    assert fa_ops.flash_attention.launches_bwd_f32 == before[1] + 2 * (
        dtype == torch.float32)
    plain = fa_ref.attention_bwd_ref(q, k, v, o, do, **kw)
    rss = fa_ref.attention_bwd_rss(q, k, v, o, do, **kw)
    assert bwd_excess(got, plain, rss, dtype) <= 1.0
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
    r = torch.randn((1, 20, 2, 16), generator=g, device=DEV,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_ops.wkv6(r, r.detach(), r.detach(), torch.rand_like(r),
                      torch.zeros(2, 16, device=DEV),
                      torch.zeros(1, 2, 16, 16, device=DEV))
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
    before = fa_ops.flash_attention.launches_bwd
    def grads(params, b):
        return steps.value_and_grad(
            lambda p: steps.chunked_ce_loss(p, cfg, b, 16)[0], params)
    l_card, g_card = grads(card, {k: v.to(DEV) for k, v in batch.items()})
    assert fa_ops.flash_attention.launches_bwd == before + 2 * cfg.n_layers
    l_cpu, g_cpu = grads(cpu, batch)
    np.testing.assert_allclose(float(l_card), float(l_cpu), atol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), path
