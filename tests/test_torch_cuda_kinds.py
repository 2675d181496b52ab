"""The attention kernels at the masks and shapes of the MoE + sliding-window
kind (mixtral-8x7b), the VLM prefix-LM (paligemma-3b), MLA (minicpm3-4b,
deepseek-v2-236b) and the encoder-decoder (whisper-base), and the reduced
models on the card against the plain layers. K4 (prefill): paligemma's
256-token bidirectional prefix at head dim 256 with one kv head (MQA), and
a window shorter than the keys; K3 (decode): a ring cache that has wrapped,
at head dims 128 (mixtral, 4 query heads a kv head) and 256 (paligemma, 8),
held against the plain attention over the same positions laid out in
order; both kernels' Dv mode (v head dim other than the q/k one: MLA's Dq
96 with Dv 64 and Dq 192 with Dv 128) in bf16 and f32, with a dropped kv
tile that the bf16 limit must fail; K4's persistent route at the
4,096-token prefill calls of minicpm3, zamba2 (32 heads of 112) and
deepseek-v2 (128 heads), three calls bit-identical, and a dropped kv tile
at zamba2's head dim; K3's Dv mode in bf16 takes the fast
one-launch kernel (``last_n_split > 0``) at its tile and split edges, in
a full 32,768-position cache, on ``_mla_kv``'s own layouts and on a
16-byte aligned view, gives the same bits twice, and a misaligned view
takes the generic kernel. The SSM kind's WKV6 recurrence (K5) against its
plain step loop: B 1-4, L 1 to 1,000 (below 16 its column kernel, then
around the split kernel's 32-step tiles), K 16, 24, 40 and 64 (24 and 40
off its 32-column groups), a carried and a zero
state, w near 0 and near 1, f32 and bf16 views of a packed projection,
one element off it (not 16-byte aligned) or heads-major, rwkv6-7b's own
prefill (B 1, L 2,048, H 64) and decode (B 4, L 1) calls, one kernel a
call in a fresh process's trace, two calls bit-identical; then
reduced rwkv6 and zamba2 (K4 and K3 in its shared block) against the plain
versions. The kernels have no CPU mode, so these tests are marked ``gpu``
and skip without a CUDA device:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kinds.py

Tolerances: bf16 outputs as in tests/test_torch_cuda_attention.py
(2^-7 |plain| + 2^-5 (K4) or 2^-10 (K3) x the row's rms); the reduced
models in f32 at atol 1e-4 on logits of |logit| < ~1 (f32 kernels and
plain layers sum in another order), with the int8 KV cache at 1e-3 (a
value within an ulp of a rounding boundary may take the neighbouring code
in the two runs).
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import bf16_excess
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

pytestmark = pytest.mark.gpu

DEV = "cuda"
ROW_RTOL = {"flash": 2.0 ** -5, "decode": 2.0 ** -10}


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _randn(shape, g, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _flash_check(q, k, v, **kw):
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert bf16_excess(out, plain, ROW_RTOL["flash"]) <= 1.0


@pytest.mark.parametrize("B", [1, 2])
def test_flash_paligemma_prefix_mask(B):
    """256 patch positions attended bidirectionally, then 256 causal text
    positions: H 8, Hkv 1, Dh 256."""
    g = torch.Generator(device=DEV).manual_seed(B)
    q = _randn((B, 512, 8, 256), g)
    k, v = _randn((B, 512, 1, 256), g), _randn((B, 512, 1, 256), g)
    _flash_check(q, k, v, causal=True, prefix_len=256)


@pytest.mark.parametrize("L,window", [(1100, 300), (700, 128), (513, 512)])
def test_flash_window_shorter_than_the_keys(L, window):
    """mixtral's heads (32/8 of 128) with a window that the prompt
    outgrows, at and off K4's 128-key tile edges."""
    g = torch.Generator(device=DEV).manual_seed(L)
    q = _randn((1, L, 32, 128), g)
    k, v = _randn((1, L, 8, 128), g), _randn((1, L, 8, 128), g)
    _flash_check(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("Dh,G", [(128, 4), (256, 8)])
def test_decode_over_a_wrapped_ring(Dh, G, kind):
    """Positions 0..n-1 written at slot t % Lc of a ring of Lc slots (as
    prefill's ring placement and decode's writes leave it): K3 over the
    ring with kv_len min(n, Lc) equals the plain attention over the last
    Lc positions in order (attention is slot-order invariant)."""
    from repro_torch.models import lm
    B, Hkv, Lc = 4, 2, 320
    n = torch.tensor([Lc + 77, 3 * Lc + 5, Lc, 50])     # positions written
    g = torch.Generator(device=DEV).manual_seed(Dh + G)
    q = _randn((B, G * Hkv, Dh), g)
    kv = _randn((2, B, int(n.max()), Hkv, Dh), g, torch.float32)
    ring = torch.zeros((2, B, Lc, Hkv, Dh), device=DEV)
    lin = torch.zeros_like(ring)
    for b in range(B):      # what the writes leave: the last Lc positions
        nb = int(n[b])
        keep = torch.arange(max(0, nb - Lc), nb, device=DEV)
        ring[:, b, keep % Lc] = kv[:, b, keep]
        lin[:, b, :len(keep)] = kv[:, b, keep]
    kv_len = n.clamp_max(Lc).to(torch.int32).to(DEV)
    before = da_ops.decode_attention.launches
    if kind == "int8":
        (rk, rks), (rv, rvs) = lm.kv_quant(ring[0]), lm.kv_quant(ring[1])
        (lk, lks), (lv, lvs) = lm.kv_quant(lin[0]), lm.kv_quant(lin[1])
        out = da_ops.decode_attention(q, rk, rv, kv_len, k_scale=rks,
                                      v_scale=rvs)
        plain = da_ref.decode_attention_ref(q, lk, lv, kv_len, k_scale=lks,
                                            v_scale=lvs)
    else:
        out = da_ops.decode_attention(q, ring[0].bfloat16(),
                                      ring[1].bfloat16(), kv_len)
        plain = da_ref.decode_attention_ref(q, lin[0].bfloat16(),
                                            lin[1].bfloat16(), kv_len)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    assert bf16_excess(out, plain, ROW_RTOL["decode"]) <= 1.0


# MLA's (Dq, Dv) at full width: minicpm3-4b and deepseek-v2-236b
MLA_DIMS = {"minicpm3": (96, 64), "deepseek-v2": (192, 128)}
ATOL_F32 = 2e-5


def _dv_flash_inputs(dims, dtype, B, L, H, seed):
    Dq, Dv = MLA_DIMS[dims]
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (_randn((B, L, H, Dq), g, dtype), _randn((B, L, H, Dq), g, dtype),
            _randn((B, L, H, Dv), g, dtype))


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, q_offset=40, ragged=True)],
    ids=["causal", "bidirectional", "offset-ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("dims", sorted(MLA_DIMS))
def test_flash_dv_mode_matches_plain(dims, dtype, kw):
    """K4 with v narrower than q/k (B 2, L 300 ragged against the 128-row
    and 128-key tiles, 8 heads): the output is (B, L, H, Dv), one launch,
    counted in ``launches_dv``."""
    kw = dict(kw)
    B, L, H = 2, 300, 8
    q, k, v = _dv_flash_inputs(dims, dtype, B, L, H, seed=len(kw))
    if kw.pop("ragged", False):
        kw["kv_valid_len"] = torch.tensor([300, 131], device=DEV)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.launches_dv)
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    assert out.shape == (B, L, H, v.shape[-1]) and out.dtype == dtype
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention.launches_dv) == (before[0] + 1,
                                                    before[1] + 1)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=ATOL_F32, rtol=0)
    else:
        assert bf16_excess(out, plain, ROW_RTOL["flash"]) <= 1.0


def _mla_layout(Dq, Dv, B, Lc, H, g):
    """K and V as ``layers._mla_kv`` builds them from a latent cache (k_nope
    and the shared k_rope concatenated, v a reshaped product), at the
    model's rank of 256 and rope width of 32."""
    from types import SimpleNamespace
    from repro_torch.models import layers as L
    rope, R = 32 if Dq == 96 else 64, 256
    cfg = SimpleNamespace(n_heads=H, qk_nope_dim=Dq - rope, qk_rope_dim=rope,
                          v_head_dim=Dv)
    p = {"wk_b": _randn((R, H * (Dq - rope)), g) / R ** 0.5,
         "wv_b": _randn((R, H * Dv), g) / R ** 0.5}
    return L._mla_kv(p, cfg, _randn((B, Lc, R), g), _randn((B, Lc, rope), g))


# K3 Dv cases: (Lc, kv_len, layout); "views": k a 16-byte aligned view of
# a wider buffer, v contiguous; "edges": the fast path's 16-row tiles and
# 64-position chunk steps, and the grid's split edges (added at run time);
# "full": kv_len = Lc = 32,768; "mla": _mla_kv's own k and v
DV_DECODE_CASES = {
    "views": (700, [700, 256, 1, 0], "views"),
    "edges": (4096, [0, 1, 15, 16, 17, 63, 64, 65, 4096], "contiguous"),
    "full": (32768, [32768, 32768], "contiguous"),
    "mla": (1100, [1100, 513, 64, 1], "mla"),
}


@pytest.mark.parametrize("case,dtype", [
    ("views", torch.bfloat16), ("views", torch.float32),
    ("edges", torch.bfloat16), ("full", torch.bfloat16),
    ("mla", torch.bfloat16)],
    ids=["bf16", "f32", "edges-bf16", "full-bf16", "mla-bf16"])
@pytest.mark.parametrize("dims", sorted(MLA_DIMS))
def test_decode_dv_mode_matches_plain(dims, dtype, case):
    """K3 with v narrower than q/k, each cache with its own strides, G = 1
    as in MLA and G = 4, at the kv lengths of ``DV_DECODE_CASES``. bf16
    takes the fast one-launch kernel (``last_n_split > 0``), f32 the
    generic one."""
    Dq, Dv = MLA_DIMS[dims]
    Lc, lens, layout = DV_DECODE_CASES[case]
    g = torch.Generator(device=DEV).manual_seed(Dq + len(case))
    for H, Hkv in ((8, 8), (8, 2)):
        B = len(lens) + (3 if case == "edges" else 0)
        if layout == "mla":
            k, v = _mla_layout(Dq, Dv, B, Lc, Hkv, g)
        else:
            k = _randn((B, Lc, Hkv, Dq + (8 if layout == "views" else 0)),
                       g, dtype)[..., :Dq]
            v = _randn((B, Lc, Hkv, Dv), g, dtype)
        q = _randn((B, H, Dq), g, dtype)
        kv_len = lens
        if case == "edges":     # the grid's split edges: n x 64 and around
            da_ops.decode_attention(q, k, v, torch.tensor(
                lens + [1, 2, 3], device=DEV))
            n = da_kernel.last_n_split.value
            assert 1 <= n <= Lc // 64
            kv_len = lens + [n * 64 - 1, n * 64, n * 64 + 1]
        kv_len = torch.tensor(kv_len, device=DEV)
        before = (da_ops.decode_attention.launches,
                  da_ops.decode_attention.launches_dv)
        out = da_ops.decode_attention(q, k, v, kv_len)
        fast = da_kernel.last_n_split.value > 0
        plain = da_ref.decode_attention_ref(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert out.shape == (B, H, Dv)
        assert (da_ops.decode_attention.launches,
                da_ops.decode_attention.launches_dv) == (before[0] + 1,
                                                         before[1] + 1)
        assert fast == (dtype == torch.bfloat16)
        for b in range(B):                               # kv_len 0
            if int(kv_len[b]) == 0:
                assert float(out[b].abs().max()) == 0.0
        if dtype == torch.float32:
            torch.testing.assert_close(out, plain, atol=ATOL_F32, rtol=0)
        else:
            assert bf16_excess(out, plain, ROW_RTOL["decode"]) <= 1.0


@pytest.mark.parametrize("dims", sorted(MLA_DIMS))
def test_decode_dv_misaligned_view_takes_the_generic_path(dims):
    """k 4 bytes off a 16-byte boundary: the generic kernel reads it through
    its strides (``last_n_split == 0``) and agrees."""
    Dq, Dv = MLA_DIMS[dims]
    B, H, Lc = 3, 8, 500
    g = torch.Generator(device=DEV).manual_seed(Dq + 1)
    q = _randn((B, H, Dq), g)
    k = _randn((B, Lc, H, Dq + 2), g)[..., 2:]
    v = _randn((B, Lc, H, Dv), g)
    kv_len = torch.tensor([500, 3, 260], device=DEV)
    out = da_ops.decode_attention(q, k, v, kv_len)
    assert da_kernel.last_n_split.value == 0
    plain = da_ref.decode_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert bf16_excess(out, plain, ROW_RTOL["decode"]) <= 1.0


@pytest.mark.parametrize("dims", sorted(MLA_DIMS))
def test_decode_dv_back_to_back_calls_are_bit_identical(dims):
    """The fast Dv kernel merges its splits in split order and leaves its
    arrival counters at 0: repeated calls give the same bits, interleaved
    with a call of another shape."""
    Dq, Dv = MLA_DIMS[dims]
    B, H, Lc = 4, 8, 8192
    g = torch.Generator(device=DEV).manual_seed(Dq + 2)
    q = _randn((B, H, Dq), g)
    k, v = _randn((B, Lc, H, Dq), g), _randn((B, Lc, H, Dv), g)
    kv_len = torch.tensor([4096, 4097, 8192, 100], device=DEV)
    first = da_ops.decode_attention(q, k, v, kv_len)
    assert da_kernel.last_n_split.value > 1
    again = da_ops.decode_attention(q, k, v, kv_len)
    q2, k2, v2 = _randn((2, 4, Dq), g), _randn((2, 1000, 4, Dq), g), \
        _randn((2, 1000, 4, Dv), g)
    da_ops.decode_attention(q2, k2, v2, torch.tensor([999, 5], device=DEV))
    third = da_ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)


@pytest.mark.parametrize("dims", sorted(MLA_DIMS))
def test_dv_mode_dropped_tile_fails_the_limit(dims):
    """A planted fault the checks above must catch: the plain versions with
    one kv tile left out (K4: 64 keys out of the last quarter of a causal
    prefill's rows; K3: one 256-position split) exceed the bf16 limit, while
    the kernels stay within it."""
    Dq, Dv = MLA_DIMS[dims]
    B, L, H = 1, 1024, 8
    q, k, v = _dv_flash_inputs(dims, torch.bfloat16, B, L, H, seed=5)
    plain = fa_ref.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)
    bad = plain.clone()
    lo, r0 = L // 2, 3 * L // 4

    def holed(x, n):
        return torch.cat([x[:, :lo], x[:, lo + n:]], dim=1)
    bad[:, r0:] = fa_ref.attention_ref(
        q[:, r0:], holed(k, 64), holed(v, 64), causal=True,
        q_offset=r0 - 64, p_dtype=v.dtype)
    assert bf16_excess(bad, plain, ROW_RTOL["flash"]) > 1.0
    out = fa_ops.flash_attention(q, k, v, causal=True)
    assert bf16_excess(out, plain, ROW_RTOL["flash"]) <= 1.0
    qd, kc, vc = q[:, -1], k, v                       # one decode query
    kv_len = torch.full((B,), L, device=DEV)
    plain = da_ref.decode_attention_ref(qd, kc, vc, kv_len)
    bad = da_ref.decode_attention_ref(qd, holed(kc, 256), holed(vc, 256),
                                      kv_len - 256)
    assert bf16_excess(bad, plain, ROW_RTOL["decode"]) > 1.0
    out = da_ops.decode_attention(qd, kc, vc, kv_len)
    assert da_kernel.last_n_split.value > 0       # the fast kernel
    torch.cuda.synchronize()
    assert bf16_excess(out, plain, ROW_RTOL["decode"]) <= 1.0


# K4's persistent route (ops.fwd_route) at the main path's prefill calls:
# (B, L, H, Hkv, Dq, Dv) of minicpm3-4b, zamba2-7b and deepseek-v2-236b
PERSISTENT_CALLS = {"minicpm3": (1, 4096, 40, 40, 96, 64),
                    "zamba2": (1, 4096, 32, 32, 112, 112),
                    "deepseek-v2": (1, 4096, 128, 128, 192, 128)}


@pytest.mark.parametrize("call", sorted(PERSISTENT_CALLS))
def test_flash_persistent_at_the_main_path_shapes(call):
    """The models' 4,096-token causal prefill through
    flash_bf16_persistent: within the bf16 limit of the plain version,
    one launch a call (counted in ``launches_persistent``, and in
    ``launches_dv`` for MLA's pairs), and
    the same bits from three calls."""
    B, L, H, Hkv, Dq, Dv = PERSISTENT_CALLS[call]
    g = torch.Generator(device=DEV).manual_seed(11)
    q = _randn((B, L, H, Dq), g)
    k, v = _randn((B, L, Hkv, Dq), g), _randn((B, L, Hkv, Dv), g)
    assert fa_ops.fwd_route(torch.bfloat16, Dq, Dv).startswith(
        "flash_bf16_persistent<")
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.launches_dv,
              fa_ops.flash_attention.launches_persistent)
    first = fa_ops.flash_attention(q, k, v, causal=True)
    again = fa_ops.flash_attention(q, k, v, causal=True)
    third = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention.launches_dv,
            fa_ops.flash_attention.launches_persistent) == (
                before[0] + 3, before[1] + 3 * (Dq != Dv), before[2] + 3)
    assert torch.equal(first, again) and torch.equal(first, third)
    plain = torch.cat([fa_ref.attention_ref(
        q[:, :, h:h + 8], k[:, :, h:h + 8], v[:, :, h:h + 8], causal=True,
        p_dtype=v.dtype) for h in range(0, H, 8)], dim=2)
    assert bf16_excess(first, plain, ROW_RTOL["flash"]) <= 1.0


def test_flash_head_dim_112_dropped_tile_fails_the_limit():
    """zamba2's (112, 112) on the persistent route: the plain version with
    64 keys left out of the last quarter of a causal prefill's rows
    exceeds the bf16 limit, while the kernel stays within it."""
    B, L, H = 1, 1024, 8
    g = torch.Generator(device=DEV).manual_seed(6)
    q, k, v = (_randn((B, L, H, 112), g) for _ in range(3))
    plain = fa_ref.attention_ref(q, k, v, causal=True, p_dtype=v.dtype)
    bad = plain.clone()
    lo, r0 = L // 2, 3 * L // 4

    def holed(x):
        return torch.cat([x[:, :lo], x[:, lo + 64:]], dim=1)
    bad[:, r0:] = fa_ref.attention_ref(q[:, r0:], holed(k), holed(v),
                                       causal=True, q_offset=r0 - 64,
                                       p_dtype=v.dtype)
    assert bf16_excess(bad, plain, ROW_RTOL["flash"]) > 1.0
    out = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert bf16_excess(out, plain, ROW_RTOL["flash"]) <= 1.0


@pytest.mark.parametrize("arch,kv_dtype", [("mixtral-8x7b", ""),
                                           ("mixtral-8x7b", "int8"),
                                           ("paligemma-3b", ""),
                                           ("minicpm3-4b", ""),
                                           ("minicpm3-4b", "absorb"),
                                           ("deepseek-v2-236b", ""),
                                           ("whisper-base", "")])
def test_reduced_model_kernels_match_plain_layers(arch, kv_dtype,
                                                  monkeypatch):
    """Reduced, f32: mixtral's 48-token prompt over window 32 (the ring
    wraps in prefill) and 4 decode steps; paligemma's 8 patch embeddings
    before 12 text tokens and 4 decode steps; minicpm3 and deepseek-v2
    (MLA, Dv mode; "absorb": the absorbed decode, which runs no K3) and
    whisper (32 stub frames through the encoder, cross-attention) over 12
    tokens and 4 decode steps; the same tokens in both runs. Logits through
    K4/K3 against the plain layers, with the launches each call makes: one
    K4 a layer in prefill (whisper: one an encoder layer, two a decoder
    layer), one K3 a layer a decode step (whisper: two)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    absorb = kv_dtype == "absorb"
    kv_dtype = "" if absorb else kv_dtype
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             kv_dtype=kv_dtype,
                                             mla_absorb=absorb)
    atol = 1e-3 if kv_dtype else 1e-4
    g = torch.Generator(device=DEV).manual_seed(7)
    params = lm.init_params(g, cfg, device=DEV)
    B, Lt = 2, 48 if cfg.window else 12
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, Lt), generator=g,
                                     device=DEV)}
    if cfg.family == "vlm":
        batch["patch_embed"] = torch.randn((B, cfg.prefix_len, cfg.d_model),
                                           generator=g, device=DEV)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((B, cfg.enc_len, cfg.d_model),
                                      generator=g, device=DEV)
    Lx = Lt + (cfg.prefix_len if cfg.family == "vlm" else 0)
    max_len = Lx + 8
    steps = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=g,
                          device=DEV)

    def run():
        cache = lm.init_cache(cfg, B, max_len, device=DEV)
        logits, cache = lm.prefill(params, cfg, batch, cache)
        out = [logits]
        for step, tok in enumerate(steps):
            d, cache = lm.decode_step(params, cfg, tok, cache, Lx + step)
            out.append(d)
        return out

    f0, d0 = fa_ops.flash_attention.launches, da_ops.decode_attention.launches
    kernel = run()
    per_layer = 2 if cfg.is_encoder_decoder else 1
    assert fa_ops.flash_attention.launches == \
        f0 + per_layer * cfg.n_layers + cfg.enc_layers
    assert da_ops.decode_attention.launches == \
        d0 + (0 if absorb else 4 * per_layer * cfg.n_layers)
    monkeypatch.setattr(L, "flash_attention", L.flash_attention_plain)
    monkeypatch.setattr(L, "decode_attention", L.decode_attention_plain)
    plain = run()
    for i, (a, b) in enumerate(zip(kernel, plain)):
        torch.testing.assert_close(a, b, atol=atol, rtol=0,
                                   msg=f"call {i}")


# ---------------------------------------------------------------------------
# the SSM kind's WKV6 recurrence (K5) and the SSM and hybrid models
# ---------------------------------------------------------------------------

WKV6_RTOL = 1e-5     # of the largest |y| or |state|: f32 sums of K terms
                     # in another order (the kernel's FMAs against the
                     # plain loop's products), which the decay keeps small


def _wkv6_inputs(B, L, H, K, g, dtype, decay, layout="packed"):
    """r, k, v as views of one projection (``packed``: (B, L, H, 3K), the
    K-wide slices; ``misaligned``: the same one element into a (B, L, H,
    3K + 1) tensor, so a bf16 view is 2-byte aligned and is staged by plain
    loads; ``heads-major``: a (3, B, H, L, K) tensor transposed), read in
    place; w from the reference's decay formula over a band of its clipped
    exponent: "mid" [-3, 1], "near-0" [4, 6] (exp(-exp(6)) is 0 in f32),
    "near-1" [-12, -10]."""
    if layout in ("packed", "misaligned"):
        off = int(layout == "misaligned")
        rkv = _randn((B, L, H, 3 * K + off), g, dtype)[..., off:]
        r, k, v = rkv[..., :K], rkv[..., K:2 * K], rkv[..., 2 * K:]
    else:
        rkv = _randn((3, B, H, L, K), g, dtype)
        r, k, v = (x.transpose(1, 2) for x in rkv)
    lo, hi = {"mid": (-3.0, 1.0), "near-0": (4.0, 6.0),
              "near-1": (-12.0, -10.0)}[decay]
    w_raw = lo + (hi - lo) * torch.rand((B, L, H, K), generator=g,
                                        device=DEV)
    w = torch.exp(-torch.exp(w_raw))
    u = _randn((H, K), g, dtype)
    s = torch.randn((B, H, K, K), generator=g, device=DEV)
    return r, k, v, w, u, s


def _wkv6_check(r, k, v, w, u, s):
    from repro_torch.kernels.wkv6 import ops, ref
    before, s_before = ops.wkv6.launches, s.clone()
    y, S = ops.wkv6(r, k, v, w, u, s)
    py, pS = ref.wkv6_ref(r, k, v, w, u, s)
    torch.cuda.synchronize()
    assert ops.wkv6.launches == before + 1
    assert y.shape == v.shape and y.dtype == S.dtype == torch.float32
    torch.testing.assert_close(s, s_before, rtol=0, atol=0)
    for out, plain, what in ((y, py, "y"), (S, pS, "state")):
        err = float((out - plain).abs().max()) if out.numel() else 0.0
        lim = WKV6_RTOL * float(plain.abs().max()) if plain.numel() else 0.0
        assert err <= lim, (what, err, lim)


@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                               1000])
@pytest.mark.parametrize("B", [1, 4])
def test_wkv6_matches_plain(B, L, K):
    """bf16 r/k/v views of a packed projection, a carried state, 64 / K
    heads at K 16 and 64 (rwkv6-7b's heads at full width are 64 of 64); L
    below 16 (the column kernel) and around the split kernel's 32-step
    tiles."""
    g = torch.Generator(device=DEV).manual_seed(B * 1000 + L + K)
    _wkv6_check(*_wkv6_inputs(B, L, 64 // K * 2, K, g, torch.bfloat16,
                              "mid"))


@pytest.mark.parametrize("layout", ["packed", "heads-major"])
@pytest.mark.parametrize("decay", ["near-0", "near-1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wkv6_decay_extremes_dtypes_and_views(dtype, decay, layout):
    """w near 0 (the state forgets at once) and near 1 (it keeps 300
    steps), f32 and bf16 r/k/v, packed and heads-major views; K 40 (not a
    multiple of 16: the padded rows stay 0) and B 3."""
    g = torch.Generator(device=DEV).manual_seed(len(decay) + len(layout))
    _wkv6_check(*_wkv6_inputs(3, 300, 3, 40, g, dtype, decay, layout))


# rwkv6-7b's own calls: the 2,048-token prefill (one prompt, a zero state
# and a carried one) and the 4-slot decode step (L 1, a carried state)
RWKV6_CALLS = {"prefill-zero": (1, 2048, False), "prefill-carried":
               (1, 2048, True), "decode": (4, 1, True)}


@pytest.mark.parametrize("call", sorted(RWKV6_CALLS))
def test_wkv6_at_rwkv6_shapes(call):
    """H 64 heads of K = V 64, bf16 r/k/v views of the packed projection;
    the prefill's column groups split every head's state 2 ways, the decode
    step takes the column kernel."""
    B, L, carried = RWKV6_CALLS[call]
    g = torch.Generator(device=DEV).manual_seed(L + B)
    r, k, v, w, u, s = _wkv6_inputs(B, L, 64, 64, g, torch.bfloat16, "mid")
    _wkv6_check(r, k, v, w, u, s if carried else torch.zeros_like(s))


@pytest.mark.parametrize("layout", ["packed", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [24, 40])
def test_wkv6_head_dims_off_the_column_group(K, dtype, layout):
    """K 24 and 40 leave the last 32-column group part empty (its padded
    columns and rows stay 0 and are never written); a view one element off
    the packed one stages by 4-byte copies (f32) or plain loads (bf16). L
    100 over 32-step tiles, B 2, a carried state."""
    g = torch.Generator(device=DEV).manual_seed(K + len(layout))
    r, k, v, w, u, s = _wkv6_inputs(2, 100, 3, K, g, dtype, "mid", layout)
    assert layout == "packed" or r.data_ptr() % 16
    _wkv6_check(r, k, v, w, u, s)


_WKV6_PROFILE_CHILD = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.wkv6 import ops
B, L = json.loads(sys.argv[1])
H, K = 64, 64
g = torch.Generator(device="cuda").manual_seed(0)
r, k, v = (torch.randn((B, L, H, K), generator=g, device="cuda").bfloat16()
           for _ in range(3))
w = torch.rand((B, L, H, K), generator=g, device="cuda")
u = torch.randn((H, K), generator=g, device="cuda")
s = torch.randn((B, H, K, K), generator=g, device="cuda")
ops.wkv6(r, k, v, w, u, s)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    ops.wkv6(r, k, v, w, u, s)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]))
"""


@pytest.mark.parametrize("B,L", [(1, 2048), (4, 1)],
                         ids=["prefill", "decode"])
def test_wkv6_one_kernel_a_call(B, L):
    """One call launches the WKV6 kernel alone (no copy, no fill), from a
    torch.profiler trace after a warm-up call, taken in a fresh child
    process: traces taken earlier in one process can drop a later trace's
    records (tools/profiler_probe.py)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(src)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run(
        [sys.executable, "-c", _WKV6_PROFILE_CHILD, json.dumps([B, L])],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    names = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "wkv6_fwd" in names[0], names


def test_wkv6_zero_state_and_back_to_back_calls_are_bit_identical():
    g = torch.Generator(device=DEV).manual_seed(11)
    r, k, v, w, u, s = _wkv6_inputs(2, 130, 4, 64, g, torch.bfloat16, "mid")
    s = torch.zeros_like(s)
    _wkv6_check(r, k, v, w, u, s)
    from repro_torch.kernels.wkv6 import ops
    a, b = ops.wkv6(r, k, v, w, u, s), ops.wkv6(r, k, v, w, u, s)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_reduced_ssm_kinds_match_plain_layers(arch, monkeypatch):
    """Reduced, f32: a 37-token prompt (over two chunks of 16) and 4 decode
    steps. rwkv6 through the WKV6 kernel, one launch a layer a call;
    zamba2's shared block through K4 (one a prompt and invocation) and K3
    (one a step and invocation); logits against the plain versions (the
    step loop, the plain attention) at atol 1e-4."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import ssm as S
    cfg = get_config(arch).reduced().replace(dtype="float32")
    g = torch.Generator(device=DEV).manual_seed(9)
    params = lm.init_params(g, cfg, device=DEV)
    if arch == "rwkv6-7b":         # a bonus that is not 0, as trained
        for bp in params["blocks"]:
            bp["u"].normal_(generator=g)
    B, Lt = 2, 37
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, Lt), generator=g,
                                     device=DEV)}
    steps = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=g,
                          device=DEV)

    def run():
        cache = lm.init_cache(cfg, B, Lt + 8, device=DEV)
        logits, cache = lm.prefill(params, cfg, batch, cache)
        out = [logits]
        for step, tok in enumerate(steps):
            d, cache = lm.decode_step(params, cfg, tok, cache, Lt + step)
            out.append(d)
        return out, cache

    n0 = (wkv6_ops.wkv6.launches, fa_ops.flash_attention.launches,
          da_ops.decode_attention.launches)
    kernel, kcache = run()
    n_inv = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    rwkv = arch == "rwkv6-7b"
    assert (wkv6_ops.wkv6.launches - n0[0],
            fa_ops.flash_attention.launches - n0[1],
            da_ops.decode_attention.launches - n0[2]) == (
        5 * cfg.n_layers if rwkv else 0, n_inv, 4 * n_inv)
    monkeypatch.setattr(S, "wkv6_ops", SimpleNamespace(wkv6=wkv6_ref))
    monkeypatch.setattr(L, "flash_attention", L.flash_attention_plain)
    monkeypatch.setattr(L, "decode_attention", L.decode_attention_plain)
    plain, pcache = run()
    for i, (a, b) in enumerate(zip(kernel, plain)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=f"call {i}")
    for key in kcache:
        torch.testing.assert_close(kcache[key], pcache[key], atol=1e-4,
                                   rtol=0, msg=key)
