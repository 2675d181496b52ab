"""The plain versions of the attention kernels (K4 prefill, K3 decode in
both modes) held against the JAX package's Pallas kernels, run as the
reference's own tests run them off a TPU (interpret mode), and against the
reference model layer; the wrappers' CPU dispatch.

Tolerances are the reference's own (tests/test_kernels.py): atol 2e-5 in
f32 (softmax attention summed in another order), 3e-2 in bf16 (outputs
rounded to bf16); 1e-5 against the reference model layer in f32. In bf16
the plain version with P rounded, as the model layer and K4 round it, is
held against the reference model layer at the limit the card holds K4 to
(``kernels.bf16_excess``, 2^-5 of each row's rms), which a dropped kv tile
must fail.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    decode_attention as j_decode_attention
from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash_attention
from repro.models import layers as JL
from repro.models.lm import kv_quant as j_kv_quant
from repro_torch.kernels import bf16_excess, on_cpu
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

torch.set_num_threads(2)

# tests/test_kernels.py CASES: causal, GQA 2:1 and 8:1, window 32,
# prefix 16, non-causal, Lq=7
CASES = [
    dict(B=2, Lq=64, Lkv=64, H=4, Hkv=2, Dh=32, causal=True),
    dict(B=1, Lq=100, Lkv=100, H=8, Hkv=1, Dh=64, causal=True),
    dict(B=2, Lq=128, Lkv=128, H=4, Hkv=4, Dh=16, causal=True, window=32),
    dict(B=1, Lq=96, Lkv=96, H=2, Hkv=2, Dh=48, causal=True, prefix_len=16),
    dict(B=2, Lq=32, Lkv=32, H=4, Hkv=2, Dh=32, causal=False),
    dict(B=1, Lq=7, Lkv=7, H=1, Hkv=1, Dh=8, causal=True),
] + [
    # the embedder's attention (siso-embedder: 12 heads of 64, bidirectional)
    # at its served batches of 4 and 1, at L=24 and at the tokenizer's
    # default length of 64
    dict(B=B, Lq=L, Lkv=L, H=12, Hkv=12, Dh=64, causal=False)
    for B in (1, 4) for L in (24, 64)
]

# tests/test_kernels.py decode shapes: (B, H, Hkv, Dh, Lc)
DECODE = [(2, 8, 2, 64, 300), (1, 4, 4, 32, 1000), (3, 16, 1, 128, 77),
          (4, 8, 8, 48, 512), (1, 2, 1, 16, 5)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_flash_plain_matches_pallas_kernel(case):
    c = dict(case)
    causal = c.pop("causal")
    window = c.pop("window", None)
    prefix = c.pop("prefix_len", 0)
    rng = np.random.default_rng(c["Lq"] + c["H"])
    q = rng.normal(size=(c["B"], c["Lq"], c["H"], c["Dh"])).astype(np.float32)
    k = rng.normal(size=(c["B"], c["Lkv"], c["Hkv"], c["Dh"])).astype(
        np.float32)
    v = rng.normal(size=(c["B"], c["Lkv"], c["Hkv"], c["Dh"])).astype(
        np.float32)
    jo = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, prefix_len=prefix,
                           block_q=32, block_k=128)
    to = fa_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                window=window, prefix_len=prefix)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)


def test_flash_plain_matches_pallas_kernel_bf16():
    rng = np.random.default_rng(5)
    shapes = [(2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)]
    q, k, v = (jnp.asarray(rng.normal(size=s), jnp.bfloat16) for s in shapes)
    jo = j_flash_attention(q, k, v, causal=True)
    tq, tk, tv = (_t(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    to = fa_ops.flash_attention(tq, tk, tv, causal=True)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2)


@pytest.mark.parametrize("kw", [
    {"causal": True, "q_offset": 5},
    {"causal": True, "q_offset": 5, "kv_valid_len": [13, 6]},
    {"causal": True, "window": 4, "q_offset": 5, "kv_valid_len": [9, 13]},
    {"causal": False, "kv_valid_len": [7, 11]},
    {"causal": True, "prefix_len": 3, "q_offset": 5},
], ids=["offset", "offset-ragged", "window-ragged", "bidir-ragged",
        "prefix"])
def test_flash_plain_matches_model_layer(kw):
    """q_offset and kv_valid_len, which the Pallas kernel lacks, against
    the reference model layer's blockwise jnp attention."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if "kv_valid_len" in kw:
        kvl = np.asarray(kw["kv_valid_len"], np.int32)
        jkw["kv_valid_len"], tkw["kv_valid_len"] = jnp.asarray(kvl), _t(kvl)
    tkw.setdefault("q_offset", 0)          # the layer's default
    jo = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            block_q=4, block_kv=8, **jkw)
    to = fa_ref.attention_ref(_t(q), _t(k), _t(v), **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


def _decode_inputs(B, H, Hkv, Dh, Lc, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Lc, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Lc, Hkv, Dh)).astype(np.float32)
    kv_len = rng.integers(1, Lc + 1, size=B).astype(np.int32)
    return q, k, v, kv_len


@pytest.mark.parametrize("B,H,Hkv,Dh,Lc", DECODE)
def test_decode_plain_matches_pallas_kernel(B, H, Hkv, Dh, Lc):
    q, k, v, kv_len = _decode_inputs(B, H, Hkv, Dh, Lc, Lc + H)
    jo = j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kv_len), block_k=128)
    to = da_ops.decode_attention(_t(q), _t(k), _t(v), _t(kv_len))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)


@pytest.mark.parametrize("B,H,Hkv,Dh,Lc", DECODE)
def test_decode_plain_int8_matches_pallas_kernel(B, H, Hkv, Dh, Lc):
    """The same int8 codes and f16 scales (the reference's kv_quant) fed to
    the Pallas kernel and to the plain version."""
    q, k, v, kv_len = _decode_inputs(B, H, Hkv, Dh, Lc, 2 * Lc + H)
    kq, ks = j_kv_quant(jnp.asarray(k))
    vq, vs = j_kv_quant(jnp.asarray(v))
    jo = j_decode_attention(jnp.asarray(q), kq, vq, jnp.asarray(kv_len),
                            k_scale=ks, v_scale=vs, block_k=128)
    to = da_ops.decode_attention(_t(q), _t(kq), _t(vq), _t(kv_len),
                                 k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)


def test_decode_plain_matches_model_layer():
    """K3's plain version equals the port's and the reference's model
    layer (f32 cache, ragged kv_len)."""
    from repro_torch.models import layers as TL
    q, k, v, _ = _decode_inputs(2, 8, 2, 64, 200, 3)
    kv_len = np.asarray([150, 60], np.int32)
    jo = JL.decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                             jnp.asarray(v), kv_len=jnp.asarray(kv_len))
    to = da_ref.decode_attention_ref(_t(q), _t(k), _t(v), _t(kv_len))
    lo = TL.decode_attention(_t(q)[:, None], _t(k), _t(v), kv_len=_t(kv_len))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[:, 0], atol=2e-5)
    np.testing.assert_allclose(lo[:, 0].numpy(), to.numpy(), atol=2e-5)


def test_wrappers_refuse_mixed_devices_and_mismatched_modes():
    q = torch.zeros((1, 2, 8))
    k = torch.zeros((1, 4, 1, 8), dtype=torch.int8)
    s = torch.ones((1, 4, 1), dtype=torch.float16)
    with pytest.raises(ValueError):          # int8 cache without scales
        da_ops.decode_attention(q, k, k, torch.tensor([4]))
    with pytest.raises(ValueError):          # scales on a float cache
        da_ops.decode_attention(q, k.float(), k.float(), torch.tensor([4]),
                                k_scale=s, v_scale=s)
    with pytest.raises(ValueError):
        on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    # fully masked rows and empty sequences return 0, not nan
    o = da_ops.decode_attention(q, k, k, torch.tensor([0]), k_scale=s,
                                v_scale=s)
    assert torch.equal(o, torch.zeros_like(o))
    o = fa_ops.flash_attention(torch.ones((1, 3, 2, 8)),
                               torch.ones((1, 3, 1, 8)),
                               torch.ones((1, 3, 1, 8)),
                               kv_valid_len=torch.tensor([0]))
    assert torch.equal(o, torch.zeros_like(o))


def test_flash_plain_bf16_matches_model_layer_and_limit_sees_a_dropped_tile():
    """bf16 causal prefill: the reference model layer rounds P to bf16 at
    each kv block's running max (blocks of 64, as K4's tiles), the plain
    version at the row's final max; they agree within the bf16 limit. The
    same output with one 64-key tile left out of the last quarter of the
    rows exceeds it."""
    rng = np.random.default_rng(21)
    L, lo, r0 = 512, 256, 384
    q = rng.normal(size=(1, L, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, L, 2, 64)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo = JL.flash_attention(jq, jk, jv, causal=True, block_q=64,
                            block_kv=64)
    tq, tk, tv = (_t(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    plain = fa_ref.attention_ref(tq, tk, tv, causal=True,
                                 p_dtype=torch.bfloat16)
    model = _t(np.asarray(jo, np.float32)).to(torch.bfloat16)
    assert bf16_excess(model, plain, 2.0 ** -5) <= 1.0

    def holed(x):
        return torch.cat([x[:, :lo], x[:, lo + 64:]], dim=1)
    bad = plain.clone()
    bad[:, r0:] = fa_ref.attention_ref(tq[:, r0:], holed(tk), holed(tv),
                                       causal=True, q_offset=r0 - 64,
                                       p_dtype=torch.bfloat16)
    assert bf16_excess(bad, plain, 2.0 ** -5) > 10.0


def test_bf16_tma_layout_limit_is_checked_before_any_launch():
    """The bf16 kernel reads q/k/v through TMA tensor maps; the wrapper's
    check accepts what the engine hands over (contiguous (B, L, H, 128),
    slices of a fused projection, a length-1 dim of any stride) and names
    the limit for what a tensor map cannot describe."""
    x = torch.zeros((2, 16, 6, 128), dtype=torch.bfloat16)
    fa_ops.tma_layout_check(x[:, :, :4], x[:, :, 4:5], x[:, :, 5:])
    fa_ops.tma_layout_check(*(x[:1, :, :1],) * 3)
    wide = torch.zeros((1, 16, 2, 72), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned base"):
        fa_ops.tma_layout_check(*(wide[..., 1:65],) * 3)
    odd = torch.zeros((1, 16, 2, 36), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 36"):
        fa_ops.tma_layout_check(odd, odd, odd)
    strided = torch.zeros((1, 16, 3, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="stride 68 of dim 2"):
        fa_ops.tma_layout_check(strided, x, x)
