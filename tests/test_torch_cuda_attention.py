"""The hand-written attention kernels on the card, held against their plain
PyTorch versions on the same CUDA tensors: K4 (prefill) over every mask
mode, f32 and bf16, head dims 64, 128 and 256 (and zamba2's 112), bf16's
persistent route (``ops.fwd_route``: zamba2's (112, 112) and MLA's (96,
64) and (192, 128) at exact widths) at L 1-4,095 on both sides of its
tile edges in every mask mode, one kernel a call and bit-identical
repeats, and bf16 at shapes ragged
against its tiles, with a wrapping kv ring, qwen3's 40/8 heads and strided
views (a misaligned view raises); K3 (decode) with f32, bf16
and int8 caches read in place, with G in {1, 4, 5, 8, 16} query heads a kv
head, kv_len at the edges of its tiles and splits, all 0, at decode_32k,
at head dim 112 (bf16 on the fast kernel, padded to 128 in shared memory,
at its tile, chunk and split edges in an 8,192-position cache, repeated
bit for bit and against a dropped span; f32 and misaligned views on the
generic kernel),
through packed, misaligned and odd-width views, and bit-identical across
repeated calls. The kernels have no CPU mode, so these tests
are marked ``gpu`` and skip without a CUDA device. The file imports neither
jax nor the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_attention.py

Tolerances: atol 2e-5 for f32 outputs (the reference's own, softmax
attention summed in another order). bf16 outputs: |kernel - plain| <=
2^-7 |plain| (one bf16 ulp) + ROW_RTOL x the rms of plain's row
(``kernels.bf16_excess``). K4 rounds P to bf16 before P·V, as the model
layer does, and its plain version is given the same rounding; the two
round at different running maxima, which moves an output by about 0.002
of its row's rms, so K4 is held at 2^-5 of it. K3 is f32 throughout, as
its plain version is, and is held at 2^-10.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

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
ATOL_F32 = 2e-5
ROW_RTOL = {"flash": 2.0 ** -5, "decode": 2.0 ** -10}

FLASH_MODES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "window": dict(causal=True, window=37),
    "prefix": dict(causal=True, prefix_len=20),
    "offset-ragged": dict(causal=True, q_offset=70, ragged=True),
    "bidirectional-ragged": dict(causal=False, ragged=True),
    "right-aligned": dict(causal=True, Lq=45),
}


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def _randn(shape, g, dtype):
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _assert_agree(out, plain, kernel):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, plain, atol=ATOL_F32, rtol=0)
    else:
        assert bf16_excess(out, plain, ROW_RTOL[kernel]) <= 1.0


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", list(FLASH_MODES))
def test_flash_kernel_matches_plain(mode, dtype, Dh):
    kw = dict(FLASH_MODES[mode])
    B, Lkv, H, Hkv = 2, 150, 4, 2
    Lq = kw.pop("Lq", Lkv)
    g = _gen(Dh + len(mode))
    # q/k/v are strided views into one packed projection, read in place
    qkv = _randn((B, Lkv, H + 2 * Hkv, Dh), g, dtype)
    q = qkv[:, Lkv - Lq:, :H]
    k, v = qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    if kw.pop("ragged", False):
        kw["kv_valid_len"] = torch.tensor([150, 61], device=DEV)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert out.shape == (B, Lq, H, Dh) and out.dtype == dtype
    _assert_agree(out, plain, "flash")



# bf16 K4 at shapes that exercise its tiles and tensor maps: 128-row q
# tiles and 128-key kv tiles (64 at Dh = 256) in a 2-stage ring
TILE_CASES = {
    # Lq and Lkv ragged against both tiles, right-aligned queries
    "ragged-causal": dict(B=2, Lq=77, Lkv=333, H=4, Hkv=2, causal=True),
    "ragged-bidirectional": dict(B=2, Lq=300, Lkv=333, H=4, Hkv=2,
                                 causal=False),
    # 8 kv tiles (16 at Dh = 256): the ring wraps more than three times
    "ring-wrap-bidirectional": dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1,
                                    causal=False),
    "ring-wrap-causal": dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1,
                             causal=True),
    "ring-wrap-window": dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1,
                             causal=True, window=300),
    "ring-wrap-prefix": dict(B=1, Lq=1000, Lkv=1000, H=2, Hkv=1,
                             causal=True, prefix_len=200),
    # qwen3-14b's 40/8 heads (H/Hkv = 5), B > 1, ragged kv_valid_len
    "gqa-5-ragged": dict(B=3, Lq=260, Lkv=260, H=40, Hkv=8, causal=True,
                         kv_valid_len=[260, 77, 129]),
}


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_flash_bf16_tile_edges(case, Dh):
    kw = dict(TILE_CASES[case])
    shape = {x: kw.pop(x) for x in ("B", "Lq", "Lkv", "H", "Hkv")}
    g = _gen(Dh + len(case))
    q = _randn((shape["B"], shape["Lq"], shape["H"], Dh), g, torch.bfloat16)
    k, v = (_randn((shape["B"], shape["Lkv"], shape["Hkv"], Dh), g,
                   torch.bfloat16) for _ in range(2))
    if "kv_valid_len" in kw:
        kw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"], device=DEV)
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    _assert_agree(out, plain, "flash")


@pytest.mark.parametrize("layout", ["fused-projection", "heads-major"])
def test_flash_bf16_reads_strided_views_in_place(layout):
    """q/k/v as slices of one fused (B, L, (H + 2 Hkv) Dh) projection, and
    as transposes of (B, H, L, Dh) tensors: the tensor maps take their
    strides as they are."""
    B, L, H, Hkv, Dh = 2, 200, 10, 2, 128
    g = _gen(3)
    if layout == "fused-projection":
        fused = _randn((B, L, (H + 2 * Hkv) * Dh), g, torch.bfloat16)
        heads = fused.view(B, L, H + 2 * Hkv, Dh)
        q = heads[:, :, :H]
        k, v = heads[:, :, H:H + Hkv], heads[:, :, H + Hkv:]
    else:
        q = _randn((B, H, L, Dh), g, torch.bfloat16).transpose(1, 2)
        k, v = (_randn((B, Hkv, L, Dh), g, torch.bfloat16).transpose(1, 2)
                for _ in range(2))
    assert not q.is_contiguous()
    for kw in (dict(causal=True), dict(causal=False)):
        out = fa_ops.flash_attention(q, k, v, **kw)
        plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
        torch.cuda.synchronize()
        _assert_agree(out, plain, "flash")


def test_flash_bf16_misaligned_view_raises():
    """A bf16 view that a TMA tensor map cannot describe raises and is
    never sent to another kernel."""
    g = _gen(4)
    wide = _randn((1, 64, 2, 72), g, torch.bfloat16)
    before = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        x = wide[..., 1:65]                          # base 2 bytes off
        fa_ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        x = _randn((1, 64, 2, 36), g, torch.bfloat16)
        fa_ops.flash_attention(x, x, x)
    assert fa_ops.flash_attention.launches == before

# f32 K4: the one-pass kernel takes Lkv <= 128 (64 at Dh > 128), the tiled
# kernel (32-row q tiles, 64-key kv tiles, 32 at Dh > 128) the rest; the
# lengths sit on both sides of those limits and of every tile edge
F32_LENGTHS = [1, 7, 23, 24, 25, 63, 64, 65, 127, 128, 129, 300]
F32_HEADS = [(12, 12), (8, 2), (40, 8)]
F32_BATCHES = [1, 4, 5]


def _f32_check(q, k, v, **kw):
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.launches_f32)
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention.launches_f32) == (before[0] + 1,
                                                     before[1] + 1)
    assert out.shape == q.shape[:3] + v.shape[3:] and out.dtype == q.dtype
    torch.testing.assert_close(out, plain, atol=ATOL_F32, rtol=0)
    return out


@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
@pytest.mark.parametrize("L", F32_LENGTHS)
def test_flash_f32_lengths(L, Dh):
    """Lq = Lkv = L, then L queries over the next length's keys (so Lq and
    Lkv differ on both sides of the limits), causal and bidirectional,
    with each head layout; B cycles through 1, 4, 5."""
    i = F32_LENGTHS.index(L)
    other = F32_LENGTHS[(i + 1) % len(F32_LENGTHS)]
    for n, (H, Hkv) in enumerate(F32_HEADS):
        B = F32_BATCHES[(i + n) % len(F32_BATCHES)]
        g = _gen(1000 * Dh + 10 * L + n)
        for Lq, Lkv in ((L, L), (L, other)):
            q = _randn((B, Lq, H, Dh), g, torch.float32)
            k, v = (_randn((B, Lkv, Hkv, Dh), g, torch.float32)
                    for _ in range(2))
            for causal in (False, True):
                _f32_check(q, k, v, causal=causal)


F32_MODES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "window": dict(causal=True, window=9),
    "window-bidirectional": dict(causal=False, window=9),
    "prefix": dict(causal=True, prefix_len=5),
    "window-prefix": dict(causal=True, window=9, prefix_len=5),
    # kv_valid_len per sequence, 0 included (its rows give 0), with queries
    # placed mid-sequence by q_offset
    "offset-ragged": dict(causal=True, q_offset=11, ragged=True),
    "bidirectional-ragged": dict(causal=False, ragged=True),
    "right-aligned": dict(causal=True, short_q=True),
}


@pytest.mark.parametrize("L", [24, 64, 129, 300])
@pytest.mark.parametrize("mode", list(F32_MODES))
def test_flash_f32_mask_modes(mode, L):
    """Every mask mode at the embedder's width (H = 12, Dh = 64) and at
    qwen3's head layout (40/8, Dh = 128), B = 5, on the one-pass kernel
    (L <= 64) and the tiled one (129, 300)."""
    kw = dict(F32_MODES[mode])
    ragged, short_q = kw.pop("ragged", False), kw.pop("short_q", False)
    if "window" in kw:
        kw["window"] = max(kw["window"], L // 3)
    if "prefix_len" in kw:
        kw["prefix_len"] = max(kw["prefix_len"], L // 4)
    for H, Hkv, Dh in ((12, 12, 64), (40, 8, 128)):
        B = 5
        g = _gen(len(mode) + L + Dh)
        Lq = max(1, L // 3) if short_q else L
        q = _randn((B, Lq, H, Dh), g, torch.float32)
        k, v = (_randn((B, L, Hkv, Dh), g, torch.float32) for _ in range(2))
        call = dict(kw)
        if ragged:
            call["kv_valid_len"] = torch.tensor(
                [L, 0, 1, max(1, L // 2), L - 1], device=DEV)
        if "q_offset" in call:
            call["q_offset"] = min(call["q_offset"], L - 1)
        out = _f32_check(q, k, v, **call)
        if ragged:
            assert not out[1].any()           # kv_valid_len 0: all masked


@pytest.mark.parametrize("L", [24, 300])
@pytest.mark.parametrize("layout", ["fused-projection", "misaligned",
                                    "odd-head-dim"])
def test_flash_f32_reads_views_in_place(layout, L):
    """q/k/v as slices of one fused (B, L, (H + 2 Hkv) Dh) projection (the
    16-byte copies), as views 4 bytes off a 16-byte boundary and with a
    head dim of 42 (the 4-byte copies of the same kernels), on the one-pass
    and the tiled kernel."""
    B, H, Hkv = 4, 12, 4
    Dh = 42 if layout == "odd-head-dim" else 64
    g = _gen(len(layout) + L)
    if layout == "fused-projection":
        heads = _randn((B, L, (H + 2 * Hkv) * Dh), g,
                       torch.float32).view(B, L, H + 2 * Hkv, Dh)
        q, k, v = heads[:, :, :H], heads[:, :, H:H + Hkv], \
            heads[:, :, H + Hkv:]
    else:
        wide = _randn((B, L, H + 2 * Hkv, Dh + 1), g, torch.float32)
        heads = wide[..., 1:] if layout == "misaligned" else wide[..., :Dh]
        q, k, v = heads[:, :, :H], heads[:, :, H:H + Hkv], \
            heads[:, :, H + Hkv:]
        assert layout != "misaligned" or q.data_ptr() % 16
    assert not q.is_contiguous()
    for causal in (False, True):
        _f32_check(q, k, v, causal=causal)
    _f32_check(q, k, v, causal=True, q_offset=3,
               kv_valid_len=torch.tensor([L, 2, 0, L // 2], device=DEV))


_PROFILE_CHILD = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.flash_attention import ops
B, L, H, Hkv, Dh, causal = json.loads(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn((B, L, H, Dh), generator=g, device="cuda")
k, v = (torch.randn((B, L, Hkv, Dh), generator=g, device="cuda")
        for _ in range(2))
ops.flash_attention(q, k, v, causal=causal)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]))
"""


def _profiled_kernels(shape, causal: bool, child: str = _PROFILE_CHILD
                      ) -> list:
    """The device kernels that one f32 K4 call at ``shape`` (B, L, H, Hkv,
    Dh) launches (``child``: another script of the same arguments), from a
    torch.profiler trace after a warm-up call, taken
    in a fresh child process: traces taken earlier in one process move its
    profiler's clock, and a later trace can then drop a kernel's record
    (tools/profiler_probe.py counts such drops)."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(src)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run(
        [sys.executable, "-c", child, json.dumps([*shape, causal])],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", [(4, 24, 12, 12, 64), (1, 24, 12, 12, 64),
                                   (4, 64, 12, 12, 64), (2, 300, 8, 2, 128)],
                         ids=["embed-B4", "embed-B1", "L64", "L300"])
def test_flash_f32_one_launch_and_bit_identical(shape):
    """One call launches one kernel (the f32 K4's, no fill or copy), and
    two calls on the same inputs give the same bits in fresh outputs."""
    B, L, H, Hkv, Dh = shape
    g = _gen(L + B)
    q = _randn((B, L, H, Dh), g, torch.float32)
    k, v = (_randn((B, L, Hkv, Dh), g, torch.float32) for _ in range(2))
    causal = L > 64
    names = _profiled_kernels(shape, causal)
    assert len(names) == 1 and "flash_f32" in names[0], names
    first = _f32_check(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert again.data_ptr() != first.data_ptr()
    assert torch.equal(first, again)


# zamba2-7b's shared attention block: 32 heads of 112 (MHA). bf16 K4
# takes its products at 112 (flash_bf16_persistent; TMA zero-fills the
# second 64-column slab past 112), f32 K4 pads to 128 (the zero-filling
# copies); both write exactly 112 columns a head, head h + 1 starting 112
# elements after head h
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_head_dim_112(dtype, ragged):
    B, L, H, Dh = 2, 333, 32, 112
    g = _gen(Dh + ragged)
    q, k, v = (_randn((B, L, H, Dh), g, dtype) for _ in range(3))
    kw = dict(causal=True)
    if ragged:
        kw.update(kv_valid_len=torch.tensor([333, 150], device=DEV),
                  q_offset=0)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert out.shape == (B, L, H, Dh) and out.is_contiguous()
    _assert_agree(out, plain, "flash")


# flash_bf16_persistent, the bf16 route of zamba2's (112, 112) and MLA's
# pairs (ops.fwd_route): a persistent grid over 128-row q tiles (two
# consumers of 64 rows) and kv tiles of 192 keys (Dv 64), 128 (112) or 96
# (192 / 128), the products at the exact widths; lengths on both sides of
# each tile edge, every mask mode, 2 query heads a kv head
PERSISTENT_DIMS = {"minicpm3": (96, 64), "zamba2": (112, 112),
                   "deepseek-v2": (192, 128)}
PERSISTENT_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 300, 4095]


def _persistent_inputs(dims, B, Lq, Lkv, H, Hkv, seed):
    Dq, Dv = PERSISTENT_DIMS[dims]
    g = _gen(seed)
    return (_randn((B, Lq, H, Dq), g, torch.bfloat16),
            _randn((B, Lkv, Hkv, Dq), g, torch.bfloat16),
            _randn((B, Lkv, Hkv, Dv), g, torch.bfloat16))


@pytest.mark.parametrize("L", PERSISTENT_LENGTHS)
@pytest.mark.parametrize("mode", list(FLASH_MODES))
@pytest.mark.parametrize("dims", sorted(PERSISTENT_DIMS))
def test_flash_persistent_tile_edges(dims, mode, L):
    kw = dict(FLASH_MODES[mode])
    B, H, Hkv = 2, 4, 2
    Lq = min(kw.pop("Lq", L), L)
    q, k, v = _persistent_inputs(dims, B, Lq, L, H, Hkv,
                                 seed=L + len(mode) + len(dims))
    if kw.pop("ragged", False):
        kw["kv_valid_len"] = torch.tensor([L, (L + 1) // 3], device=DEV)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.launches_dv,
              fa_ops.flash_attention.launches_persistent)
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    torch.cuda.synchronize()
    dv = int(q.shape[-1] != v.shape[-1])
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention.launches_dv,
            fa_ops.flash_attention.launches_persistent) == (
                before[0] + 1, before[1] + dv, before[2] + 1)
    assert out.shape == (B, Lq, H, v.shape[-1]) and out.is_contiguous()
    _assert_agree(out, plain, "flash")


_PROFILE_BF16_CHILD = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.flash_attention import ops
B, L, H, Hkv, Dq, Dv, causal = json.loads(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn((B, L, H, Dq), generator=g, device="cuda").bfloat16()
k = torch.randn((B, L, Hkv, Dq), generator=g, device="cuda").bfloat16()
v = torch.randn((B, L, Hkv, Dv), generator=g, device="cuda").bfloat16()
ops.flash_attention(q, k, v, causal=causal)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]))
"""


@pytest.mark.parametrize("dims", sorted(PERSISTENT_DIMS))
def test_flash_persistent_one_launch_and_bit_identical(dims):
    """One call launches one kernel, the route's flash_bf16_persistent
    instance (no fill, copy or second pass), and two calls on the same
    inputs give the same bits in fresh outputs (a static tile order, no
    atomics)."""
    Dq, Dv = PERSISTENT_DIMS[dims]
    B, L, H, Hkv = 2, 1000, 8, 4
    names = _profiled_kernels((B, L, H, Hkv, Dq, Dv), True,
                              child=_PROFILE_BF16_CHILD)
    route = fa_ops.fwd_route(torch.bfloat16, Dq, Dv)
    assert route.startswith("flash_bf16_persistent<")
    assert len(names) == 1 and route in names[0], names
    q, k, v = _persistent_inputs(dims, B, L, L, H, Hkv, seed=7)
    first = fa_ops.flash_attention(q, k, v, causal=True)
    again = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert again.data_ptr() != first.data_ptr()
    assert torch.equal(first, again)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_flash_bf16_pairs_that_pad_alike_stay_on_flash_bf16(Dh):
    """qwen3's Dh 128 (and 64, 256) keep flash_bf16's instance: one kernel
    of that name, and the persistent count does not move."""
    names = _profiled_kernels((1, 300, 8, 4, Dh, Dh), True,
                              child=_PROFILE_BF16_CHILD)
    route = fa_ops.fwd_route(torch.bfloat16, Dh, Dh)
    assert route.startswith("flash_bf16<")
    assert len(names) == 1 and route in names[0], names
    g = _gen(Dh)
    q, k, v = (_randn((1, 300, 8 if i == 0 else 4, Dh), g, torch.bfloat16)
               for i in range(3))
    before = fa_ops.flash_attention.launches_persistent
    fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches_persistent == before


@pytest.mark.parametrize("dims", sorted(PERSISTENT_DIMS))
def test_flash_persistent_misaligned_view_raises(dims):
    """A view that TMA cannot describe (a base 2 bytes off, a head dim not
    a multiple of 8) raises at the new routes' widths, as at the old ones,
    and launches nothing."""
    Dq, Dv = PERSISTENT_DIMS[dims]
    g = _gen(5)
    k = _randn((1, 64, 2, Dq), g, torch.bfloat16)
    v = _randn((1, 64, 2, Dv), g, torch.bfloat16)
    before = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        q = _randn((1, 64, 2, Dq + 8), g, torch.bfloat16)[..., 1:Dq + 1]
        fa_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="TMA"):
        vv = _randn((1, 64, 2, Dv + 8), g, torch.bfloat16)[..., 1:Dv + 1]
        fa_ops.flash_attention(k[:, :, :2], k, vv)
    assert fa_ops.flash_attention.launches == before


DECODE_KINDS = ["f32", "bf16", "int8-f32q", "int8-bf16q"]


def _decode_inputs(kind, B, H, Hkv, Dh, Lc, g, layers=1):
    """q (B, H, Dh) and caches (B, Lc, Hkv, Dh) as views of layer
    ``layers - 1`` of a stacked (2, layers, ...) cache, read in place;
    int8 kinds give codes and f16 scales (views of a stacked scale too)."""
    qdt = torch.bfloat16 if kind.endswith("bf16") or kind.endswith("bf16q") \
        else torch.float32
    q = _randn((B, H, Dh), g, qdt)
    kv = _randn((2, layers, B, Lc, Hkv, Dh), g, torch.float32)
    scales = {}
    if kind.startswith("int8"):
        amax = kv.abs().amax(dim=-1)
        s = (amax / 127.0).to(torch.float16)
        codes = torch.round(kv / s.float()[..., None]).clamp(-127, 127)
        kv = codes.to(torch.int8)
        scales = dict(k_scale=s[0, -1], v_scale=s[1, -1])
    else:
        kv = kv.to(qdt)
    return q, kv[0, -1], kv[1, -1], scales


def _decode_check(q, k, v, kv_len, scales):
    before = (da_ops.decode_attention.launches,
              da_ops.decode_attention.launches_int8)
    out = da_ops.decode_attention(q, k, v, kv_len, **scales)
    plain = da_ref.decode_attention_ref(q, k, v, kv_len, **scales)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before[0] + 1
    assert da_ops.decode_attention.launches_int8 == before[1] + bool(scales)
    assert out.shape == q.shape and out.dtype == q.dtype
    _assert_agree(out, plain, "decode")
    return out


# G = H / Hkv query heads a kv head: one tensor-core n-block (G <= 8) or
# two (G = 16); head dims of the fast path
@pytest.mark.parametrize("G", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kernel_matches_plain(kind, Dh, G):
    B, Hkv, Lc = 3, 2, 700
    g = _gen(Dh + len(kind) + 17 * G)
    # caches are per-layer views of a stacked cache, read in place
    q, k, v, scales = _decode_inputs(kind, B, G * Hkv, Hkv, Dh, Lc, g,
                                     layers=2)
    _decode_check(q, k, v, torch.tensor([1, 700, 413], device=DEV), scales)


# K3 at zamba2's head dim 112 (32 heads, MHA): a bf16 q and cache take the
# fast kernel, its 128 instance over rows zero-filled past 112 in shared
# memory; f32 the generic two-pass kernel. kv_len ragged across the batch
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_decode_head_dim_112_routes_bf16_to_the_fast_kernel(kind):
    B, H, Dh, Lc = 4, 32, 112, 700
    q, k, v, scales = _decode_inputs(kind, B, H, H, Dh, Lc, _gen(112),
                                     layers=2)
    out = _decode_check(q, k, v, torch.tensor([1, 700, 413, 256],
                                              device=DEV), scales)
    assert out.shape == (B, H, Dh) and out.is_contiguous()
    fast = da_kernel.last_n_split.value > 0
    assert fast == (kind == "bf16")


def _dh112_inputs(B, Lc, seed, H=32):
    g = _gen(seed)
    q = _randn((B, H, 112), g, torch.bfloat16)
    k, v = (_randn((B, Lc, H, 112), g, torch.bfloat16) for _ in range(2))
    return q, k, v


def test_decode_head_dim_112_kv_len_at_its_edges():
    """An 8,192-position cache (zamba2's max_len): kv_len 0, 1, a 16-row
    tile and a 64-position chunk step and their neighbours, 4,096 and the
    whole cache, then n x 64 and its neighbours, n the grid's splits (the
    last split full, one short, one row into a longer chunk). bf16 on the
    fast kernel, int32 and int64 lengths."""
    Lc = 8192
    lens = [0, 1, 15, 16, 17, 63, 64, 65, 4095, 4096, 4097, Lc]
    q, k, v = _dh112_inputs(len(lens) + 3, Lc, 113, H=4)
    da_ops.decode_attention(q, k, v, torch.tensor(lens + [1, 2, 3],
                                                  device=DEV))
    n = da_kernel.last_n_split.value
    assert 1 <= n <= Lc // 64
    lens += [n * 64 - 1, n * 64, n * 64 + 1]
    for dtype in (torch.int32, torch.int64):
        kv_len = torch.tensor(lens, dtype=dtype, device=DEV)
        out = _decode_check(q, k, v, kv_len, {})
        assert da_kernel.last_n_split.value > 0
        assert float(out[0].abs().max()) == 0.0          # kv_len 0


def test_decode_head_dim_112_misaligned_view_takes_the_generic_path():
    """k and v 4 bytes off a 16-byte boundary: the generic kernel reads
    them through their strides (``last_n_split == 0``) and agrees."""
    B, H, Lc = 3, 8, 500
    g = _gen(114)
    q = _randn((B, H, 112), g, torch.bfloat16)
    wide = _randn((2, B, Lc, H, 114), g, torch.bfloat16)
    k, v = wide[0, ..., 2:], wide[1, ..., 2:]
    _decode_check(q, k, v, torch.tensor([500, 3, 260], device=DEV), {})
    assert da_kernel.last_n_split.value == 0


def test_decode_head_dim_112_back_to_back_calls_are_bit_identical():
    """zamba2's decode (B 4, 32 heads, an 8,192 cache): the splits merge in
    split order and the counters are left at 0, so repeated calls give
    the same bits, interleaved with a call of another shape."""
    q, k, v = _dh112_inputs(4, 8192, 115)
    kv_len = torch.tensor([4096, 4097, 8192, 100], device=DEV)
    first = _decode_check(q, k, v, kv_len, {})
    assert da_kernel.last_n_split.value > 1
    again = da_ops.decode_attention(q, k, v, kv_len)
    q2, k2, v2 = _dh112_inputs(2, 1000, 116, H=4)
    da_ops.decode_attention(q2, k2, v2, torch.tensor([999, 5], device=DEV))
    third = da_ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)


def test_decode_head_dim_112_dropped_tile_fails_the_limit():
    """A planted fault the checks above must catch: the plain version with
    one 256-position span of the cache left out exceeds the bf16 limit,
    while the fast kernel stays within it."""
    B, Lc, n = 2, 2048, 2048
    q, k, v = _dh112_inputs(B, Lc, 117)
    kv_len = torch.full((B,), n, device=DEV)
    plain = da_ref.decode_attention_ref(q, k, v, kv_len)

    def holed(x):
        return torch.cat([x[:, :1024], x[:, 1280:]], dim=1)
    bad = da_ref.decode_attention_ref(q, holed(k), holed(v), kv_len - 256)
    assert bf16_excess(bad, plain, ROW_RTOL["decode"]) > 1.0
    out = da_ops.decode_attention(q, k, v, kv_len)
    assert da_kernel.last_n_split.value > 0
    torch.cuda.synchronize()
    assert bf16_excess(out, plain, ROW_RTOL["decode"]) <= 1.0


@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kv_len_at_split_edges(kind):
    """kv_len 0, 1, one 16-position tile and one 64-position chunk step and
    their neighbours, the generic path's 256-position split and its
    neighbours, the whole cache; with a bf16 q (the fast path) also n x 64
    and its neighbours, n the splits of the kernel's grid (the last split
    full, one short, one row into a longer chunk). int32 and int64."""
    Hkv, Dh, Lc = 2, 128, 2048
    lens = [0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 1000, Lc]
    g = _gen(len(kind))
    q, k, v, scales = _decode_inputs(kind, len(lens) + 3, 5 * Hkv, Hkv, Dh,
                                     Lc, g)
    da_ops.decode_attention(q, k, v, torch.tensor(lens + [1, 2, 3],
                                                  device=DEV), **scales)
    n = da_kernel.last_n_split.value
    if q.dtype == torch.bfloat16:
        assert 1 <= n <= Lc // 64
        lens += [n * 64 - 1, n * 64, n * 64 + 1]
    else:
        assert n == 0                    # an f32 q takes the generic path
        lens += [511, 512, 513]
    for dtype in (torch.int32, torch.int64):
        _decode_check(q, k, v, torch.tensor(lens, dtype=dtype, device=DEV),
                      scales)


@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kv_len_all_zero_gives_zero(kind):
    q, k, v, scales = _decode_inputs(kind, 3, 10, 2, 128, 300, _gen(5))
    out = _decode_check(q, k, v, torch.zeros(3, dtype=torch.int32,
                                             device=DEV), scales)
    assert not out.any()


@pytest.mark.parametrize("layout", ["heads-interleaved", "misaligned",
                                    "odd-head-dim"])
def test_decode_reads_views_in_place(layout):
    """k and v as slices of one packed (B, Lc, 2 Hkv, Dh) cache (the fast
    path: 16-byte aligned rows, head stride 2 Dh); a view 4 bytes off a
    16-byte boundary and a head dim of 40 take the generic path. Both read
    the cache through its strides, and both agree."""
    B, H, Hkv, Lc = 3, 10, 2, 500
    g = _gen(7)
    Dh = 40 if layout == "odd-head-dim" else 128
    q = _randn((B, H, Dh), g, torch.bfloat16)
    if layout == "heads-interleaved":
        kv = _randn((B, Lc, 2, Hkv, Dh), g, torch.bfloat16)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        wide = _randn((2, B, Lc, Hkv, Dh + 2), g, torch.bfloat16)
        k, v = (wide[i, ..., 2:] if layout == "misaligned"
                else wide[i, ..., :Dh] for i in range(2))
    assert not k.is_contiguous()
    kv_len = torch.tensor([500, 3, 260], device=DEV)
    _decode_check(q, k, v, kv_len, {})
    generic = da_kernel.last_n_split.value == 0
    assert generic == (layout != "heads-interleaved")


@pytest.mark.parametrize("kind", ["bf16", "int8-bf16q"])
def test_decode_back_to_back_calls_are_bit_identical(kind):
    """The last CTA of a (sequence, kv head) merges the splits in split
    order, whichever arrives last, and leaves its counter at 0: repeated
    calls give the same bits, interleaved with a call of another shape."""
    q, k, v, scales = _decode_inputs(kind, 4, 40, 8, 128, 8192, _gen(9))
    kv_len = torch.tensor([4096, 4097, 8192, 100], device=DEV)
    first = _decode_check(q, k, v, kv_len, scales)
    assert da_kernel.last_n_split.value > 1
    again = da_ops.decode_attention(q, k, v, kv_len, **scales)
    q2, k2, v2, sc2 = _decode_inputs(kind, 2, 10, 2, 128, 1000, _gen(10))
    da_ops.decode_attention(q2, k2, v2, torch.tensor([999, 5], device=DEV),
                            **sc2)
    third = da_ops.decode_attention(q, k, v, kv_len, **scales)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)


@pytest.mark.parametrize("kind", ["bf16", "int8-bf16q"])
def test_decode_engine_long_shape_at_32k(kind):
    """qwen3-14b's decode layout (B=4, H=40/8, Dh=128) at decode_32k's
    kv_len = Lc = 32,768, and a ragged batch in the same cache."""
    Lc = 32768
    q, k, v, scales = _decode_inputs(kind, 4, 40, 8, 128, Lc, _gen(11))
    for lens in ([Lc] * 4, [Lc, Lc - 1, 4097, 1]):
        _decode_check(q, k, v, torch.tensor(lens, device=DEV), scales)


def test_model_layers_route_cuda_tensors_to_the_kernels():
    from repro_torch.models import layers as L
    g = _gen(1)
    q = _randn((2, 9, 4, 64), g, torch.float32)
    k = _randn((2, 9, 2, 64), g, torch.float32)
    f0, d0 = fa_ops.flash_attention.launches, da_ops.decode_attention.launches
    out = L.flash_attention(q, k, k, causal=True)
    torch.testing.assert_close(
        out, L.flash_attention_plain(q, k, k, causal=True), atol=2e-5,
        rtol=0)
    kv_len = torch.tensor([9, 4], device=DEV)
    dec = L.decode_attention(q[:, :1], k, k, kv_len=kv_len)
    torch.testing.assert_close(
        dec, L.decode_attention_plain(q[:, :1], k, k, kv_len=kv_len),
        atol=2e-5, rtol=0)
    assert fa_ops.flash_attention.launches == f0 + 1
    assert da_ops.decode_attention.launches == d0 + 1
    with pytest.raises(NotImplementedError):
        L.decode_attention(q[:, :1], k, k, kv_len=kv_len, window=4)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), k.half())


def test_int8_engine_kernels_match_plain_layers(monkeypatch):
    """Reduced qwen3 in fp32 with the int8 KV cache on the card: prefill
    and decode logits through K4 + K3 (int8 codes read in place) against
    the plain layers (dequantize, then attend) from the same cache. atol
    1e-3: a k/v value within an ulp of a rounding boundary may take the
    neighbouring code in the two runs, one code step being 1/127 of its
    row's largest magnitude."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                    kv_dtype="int8")
    params = lm.init_params(_gen(0), cfg, device=DEV)
    toks = torch.arange(3, 23, device=DEV).reshape(2, 10) * 37 \
        % cfg.vocab_size
    cache = lm.init_cache(cfg, 2, 16, device=DEV)
    d0 = da_ops.decode_attention.launches_int8
    last, cache = lm.prefill(params, cfg, {"tokens": toks}, cache)
    nxt = torch.argmax(last, dim=-1)[:, None]
    start = {k: v.clone() for k, v in cache.items()}
    dec, _ = lm.decode_step(params, cfg, nxt, cache, 10)
    assert da_ops.decode_attention.launches_int8 == d0 + cfg.n_layers
    monkeypatch.setattr(L, "flash_attention", L.flash_attention_plain)
    monkeypatch.setattr(L, "decode_attention", L.decode_attention_plain)
    plain_last, _ = lm.prefill(params, cfg, {"tokens": toks},
                               lm.init_cache(cfg, 2, 16, device=DEV))
    plain_dec, _ = lm.decode_step(params, cfg, nxt, start, 10)
    torch.testing.assert_close(last, plain_last, atol=1e-3, rtol=0)
    torch.testing.assert_close(dec, plain_dec, atol=1e-3, rtol=0)
