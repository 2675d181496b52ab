"""Wrapper around the prefill attention kernel (K4).

For CUDA tensors ``flash_attention`` launches the hand-written kernel (see
``kernel.py``) on the current stream, or raises; for CPU tensors it runs
the plain version in ``ref.py`` with P rounded to v's dtype before P·V,
as the bf16 kernel does. There is no fallback from one to the
other. A bf16 view that TMA cannot describe raises ``ValueError``
(``tma_layout_check``); an f32 view of any strides is read in place (16
bytes at a time where it is 16-byte aligned, else 4). ``fwd_route``
names the kernel instance a CUDA call takes: in bf16 zamba2's (112, 112)
and the MLA pairs take ``flash_bf16_persistent`` at exact widths, the
other pairs ``flash_bf16``. Launches are counted
in ``flash_attention.launches``; of them, those with a value head dim
other than the q/k one also in ``flash_attention.launches_dv``, and the
other f32 ones in ``flash_attention.launches_f32`` (the two are
disjoint); the bf16 ones on ``flash_bf16_persistent`` (or its
``_lse`` instance) also in ``flash_attention.launches_persistent``, and
those that write the LSE for the backward in
``flash_attention.launches_lse``.

The Dv mode (MLA: q/k of Dq = 96 with v of Dv = 64 in minicpm3, 192 with
128 in deepseek-v2) is a port extension: the Pallas kernel takes one head
dim, and the mode is held against the reference model layer's jnp
``flash_attention``, which takes a separate Dv. The kernel reads v at its
own width and writes the (B, Lq, H, Dv) output directly; nothing is padded
or sliced around it (``dv_supported`` names the pairs it takes).

Unlike the Pallas wrapper, the kernel reads q/k/v in the (B, L, H, Dh)
layout through their strides (no transposed or padded copies), and takes
an explicit ``q_offset`` and a ragged ``kv_valid_len``.

Training: with grad mode on and an input that requires grad,
``flash_attention`` goes through ``FlashAttentionFn``, whose backward is
``flash_attention_bwd``: hand-written kernels on CUDA tensors
(``csrc/flash_attention_bwd.cu``), ``ref.attention_bwd_ref`` on CPU
tensors, at every (Dq, Dv) the forward takes (the MLA pairs among them),
head dims up to 256 and a ragged ``kv_valid_len`` (a non-differentiable
input that every backward kernel takes). On the card ``bwd_route`` picks
the kernels: an f32 call with Lq and Lkv at most 64 (32 past head dim
128; the embedder's 24 tokens) takes one fused one-pass kernel, one
launch with no LSE/D scratch; every other call a pair, (a) dQ then (b)
dK/dV: the tiled pair ("tiled": the wgmma kernels in bf16 with both head
dims at most 128, the CUDA-core kernels in f32), in bf16 at minicpm3's
class (Dq in (64, 96], Dv <= 64) the wgmma pair at its exact widths
("tiled_exact", whose (a) takes the LSE that the forward saved), or, in
bf16 past 128 (paligemma's 256, deepseek-v2's (192, 128)), the wide wgmma
pair ("tiled_wide"). At that class (``saves_lse``) ``FlashAttentionFn``'s
forward writes each row's LSE (K4's ``flash_bf16_persistent_lse``; on
CPU tensors ``ref.attention_lse``) and saves it for the backward. Every
backward launch counts in ``flash_attention.launches_bwd``; the f32 ones
also in ``flash_attention.launches_bwd_f32``, and of those the one-pass
ones in ``flash_attention.launches_bwd_f32_one_pass``; the bf16
"tiled_wide" ones in ``launches_bwd_wide``, and the other bf16 ones with
Dv != Dq (the wgmma pair's MLA calls) in ``launches_bwd_dv``, of which
those of the exact-width instances in ``launches_bwd_exact``. No route
falls back to another or to the plain version: a kernel that fails to
build or launch raises. The backward is a port extension: the Pallas
kernel has no VJP, and the reference differentiates its jnp attention
(held against ``jax.grad`` of ``repro/models/layers.py``'s
``flash_attention``).
Serving, without grad, takes the plain forward route above.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_cpu
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref

DH_MAX = 256
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0, q_offset: Optional[int] = None,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q (B, Lq, H, Dh), k (B, Lkv, Hkv, Dh), v (B, Lkv, Hkv, Dv) ->
    (B, Lq, H, Dv) in q's dtype, scaled by 1 / sqrt(Dh). ``q_offset`` is
    the position of q[:, 0] (default ``Lkv - Lq``, right-aligned queries);
    ``kv_valid_len`` (B,) masks keys at or past it. The mask is
    ``ref.attention_mask``'s.

    With grad mode on and q, k or v requiring grad, the call goes through
    ``FlashAttentionFn`` (the same forward, and the backward kernels on
    CUDA tensors); ``kv_valid_len`` gets no gradient."""
    Lq, Lkv = q.shape[1], k.shape[1]
    if q_offset is None:
        q_offset = Lkv - Lq
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, prefix_len,
                                      q_offset, kv_valid_len)
    return _forward(q, k, v, causal, window, prefix_len, q_offset,
                    kv_valid_len)


def _forward(q, k, v, causal, window, prefix_len, q_offset, kv_valid_len,
             with_lse: bool = False):
    """K4's launch on CUDA tensors, ``ref.attention_ref`` on CPU tensors.
    With ``with_lse`` (a call that ``saves_lse`` takes) it returns (out,
    lse): the rows' LSE as ``ref.attention_lse`` gives it, written by the
    kernel's ``_lse`` instance (the same out, bit for bit) or, on CPU
    tensors, by ``ref.attention_lse``."""
    B, Lq, H, Dh = q.shape
    Lkv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if with_lse and not saves_lse(q.dtype, Dh, Dv):
        raise ValueError(f"no kernel instance writes the LSE of a "
                         f"{q.dtype} call at head dims {Dh}, {Dv}")
    if on_cpu(q, k, v, kv_valid_len):
        out = ref.attention_ref(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len, q_offset=q_offset,
                                kv_valid_len=kv_valid_len, p_dtype=v.dtype)
        if not with_lse:
            return out
        return out, ref.attention_lse(q, k, causal=causal, window=window,
                                      prefix_len=prefix_len,
                                      q_offset=q_offset,
                                      kv_valid_len=kv_valid_len)
    dtype = q.dtype
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q/k/v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, Lkv, Hkv, Dh) or v.shape != (B, Lkv, Hkv, Dv):
        raise ValueError(f"k/v must be (B, Lkv, Hkv, {Dh}) like q's batch and "
                         f"head dim, and (B, Lkv, Hkv, Dv), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}")
    if not (1 <= Dh <= DH_MAX and 1 <= Dv <= DH_MAX):
        raise ValueError(f"head dims {Dh}, {Dv} outside [1, {DH_MAX}]")
    if not dv_supported(Dh, Dv):
        raise ValueError(f"no kernel instance takes q/k head dim {Dh} with "
                         f"v head dim {Dv}")
    strides = q.stride() + k.stride() + v.stride()
    if strides[3] != 1 or strides[7] != 1 or strides[11] != 1:
        raise ValueError("q/k/v need unit stride in the head dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if kv_valid_len is not None:
        if kv_valid_len.shape != (B,):
            raise ValueError(f"kv_valid_len must have shape ({B},)")
        kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    if dtype == torch.bfloat16:
        tma_layout_check(q, k, v)
    out = torch.empty((B, Lq, H, Dv), dtype=dtype, device=q.device)
    lse = torch.empty((B, H, ref.lse_rows(Lq)), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if not (B and Lq and H):
        return (out, lse) if with_lse else out
    K.launch(q, k, v, out, kv_valid_len, causal=causal,
             window=window or 0, prefix_len=prefix_len, q_offset=q_offset,
             strides=strides, lse=lse)
    flash_attention.launches += 1
    flash_attention.launches_lse += with_lse
    if Dv != Dh:
        flash_attention.launches_dv += 1
    elif dtype == torch.float32:
        flash_attention.launches_f32 += 1
    if dtype == torch.bfloat16 and _persistent(Dh, Dv):
        flash_attention.launches_persistent += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0        # every K4 launch
flash_attention.launches_f32 = 0    # of which f32 with Dv = Dq (embedder)
flash_attention.launches_dv = 0     # of which Dv != Dq (MLA's prefill)
flash_attention.launches_persistent = 0     # bf16 on flash_bf16_persistent
flash_attention.launches_lse = 0    # of which writing the LSE (training)
flash_attention.launches_bwd = 0    # every backward kernel launch
flash_attention.launches_bwd_f32 = 0    # of which f32
flash_attention.launches_bwd_f32_one_pass = 0   # of which one-pass (embedder)
flash_attention.launches_bwd_dv = 0     # bf16 wgmma pair, Dv != Dq (MLA)
flash_attention.launches_bwd_exact = 0  # of which at the exact <96, 64>
flash_attention.launches_bwd_wide = 0   # bf16 wide wgmma pair (past 128)

BWD_DH_MAX = 256
BWD_WGMMA_DH_MAX = 128      # the bf16 wgmma pair's largest head dims
BWD_ONE_PASS_MAX = 64       # the one-pass kernel's largest Lq and Lkv,
BWD_ONE_PASS_WIDE_MAX = 32  # and past head dim 128


def saves_lse(dtype: torch.dtype, Dq: int, Dv: int) -> bool:
    """True for the calls whose training forward writes each row's LSE for
    the backward (K4's ``flash_bf16_persistent_lse<96, 64, 192>``): bf16
    with Dq in (64, 96] and Dv <= 64, minicpm3's MLA class, whose backward
    is the ``"tiled_exact"`` pair."""
    return dtype == torch.bfloat16 and 64 < Dq <= 96 and 1 <= Dv <= 64


def bwd_route(dtype: torch.dtype, Lq: int, Lkv: int, Dq: int,
              Dv: Optional[int] = None) -> str:
    """The backward kernels a CUDA call with q/k head dim Dq and v head dim
    Dv (default Dq) takes, as the C dispatch of
    ``csrc/flash_attention_bwd.cu`` picks them: ``"one_pass"`` (one fused
    kernel, ``bwd_one_pass_f32``) for float32 with Lq and Lkv at most 64,
    or at most 32 where a head dim is over 128; ``"tiled"``, the pair (a)
    dQ, (b) dK/dV, for every other call: ``bwd_dq_bf16<DQP, DVP>`` /
    ``bwd_dkv_bf16`` (wgmma, each width padded to 64 or 128) in bf16,
    ``bwd_dq_f32<DP, VEC>`` / ``bwd_dkv_f32`` (CUDA cores, the larger
    head dim padded to 64, 128 or 256) in f32;
    ``"tiled_exact"`` for bf16 with Dq in (64, 96] and Dv <= 64
    (minicpm3's MLA, ``saves_lse``): the wgmma pair at the exact widths
    <96, 64>, (a) ``bwd_dq_lse_bf16<96, 64>`` from the LSE the forward
    saved (pass 2 alone) or, for a call without one, ``bwd_dq_bf16<128,
    64>`` (passes 1 and 2), and (b) ``bwd_dkv_bf16<96, 64>``;
    ``"tiled_wide"`` for bf16 with a head dim over 128:
    ``bwd_dq_wide_bf16<DQP, DVP>`` / ``bwd_dkv_wide_bf16`` (wgmma, at
    <192, 128> where Dq <= 192 and Dv <= 128, deepseek-v2's, else <256,
    256>, whose (b) splits dK's and dV's columns across two CTAs where its
    grid would fill at most the SMs). Raises ``ValueError`` for a head
    dim outside [1, 256]."""
    Dv = Dq if Dv is None else Dv
    if not (1 <= Dq <= BWD_DH_MAX and 1 <= Dv <= BWD_DH_MAX):
        raise ValueError(f"head dims {Dq}, {Dv} outside [1, {BWD_DH_MAX}]")
    wide = max(Dq, Dv) > BWD_WGMMA_DH_MAX
    if dtype == torch.float32:
        short = BWD_ONE_PASS_WIDE_MAX if wide else BWD_ONE_PASS_MAX
        return "one_pass" if max(Lq, Lkv) <= short else "tiled"
    if saves_lse(dtype, Dq, Dv):
        return "tiled_exact"
    return "tiled_wide" if wide else "tiled"


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a hand-written backward: the forward is K4 (or
    ``ref.attention_ref`` on CPU tensors), the backward
    ``flash_attention_bwd`` from q, k, v, the saved output and, where
    ``saves_lse`` holds, the rows' LSE that the forward wrote (saved like
    the output, so that a recomputed forward, under ``torch.utils.
    checkpoint``, writes it again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, q_offset,
                kv_valid_len):
        lse = None
        if saves_lse(q.dtype, q.shape[-1], v.shape[-1]):
            out, lse = _forward(q, k, v, causal, window, prefix_len,
                                q_offset, kv_valid_len, with_lse=True)
        else:
            out = _forward(q, k, v, causal, window, prefix_len, q_offset,
                           kv_valid_len)
        ctx.save_for_backward(q, k, v, out, kv_valid_len, lse)
        ctx.mask = dict(causal=causal, window=window, prefix_len=prefix_len,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, kv_valid_len, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do,
                                         kv_valid_len=kv_valid_len, lse=lse,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        prefix_len: int = 0, q_offset: Optional[int] = None,
                        kv_valid_len: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at q (B, Lq, H, Dq), k (B, Lkv,
    Hkv, Dq), v (B, Lkv, Hkv, Dv) given its output o and the output's
    cotangent do (B, Lq, H, Dv), in the inputs' dtypes: on CUDA tensors
    the kernels ``bwd_route`` names (the one-pass kernel in one launch, or
    (a) then (b)), each launch counted as the module docstring says;
    ``ref.attention_bwd_ref`` on CPU tensors. ``lse``: the rows' LSE that
    the forward saved (``_forward(..., with_lse=True)``, (B, H,
    ``ref.lse_rows(Lq)``) f32), which the "tiled_exact" route's (a) reads
    in place of its pass 1; another route raises on it. Inputs of any
    strides are copied contiguous first, and bf16 ones as
    ``bwd_operands`` gives them (the gradients of a padded head dim
    sliced back). The scale is 1 / sqrt(Dq). ``kv_valid_len`` (B,) masks keys of row b at or past it:
    every route takes it, and keys that no row sees get zero dk and dv."""
    Lq, Lkv = q.shape[1], k.shape[1]
    if q_offset is None:
        q_offset = Lkv - Lq
    if on_cpu(q, k, v, o, do, kv_valid_len, lse):
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                     window=window, prefix_len=prefix_len,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len, lse=lse)
    B, _, H, Dq = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    dtype = q.dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in (k, v, o, do)):
        raise TypeError(f"q/k/v/o/do must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}, {o.dtype}, "
                        f"{do.dtype}")
    if k.shape != (B, Lkv, Hkv, Dq) or v.shape != (B, Lkv, Hkv, Dv) \
            or o.shape != (B, Lq, H, Dv) or do.shape != o.shape:
        raise ValueError(f"k must be (B, Lkv, Hkv, {Dq}), v (B, Lkv, Hkv, "
                         f"Dv) and o/do (B, Lq, H, Dv) for q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(o.shape)}, "
                         f"{tuple(do.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}")
    route = bwd_route(dtype, Lq, Lkv, Dq, Dv)
    if lse is not None:
        if route != "tiled_exact":
            raise ValueError(f"a saved LSE is read by the tiled_exact route "
                             f"alone, not by {route} (head dims {Dq}, {Dv})")
        if lse.dtype != torch.float32 or not lse.is_contiguous() or \
                lse.shape != (B, H, ref.lse_rows(Lq)):
            raise ValueError(f"lse must be contiguous float32 (B, H, "
                             f"{ref.lse_rows(Lq)}), got {lse.dtype} "
                             f"{tuple(lse.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if kv_valid_len is not None:
        if kv_valid_len.shape != (B,):
            raise ValueError(f"kv_valid_len must have shape ({B},)")
        kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    if not (B and Lq and H and Lkv):
        return tuple(torch.zeros(t.shape, dtype=dtype, device=t.device)
                     for t in (q, k, v))
    if dtype == torch.bfloat16:
        q, k, v, o, do = bwd_operands(q, k, v, o, do)
    else:
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if lse is not None:                 # (a) from it, then (b)
        dsum, parts = torch.empty_like(lse), (3, 1)
    else:
        lse, dsum = (None, None) if route == "one_pass" else \
            K.bwd_scratch(q)
        parts = (2,) if route == "one_pass" else (0, 1)
    for part in parts:
        K.launch_bwd(q, k, v, o, do, dq, dk, dv, lse, dsum, causal=causal,
                     window=window or 0, prefix_len=prefix_len,
                     q_offset=q_offset, part=part, scale_dim=Dq,
                     kv_valid_len=kv_valid_len)
        flash_attention.launches_bwd += 1
        if dtype == torch.float32:
            flash_attention.launches_bwd_f32 += 1
        elif route == "tiled_wide":
            flash_attention.launches_bwd_wide += 1
        elif Dv != Dq:
            flash_attention.launches_bwd_dv += 1
            # the exact-width instances: (b), and (a) from a saved LSE
            flash_attention.launches_bwd_exact += (route == "tiled_exact"
                                                   and part != 0)
        if part == 2:
            flash_attention.launches_bwd_f32_one_pass += 1
    if q.shape[-1] != Dq:
        dq, dk = dq[..., :Dq].contiguous(), dk[..., :Dq].contiguous()
    if v.shape[-1] != Dv:
        dv = dv[..., :Dv].contiguous()
    return dq, dk, dv


def bwd_operands(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """q, k, v, o and do as the bf16 backward kernels read them (through TMA
    tensor maps, and o and do 16 bytes at a time for D): contiguous, with a 16-byte aligned base (a contiguous view at a
    misaligned storage offset is copied) and a head dim that is a multiple
    of 8 (16-byte rows): another head dim (100) is given as a copy
    zero-padded to the next multiple, each tensor to its own (q and k by
    Dq, v, o and do by Dv), which adds nothing to S, dP or D, and whose
    gradients' extra columns are zero. The kernels take the scale of the
    unpadded Dq. Tensors already so are passed as they are; nothing here
    depends on the device."""
    out = []
    for t in tensors:
        t = t.contiguous()
        pad = -t.shape[-1] % 8
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        elif t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _pad(d: int) -> int:
    return 64 if d <= 64 else 128 if d <= 128 else 256


def dv_supported(Dq: int, Dv: int) -> bool:
    """True when a kernel instance takes q/k of head dim Dq with v of Dv
    (``flash_attention.cu``'s ``dq_instance``): both pad alike to 64, 128
    or 256, or Dq <= 128 with Dv <= 64, or Dq <= 192 with Dv <= 128 (the
    MLA pairs)."""
    pq, pv = _pad(Dq), _pad(Dv)
    return pq == pv or (pq == 128 and pv == 64) or (pv == 128 and Dq <= 192)


def fwd_route(dtype: torch.dtype, Dq: int, Dv: int) -> str:
    """The forward kernel a CUDA call with q/k head dim Dq and v head dim
    Dv takes, as its device name begins (``flash_attention.cu``'s
    ``flash_attention`` dispatch): ``"flash_f32"`` for float32; in bf16
    ``"flash_bf16_persistent<DQ, DV, BK>"`` at exact widths for zamba2's
    (112, 112) and the MLA pairs (Dq <= 96 with Dv <= 64 past the 64s at
    <96, 64, 192>, minicpm3's; every other MLA pair at <192, 128, 96>,
    deepseek-v2's), and ``"flash_bf16<P, P, BK>"`` where both pad alike to
    P = 64, 128 or 256 (BK 128, 64 at 256). Raises ``ValueError`` for a
    pair that ``dv_supported`` refuses."""
    if not (1 <= Dq <= DH_MAX and 1 <= Dv <= DH_MAX
            and dv_supported(Dq, Dv)):
        raise ValueError(f"no kernel instance takes q/k head dim {Dq} with "
                         f"v head dim {Dv}")
    if dtype == torch.float32:
        return "flash_f32"
    pq = _pad(Dq)
    if not _persistent(Dq, Dv):
        return f"flash_bf16<{pq}, {pq}, {64 if pq == 256 else 128}>"
    if (Dq, Dv) == (112, 112):
        return "flash_bf16_persistent<112, 112, 128>"
    if pq == 128 and Dq <= 96:
        return "flash_bf16_persistent<96, 64, 192>"
    return "flash_bf16_persistent<192, 128, 96>"


def _persistent(Dq: int, Dv: int) -> bool:
    """A supported pair that bf16 sends to flash_bf16_persistent: zamba2's
    (112, 112) and every pair whose widths pad apart (the MLA pairs)."""
    return (Dq, Dv) == (112, 112) or _pad(Dq) != _pad(Dv)


def tma_layout_check(*tensors: torch.Tensor) -> None:
    """The bf16 kernel reads q/k/v through TMA tensor maps, which take
    16-byte aligned base addresses and byte strides that are multiples of
    16: a head dim that is a multiple of 8, and B/L/H strides (of dims
    longer than 1) that are positive multiples of 8 elements. Anything else
    raises; it is never sent to another kernel."""
    for name, t in zip("qkv", tensors):
        bad = [f"stride {st} of dim {i}" for i, (n, st) in
               enumerate(zip(t.shape[:3], t.stride()[:3]))
               if n > 1 and (st <= 0 or st % 8)]
        if t.shape[3] % 8:
            bad.append(f"head dim {t.shape[3]}")
        if t.data_ptr() % 16:
            bad.append(f"base address {t.data_ptr():#x}")
        if bad:
            raise ValueError(
                f"bf16 flash_attention reads {name} through a TMA tensor map, "
                f"which needs a 16-byte aligned base, a head dim that is a "
                f"multiple of 8 and B/L/H strides that are multiples of 8 "
                f"elements (16 bytes); {name} has " + ", ".join(bad))
