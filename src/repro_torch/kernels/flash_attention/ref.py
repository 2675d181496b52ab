"""Plain PyTorch version of the prefill attention kernel (K4).

A port of ``repro/kernels/flash_attention/ref.py::attention_ref`` with
what the engine needs added: an explicit ``q_offset`` (default
``Lkv - Lq``, the Pallas wrapper's right-aligned queries), an optional
ragged ``kv_valid_len`` (B,) and an optional rounding of P. The mask is
the model layer's (``repro/models/layers.py:157-161,212-223``): keys past
``kv_valid_len[b]`` are masked; ``kpos <= qpos`` when causal;
``qpos - kpos < window`` when a window is set; keys before ``prefix_len``
are always visible. A fully masked row returns 0, as the Pallas kernel's
online-softmax recurrence does.

Scores, softmax and the sums are f32. With ``p_dtype`` set, the
unnormalised P is rounded to it before P·V, as the model layer and the
bf16 kernel do with the value dtype; without it P stays f32, the Pallas
kernel's form. ``models.layers.flash_attention_plain`` is this function
with ``p_dtype`` the value dtype. The CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.

``attention_bwd_ref`` is the plain version of the backward kernel: the
gradients of ``attention_ref`` in the recurrence that kernel runs, from
the LSE it recomputes or from a saved one; ``attention_lse`` is the plain
version of the LSE that K4's training forward writes for it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LOG2E = 1.4426950408889634


def lse_rows(Lq: int) -> int:
    """The rows of a saved LSE (and of the bf16 backward's scratch): Lq
    rounded up to the kernels' 64-row q tile."""
    return -(-Lq // 64) * 64


def attention_mask(Lq: int, Lkv: int, *, causal: bool, window: Optional[int],
                   prefix_len: int, q_offset: int,
                   kv_valid_len: Optional[torch.Tensor], device
                   ) -> torch.Tensor:
    """(B or 1, Lq, Lkv) bool: True where query i may attend to key j."""
    qpos = q_offset + torch.arange(Lq, device=device)[:, None]
    kpos = torch.arange(Lkv, device=device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    if prefix_len:
        mask = mask | (kpos < prefix_len)
    mask = mask[None]
    if kv_valid_len is not None:
        ragged = kpos < kv_valid_len.to(device).long()[:, None]   # (B, Lkv)
        mask = mask & ragged[:, None, :]
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0, q_offset: Optional[int] = None,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q (B, Lq, H, Dq), k (B, Lkv, Hkv, Dq), v (B, Lkv, Hkv, Dv) ->
    (B, Lq, H, Dv) in q's dtype. Head h reads kv head ``h // (H // Hkv)``."""
    B, Lq, H, Dq = q.shape
    _, Lkv, Hkv, Dv = v.shape
    if q_offset is None:
        q_offset = Lkv - Lq
    qg = q.reshape(B, Lq, Hkv, H // Hkv, Dq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(Dq))
    mask = attention_mask(Lq, Lkv, causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset,
                          kv_valid_len=kv_valid_len, device=q.device)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)                                        # (B,Hkv,G,Lq)
    if p_dtype is not None:
        p = p.to(p_dtype)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    l = l.permute(0, 3, 1, 2)[..., None]                     # (B,Lq,Hkv,G,1)
    out = pv / l.clamp_min(1e-37)
    return out.reshape(B, Lq, H, Dv).to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None, prefix_len: int = 0,
                  q_offset: Optional[int] = None,
                  kv_valid_len: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Each row's log-sum-exp as K4's training forward writes it for the
    backward (``flash_bf16_persistent_lse``): (B, H, ``lse_rows(Lq)``) f32
    in log2 units with the scale folded, log2 sum_k 2^(log2(e) S_qk /
    sqrt(Dq)) over the keys the mask (``attention_mask``'s) lets row q
    see; +inf where a row sees no key and in the rows past Lq."""
    B, Lq, H, Dq = q.shape
    _, Lkv, Hkv, _ = k.shape
    if q_offset is None:
        q_offset = Lkv - Lq
    qg = q.float().reshape(B, Lq, Hkv, H // Hkv, Dq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * (1.0 / math.sqrt(Dq))
    mask = attention_mask(Lq, Lkv, causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset,
                          kv_valid_len=kv_valid_len, device=q.device)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    lse = torch.logsumexp(s, dim=-1) * LOG2E                 # (B,Hkv,G,Lq)
    lse = torch.where(torch.isfinite(lse), lse, float("inf"))
    out = torch.full((B, H, lse_rows(Lq)), float("inf"), dtype=torch.float32,
                     device=q.device)
    out[..., :Lq] = lse.reshape(B, H, Lq)
    return out


def _bwd_terms(q, k, v, o, do, causal, window, prefix_len, q_offset,
               scale=None, kv_valid_len=None, lse=None):
    """P, dP and D (broadcast) (B, Hkv, G, Lq, Lkv) f32 of the backward's
    recurrence, with the f32 q (B, Lq, Hkv, G, Dq), do (B, Lq, Hkv, G, Dv)
    and the scale (default 1 / sqrt(Dq)); the mask is ``attention_mask``'s,
    ``kv_valid_len`` (B,) included. P is exp(S - LSE) with the LSE
    recomputed from S, or 2^(log2(e) S - ``lse``) from a saved one
    (``attention_lse``'s form)."""
    B, Lq, H, Dq = q.shape
    _, Lkv, Hkv, Dv = v.shape
    G = H // Hkv
    if q_offset is None:
        q_offset = Lkv - Lq
    if scale is None:
        scale = 1.0 / math.sqrt(Dq)
    qf = q.float().reshape(B, Lq, Hkv, G, Dq)
    dof = do.float().reshape(B, Lq, Hkv, G, Dv)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = attention_mask(Lq, Lkv, causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset,
                          kv_valid_len=kv_valid_len,
                          device=q.device)[:, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    if lse is None:
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - torch.where(
            torch.isfinite(lse), lse, torch.zeros_like(lse))), 0.0)
    else:
        l2 = lse[..., :Lq].to(s.device, torch.float32).reshape(
            B, Hkv, G, Lq)[..., None]
        p = torch.where(mask, torch.exp2(s * LOG2E - l2), 0.0)
    dsum = (dof * o.float().reshape(B, Lq, Hkv, G, Dv)).sum(dim=-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    return p, dp, dsum.permute(0, 2, 3, 1)[..., None], qf, dof, scale


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      prefix_len: int = 0, q_offset: Optional[int] = None,
                      scale: Optional[float] = None,
                      kv_valid_len: Optional[torch.Tensor] = None,
                      lse: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``attention_ref`` at q, k, v, given its
    output o and the output's cotangent do (B, Lq, H, Dv), in the
    recurrence the backward kernel (``csrc/flash_attention_bwd.cu``) runs,
    all in f32: the row logsumexp LSE recomputed from the masked scores S
    (or a saved one, ``lse`` in ``attention_lse``'s form, as K4's training
    forward writes it),
    D = rowsum(do . o), P = exp(S - LSE), dV = P^T do, dS = P . (do V^T -
    D), dQ = dS K / sqrt(Dq), dK = dS^T Q / sqrt(Dq). A kv head's dk and
    dv sum over its G query heads. A fully masked row has P = 0 and gives
    no gradient, as its output is 0. Each gradient is returned in its
    input's dtype. ``scale`` replaces 1 / sqrt(Dq) (the route of a head
    dim zero-padded for the bf16 kernels keeps the unpadded one's). A
    ragged ``kv_valid_len`` (B,) masks keys at or past it, as the forward
    does; keys that no row sees get zero dk and dv. Calls are counted in
    ``attention_bwd_ref.calls``."""
    attention_bwd_ref.calls += 1
    p, dp, dsum, qf, dof, scale = _bwd_terms(q, k, v, o, do, causal, window,
                                             prefix_len, q_offset, scale,
                                             kv_valid_len, lse)
    ds = p * (dp - dsum)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


attention_bwd_ref.calls = 0


def attention_bwd_rss(q, k, v, o, do, *, causal: bool = True,
                      window: Optional[int] = None, prefix_len: int = 0,
                      q_offset: Optional[int] = None,
                      kv_valid_len: Optional[torch.Tensor] = None):
    """The root sum of squares of each gradient's terms, f32, shaped as dq,
    dk and dv: sqrt(sum_k (dS_qk K_kd)^2) / sqrt(Dq), sqrt(sum_q (dS_qk
    Q_qd)^2) / sqrt(Dq) and sqrt(sum_q (P_qk do_qd)^2), with |dS| taken as
    P (|dP| + |D|). Rounding errors of random sign grow with it, and it
    does not cancel where the gradient does (a causal row that sees one key
    has dS = P (dP - D) = 0 exactly, so its dq is rounding noise). The bf16
    backward kernels are held to 2^-7 |plain| + c x the row's rms of it
    (``kernels.bf16_excess``'s ``scale``)."""
    p, dp, dsum, qf, dof, scale = _bwd_terms(q, k, v, o, do, causal, window,
                                             prefix_len, q_offset,
                                             kv_valid_len=kv_valid_len)
    ds2 = torch.square(p * (dp.abs() + dsum.abs()))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds2, torch.square(k.float()))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds2, torch.square(qf))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", torch.square(p),
                      torch.square(dof))
    return (torch.sqrt(dq).reshape(q.shape) * scale, torch.sqrt(dk) * scale,
            torch.sqrt(dv))
