"""Attention-free sequence mixers (port of ``repro/models/ssm.py``): RWKV6
(Finch) and Mamba2 (SSD).

RWKV6 recurrence (per head, K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t: data-dependent decay)
    y_t = r_t (S_{t-1} + diag(u . k_t) v_t^T)
``rwkv6_linear_attention`` runs it exactly, step by step: the WKV6 kernel
(K5, ``kernels/wkv6``) on CUDA tensors, its plain step loop on CPU
tensors; under grad its backward is the K5-bwd kernel on CUDA tensors and
the plain reverse recurrence on CPU tensors (``wkv6_ops.WKV6Fn``). The
reference scans it in chunks padded with w = 1, k = 0 steps, which leave
the state as it was; the port runs the L real steps, which gives the same
y and the same final state.

Mamba2 SSD (scalar-per-head decay a_t = exp(dt_t * A_h)):
    h_t = a_t h_{t-1} + dt_t * B_t (x) x_t ;  y_t = C_t . h_t + D x_t
``ssd_chunked`` is the reference's chunked form in torch products (the
reference computes it as plain jnp products outside any Pallas kernel):
intra-chunk via (C B^T (.) decay), inter-chunk via a chunk state scan.

Params are dicts of tensors, as the reference's; init functions take a
``torch.Generator`` and a device. Every state is f32; ``A_log``, ``D``
and ``dt_bias`` stay f32 leaves in a bf16 model, as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import layers as L

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

_DDLERP_RANK = 32
_DECAY_RANK = 64


def _normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def rwkv6_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, H, K = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, dtype, device, scale=scale)
    return {
        "ln1": L.layernorm_init(d, dtype, device),
        "ln2": L.layernorm_init(d, dtype, device),
        # token-shift dynamic lerp
        "mu_x": zeros(d),
        "mu": zeros(5, d),                       # w, k, v, r, g
        "dd_w1": dense(d, 5 * _DDLERP_RANK, 1e-2),
        "dd_w2": _normal(gen, (5, _DDLERP_RANK, d), 1e-2, dtype, device),
        # data-dependent decay
        "w0": torch.full((d,), -0.5, dtype=torch.float32,
                         device=device).to(dtype),
        "wa": dense(d, _DECAY_RANK, 1e-2),
        "wb": dense(_DECAY_RANK, d, 1e-2),
        "u": zeros(H, K),                        # bonus ("time_faaaa")
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        "ln_x": L.layernorm_init(d, dtype, device),
        # channel mix
        "cm_mu_k": zeros(d),
        "cm_mu_r": zeros(d),
        "cm_wk": dense(d, cfg.d_ff),
        "cm_wv": dense(cfg.d_ff, d),
        "cm_wr": dense(d, d),
    }


def _rwkv6_mix_inputs(p: Params, cfg, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift dynamic lerp producing the 5 mixed streams, then r, k,
    v (B, L, H, K) in the model dtype, the f32 decay w (B, L, H, K) and the
    gate g (B, L, d)."""
    B, Lx, d = x.shape
    H, K = cfg.ssm_heads, cfg.ssm_head_dim
    dx = x_prev - x
    xxx = x + dx * p["mu_x"].to(x.dtype)
    dd = torch.tanh(xxx @ p["dd_w1"]).reshape(B, Lx, 5, _DDLERP_RANK)
    offs = torch.einsum("blfr,frd->bfld", dd, p["dd_w2"])    # (B, 5, L, d)
    mu = p["mu"].to(x.dtype)
    mixed = x[:, None] + dx[:, None] * (mu[None, :, None, :] + offs)
    xw, xk, xv, xr, xg = mixed.unbind(1)
    r = (xr @ p["wr"]).reshape(B, Lx, H, K)
    k = (xk @ p["wk"]).reshape(B, Lx, H, K)
    v = (xv @ p["wv"]).reshape(B, Lx, H, K)
    g = F.silu(xg @ p["wg"])
    w_raw = p["w0"].float() + (torch.tanh(xw @ p["wa"]) @ p["wb"]).float()
    # decay in (0, 1); the exponent clamped as the reference does
    w = torch.exp(-torch.exp(w_raw.clamp(-12.0, 6.0))).reshape(B, Lx, H, K)
    return r, k, v, w, g


def rwkv6_linear_attention(r, k, v, w, u, state, chunk: int):
    """The exact recurrence. r, k, w: (B, L, H, K); v: (B, L, H, V); u:
    (H, K); state: (B, H, K, V). Returns (y (B, L, H, V) f32, the final
    state f32), from ``kernels.wkv6.ops.wkv6``: the WKV6 kernel on CUDA
    tensors (it launches or raises), its plain step loop on CPU tensors,
    and under grad the backward kernel or its plain version. ``chunk`` is
    the reference's scan chunk; the result does not depend on it."""
    return wkv6_ops.wkv6(r, k, v, w, u, state)


def rwkv6_time_mix(p: Params, cfg, x: torch.Tensor, x_prev: torch.Tensor,
                   state: torch.Tensor, chunk: int):
    """x: (B, L, d); x_prev: token-shifted x (decode passes the carry-in).
    Returns (out (B, L, d), new_state, last_x)."""
    B, Lx, d = x.shape
    r, k, v, w, g = _rwkv6_mix_inputs(p, cfg, x, x_prev)
    y, S = rwkv6_linear_attention(r, k, v, w, p["u"], state, chunk)
    # the reference's "group-norm stand-in": one LayerNorm over all of d
    y = L.layernorm(p["ln_x"], y.reshape(B, Lx, d).to(x.dtype))
    return (y * g) @ p["wo"], S, x[:, -1]


def rwkv6_channel_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    dx = x_prev - x
    xk = x + dx * p["cm_mu_k"].to(x.dtype)
    xr = x + dx * p["cm_mu_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"]), x[:, -1]


def _shift(x: torch.Tensor, first: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: out[t] = x[t-1]; out[0] = first (or zeros)."""
    pad = torch.zeros_like(x[:, :1]) if first is None else first[:, None]
    return torch.cat([pad.to(x.dtype), x[:, :-1]], dim=1)


def rwkv6_block(p: Params, cfg, x: torch.Tensor, state: Optional[Params],
                chunk: int):
    """A full RWKV6 layer. state: None (zero state) or a dict with s (B, H,
    K, V) f32, tm_x (B, d) and cm_x (B, d), the last *normalised* inputs
    of the time mix and the channel mix. Returns (x, new_state)."""
    B, _, d = x.shape
    H, K = cfg.ssm_heads, cfg.ssm_head_dim
    if state is None:
        s0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
        tm_first = cm_first = None
    else:
        s0, tm_first, cm_first = state["s"], state["tm_x"], state["cm_x"]
    h = L.layernorm(p["ln1"], x)
    tm_out, s1, tm_last = rwkv6_time_mix(p, cfg, h, _shift(h, tm_first), s0,
                                         chunk)
    x = x + tm_out
    h2 = L.layernorm(p["ln2"], x)
    cm_out, cm_last = rwkv6_channel_mix(p, h2, _shift(h2, cm_first))
    return x + cm_out, {"s": s1, "tm_x": tm_last, "cm_x": cm_last}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, d_in, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": L.rmsnorm_init(d, dtype, device),
        "in_proj": L.dense_init(gen, d, 2 * d_in + 2 * N + H, dtype, device),
        "conv_w": _normal(gen, (cfg.conv_kernel, conv_dim), 0.1, dtype,
                          device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "gn": L.rmsnorm_init(d_in, dtype, device),
        "out_proj": L.dense_init(gen, d_in, d, dtype, device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, state: Optional[torch.Tensor]):
    """x: (B, L, C); w: (k, C); state: (B, k-1, C) carry-in or None (zeros).
    Returns (y (B, L, C), new_state (B, k-1, C)): the last k-1 rows of the
    padded input, zeros included when L < k-1."""
    ksz = w.shape[0]
    pad = (torch.zeros((x.shape[0], ksz - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                    # (B, L + k-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(ksz)) + b
    return y, xp[:, xp.shape[1] - (ksz - 1):]


def _split_xbc_dt(p: Params, cfg, x: torch.Tensor):
    """rmsnorm, in_proj, then (z, xBC, dt): dt = softplus(. + dt_bias) in
    f32."""
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = L.rmsnorm(p["norm"], x) @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * N]
    dt = F.softplus(zxbcdt[..., -H:].float() + p["dt_bias"])
    return z, xBC, dt


def ssd_chunked(x, dt, A_log, Bm, Cm, D, state, chunk: int):
    """Mamba2 SSD. x: (B, L, H, P); dt: (B, L, H); Bm, Cm: (B, L, N);
    state: (B, H, N, P) f32. Returns (y (B, L, H, P) f32, new state)."""
    Bsz, Lx, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-Lx) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc, Q = (Lx + pad) // chunk, chunk
    a = -torch.exp(A_log)                               # (H,) negative
    dA = (dt.float() * a).reshape(Bsz, nc, Q, H)        # log-decay <= 0
    cum = torch.cumsum(dA, dim=2)                       # (B, nc, Q, H)
    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    # intra-chunk: M[b,c,i,j,h] = exp(cum_i - cum_j) dt_j (C_i . B_j), j <= i
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    li = cum[:, :, :, None, :]                          # (B, nc, Q, 1, H)
    lj = cum[:, :, None, :, :]                          # (B, nc, 1, Q, H)
    idx = torch.arange(Q, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    # mask BEFORE exp: for j > i the gap is positive and exp overflows
    gap = torch.where(mask[None, None, :, :, None], li - lj,
                      torch.tensor(float("-inf"), device=x.device))
    M = CB[..., None] * torch.exp(gap) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # per-chunk outgoing state: sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    last = cum[:, :, -1:, :]                            # (B, nc, 1, H)
    wj = torch.exp(last - cum) * dtc                    # (B, nc, Q, H)
    S_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", wj, Bc, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])           # (B, nc, H)

    S = state.float()
    S_in = []                                           # state entering
    for c in range(nc):
        S_in.append(S)
        S = chunk_decay[:, c, :, None, None] * S + S_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)                     # (B, nc, H, N, P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, S_in)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)[:, :Lx]
    y = y + D[None, None, :, None] * xc.reshape(Bsz, nc * Q, H, P)[:, :Lx]
    return y, S


def mamba2_block(p: Params, cfg, x: torch.Tensor, state: Optional[Params],
                 chunk: int):
    """A full Mamba2 layer. state: None (zero state) or {"s": (B, H, N, P),
    "conv": (B, k-1, conv_dim)}. Returns (x, new_state)."""
    B, Lx, d = x.shape
    d_in, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_xbc_dt(p, cfg, x)
    xBC, conv_state = _causal_depthwise_conv(
        xBC, p["conv_w"], p["conv_b"], None if state is None
        else state["conv"])
    xBC = F.silu(xBC)
    xs = xBC[..., :d_in].reshape(B, Lx, H, P)
    s0 = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
          if state is None else state["s"])
    y, S = ssd_chunked(xs, dt, p["A_log"], xBC[..., d_in:d_in + N],
                       xBC[..., d_in + N:], p["D"], s0, chunk)
    y = y.reshape(B, Lx, d_in).to(x.dtype)
    y = L.rmsnorm(p["gn"], y * F.silu(z))
    return x + y @ p["out_proj"], {"s": S, "conv": conv_state}


def mamba2_decode_step(p: Params, cfg, x: torch.Tensor, state: Params):
    """A single-token O(1) state update. x: (B, 1, d)."""
    B = x.shape[0]
    d_in, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_xbc_dt(p, cfg, x)
    xBC, conv_state = _causal_depthwise_conv(xBC, p["conv_w"], p["conv_b"],
                                             state["conv"])
    xBC = F.silu(xBC)
    xs = xBC[..., :d_in].reshape(B, H, P).float()
    Bm = xBC[..., d_in:d_in + N].reshape(B, N).float()
    Cm = xBC[..., d_in + N:].reshape(B, N).float()
    dec = torch.exp(dt[:, 0] * -torch.exp(p["A_log"]))          # (B, H)
    S = state["s"] * dec[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt[:, 0], Bm, xs)
    y = torch.einsum("bn,bhnp->bhp", Cm, S) + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = L.rmsnorm(p["gn"], y * F.silu(z))
    return x + y @ p["out_proj"], {"s": S, "conv": conv_state}
