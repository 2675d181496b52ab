"""Core NN layers in plain PyTorch: ``repro/models/layers.py`` (norms,
RoPE, GQA and MLA attention, MLPs, the scatter-dispatch MoE, the bf16
gradient barrier at layer boundaries) for one device.

Conventions (kept from the reference so the two can be compared):
  * params are nested dicts of tensors; init functions take an explicit
    ``torch.Generator`` and ``device``;
  * activation layout at the public functions: (batch, seq, heads,
    head_dim) for attention;
  * compute dtype follows the inputs (bf16 for the big configs); softmax,
    norms and attention scores accumulate in fp32.

The attention functions route CUDA tensors to the hand-written Hopper
kernels (K4 ``kernels/flash_attention``, K3 ``kernels/decode_attention``),
which launch or raise. CPU tensors run ``flash_attention_plain`` and
``decode_attention_plain``: the kernels' plain versions (``ref.py``) in
the reference model's form (``repro/models/layers.py``), including the
cast of P to the value dtype before P·V.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


class _BF16GradBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward rounds the cotangent through bf16
    (the reference's custom VJP): at layer boundaries it puts the
    cross-layer activation cotangents at bf16 width."""
    return _BF16GradBarrier.apply(x)


# toggled by the launcher, as the reference's CellPolicy.bf16_boundary
_BF16_BOUNDARY: list = [False]


def set_bf16_boundary(on: bool) -> None:
    _BF16_BOUNDARY[0] = bool(on)


def dp_constrain(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """A layer-boundary activation. The reference pins its batch dim to the
    data-parallel mesh ``axes`` so that GSPMD keeps the ZeRO-3 choice
    (per-layer weight gathers). The port's sharded train step
    (``distributed/sharded_train.py``) runs each data rank's forward on
    its own rows with the weights gathered, so here the placement is the
    identity, and a bf16 ``x`` passes ``bf16_grad_barrier`` when the
    boundary is on."""
    if _BF16_BOUNDARY[0] and x.dtype == torch.bfloat16:
        return bf16_grad_barrier(x)
    return x


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., L, H, D); positions: broadcastable to (..., L)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs       # (..., L, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0, q_offset: int = 0,
                    kv_valid_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Softmax attention with GQA and the reference's masks: K4 on CUDA
    tensors, ``flash_attention_plain`` on CPU tensors (arguments as
    there). Meta tensors take the wrapper too: its shape-only op, never
    the plain version's score matrix."""
    if q.is_cuda or q.is_meta:
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      prefix_len=prefix_len,
                                      q_offset=q_offset,
                                      kv_valid_len=kv_valid_len)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None, prefix_len: int = 0,
                          q_offset: int = 0,
                          kv_valid_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Softmax attention with GQA, the reference's masks and fp32 scores,
    P rounded to v's dtype before P·V: K4's plain version
    (``fa_ref.attention_ref``) in the reference model layer's form.

    q: (B, Lq, Hq, Dq); k: (B, Lkv, Hkv, Dq); v: (B, Lkv, Hkv, Dv).
    q_offset: global position of q[0]; kv_valid_len: optional (B,) count of
    valid kv positions. Fully masked rows return 0, as the reference's
    online-softmax recurrence does. Returns (B, Lq, Hq, Dv).
    """
    return fa_ref.attention_ref(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len, q_offset=q_offset,
                                kv_valid_len=kv_valid_len, p_dtype=v.dtype)


def kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 codes * per-(position, head) scale, in ``dtype`` (the reference
    model's ``kv_dequant``)."""
    return da_ref.dequant(q, scale, dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len: torch.Tensor,
                     window: Optional[int] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention over a KV cache: K3 on CUDA tensors (int8
    codes and f16 scales read in place), ``decode_attention_plain`` on CPU
    tensors. q: (B, 1, Hq, D); caches (B, Lmax, Hkv, D) and (B, Lmax, Hkv,
    Dv), int8 when ``k_scale``/``v_scale`` (B, Lmax, Hkv) are given;
    kv_len: (B,). Returns (B, 1, Hq, Dv). Meta tensors take the wrapper's
    shape-only op."""
    if q.is_cuda or q.is_meta:
        if window is not None:
            raise NotImplementedError("decode attention with a window has "
                                      "no kernel yet")
        out = da_ops.decode_attention(q[:, 0], k_cache, v_cache, kv_len,
                                      k_scale=k_scale, v_scale=v_scale)
        return out[:, None]
    return decode_attention_plain(q, k_cache, v_cache, kv_len=kv_len,
                                  window=window, k_scale=k_scale,
                                  v_scale=v_scale)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, *, kv_len: torch.Tensor,
                           window: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token attention over a KV cache, the reference model's form
    of K3's plain version (``da_ref.decode_attention_ref``): an int8 cache
    is first dequantized into q's dtype (``kv_dequant``), and the
    normalised P is rounded to the value dtype before P·V.

    q: (B, 1, Hq, D); k_cache: (B, Lmax, Hkv, D); v_cache: (B, Lmax, Hkv,
    Dv); kv_len: (B,) number of valid cache entries.
    """
    out = da_ref.decode_attention_ref(
        q[:, 0], k_cache, v_cache, kv_len, k_scale=k_scale, v_scale=v_scale,
        window=window, dequant_dtype=q.dtype,
        p_dtype=q.dtype if k_scale is not None else v_cache.dtype)
    return out[:, None]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, d, H * Dh, dtype, device),
        "wk": dense_init(gen, d, Hkv * Dh, dtype, device),
        "wv": dense_init(gen, d, Hkv * Dh, dtype, device),
        "wo": dense_init(gen, H * Dh, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv * Dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv * Dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(Dh, dtype, device)
        p["k_norm"] = rmsnorm_init(Dh, dtype, device)
    return p


def gqa_q(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The queries (B, L, H, Dh) before RoPE: ``gqa_qkv``'s q, and an
    encoder-decoder's cross-attention queries (the reference takes the q of
    ``gqa_qkv(..., rope=False)``, whose k and v it drops)."""
    B, L, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, L, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    return q


def gqa_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
            rope: bool = True):
    B, L, _ = x.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    q = gqa_q(p, cfg, x)
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, L, Hkv, Dh)
    v = v.reshape(B, L, Hkv, Dh)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    q, k, v = gqa_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal, window=cfg.window,
                          prefix_len=prefix_len)
    B, L = x.shape[:2]
    return out.reshape(B, L, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) block
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    R = cfg.kv_lora_rank
    p: Params = {}
    if cfg.q_lora_rank:
        p["wq_a"] = dense_init(gen, d, cfg.q_lora_rank, dtype, device)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, device)
        p["wq_b"] = dense_init(gen, cfg.q_lora_rank, H * qd, dtype, device)
    else:
        p["wq"] = dense_init(gen, d, H * qd, dtype, device)
    p["wkv_a"] = dense_init(gen, d, R, dtype, device)
    p["kv_norm"] = rmsnorm_init(R, dtype, device)
    p["wk_rope"] = dense_init(gen, d, cfg.qk_rope_dim, dtype, device)
    p["wk_b"] = dense_init(gen, R, H * cfg.qk_nope_dim, dtype, device)
    p["wv_b"] = dense_init(gen, R, H * cfg.v_head_dim, dtype, device)
    p["wo"] = dense_init(gen, H * cfg.v_head_dim, d, dtype, device)
    return p


def mla_latent(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """The (latent (B, L, R), k_rope (B, L, rope_d)) pair the MLA cache
    stores."""
    latent = rmsnorm(p["kv_norm"], x @ p["wkv_a"])
    k_rope = apply_rope((x @ p["wk_rope"])[:, :, None, :], positions,
                        cfg.rope_theta)
    return latent, k_rope[:, :, 0, :]


def mla_queries(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope (B, L, H, nope), q_rope (B, L, H, rope), rotated)."""
    B, L, _ = x.shape
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rmsnorm(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, L, cfg.n_heads, qd)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(p: Params, cfg, latent: torch.Tensor, k_rope: torch.Tensor):
    """Per-head K (B, L, H, nope + rope) and V (B, L, H, v_head_dim)
    materialised from the latent; every head shares k_rope."""
    B, L, _ = latent.shape
    H = cfg.n_heads
    k_nope = (latent @ p["wk_b"]).reshape(B, L, H, cfg.qk_nope_dim)
    v = (latent @ p["wv_b"]).reshape(B, L, H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, L, H, cfg.qk_rope_dim)], dim=-1)
    return k, v


def mla_attend(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
               latent: torch.Tensor, k_rope: torch.Tensor, *,
               causal: bool = True) -> torch.Tensor:
    """Prefill: per-head K/V materialised from ``mla_latent``'s (latent,
    k_rope) of the same x (the caller caches them; the reference computes
    them again here), then K4's Dv mode (q/k of nope + rope, v of
    v_head_dim)."""
    B, L, _ = x.shape
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    k, v = _mla_kv(p, cfg, latent, k_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q, k, v, causal=causal)
    return out.reshape(B, L, -1) @ p["wo"]


def mla_decode(p: Params, cfg, x: torch.Tensor, latent_cache: torch.Tensor,
               krope_cache: torch.Tensor, kv_len: torch.Tensor,
               positions: torch.Tensor, kv_max: Optional[int] = None
               ) -> torch.Tensor:
    """Decode over the latent cache (B, Lmax, R) and k_rope cache (B, Lmax,
    rope_d). With ``cfg.mla_absorb`` attention runs in latent space (W_uk
    and W_uv absorbed; f32 products, no kernel, as in the reference);
    otherwise K/V are materialised and K3's Dv mode attends. ``kv_max``:
    the largest kv_len, known on the host; then only the first kv_max
    positions are read or materialised, which gives the same result as
    all Lmax of them (the rest are masked)."""
    B = x.shape[0]
    H, R = cfg.n_heads, cfg.kv_lora_rank
    if kv_max is not None:
        latent_cache = latent_cache[:, :kv_max]
        krope_cache = krope_cache[:, :kv_max]
    q_nope, q_rope = mla_queries(p, cfg, x, positions)        # (B, 1, H, *)
    if cfg.mla_absorb:
        scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        Lm = latent_cache.shape[1]
        wk_b = p["wk_b"].reshape(R, H, cfg.qk_nope_dim)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wk_b)
        lat = latent_cache.float()
        s = torch.einsum("bqhr,blr->bhql", q_lat.float(), lat)
        s = s + torch.einsum("bqhd,bld->bhql", q_rope.float(),
                             krope_cache.float())
        s = s * scale
        kpos = torch.arange(Lm, device=x.device)[None, :]
        mask = kpos < kv_len.to(x.device).long()[:, None]
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        o_lat = torch.einsum("bhql,blr->bqhr", torch.softmax(s, dim=-1), lat)
        wv_b = p["wv_b"].reshape(R, H, cfg.v_head_dim).float()
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b).to(x.dtype)
    else:
        k, v = _mla_kv(p, cfg, latent_cache, krope_cache)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = decode_attention(q, k, v, kv_len=kv_len)
    return out.reshape(B, 1, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu_sq": lambda x: torch.square(F.relu(x)),
}


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype, device,
             gated: bool = True) -> Params:
    p = {"w_up": dense_init(gen, d, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, d, d_ff, dtype, device)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = _ACTS[act]
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = a(x @ p["w_gate"]) * h
    else:
        h = a(h)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (scatter dispatch with a static capacity; the reference's jnp MoE,
# whose expert products are batched matmuls outside any kernel)
# ---------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    """``router`` (d, E), ``w_gate``/``w_up`` (E, d, dff), ``w_down``
    (E, dff, d), and a dense ``shared`` MLP with ``n_shared_experts``."""
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def expert(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        return (w / math.sqrt(d_in)).to(dtype)

    p: Params = {"router": dense_init(gen, d, E, dtype, device, scale=0.02),
                 "w_gate": expert(d, dff), "w_up": expert(d, dff),
                 "w_down": expert(dff, d)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, dff * cfg.n_shared_experts, dtype,
                               device)
    return p


def moe_gating(logits: torch.Tensor, top_k: int, renormalize: bool = True):
    """(..., T, E) router logits -> (gates (..., T, k), idx (..., T, k),
    aux (...)): f32 softmax, top-k, gates renormalised, the Switch
    load-balancing loss E * sum_e f_e * p_e over the T tokens.

    The top-k is a stable descending sort: of equal probabilities the lower
    expert index comes first, as ``lax.top_k`` orders them."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :top_k], idx[..., :top_k]
    if renormalize:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=-2)
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=-2)
    aux = E * (me * ce).sum(dim=-1)
    return gates, idx, aux


def moe_capacity(cfg, T: int) -> int:
    """Slots per expert for a dispatch of T tokens (a multiple of 8, at
    least 8)."""
    k, E = cfg.top_k, cfg.n_experts
    return max(8, int(math.ceil(cfg.capacity_factor * T * k / E / 8.0)) * 8)


def _experts(p: Params, cfg, buf: torch.Tensor) -> torch.Tensor:
    """The gated expert MLPs over their slots, (E, S, d) -> (E, S, d)."""
    a = _ACTS[cfg.act]
    h = a(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _moe_dispatch(p: Params, cfg, xg: torch.Tensor,
                  expert_lo: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """G independent dispatches of T tokens each, xg (G, T, d) -> (out
    (G, T, d), aux (G,)): each group has its own capacity C, its own
    ranking and its own drops, and all groups share one (E, G x C, d)
    buffer, so each expert's weights are read once.

    Each (token, k) assignment is ranked within its (group, expert) by a
    stable argsort, so earlier tokens take the slots first; assignments
    ranked past C go to the trash slot E x G x C and read zeros back.

    ``expert_lo``: ``p`` holds only the experts [expert_lo, expert_lo +
    E_loc) (an expert-parallel shard); the ranking and the capacity are
    over all E experts, and assignments outside the range go to the trash
    slot, so this shard's output lacks them (``moe_apply_shard_map`` sums
    the shards')."""
    G, T, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = p["w_gate"].shape[0]
    C = moe_capacity(cfg, T)
    dev = xg.device
    xt = xg.reshape(G * T, d)
    gates, idx, aux = moe_gating((xt @ p["router"]).reshape(G, T, E), k)

    group = torch.arange(G, device=dev).repeat_interleave(T * k)
    flat_e = idx.reshape(-1)                                   # (G*T*k,)
    key = group * E + flat_e
    order = torch.argsort(key, stable=True)
    # bincount's integers by a scatter, which has a meta kernel
    counts = torch.zeros(G * E, dtype=key.dtype, device=dev).scatter_add_(
        0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=dev) - starts[key[order]]
    keep = pos < C
    le = flat_e
    if expert_lo is not None or E_loc != E:
        le = flat_e - (expert_lo or 0)
        keep = keep & (le >= 0) & (le < E_loc)
    slot = torch.where(keep, (le * G + group) * C + pos,
                       torch.full_like(pos, E_loc * G * C))

    x_rep = xt.repeat_interleave(k, dim=0)                     # (G*T*k, d)
    # the slots are unique apart from the trash slot: the add is a copy
    buf = torch.zeros((E_loc * G * C + 1, d), dtype=xg.dtype, device=dev)
    buf.index_add_(0, slot, x_rep)
    buf = buf[:-1].reshape(E_loc, G * C, d)

    y = _experts(p, cfg, buf)                              # (E_loc, G*C, d)

    y_flat = torch.cat([y.reshape(E_loc * G * C, d),
                        torch.zeros((1, d), dtype=y.dtype, device=dev)])
    y_tok = y_flat[slot] * gates.reshape(-1, 1).to(y.dtype)
    out = y_tok.reshape(G * T, k, d).sum(dim=1)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xt, cfg.act)
    return out.reshape(G, T, d), aux


# the mesh ``moe_apply_shard_map`` runs on; set by the launcher
# (``launch/steps.cell_shardings``), as the reference's
_SHARD_MESH: list = [None]


def set_shard_mesh(mesh) -> None:
    _SHARD_MESH[0] = mesh


def _mesh_coords(mesh, dp: tuple) -> list:
    """For each data shard (row-major over the ``dp`` axes), the mesh
    coordinates of its "model" shards, in "model" order."""
    ranks = itertools.product(*(range(mesh.shape[a]) for a in dp))
    return [[{**dict(zip(dp, r)), "model": m}
             for m in range(mesh.shape["model"])] for r in ranks]


def _moe_shard_params(p: Params, cfg, m: int, tp: int, ep: bool) -> Params:
    """Model shard ``m`` of ``tp`` of an MoE layer's params, as views: the
    experts [m E/tp, (m+1) E/tp) (expert parallel) or every expert's ffn
    columns [m c, (m+1) c), c = ceil(dff / tp) (the last slices short or
    empty, as XLA pads); the router whole, a shared MLP's ffn sliced."""
    def cols(n):
        c = -(-n // tp)
        return slice(min(m * c, n), min((m + 1) * c, n))
    out: Params = {"router": p["router"]}
    if ep:
        e = cfg.n_experts // tp
        for k in ("w_gate", "w_up", "w_down"):
            out[k] = p[k][m * e:(m + 1) * e]
    else:
        f = cols(p["w_gate"].shape[-1])
        out["w_gate"], out["w_up"] = p["w_gate"][..., f], p["w_up"][..., f]
        out["w_down"] = p["w_down"][:, f]
    if "shared" in p:
        f = cols(p["shared"]["w_up"].shape[-1])
        out["shared"] = {k: (v[f] if k == "w_down" else v[:, f])
                         for k, v in p["shared"].items()}
    return out


def _moe_partial(p: Params, cfg, x: torch.Tensor, expert_lo: Optional[int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One (data, model) shard's dispatch of its data shard's tokens x
    (b, L, d): its partial output and its aux loss."""
    return moe_apply(p, cfg, x, expert_lo=expert_lo)


def moe_apply_shard_map(p: Params, cfg, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard MoE dispatch over the mesh ``set_shard_mesh`` set (the
    reference's ``moe_apply_shard_map``): each data shard (the batch split
    over ``cfg.act_dp``'s axes) dispatches only its own tokens, at its own
    capacity. When E % tp == 0 and E >= tp the experts split over "model"
    (each shard's assignments outside its range go to the trash slot),
    otherwise every expert's ffn dim is sliced over "model"; a shared
    MLP's ffn dim is sliced either way. Shard (r, m) runs on the mesh's
    device at that coordinate; the "model" shards' partial outputs are
    summed in "model" order on shard (r, 0)'s device, and the aux loss is
    the mean of the data shards'. With no mesh, or no data or "model"
    axis in it, the scatter dispatch of all the tokens."""
    mesh = _SHARD_MESH[0]
    dp = tuple(a for a in cfg.act_dp
               if mesh is not None and a in mesh.axis_names)
    if not dp or "model" not in getattr(mesh, "axis_names", ()):
        return moe_apply(p, cfg.replace(moe_impl="scatter"), x)
    local_cfg = cfg.replace(moe_impl="scatter", act_dp=())
    tp = mesh.shape["model"]
    ep = cfg.n_experts % tp == 0 and cfg.n_experts >= tp
    shards = _mesh_coords(mesh, dp)
    B = x.shape[0]
    if B % len(shards):
        raise ValueError(f"batch {B} does not split over {len(shards)} data "
                         f"shards")
    b = B // len(shards)
    ys, auxes = [], []
    for r, coords in enumerate(shards):
        xr = x[r * b:(r + 1) * b]
        acc, aux = None, None
        for m, c in enumerate(coords):
            dev = mesh.device(**c)
            pm = _moe_shard_params(p, cfg, m, tp, ep)
            pm = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in pm.items()}
            y, a = _moe_partial(pm, local_cfg, xr.to(dev),
                                m * (cfg.n_experts // tp) if ep else None)
            if acc is None:
                acc, aux = y, a
            else:
                acc = acc + y.to(acc.device)
        ys.append(acc.to(x.device))
        auxes.append(aux.to(x.device))
    return torch.cat(ys), torch.stack(auxes).mean()


def moe_apply(p: Params, cfg, x: torch.Tensor, groups: int = 1,
              expert_lo: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> (out, aux loss): the reference's ``moe_apply``.

    The B x L tokens form one dispatch, with its capacity from all of them.
    ``groups`` > 1 splits them along B into that many dispatches of equal
    size, each with its own capacity: what the reference computes when it
    vmaps a one-row call over the batch (its engine's decode over slots).
    ``cfg.moe_chunk_tokens`` cuts each dispatch into chunks of at most that
    many tokens (the largest divisor), run one after another with a
    capacity each, and averages their aux losses. ``expert_lo``: ``p``
    holds an expert-parallel shard's experts (``_moe_dispatch``).
    ``cfg.moe_impl == "shard_map"`` with ``cfg.act_dp`` set takes
    ``moe_apply_shard_map``."""
    if cfg.moe_impl == "shard_map" and cfg.act_dp and groups == 1:
        return moe_apply_shard_map(p, cfg, x)
    B, L, d = x.shape
    Tg = B * L // groups
    xg = x.reshape(groups, Tg, d)
    chunk = cfg.moe_chunk_tokens
    if chunk and Tg > chunk:
        while Tg % chunk:                 # largest divisor <= requested
            chunk -= 1
        outs, aux = [], torch.zeros((groups,), device=x.device)
        for c in range(0, Tg, chunk):
            y, a = _moe_dispatch(p, cfg, xg[:, c:c + chunk], expert_lo)
            outs.append(y)
            aux = aux + a
        return (torch.cat(outs, dim=1).reshape(B, L, d),
                (aux / (Tg // chunk)).mean())
    y, aux = _moe_dispatch(p, cfg, xg, expert_lo)
    return y.reshape(B, L, d), aux.mean()
