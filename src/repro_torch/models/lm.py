"""Config-driven LM, dense kind (port of the dense path of
``repro/models/lm.py``): GQA with optional ``qk_norm`` (as qwen3 uses),
gated MLP, RMSNorm, padded-vocab unembedding.

Public entry points:
    init_params(gen, cfg, device)               -> params
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    prefill(params, cfg, batch, cache)          -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache, pos, kv_len) -> (logits, cache)

Params are nested dicts; the reference's layer-stacked ``blocks`` pytree is
a list of per-layer dicts here (``repro_torch.weights`` converts). The KV
cache is updated in place (the reference returns a new pytree). MoE, MLA,
SSM, encoder-decoder, VLM and sliding windows arrive in later slices and
raise ``NotImplementedError``.

``kv_dtype="int8"`` keeps the reference's int8 KV cache: int8 codes with a
per-(position, head) f16 scale (``kv_quant``). On the card, decode hands
the codes and scales straight to the K3 kernel; on the CPU it dequantizes
into the model dtype first, as the reference model does.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = dict[str, Any]


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.is_moe or cfg.ssm_kind or cfg.is_encoder_decoder
            or cfg.attn_kind != "gqa" or cfg.family in ("vlm", "audio")
            or cfg.window is not None or cfg.first_dense_layers):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA kind is ported so far")


def _block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    gated = cfg.act != "gelu"
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": L.gqa_init(gen, cfg, dtype, device),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                              gated=gated)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    d = cfg.d_model
    emb = torch.randn((cfg.padded_vocab, d), generator=gen,
                      dtype=torch.float32, device=dev) * 0.02
    p: Params = {"embed": emb.to(dtype),
                 "final_norm": L.rmsnorm_init(d, dtype, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.padded_vocab, dtype, dev,
                                    scale=0.02)
    p["blocks"] = [_block_init(gen, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)]
    return p


def embed_tokens(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.long()]


def unembed(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    logits = x @ (p["embed"].T if cfg.tie_embeddings else p["lm_head"])
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab_size,
                                    torch.finfo(logits.dtype).min)
    return logits


def _block(bp: Params, cfg, x, attend):
    """Pre-norm block; ``attend(h) -> attention output`` supplies the
    prefill or decode attention."""
    h = L.rmsnorm(bp["ln1"], x)
    x = x + attend(h)
    h = L.rmsnorm(bp["ln2"], x)
    return x + L.mlp(bp["mlp"], h, cfg.act)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Ring-buffer length for SWA archs, else max_len."""
    if cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


kv_dequant = L.kv_dequant


def kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) -> (int8 codes, f16 per-(..., H) symmetric scale). The
    codes come from the f32 scale, which is then stored as f16 (the
    reference's ``kv_quant``; ``torch.round`` rounds half to even, as
    ``jnp.round`` does)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale.to(torch.float16)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> Params:
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    shape = (cfg.n_layers, batch, cache_len(cfg, max_len), cfg.n_kv_heads,
             cfg.head_dim)
    if cfg.kv_dtype == "int8":
        # int8 codes + per-(position, head) f16 scales
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _write_kv(cache: Params, i: int, idx, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Store k/v (quantized for an int8 cache) at ``cache[key][i][idx]``."""
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = kv_quant(k), kv_quant(v)
        cache["k_scale"][i][idx] = ks
        cache["v_scale"][i][idx] = vs
        k, v = kq, vq
    cache["k"][i][idx] = k.to(cache["k"].dtype)
    cache["v"][i][idx] = v.to(cache["v"].dtype)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def prefill(p: Params, cfg: ModelConfig, batch: dict, cache: Params
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt ``batch["tokens"]`` (B, L); write its K/V
    into cache positions [0, L) in place; return last-position logits."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(p, cfg, tokens)
    B, Lx, _ = x.shape
    positions = torch.arange(Lx, device=x.device)
    for i, bp in enumerate(p["blocks"]):
        def attend(h, bp=bp, i=i):
            q, k, v = L.gqa_qkv(bp["attn"], cfg, h, positions)
            a = L.flash_attention(q, k, v, causal=True)
            _write_kv(cache, i, (slice(None), slice(0, Lx)), k, v)
            return a.reshape(B, Lx, -1) @ bp["attn"]["wo"]
        x = _block(bp, cfg, x, attend)
    logits = unembed(p, cfg, L.rmsnorm(p["final_norm"], x[:, -1:]))
    return logits[:, 0], cache


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos, kv_len: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1); pos: write index, an int or a (B,)
    tensor (one position per slot — the reference vmaps a scalar pos over
    slots); kv_len: (B,) valid lengths (default pos + 1). Returns
    (logits (B, V), cache), the cache updated in place. kv_len goes to
    every layer's attention as int32, converted here once a step (not
    once a layer) when it comes in another type."""
    _check_dense(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    pos = torch.as_tensor(pos, device=dev).long().expand(B)
    kv_len = (pos + 1 if kv_len is None else kv_len).to(torch.int32)
    rows = torch.arange(B, device=dev)
    positions = pos[:, None]                                  # (B, 1)

    def scale(kv, i):
        s = cache.get(f"{kv}_scale")
        return None if s is None else s[i]

    x = embed_tokens(p, cfg, tokens)
    for i, bp in enumerate(p["blocks"]):
        def attend(h, bp=bp, i=i):
            q, k, v = L.gqa_qkv(bp["attn"], cfg, h, positions)
            _write_kv(cache, i, (rows, pos), k[:, 0], v[:, 0])
            a = L.decode_attention(q, cache["k"][i], cache["v"][i],
                                   kv_len=kv_len, k_scale=scale("k", i),
                                   v_scale=scale("v", i))
            return a.reshape(B, 1, -1) @ bp["attn"]["wo"]
        x = _block(bp, cfg, x, attend)
    logits = unembed(p, cfg, L.rmsnorm(p["final_norm"], x))
    return logits[:, 0], cache


def n_params(p: Params) -> int:
    """Parameter count of a params tree."""
    if isinstance(p, torch.Tensor):
        return p.numel()
    items = p.values() if isinstance(p, dict) else p
    return sum(n_params(v) for v in items)

