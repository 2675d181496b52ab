"""Config-driven LM (port of ``repro/models/lm.py``): the dense and MoE
kinds with GQA (optional ``qk_norm``, ``qkv_bias``), sliding windows over a
ring KV cache, and the VLM prefix-LM (patch embeddings before the text,
attended bidirectionally); gated MLP, RMSNorm, padded-vocab unembedding.

Public entry points:
    init_params(gen, cfg, device)               -> params
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    prefill(params, cfg, batch, cache)          -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache, pos, kv_len) -> (logits, cache)

``batch`` is a dict: ``tokens`` (B, L), plus ``patch_embed`` (B, P, d) for
the VLM kind. Params are nested dicts; the reference's layer-stacked
``blocks`` pytree is a list of per-layer dicts here (``repro_torch.weights``
converts). The KV cache is updated in place (the reference returns a new
pytree). MLA, SSM, hybrid, encoder-decoder, audio and ``first_dense_layers``
arrive in later slices and raise ``NotImplementedError``.

A config with a ``window`` keeps a ring of ``cache_len`` positions: prefill
stores the trailing ``Lc`` positions with token t at slot t % Lc, decode
writes at pos % Lc and attends over min(kv_len, Lc) slots with no window
(the ring bounds it), as the reference does.

``kv_dtype="int8"`` keeps the reference's int8 KV cache: int8 codes with a
per-(position, head) f16 scale (``kv_quant``). On the card, decode hands
the codes and scales straight to the K3 kernel; on the CPU it dequantizes
into the model dtype first, as the reference model does.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = dict[str, Any]


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


def _check_kind(cfg: ModelConfig) -> None:
    """Raise for the kinds the port does not run yet, naming the kind."""
    unported = [name for name, on in (
        (f"attn_kind={cfg.attn_kind!r}", cfg.attn_kind != "gqa"),
        (f"ssm_kind={cfg.ssm_kind!r}", bool(cfg.ssm_kind)),
        ("encoder-decoder", cfg.is_encoder_decoder),
        (f"family={cfg.family!r}", cfg.family in ("audio", "hybrid")),
        ("first_dense_layers", bool(cfg.first_dense_layers))) if on]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} is not ported yet (the port "
            f"runs the dense, MoE, sliding-window and VLM kinds)")


def _block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    p: Params = {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device),
                 "attn": L.gqa_init(gen, cfg, dtype, device),
                 "ln2": L.rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.is_moe:
        p["mlp"] = L.moe_init(gen, cfg, dtype, device)
    else:
        gated = cfg.act != "gelu" or cfg.family == "vlm"
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                              gated=gated)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    _check_kind(cfg)
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
    x = p["embed"][tokens.long()]
    if cfg.family == "vlm":     # gemma: sqrt(d) rounded to the dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _assemble_input(p: Params, cfg, batch: dict) -> tuple[torch.Tensor, int]:
    """tokens (after the VLM's patch embeddings) -> (x (B, L, d),
    prefix_len: how many leading positions attend bidirectionally)."""
    x = embed_tokens(p, cfg, batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embed"].to(x.dtype), x], dim=1)
        return x, cfg.prefix_len
    return x, 0


def unembed(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    logits = x @ (p["embed"].T if cfg.tie_embeddings else p["lm_head"])
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab_size,
                                    torch.finfo(logits.dtype).min)
    return logits


def _block(bp: Params, cfg, x, attend, moe_groups: int = 1):
    """Pre-norm block; ``attend(h) -> attention output`` supplies the
    prefill or decode attention. An MoE block dispatches its tokens in
    ``moe_groups`` groups along the batch (``L.moe_apply``)."""
    h = L.rmsnorm(bp["ln1"], x)
    x = x + attend(h)
    h = L.rmsnorm(bp["ln2"], x)
    if "router" in bp["mlp"]:
        m, _ = L.moe_apply(bp["mlp"], cfg, h, groups=moe_groups)
        return x + m
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
    _check_kind(cfg)
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


def _ring_place(kv: torch.Tensor, seq_len: int, ring_len: int
                ) -> torch.Tensor:
    """Align prefill's trailing-``ring_len`` slice (positions [seq_len -
    ring_len, seq_len)) with decode's pos % ring_len slots, so decode
    overwrites the oldest entry first."""
    if kv.shape[1] < ring_len or seq_len <= ring_len:
        return kv
    return torch.roll(kv, seq_len % ring_len, dims=1)


def prefill(p: Params, cfg: ModelConfig, batch: dict, cache: Params
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt (``batch["tokens"]`` (B, L), after the VLM's
    ``patch_embed``); write its K/V into the cache in place: positions
    [0, L), or for a window the trailing ``cache_len`` positions placed
    for decode's ring (``_ring_place``); return last-position logits."""
    _check_kind(cfg)
    x, prefix_len = _assemble_input(p, cfg, batch)
    B, Lx, _ = x.shape
    Lc = cache_len(cfg, Lx)
    positions = torch.arange(Lx, device=x.device)
    for i, bp in enumerate(p["blocks"]):
        def attend(h, bp=bp, i=i):
            q, k, v = L.gqa_qkv(bp["attn"], cfg, h, positions)
            a = L.flash_attention(q, k, v, causal=True, window=cfg.window,
                                  prefix_len=prefix_len)
            _write_kv(cache, i, (slice(None), slice(0, Lc)),
                      _ring_place(k[:, -Lc:], Lx, Lc),
                      _ring_place(v[:, -Lc:], Lx, Lc))
            return a.reshape(B, Lx, -1) @ bp["attn"]["wo"]
        x = _block(bp, cfg, x, attend)
    logits = unembed(p, cfg, L.rmsnorm(p["final_norm"], x[:, -1:]))
    return logits[:, 0], cache


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos, kv_len: Optional[torch.Tensor] = None,
                *, moe_groups: int = 1) -> tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1); pos: the token's position, an int
    or a (B,) tensor (one position per slot — the reference vmaps a scalar
    pos over slots); kv_len: (B,) valid lengths (default pos + 1). With a
    window the k/v go to ring slot pos % Lc and attention reads
    min(kv_len, Lc) slots. Returns (logits (B, V), cache), the cache
    updated in place. kv_len goes to every layer's attention as int32,
    converted here once a step (not once a layer) when it comes in another
    type.

    ``moe_groups``: an MoE layer dispatches the B rows in that many groups,
    each with its own capacity (``L.moe_apply``). The default, one group,
    takes the capacity from all B tokens, as the reference's decode_step
    does; ``ModelEngine`` passes B, as the reference engine's decode
    vmapped over slots computes (each slot its own T = 1 dispatch)."""
    _check_kind(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    pos = torch.as_tensor(pos, device=dev).long().expand(B)
    kv_len = (pos + 1 if kv_len is None else kv_len).to(torch.int32)
    write = pos
    if cfg.window is not None:      # the ring already bounds the window
        Lc = cache["k"].shape[2]
        write = pos % Lc
        kv_len = kv_len.clamp_max(Lc)
    rows = torch.arange(B, device=dev)
    positions = pos[:, None]                                  # (B, 1)

    def scale(kv, i):
        s = cache.get(f"{kv}_scale")
        return None if s is None else s[i]

    x = embed_tokens(p, cfg, tokens)
    for i, bp in enumerate(p["blocks"]):
        def attend(h, bp=bp, i=i):
            q, k, v = L.gqa_qkv(bp["attn"], cfg, h, positions)
            _write_kv(cache, i, (rows, write), k[:, 0], v[:, 0])
            a = L.decode_attention(q, cache["k"][i], cache["v"][i],
                                   kv_len=kv_len, k_scale=scale("k", i),
                                   v_scale=scale("v", i))
            return a.reshape(B, 1, -1) @ bp["attn"]["wo"]
        x = _block(bp, cfg, x, attend, moe_groups=moe_groups)
    logits = unembed(p, cfg, L.rmsnorm(p["final_norm"], x))
    return logits[:, 0], cache


def n_params(p: Params) -> int:
    """Parameter count of a params tree."""
    if isinstance(p, torch.Tensor):
        return p.numel()
    items = p.values() if isinstance(p, dict) else p
    return sum(n_params(v) for v in items)

