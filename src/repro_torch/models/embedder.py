"""ALBERT-small-style sentence embedder (port of
``repro/models/embedder.py``).

Factorized embedding (vocab -> 128 -> d), N transformer layers with
cross-layer weight sharing (one parameter set applied n_layers times),
post-LN, GELU FFN, RoPE positions, bidirectional attention over every
position (padding included, as in the reference), masked mean pooling and
L2 normalization, in fp32.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.siso_embedder import EMBED_FACTOR_DIM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = dict[str, Any]


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    tok = torch.randn((cfg.vocab_size, EMBED_FACTOR_DIM), generator=gen,
                      dtype=torch.float32, device=dev) * 0.02
    return {
        "tok_embed": tok.to(dtype),
        "embed_proj": L.dense_init(gen, EMBED_FACTOR_DIM, d, dtype, dev),
        "embed_ln": L.layernorm_init(d, dtype, dev),
        "attn": L.gqa_init(gen, cfg, dtype, dev),      # ONE shared layer
        "ln1": L.layernorm_init(d, dtype, dev),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype, dev, gated=False),
        "ln2": L.layernorm_init(d, dtype, dev),
    }


def encode(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (B, L) int; mask: (B, L) bool (True = real token).
    Returns L2-normalized sentence embeddings (B, d) float32."""
    B, Lseq = tokens.shape
    if mask is None:
        mask = tokens > 0
    x = p["tok_embed"][tokens.long()] @ p["embed_proj"]
    x = L.layernorm(p["embed_ln"], x)
    positions = torch.arange(Lseq, device=tokens.device)
    for _ in range(cfg.n_layers):        # shared weights
        a = L.gqa_attend(p["attn"], cfg, x, positions, causal=False)
        x = L.layernorm(p["ln1"], x + a)
        m = L.mlp(p["mlp"], x, cfg.act)
        x = L.layernorm(p["ln2"], x + m)
    w = mask.float()[..., None]
    pooled = (x.float() * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)
