"""The paper's own model: paraphrase-albert-small-v2-style sentence embedder.

ALBERT-small: 6 transformer layers with CROSS-LAYER WEIGHT SHARING,
factorized embedding (vocab->128->768), GELU, post-LN, mean pooling +
L2 normalization. ~11M parameters. (Reimers & Gurevych 2019; Table 1.)
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="siso-embedder",
    family="embedder",
    n_layers=6,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=30000,
    attn_kind="gqa",
    qkv_bias=True,
    act="gelu",
    scan_layers=False,   # weights shared across layers instead
))

EMBED_FACTOR_DIM = 128  # ALBERT factorized embedding inner dim
EMBED_DIM = 768         # output sentence-embedding dimensionality
