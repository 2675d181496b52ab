"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,          # expert hidden size
    d_ff_expert=14336,
    vocab_size=32000,
    attn_kind="gqa",
    window=4096,         # SWA -> bounded KV; runs long_500k
    n_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
    act="silu",
))
