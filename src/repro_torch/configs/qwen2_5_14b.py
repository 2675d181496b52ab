"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5 family; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab_size=152064,
    attn_kind="gqa",
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    skip_shapes={
        "long_500k": "pure full attention (DESIGN.md §5)",
    },
))
