"""qwen3-14b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab_size=151936,
    attn_kind="gqa",
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    act="silu",
    skip_shapes={
        "long_500k": "pure full attention; 524k dense-KV decode is not "
                     "sub-quadratic (DESIGN.md §5)",
    },
))
