"""command-r-35b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab_size=256000,
    attn_kind="gqa",
    qk_norm=False,
    qkv_bias=False,
    rope_theta=8_000_000.0,
    act="silu",
    tie_embeddings=True,  # command-r ties input/output embeddings
    skip_shapes={
        "long_500k": "pure full attention (DESIGN.md §5)",
    },
))
