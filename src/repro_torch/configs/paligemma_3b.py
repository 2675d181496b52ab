"""paligemma-3b [vlm] — SigLIP frontend (stub) + Gemma backbone, prefix-LM.
[arXiv:2407.07726; hf]

The assignment specifies the transformer BACKBONE only; the SigLIP vision
tower is a stub — input_specs() supplies 256 precomputed patch embeddings
which are prepended (bidirectionally attended) to the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,         # MQA
    d_head=256,
    d_ff=16384,
    vocab_size=257216,
    attn_kind="gqa",
    rope_theta=10_000.0,
    act="gelu",
    prefix_len=256,       # image patch tokens (stub frontend)
    tie_embeddings=True,
    skip_shapes={
        "long_500k": "pure full attention (DESIGN.md §5)",
    },
))
