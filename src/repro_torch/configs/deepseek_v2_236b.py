"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,           # first dense layer hidden
    d_ff_expert=1536,
    vocab_size=102400,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    rope_theta=10_000.0,
    act="silu",
    skip_shapes={
        "long_500k": "pure full attention (DESIGN.md §5)",
    },
))
