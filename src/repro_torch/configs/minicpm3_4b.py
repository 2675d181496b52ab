"""minicpm3-4b [dense] — MLA (multi-head latent attention). [hf:openbmb/MiniCPM3-4B; hf]

MLA: q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
The assignment's "GQA kv=40" reflects MLA's effective per-head keys after
up-projection (40 heads attend over a shared 256-dim latent cache).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=True,
    skip_shapes={
        "long_500k": "pure full attention (MLA latent cache is linear in "
                     "memory but attention is still dense; DESIGN.md §5)",
    },
))
