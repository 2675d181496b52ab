"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

81 Mamba2 layers; a single weight-shared (attention + MLP) block is invoked
every 6 layers with per-invocation LoRA deltas (Zamba2's shared-block trick).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    attn_kind="gqa",
    ssm_kind="mamba2",
    ssm_state=64,
    ssm_heads=112,        # d_inner / head_dim = 7168 / 64
    ssm_head_dim=64,
    d_inner=7168,         # expand=2
    conv_kernel=4,
    chunk_size=128,
    attn_every=6,
    shared_lora_rank=64,
    act="silu",
    # hybrid & state-bounded: runs long_500k
))
