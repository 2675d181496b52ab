"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads = d_model / head_size(64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    attn_kind="none",
    ssm_kind="rwkv6",
    ssm_heads=64,
    ssm_head_dim=64,
    chunk_size=64,
    act="relu_sq",       # rwkv channel-mix uses squared relu
    # sub-quadratic: runs long_500k
))
