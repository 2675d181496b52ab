"""whisper-base [audio] — encoder-decoder, conv frontend (stub). [arXiv:2212.04356; unverified]

Backbone only: input_specs() supplies precomputed frame embeddings in place
of the 2x conv1d stem. 6 encoder + 6 decoder layers, d=512, 8 heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab_size=51865,
    attn_kind="gqa",
    is_encoder_decoder=True,
    enc_len=1500,
    rope_theta=10_000.0,   # we use sinusoidal-free learned-pos-free RoPE stand-in
    act="gelu",
    qkv_bias=True,
    tie_embeddings=True,
    skip_shapes={
        "long_500k": "enc-dec; decoder contexts are structurally short "
                     "(DESIGN.md §5)",
    },
))
