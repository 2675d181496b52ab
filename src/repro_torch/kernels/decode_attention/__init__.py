"""Flash-decoding attention over a KV cache (K3), bf16/f32 or int8 codes
with per-position scales: hand-written Hopper kernel, wrapper and plain
version."""
