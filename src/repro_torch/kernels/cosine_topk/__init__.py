"""Cosine top-k cache lookup: f32 (K1) and int8 (K2) kernels."""
