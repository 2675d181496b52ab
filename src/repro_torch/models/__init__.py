"""Transformer layers (dense and MoE), the ALBERT-style embedder and the
LM (dense, MoE with sliding windows, VLM prefix-LM)."""
