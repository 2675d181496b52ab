"""Prefill flash attention (K4): hand-written Hopper kernel, wrapper and
plain version."""
