"""Tokenizer and calibrated synthetic workloads (numpy, carried over)."""
