"""Serving layer, ported: ModelEngine, continuous batching, gateway."""
