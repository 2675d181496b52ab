"""Model factory keyed by config name (port of
``repro/models/registry.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import DeviceLike
from repro_torch.models import embedder, lm


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None):
    if cfg.family == "embedder":
        return embedder.init_params(gen, cfg, device)
    return lm.init_params(gen, cfg, device)


def build(name: str, reduced: bool = False):
    """Returns (cfg, init_fn, forward_fn)."""
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    if cfg.family == "embedder":
        return cfg, embedder.init_params, embedder.encode
    return cfg, lm.init_params, lm.forward
