"""Convert the JAX package's parameters into the port's.

Input is the reference parameter tree as numpy arrays (for example
``jax.tree.map(np.asarray, params)`` on the JAX side); this module never
imports jax. bfloat16 arrays (numpy dtype name ``bfloat16``) are carried
bit for bit. After conversion both packages compute the same function.
``convert_lm`` and ``convert_embedder`` carry any tree shaped like the
parameters the same way: gradients and AdamW moments, which the tests
compare leaf by leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.tensor(bits.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def to_torch(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists of arrays -> the same structure of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, dev) for v in tree]
    return _tensor(tree, dev)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def convert_embedder(params: dict, device: DeviceLike = None) -> dict:
    """Embedder params: the same tree, as tensors (one shared layer)."""
    return to_torch(params, device)


def convert_lm(params: dict, cfg: ModelConfig,
               device: DeviceLike = None) -> dict:
    """LM params of every kind: the reference stacks ``blocks`` and
    ``enc_blocks`` along a leading layer axis (one scan over layers), its
    MoE leaves as (n, E, d, dff); the port keeps a list of layers, each
    with its (E, d, dff) experts, and the same for the RWKV6 and Mamba2
    layers. ``dense0`` (deepseek's leading dense layers) is a list in both.
    Zamba2's ``shared_attn`` is one block in both, its LoRA ``lora_a`` (n_inv,
    2d, r) and ``lora_b`` (n_inv, r, H Dh) kept stacked by invocation. A
    tied embedding has no ``lm_head``. Every leaf keeps its dtype (f32
    leaves of a bf16 model, such as Mamba2's ``A_log``, stay f32)."""
    stacked = {"blocks": cfg.n_layers - cfg.first_dense_layers,
               "enc_blocks": cfg.enc_layers}
    extra = set(params) - {"embed", "final_norm", "lm_head", "dense0",
                           "enc_norm", "shared_attn", *stacked}
    if extra:
        raise ValueError(f"{cfg.name}: unknown parameters {sorted(extra)}")
    out = {k: to_torch(v, device) for k, v in params.items()
           if k not in stacked}
    for key, n in stacked.items():
        if key in params:
            out[key] = [to_torch(_layer(params[key], i), device)
                        for i in range(n)]
    return out
