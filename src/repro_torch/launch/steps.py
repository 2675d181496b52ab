"""Step builders (port of ``repro/launch/steps.py``): the train step
(forward, chunked cross-entropy, backward, AdamW), the prefill step and
the decode step over the port's ``lm``.

The chunked cross-entropy never holds (B, L, vocab) logits for the
backward: the final features are unembedded one sequence chunk at a
time, in f32, and each chunk is recomputed in the backward
(``torch.utils.checkpoint``), so only one chunk's logits are alive.

The shape structs, ``CellPolicy`` and the per-cell shardings belong to
the parallel-training and dry-run slices and are not here yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.training import optimizer as opt


def _chunk_ce(params, cfg: ModelConfig, fc: torch.Tensor,
              yc: torch.Tensor) -> torch.Tensor:
    """Summed next-token CE of one chunk: f32 logits (pad columns at the
    dtype's minimum, ``lm.unembed``), logsumexp minus the gold logit."""
    logits = lm.unembed(params, cfg, fc).float()
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_ce_loss(params, cfg: ModelConfig, batch: dict,
                    chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean next-token CE over the (B, L) labels + 0.01 x the MoE aux
    loss, the aux loss). The VLM's loss covers its text positions. The
    chunk halves until it divides L (the VLM's text span may be odd)."""
    feats, aux, prefix_len = lm.forward_features(params, cfg, batch)
    if cfg.family == "vlm":
        feats = feats[:, prefix_len:]
    labels = batch["labels"]
    B, L, _ = feats.shape
    chunk = min(chunk, L)
    while L % chunk:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for c in range(0, L, chunk):
        fc, yc = feats[:, c:c + chunk], labels[:, c:c + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_ce, params, cfg, fc, yc,
                                       use_reentrant=False)
        else:
            total = total + _chunk_ce(params, cfg, fc, yc)
    loss = total / (B * L)
    return loss + 0.01 * aux, aux


def value_and_grad(loss_fn, params):
    """(``loss_fn(params)`` detached, its gradient: a tree like ``params``,
    each leaf in its parameter's dtype, zeros where the loss does not
    reach it), as ``jax.value_and_grad``. The leaves require grad only
    within the call."""
    leaves = [p for _, p in opt.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    flat = iter(torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, flat))
    return loss.detach(), opt.tree_map(lambda _: next(flat), params)


def make_train_step(cfg: ModelConfig, accum: int = 1,
                    optc: Optional[opt.AdamWConfig] = None,
                    ce_chunk: int = 512):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics
    {"loss", "grad_norm", "lr"}). With ``accum`` > 1 the batch is split
    along its first dim into that many microbatches, their gradients
    summed in f32 and divided by ``accum``, as the loss. The parameters
    and moments are updated in place (``opt.apply_updates``)."""
    optc = optc or opt.AdamWConfig()

    def loss_grads(params, batch):
        return value_and_grad(
            lambda p: chunked_ce_loss(p, cfg, batch, ce_chunk)[0], params)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = loss_grads(params, batch)
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = opt.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            losses = []
            for i in range(accum):
                l_i, g_i = loss_grads(params, {k: v[i] for k, v in
                                               micro.items()})
                opt.tree_map(lambda a, b: a.add_(b.float()), grads, g_i)
                losses.append(l_i)
                del g_i
            grads = opt.tree_map(lambda g: g / accum, grads)
            loss = sum(losses[1:], losses[0]) / accum
        params, opt_state, metrics = opt.apply_updates(params, grads,
                                                       opt_state, optc)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return lm.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, tokens, cache, pos, kv_len):
        return lm.decode_step(params, cfg, tokens, cache, pos, kv_len)

    return decode_step
