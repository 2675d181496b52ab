"""Real-model engine (port of ``ModelEngine`` in
``repro/serving/engine.py``).

Slot-based: prefill into a slot, then one batched decode step for every
slot with its own position / kv_len (the continuous-batching requirement).
The reference vmaps a single-sequence decode over the slots; the port runs
one batched decode with per-slot positions. Placing a slot's prefill cache
is an index copy. The reference's ``AnalyticEngine`` (a latency model whose
constants describe a TPU) is not ported in this slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm


class ModelEngine:
    def __init__(self, params, cfg: ModelConfig, n_slots: int = 4,
                 max_len: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        self.cache = lm.init_cache(cfg, n_slots, max_len,
                                   device=self.device)
        self.pos = np.zeros(n_slots, np.int32)        # next write index
        self.active = np.zeros(n_slots, bool)

    def free_slots(self) -> list[int]:
        return [i for i in range(self.n_slots) if not self.active[i]]

    @torch.inference_mode()
    def prefill_into(self, slot: int, tokens: np.ndarray) -> int:
        """Prefill a (Lp,) prompt into ``slot``; returns the first token."""
        lp = len(tokens)
        batch = {"tokens": torch.tensor(np.asarray(tokens, np.int64),
                                        device=self.device)[None]}
        cache1 = lm.init_cache(self.cfg, 1, self.max_len, device=self.device)
        logits, cache1 = lm.prefill(self.params, self.cfg, batch, cache1)
        for key, full in self.cache.items():
            full[:, slot] = cache1[key][:, 0]
        self.pos[slot] = lp
        self.active[slot] = True
        return int(torch.argmax(logits[0]))

    @torch.inference_mode()
    def decode_active(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for every slot (inactive slots decode garbage
        that callers ignore). tokens: (n_slots,) last token per slot."""
        tok = torch.tensor(np.asarray(tokens, np.int64),
                           device=self.device)[:, None]
        pos = torch.tensor(self.pos.astype(np.int64), device=self.device)
        kv_len = torch.tensor((self.pos + 1).astype(np.int32),
                              device=self.device)
        logits, self.cache = lm.decode_step(self.params, self.cfg, tok,
                                            self.cache, pos, kv_len=kv_len)
        self.pos[self.active] += 1
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.pos[slot] = 0
