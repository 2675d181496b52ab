"""LLM engines (port of ``repro/serving/engine.py``).

Two tiers (DESIGN.md §9.2):

* ``AnalyticEngine``: the latency box the paper's M/D/1 model abstracts
  the GPU server into. Per-request E2E = TTFT(tokens_in) + TBT *
  (tokens_out-1), with per-token costs from model size and a device
  profile. The reference fixes that profile as module constants; here
  ``EngineModel`` carries it as two fields, ``peak_flops`` and ``hbm_bw``,
  which default to one NVIDIA H100 SXM's data-sheet figures (989e12 bf16
  dense FLOP/s, 3.35e12 B/s), with ``n_chips`` = 1. Drives the
  discrete-event SLO simulator.

* ``ModelEngine``: a real model behind prefill into a slot and one batched
  decode step for every slot with its own position / kv_len (the
  continuous-batching requirement). The reference vmaps a single-sequence
  decode over the slots; the port runs one batched decode with per-slot
  positions, and an MoE layer dispatches each slot's token on its own
  (``moe_groups``), with the capacity the vmapped one-slot call has.
  Placing a slot's prefill cache is an index copy, whatever its keys (the
  MLA latent cache too). The slots' largest kv length, known here on the
  host, goes to the decode as ``kv_max`` (MLA reads or materialises only
  that many cache positions).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm


# one NVIDIA H100 SXM, data sheet (the same figures chip_smoke.py's bounds use)
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12        # HBM3 bytes/s


@dataclass(frozen=True)
class EngineModel:
    """Analytic per-request latency model of a serving instance."""
    name: str
    n_active_params: int       # per-token matmul params (6ND convention)
    n_chips: int = 1
    kv_bytes_per_token: float = 0.0   # KV-cache bytes appended per token
    weight_bytes: float = 0.0         # bytes read per decode step (weights)
    mfu_prefill: float = 0.5          # fraction of peak during prefill
    bwu_decode: float = 0.6           # fraction of HBM bw during decode
    overhead_s: float = 0.02          # fixed per-request overhead
    peak_flops: float = H100_BF16_FLOPS   # per device
    hbm_bw: float = H100_HBM_BW           # bytes/s per device

    @classmethod
    def from_config(cls, cfg: ModelConfig, n_chips: int = 1,
                    dtype_bytes: int = 2, peak_flops: float = H100_BF16_FLOPS,
                    hbm_bw: float = H100_HBM_BW) -> "EngineModel":
        n_act = cfg.active_params
        if cfg.attn_kind == "mla":
            kv_tok = cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) \
                * dtype_bytes
        elif cfg.ssm_kind:
            kv_tok = 0.0          # O(1) state
        else:
            kv_tok = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim \
                * dtype_bytes
        return cls(name=cfg.name, n_active_params=n_act, n_chips=n_chips,
                   kv_bytes_per_token=kv_tok,
                   weight_bytes=cfg.total_params * dtype_bytes,
                   peak_flops=peak_flops, hbm_bw=hbm_bw)

    # --- latency terms -----------------------------------------------------

    def ttft(self, tokens_in: float) -> float:
        """Prefill: compute-bound, 2*N*L FLOPs over the devices."""
        flops = 2.0 * self.n_active_params * tokens_in
        return self.overhead_s + flops / (self.n_chips * self.peak_flops
                                          * self.mfu_prefill)

    def tbt(self, kv_tokens: float = 0.0, batch: int = 1) -> float:
        """Decode: memory-bound; weights (amortized over the batch) + this
        request's KV stream per generated token."""
        bytes_per_step = self.weight_bytes / max(batch, 1) \
            + self.kv_bytes_per_token * kv_tokens
        return bytes_per_step / (self.n_chips * self.hbm_bw
                                 * self.bwu_decode)

    def e2e(self, tokens_in: float, tokens_out: float,
            batch: int = 1) -> float:
        """Zero-load end-to-end latency (paper §5.1's SLO reference):
        TTFT + TBT x (#generated - 1)."""
        kv_mid = tokens_in + tokens_out / 2.0   # average KV length
        return self.ttft(tokens_in) + max(tokens_out - 1, 0) \
            * self.tbt(kv_mid, batch)


@dataclass
class ServiceStats:
    served: int = 0
    busy_until: float = 0.0
    total_busy: float = 0.0


class AnalyticEngine:
    """Single FIFO server with deterministic service times (the 'D' in
    M/D/1). ``concurrency`` > 1 models continuous batching: up to C
    requests share the server; decode TBT amortizes weight reads over the
    live batch."""

    def __init__(self, model: EngineModel, concurrency: int = 1):
        self.model = model
        self.concurrency = concurrency
        self._free_at = np.zeros(concurrency, dtype=np.float64)
        self.stats = ServiceStats()

    def reset(self) -> None:
        self._free_at[:] = 0.0
        self.stats = ServiceStats()

    def mean_service_time(self, tokens_in: float, tokens_out: float) -> float:
        return self.model.e2e(tokens_in, tokens_out, batch=self.concurrency)

    def submit(self, arrival: float, tokens_in: int, tokens_out: int
               ) -> tuple[float, float]:
        """Returns (start_time, completion_time) under FIFO dispatch to the
        earliest-free lane."""
        lane = int(np.argmin(self._free_at))
        start = max(arrival, self._free_at[lane])
        live = int((self._free_at > start).sum()) + 1
        service = self.model.e2e(tokens_in, tokens_out,
                                 batch=min(live, self.concurrency))
        done = start + service
        self._free_at[lane] = done
        self.stats.served += 1
        self.stats.total_busy += service
        self.stats.busy_until = float(self._free_at.max())
        return start, done


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
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, tok, self.cache, pos, kv_len=kv_len,
            moe_groups=self.n_slots, kv_max=int(self.pos.max()) + 1)
        self.pos[self.active] += 1
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.pos[slot] = 0
