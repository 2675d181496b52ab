"""Discrete-event SLO simulator (paper §5 methodology); port of
``repro/serving/simulator.py``, numerically as the reference.

Replays a QueryBatch (timestamped arrivals) through an optional semantic
cache frontend into an AnalyticEngine, faithfully modelling:

  * per-request SLO = slo_scale x zero-load E2E (TTFT + TBT*(out-1)),
    the paper's 1.3x rule;
  * cache-frontend latency (embedding + search, the paper's Table 4
    figures, kept as the reference's defaults);
  * answers become cacheable only when the LLM *finishes* them (pending
    inserts carry their ready time);
  * SISO's online loop: lambda monitoring -> M/D/1 retune, +-10% wait
    feedback, refresh when +10% new queries accumulate;
  * straggler injection (lognormal service jitter) + hedged re-issue —
    the scheduler-level mitigation for multi-replica serving.

Quality metrics: mean answer cosine (hit answers vs true answers) and the
paper's F1-style score where SLO-violating requests count 0 (§5.2.7).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.synth import QueryBatch
from repro_torch.device import DeviceLike
from repro_torch.serving.baselines import FrontendTimes, NoCache
from repro_torch.serving.engine import AnalyticEngine


@dataclass
class SimResult:
    name: str
    n: int
    hit_ratio: float
    slo_attainment: float
    mean_e2e: float
    p99_e2e: float
    mean_wait: float
    mean_quality: float          # answer cosine (1.0 for LLM-served)
    slo_weighted_quality: float  # violations scored 0 (F1 proxy)
    theta_trace: list = field(default_factory=list)
    extras: dict = field(default_factory=dict)


class ServingSimulator:
    def __init__(self, engine: AnalyticEngine, frontend=None, *,
                 slo_scale: float = 1.3, jitter_cv: float = 0.0,
                 hedge_threshold: float = 0.0, seed: int = 0,
                 siso_times: FrontendTimes | None = None):
        self.engine = engine
        self.frontend = frontend or NoCache()
        self.slo_scale = slo_scale
        self.jitter_cv = jitter_cv
        self.hedge_threshold = hedge_threshold   # x mean service; 0 = off
        self.rng = np.random.default_rng(seed)
        self.is_siso = hasattr(self.frontend, "handle_batch")
        self.times = (siso_times or
                      FrontendTimes(search_hit=13.92e-3, search_miss=16.16e-3)
                      if self.is_siso
                      else getattr(self.frontend, "times", FrontendTimes()))

    # ------------------------------------------------------------------ run

    def _jittered(self, service: float) -> tuple[float, bool]:
        """Apply straggler jitter; hedge (re-issue) when the draw exceeds
        the threshold — completion is the min of two draws."""
        if self.jitter_cv <= 0:
            return service, False
        sigma = np.sqrt(np.log1p(self.jitter_cv ** 2))
        mult = self.rng.lognormal(-sigma * sigma / 2, sigma)
        if self.hedge_threshold and mult > self.hedge_threshold:
            mult2 = self.rng.lognormal(-sigma * sigma / 2, sigma)
            return service * min(mult, mult2), True
        return service * mult, False

    def run(self, batch: QueryBatch, name: str = "sim",
            calibrate_siso: bool = True) -> SimResult:
        eng, fe = self.engine, self.frontend
        eng.reset()
        n = len(batch.vectors)
        if self.is_siso and calibrate_siso:
            # seed L from the analytic estimate; the controller's online
            # EMA (observe_completion below) refines it from realized
            # service times — the same loop the live gateway runs
            fe.threshold.calibrate(eng.mean_service_time(
                float(np.mean(batch.tokens_in)),
                float(np.mean(batch.tokens_out))))
        pending: list[tuple[float, int]] = []   # (ready_time, query idx)
        e2e = np.zeros(n)
        wait = np.zeros(n)
        hit = np.zeros(n, bool)
        quality = np.ones(n)
        slo = np.zeros(n)
        theta_trace = []
        hedged = 0

        for i in range(n):
            t = float(batch.arrivals[i])
            # LLM answers that have finished by now become cacheable
            while pending and pending[0][0] <= t:
                _, j = heapq.heappop(pending)
                self._insert(batch, j)
            vec = batch.vectors[i]
            if self.is_siso:
                res = fe.handle_batch(vec[None], now=t,
                                      user_ids=batch.user_ids[i:i + 1])
            else:
                res = fe.lookup(vec[None], now=t)
            fe_cost = self.times.embed + (
                self.times.search_hit if res.hit[0] else self.times.search_miss)

            zero_load = eng.model.e2e(int(batch.tokens_in[i]),
                                      int(batch.tokens_out[i]))
            slo[i] = self.slo_scale * zero_load

            if res.hit[0]:
                hit[i] = True
                e2e[i] = fe_cost
                quality[i] = float(res.answer[0] @ batch.answers[i])
                if self.is_siso:
                    # an inline hit's realized wait is just the frontend
                    # cost — feeding it keeps the observed-wait average
                    # aligned with what W(theta) models (all requests)
                    fe.observe_completion(fe_cost)
            else:
                start, done = eng.submit(t + fe_cost,
                                         int(batch.tokens_in[i]),
                                         int(batch.tokens_out[i]))
                service, was_hedged = self._jittered(done - start)
                hedged += was_hedged
                done = start + service
                e2e[i] = done - t
                wait[i] = start - t
                heapq.heappush(pending, (done, i))
                if self.is_siso:
                    fe.observe_completion(done - t, service)
                    if fe.needs_refresh():
                        fe.refresh()
            if self.is_siso:
                theta_trace.append(fe.theta_r)

        met = e2e <= slo
        return SimResult(
            name=name, n=n,
            hit_ratio=float(hit.mean()),
            slo_attainment=float(met.mean()),
            mean_e2e=float(e2e.mean()),
            p99_e2e=float(np.percentile(e2e, 99)),
            mean_wait=float(wait[~hit].mean()) if (~hit).any() else 0.0,
            mean_quality=float(quality.mean()),
            slo_weighted_quality=float((quality * met).mean()),
            theta_trace=theta_trace,
            extras={"hedged": hedged},
        )

    def _insert(self, batch: QueryBatch, j: int) -> None:
        if self.is_siso:
            self.frontend.record_llm_answer(batch.vectors[j],
                                            batch.answers[j], answer_id=j)
        else:
            self.frontend.insert(batch.vectors[j], batch.answers[j],
                                 answer_id=j)


# ---------------------------------------------------------------------------
# The paper's four-system comparison (vLLM / GPTCache / SISO-NoDTA / SISO)
# ---------------------------------------------------------------------------


def build_system(kind: str, *, dim: int, capacity: int,
                 theta_r: float = 0.86, slo_latency: float = 1.0,
                 llm_latency: float = 0.5, backend: str = "dense",
                 device: DeviceLike = None):
    """One of the four systems; ``device`` places SISO's cache (the
    baselines are host numpy)."""
    from repro_torch.core.siso import SISO
    from repro_torch.serving.baselines import VectorCache
    from repro_torch.serving.config import CacheConfig, ServingConfig
    if kind == "vllm":
        return NoCache()
    if kind == "gptcache":
        return VectorCache(dim, dim, capacity, policy="lru", theta_r=theta_r)
    if kind in ("siso", "siso-nodta"):
        cfg = ServingConfig(
            cache=CacheConfig(dim=dim, answer_dim=dim, capacity=capacity,
                              theta_r=theta_r, backend=backend,
                              dynamic_threshold=(kind == "siso")),
            slo_latency=slo_latency, llm_latency=llm_latency)
        return SISO.from_config(cfg, device=device)
    raise ValueError(kind)


def bootstrap_frontend(frontend, train: QueryBatch) -> None:
    """Warm a frontend with the training split (the paper's 95%):
    SISO clusters it; vector caches replay-insert misses."""
    if hasattr(frontend, "bootstrap"):
        frontend.bootstrap(train.vectors, train.answers,
                           answer_ids=np.arange(len(train.vectors)))
    elif hasattr(frontend, "insert"):
        for i in range(len(train.vectors)):
            res = frontend.lookup(train.vectors[i][None])
            if not res.hit[0]:
                frontend.insert(train.vectors[i], train.answers[i],
                                answer_id=i)
        # warm-up lookups shouldn't count toward measured hit ratios
        if hasattr(frontend, "hits"):
            frontend.hits = 0
            frontend.misses = 0
