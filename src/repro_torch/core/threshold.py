"""Dynamic threshold adjustment (paper §3.3 / §4.3).

M/D/1 waiting time with semantic-cache shunting:
    E(theta)  = L * (1 - h(theta))                      (Eq. 2 service time)
    W(theta)  = E + lambda E^2 / (2 (1 - lambda E))
SISO picks the HIGHEST theta_R whose predicted W satisfies the SLO S. The
h(theta) map is the T2H table sampled offline (5% of fresh queries); lambda
is monitored online (10 s refresh); a +-10% error band feeds back observed
waits into a theta correction.

This module is the *controller* shared by both serving paths (DESIGN.md
§7.1): the discrete-event simulator and the live gateway both drive it
through the same entry points —

    observe_arrivals(t, n)        lambda monitoring -> windowed retune
    observe_completion(wait, s)   +-10% feedback + service-time EMA
    calibrate(L)                  seed L from an engine estimate

``llm_latency`` (L) starts as a constructor guess but is re-calibrated
online from measured per-request service times (EMA), so the M/D/1
prediction tracks the engine actually behind the cache rather than a
static configuration value.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# bounded telemetry windows: the controller lives inside long-running
# serving objects, so traces describe the recent past, not the lifetime
TRACE_WINDOW = 4096
ERR_WINDOW = 512


@dataclass
class T2HTable:
    thetas: np.ndarray       # descending, e.g. 0.98 ... 0.60
    hit_ratios: np.ndarray   # same length, non-decreasing as theta falls

    @classmethod
    def build(cls, cache, sample_vectors: np.ndarray,
              thetas: np.ndarray | None = None) -> "T2HTable":
        """One lookup pass gives best-sims; hit ratio per theta is a mean."""
        if len(sample_vectors) == 0:
            thetas = (np.round(np.arange(0.98, 0.599, -0.02), 4)
                      if thetas is None else np.asarray(thetas))
            return cls(thetas, np.zeros_like(thetas))
        res = cache.lookup(sample_vectors, theta_r=-1.0, update_counts=False)
        return cls.from_sims(res.sim, thetas)

    @classmethod
    def from_sims(cls, sims: np.ndarray,
                  thetas: np.ndarray | None = None) -> "T2HTable":
        """Table from pre-computed best-sims — the single source of the
        theta grid and hit-ratio formula, shared by the synchronous build
        and the incremental RefreshPipeline's blocked probes (so the two
        paths can never drift apart)."""
        thetas = (np.round(np.arange(0.98, 0.599, -0.02), 4)
                  if thetas is None else np.asarray(thetas))
        hit = np.array([(sims >= t).mean() for t in thetas])
        return cls(thetas, hit)

    def h(self, theta: float) -> float:
        i = int(np.argmin(np.abs(self.thetas - theta)))
        return float(self.hit_ratios[i])


def mdo1_wait(lam: float, E: float) -> float:
    """M/D/1 mean sojourn (service + queue) time; inf when unstable."""
    rho = lam * E
    if rho >= 1.0:
        return float("inf")
    return E + lam * E * E / (2.0 * (1.0 - rho))


@dataclass
class DynamicThreshold:
    t2h: T2HTable
    slo_latency: float            # S
    llm_latency: float            # L — seed guess, EMA-calibrated online
    lambda_window: float = 10.0   # seconds between lambda refreshes
    error_band: float = 0.10
    enabled: bool = True
    ema_alpha: float = 0.2        # service-time EMA weight
    # state
    lam: float = 0.0
    theta: float = 0.98
    _arrivals: list = field(default_factory=list)
    # None until the first observed arrival: anchoring the window at the
    # first arrival (not 0.0) keeps a wall-clock first batch from
    # "satisfying" the window immediately and retuning on a meaningless
    # lambda = first_batch_size / lambda_window
    _last_refresh: Optional[float] = None
    _bias: int = 0                # feedback correction in table steps
    _calibrated: bool = False     # has a measured service time arrived?
    # telemetry (read by GatewayStats / report(); the theta_R trace is
    # kept by the callers — gateway per batch, simulator per request —
    # not here, to avoid three differently-sampled copies)
    n_feedback: int = 0
    lam_trace: deque = field(
        default_factory=lambda: deque(maxlen=TRACE_WINDOW))  # (t, lam)
    wait_errors: deque = field(
        default_factory=lambda: deque(maxlen=ERR_WINDOW))  # relative err
    # per-namespace calibration (DESIGN.md §14): each identified tenant
    # gets its own arrival window, theta operating point, and feedback
    # bias, while sharing the global T2H table and LLM-latency EMA (one
    # engine behind the cache — service time is not tenant-specific).
    # Keyed by tenant id; empty until observe_tenant_arrivals sees one.
    _tenants: dict = field(default_factory=dict)

    # ------------------------------------------------------------ arrivals

    def observe_arrival(self, t: float) -> None:
        self.observe_arrivals(t, 1)

    def observe_arrivals(self, t: float, n: int) -> None:
        """Batched arrival accounting: a size-n batch at time t counts n
        arrivals toward lambda without a per-request Python call."""
        self._arrivals.extend([t] * n)
        if self._last_refresh is None:
            self._last_refresh = t
            return
        if t - self._last_refresh >= self.lambda_window:
            horizon = t - self.lambda_window
            self._arrivals = [a for a in self._arrivals if a >= horizon]
            self.lam = len(self._arrivals) / self.lambda_window
            self._last_refresh = t
            self.lam_trace.append((t, self.lam))
            self.retune()

    # ------------------------------------------------------- per-namespace

    def _tenant_state(self, tid: int) -> dict:
        ts = self._tenants.get(tid)
        if ts is None:
            ts = {"lam": 0.0, "theta": None, "bias": 0, "arrivals": [],
                  "last_refresh": None, "n_feedback": 0}
            self._tenants[tid] = ts
        return ts

    def observe_tenant_arrivals(self, t: float,
                                tenant_ids: np.ndarray) -> None:
        """Per-namespace lambda monitoring: each identified tenant's
        arrivals feed its own window; a rollover retunes that tenant's
        theta under the *fair-share* M/D/1 — the tenant's own rate scaled
        by the number of active namespaces, modeling its slice of the
        shared engine (DESIGN.md §14). Anonymous rows (tenant < 0) are
        covered by the global window alone."""
        tids = np.asarray(tenant_ids, np.int64)
        for tid in np.unique(tids[tids >= 0]):
            ts = self._tenant_state(int(tid))
            n = int((tids == tid).sum())
            ts["arrivals"].extend([t] * n)
            if ts["last_refresh"] is None:
                ts["last_refresh"] = t
                continue
            if t - ts["last_refresh"] >= self.lambda_window:
                horizon = t - self.lambda_window
                ts["arrivals"] = [a for a in ts["arrivals"]
                                  if a >= horizon]
                ts["lam"] = len(ts["arrivals"]) / self.lambda_window
                ts["last_refresh"] = t
                self._retune_tenant(ts)

    def _retune_tenant(self, ts: dict) -> None:
        if not self.enabled:
            return
        lam_eff = ts["lam"] * max(1, len(self._tenants))
        ts["theta"] = self._pick_theta(lam_eff, ts["bias"])

    def tenant_theta(self, tid: int) -> float:
        """The namespace's operating point; the shared global theta until
        the tenant's first window rollover calibrates one."""
        ts = self._tenants.get(int(tid))
        if ts is None or ts["theta"] is None or not self.enabled:
            return self.theta
        return float(ts["theta"])

    @property
    def n_tenants(self) -> int:
        return len(self._tenants)

    # --------------------------------------------------------- calibration

    def calibrate(self, llm_latency: float) -> None:
        """Seed L from an external estimate (e.g. the analytic engine's
        mean service time). Later measured services EMA from here."""
        self.llm_latency = float(llm_latency)
        self._calibrated = True

    def observe_service(self, service: float) -> None:
        """One measured per-request engine service time: EMA-update L so
        the M/D/1 prediction tracks the real engine, not the constructor
        guess. The first measurement replaces an uncalibrated guess."""
        service = float(service)
        if not np.isfinite(service) or service <= 0:
            return
        if not self._calibrated:
            self.llm_latency = service
            self._calibrated = True
        else:
            self.llm_latency += self.ema_alpha * (service - self.llm_latency)

    # ------------------------------------------------------------- predict

    def predicted_wait(self, theta: float) -> float:
        E = self.llm_latency * (1.0 - self.t2h.h(theta))
        return mdo1_wait(self.lam, E)

    def _pick_theta(self, lam: float, bias: int) -> float:
        """Highest theta with W(theta) <= S at arrival rate ``lam``, then
        the feedback bias in table steps — the one selection rule shared
        by the global retune and every per-namespace retune."""
        chosen = None
        for i, th in enumerate(self.t2h.thetas):  # descending thetas
            E = self.llm_latency * (1.0 - self.t2h.h(float(th)))
            if mdo1_wait(lam, E) <= self.slo_latency:
                chosen = i
                break
        if chosen is None:
            chosen = len(self.t2h.thetas) - 1
        chosen = int(np.clip(chosen + bias, 0, len(self.t2h.thetas) - 1))
        return float(self.t2h.thetas[chosen])

    def retune(self) -> float:
        """Pick the highest theta with W(theta) <= S (then apply feedback
        bias). Falls back to the lowest theta when nothing is feasible."""
        if not self.enabled:
            # fixed-theta operation (SISO-NoDTA): the configured operating
            # point must never be overwritten by the table
            return self.theta
        self.theta = self._pick_theta(self.lam, self._bias)
        # a retune fires when the shared model moved (new T2H table,
        # recalibrated L, global window rollover): refresh every
        # namespace operating point against the new model too
        for ts in self._tenants.values():
            self._retune_tenant(ts)
        return self.theta

    # ------------------------------------------------------------ feedback

    def feedback(self, observed_wait: float) -> None:
        """±10% band: if the realized wait beats/misses the model, shift the
        operating point one table step (paper §4.3 last paragraph)."""
        self.n_feedback += 1
        predicted = self.predicted_wait(self.theta)
        if np.isfinite(predicted) and predicted > 0:
            self.wait_errors.append(
                (observed_wait - predicted) / predicted)
        if not self.enabled:
            return
        if not np.isfinite(predicted):
            self._bias += 1
        else:
            # degenerate prediction (h(theta)=1 -> W=0, e.g. at the table
            # floor): fall back to the SLO as the band reference, so the
            # bias can still decay once realized waits are comfortably
            # inside the SLO — without this the controller wedges at the
            # lowest theta after an overload episode
            ref = predicted if predicted > 0 else self.slo_latency
            if ref <= 0:
                return
            err = (observed_wait - ref) / ref
            if err > self.error_band:
                self._bias += 1      # waits longer than modeled -> lower theta
            elif err < -self.error_band and self._bias > 0:
                self._bias -= 1
        self._bias = int(np.clip(self._bias, 0, len(self.t2h.thetas) - 1))
        self.retune()

    def _tenant_feedback(self, tid: int, observed_wait: float) -> None:
        """Per-namespace ±band correction mirroring :meth:`feedback`, run
        against the tenant's own fair-share M/D/1 prediction so one
        tenant's SLO misses bias only its own operating point."""
        ts = self._tenants.get(int(tid))
        if ts is None or not self.enabled:
            return
        ts["n_feedback"] += 1
        lam_eff = ts["lam"] * max(1, len(self._tenants))
        theta = self.theta if ts["theta"] is None else float(ts["theta"])
        E = self.llm_latency * (1.0 - self.t2h.h(theta))
        predicted = mdo1_wait(lam_eff, E)
        if not np.isfinite(predicted):
            ts["bias"] += 1
        else:
            ref = predicted if predicted > 0 else self.slo_latency
            if ref <= 0:
                return
            err = (observed_wait - ref) / ref
            if err > self.error_band:
                ts["bias"] += 1
            elif err < -self.error_band and ts["bias"] > 0:
                ts["bias"] -= 1
        ts["bias"] = int(np.clip(ts["bias"], 0, len(self.t2h.thetas) - 1))
        self._retune_tenant(ts)

    def observe_completion(self, wait: float,
                           service: Optional[float] = None,
                           tenant: Optional[int] = None) -> None:
        """One served request: ``wait`` is its realized sojourn (0 for an
        inline cache hit), ``service`` its measured engine time (None for
        hits — nothing to calibrate from). This is the single completion
        entry point both the simulator and the live scheduler call.
        ``tenant`` (when identified, >= 0) additionally feeds the
        namespace's own feedback loop."""
        self.feedback(wait)
        if service is not None:
            self.observe_service(service)
        if tenant is not None and tenant >= 0:
            self._tenant_feedback(int(tenant), wait)

    # --------------------------------------------------------- persistence

    def state_dict(self) -> dict:
        """Controller state a warm restart must reproduce exactly: the
        operating point, calibration, feedback bias, the open lambda
        window, and the bounded telemetry (DESIGN.md §12). Constructor
        configuration (SLO, windows, bands, enabled) is not state — the
        restoring process re-supplies it."""
        return {
            "theta": np.asarray(self.theta),
            "lam": np.asarray(self.lam),
            "llm_latency": np.asarray(self.llm_latency),
            "bias": np.asarray(self._bias),
            "calibrated": np.asarray(self._calibrated),
            "n_feedback": np.asarray(self.n_feedback),
            "arrivals": np.asarray(self._arrivals, np.float64),
            "last_refresh": np.asarray(
                np.nan if self._last_refresh is None
                else float(self._last_refresh)),
            "lam_trace": np.asarray(list(self.lam_trace),
                                    np.float64).reshape(-1, 2),
            "wait_errors": np.asarray(list(self.wait_errors), np.float64),
            "t2h": {"thetas": np.asarray(self.t2h.thetas, np.float64),
                    "hit_ratios": np.asarray(self.t2h.hit_ratios,
                                             np.float64)},
            # per-namespace calibration, flattened to parallel arrays
            # (NaN encodes a not-yet-calibrated theta / open window)
            "tenants": self._tenants_state(),
        }

    def _tenants_state(self) -> dict:
        tids = sorted(self._tenants)
        states = [self._tenants[t] for t in tids]
        return {
            "ids": np.asarray(tids, np.int64),
            "theta": np.asarray(
                [np.nan if ts["theta"] is None else float(ts["theta"])
                 for ts in states], np.float64),
            "lam": np.asarray([ts["lam"] for ts in states], np.float64),
            "bias": np.asarray([ts["bias"] for ts in states], np.int64),
            "n_feedback": np.asarray(
                [ts["n_feedback"] for ts in states], np.int64),
            "last_refresh": np.asarray(
                [np.nan if ts["last_refresh"] is None
                 else float(ts["last_refresh"]) for ts in states],
                np.float64),
            "arrivals": np.asarray(
                [a for ts in states for a in ts["arrivals"]], np.float64),
            "arrival_counts": np.asarray(
                [len(ts["arrivals"]) for ts in states], np.int64),
        }

    def _load_tenants(self, state: dict) -> None:
        self._tenants = {}
        ids = np.asarray(state["ids"], np.int64)
        arrivals = np.asarray(state["arrivals"], np.float64)
        counts = np.asarray(state["arrival_counts"], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for i, tid in enumerate(ids):
            theta = float(np.asarray(state["theta"])[i])
            last = float(np.asarray(state["last_refresh"])[i])
            self._tenants[int(tid)] = {
                "lam": float(np.asarray(state["lam"])[i]),
                "theta": None if np.isnan(theta) else theta,
                "bias": int(np.asarray(state["bias"])[i]),
                "arrivals": [float(a) for a in
                             arrivals[offsets[i]:offsets[i + 1]]],
                "last_refresh": None if np.isnan(last) else last,
                "n_feedback": int(np.asarray(state["n_feedback"])[i]),
            }

    def load_state(self, state: dict) -> None:
        self.theta = float(state["theta"])
        self.lam = float(state["lam"])
        self.llm_latency = float(state["llm_latency"])
        self._bias = int(state["bias"])
        self._calibrated = bool(state["calibrated"])
        self.n_feedback = int(state["n_feedback"])
        self._arrivals = [float(a) for a in np.asarray(state["arrivals"])]
        last = float(state["last_refresh"])
        self._last_refresh = None if np.isnan(last) else last
        self.lam_trace = deque((map(tuple, np.asarray(
            state["lam_trace"]).reshape(-1, 2))), maxlen=TRACE_WINDOW)
        self.wait_errors = deque(np.asarray(state["wait_errors"]).tolist(),
                                 maxlen=ERR_WINDOW)
        # np.array (copy): never alias a live table from the donor state
        self.t2h = T2HTable(np.array(state["t2h"]["thetas"]),
                            np.array(state["t2h"]["hit_ratios"]))
        # .get(): checkpoints predating tenancy restore tenant-free
        self._load_tenants(state.get(
            "tenants", {"ids": [], "theta": [], "lam": [], "bias": [],
                        "n_feedback": [], "last_refresh": [],
                        "arrivals": [], "arrival_counts": []}))

    # ----------------------------------------------------------- telemetry

    def wait_error_stats(self) -> dict:
        """Predicted-vs-observed wait error over the recent window."""
        if not self.wait_errors:
            return {"mean": 0.0, "mean_abs": 0.0, "n": 0}
        e = np.asarray(self.wait_errors)
        return {"mean": float(e.mean()),
                "mean_abs": float(np.abs(e).mean()),
                "n": int(len(e))}
