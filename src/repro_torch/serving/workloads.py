"""Scenario-diverse load generators for the live SLO harness (port of
``repro/serving/workloads.py``, carried over as numpy).

The analytic simulator replays one steady arrival process; the live
control loop (DESIGN.md §7.1) has to be proven under the load shapes a
real deployment sees. Each scenario here couples an *arrival-time
pattern* with a *content stream* and returns a (train, test) pair of
QueryBatches: ``train`` bootstraps a cache frontend, ``test`` drives the
real ``ServingGateway`` (``chip_smoke.py``'s slo phase on the card;
EXPERIMENTS.md §SLO).

Scenarios (names are the ``SCENARIOS`` registry keys):

* ``poisson``      — steady-state Poisson arrivals at a fixed rate.
* ``bursty``       — on/off square wave: rate alternates between a burst
                     plateau and a quiet floor (duty-cycled overload).
* ``diurnal``      — sinusoidal ramp between a night floor and a day
                     peak (one full "day" over the stream).
* ``topic_drift``  — the embedding distribution shifts mid-stream: the
                     stream walks through disjoint cluster blocks, and
                     only the first block is in the training history.
* ``repeat_heavy`` — per-user streams: each user keeps re-asking
                     paraphrases from a small personal topic set drawn
                     from the global popularity, so semantic locality is
                     extreme but exact-vector repeats are rare.
* ``multi_tenant`` — namespaced streams: power-law tenant sizes, each
                     tenant mixing private topics with a shared popular
                     pool (DESIGN.md §14).

Non-homogeneous arrivals use Lewis–Shedler thinning, so any bounded
rate function works.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.data.synth import QueryBatch, SyntheticWorkload


@dataclass
class Scenario:
    name: str
    train: QueryBatch           # bootstrap history (the paper's 95% split)
    test: QueryBatch            # timestamped live stream
    notes: str = ""
    extras: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# arrival-time patterns
# ---------------------------------------------------------------------------


def poisson_arrivals(rng: np.random.Generator, n: int, rps: float,
                     t0: float = 0.0) -> np.ndarray:
    return t0 + np.cumsum(rng.exponential(1.0 / max(rps, 1e-9), size=n))


def thinned_arrivals(rng: np.random.Generator, n: int,
                     rate_fn: Callable[[float], float], rate_max: float,
                     t0: float = 0.0) -> np.ndarray:
    """Lewis–Shedler thinning: sample a non-homogeneous Poisson process
    with intensity ``rate_fn`` (bounded by ``rate_max``)."""
    out = np.empty(n)
    t = t0
    k = 0
    while k < n:
        t += rng.exponential(1.0 / rate_max)
        if rng.random() * rate_max <= rate_fn(t):
            out[k] = t
            k += 1
    return out


def onoff_rate(rps_on: float, rps_off: float, period: float,
               duty: float = 0.5) -> Callable[[float], float]:
    """Square-wave intensity: ``rps_on`` for the first ``duty`` fraction
    of every period, ``rps_off`` for the rest."""
    def rate(t: float) -> float:
        return rps_on if (t % period) < duty * period else rps_off
    return rate


def diurnal_rate(rps_lo: float, rps_hi: float,
                 period: float) -> Callable[[float], float]:
    """Sinusoidal day/night ramp: floor at t=0, peak at t=period/2."""
    def rate(t: float) -> float:
        x = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / period))
        return rps_lo + (rps_hi - rps_lo) * x
    return rate


# ---------------------------------------------------------------------------
# content-stream assembly
# ---------------------------------------------------------------------------


def _assemble(wl: SyntheticWorkload, cids: np.ndarray, arrivals: np.ndarray,
              users: np.ndarray | None = None,
              vecs: np.ndarray | None = None) -> QueryBatch:
    """QueryBatch from explicit cluster ids + arrival times, with the
    profile's token-length and complexity statistics."""
    p = wl.profile
    cids = np.asarray(cids)
    n = len(cids)
    if vecs is None:
        vecs = wl.embed(cids)
    is_complex = wl.cluster_complex[cids]
    answers = wl.llm_answer(vecs, is_complex)
    tokens_in = np.maximum(1, wl.rng.poisson(p.avg_tokens_in, size=n))
    tokens_out = np.maximum(
        1, wl.rng.lognormal(np.log(p.avg_tokens_out), 0.6,
                            size=n)).astype(np.int64)
    if users is None:
        users = wl.rng.integers(0, p.n_users, size=n)
    return QueryBatch(vecs, answers, cids, np.asarray(users),
                      np.asarray(arrivals, np.float64),
                      tokens_in, tokens_out, is_complex)


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def poisson_steady(*, dim: int = 32, n_clusters: int = 240, seed: int = 0,
                   n_train: int = 1200, n_test: int = 160,
                   rps: float = 10.0) -> Scenario:
    wl = SyntheticWorkload("quora", dim=dim, n_clusters=n_clusters, seed=seed)
    train = wl.sample(n_train, rps=50.0)
    test = wl.sample(n_test, rps=rps)
    return Scenario("poisson", train, test,
                    notes=f"steady Poisson arrivals @ {rps} rps")


def bursty_onoff(*, dim: int = 32, n_clusters: int = 240, seed: int = 0,
                 n_train: int = 1200, n_test: int = 160,
                 rps: float = 10.0, burst_x: float = 2.4,
                 floor_x: float = 0.3, period: float = 6.0,
                 duty: float = 0.45) -> Scenario:
    wl = SyntheticWorkload("quora", dim=dim, n_clusters=n_clusters, seed=seed)
    train = wl.sample(n_train, rps=50.0)
    test = wl.sample(n_test, rps=rps)
    rate = onoff_rate(burst_x * rps, floor_x * rps, period, duty)
    test.arrivals = thinned_arrivals(wl.rng, n_test, rate, burst_x * rps)
    return Scenario("bursty", train, test,
                    notes=f"on/off bursts {burst_x * rps:.0f}/"
                          f"{floor_x * rps:.0f} rps, period {period}s",
                    extras={"period": period, "duty": duty})


def diurnal_ramp(*, dim: int = 32, n_clusters: int = 240, seed: int = 0,
                 n_train: int = 1200, n_test: int = 160,
                 rps: float = 10.0, peak_x: float = 2.0,
                 floor_x: float = 0.2) -> Scenario:
    wl = SyntheticWorkload("quora", dim=dim, n_clusters=n_clusters, seed=seed)
    train = wl.sample(n_train, rps=50.0)
    test = wl.sample(n_test, rps=rps)
    # one full "day" over the stream at the mean rate
    period = n_test / rps
    rate = diurnal_rate(floor_x * rps, peak_x * rps, period)
    test.arrivals = thinned_arrivals(wl.rng, n_test, rate, peak_x * rps)
    return Scenario("diurnal", test=test, train=train,
                    notes=f"sinusoidal ramp {floor_x * rps:.0f}->"
                          f"{peak_x * rps:.0f} rps over {period:.0f}s",
                    extras={"period": period})


def topic_drift(*, dim: int = 32, n_clusters: int = 240, seed: int = 0,
                n_train: int = 1200, n_test: int = 160,
                rps: float = 10.0, n_phases: int = 3) -> Scenario:
    """The embedding distribution shifts mid-stream: the test walks
    through ``n_phases`` disjoint cluster blocks and only block 0 is in
    the training history — the cache must adapt via refresh."""
    wl = SyntheticWorkload("quora", dim=dim, n_clusters=n_clusters, seed=seed)
    block = n_clusters // n_phases
    w = _zipf_weights(block, wl.profile.zipf_s)
    train_cids = wl.rng.choice(block, size=n_train, p=w)   # block 0 only
    train = _assemble(wl, train_cids, poisson_arrivals(wl.rng, n_train, 50.0))
    cids = np.empty(n_test, np.int64)
    phase_len = n_test // n_phases
    boundaries = []
    for k in range(n_phases):
        lo = k * phase_len
        hi = n_test if k == n_phases - 1 else (k + 1) * phase_len
        cids[lo:hi] = k * block + wl.rng.choice(block, size=hi - lo, p=w)
        boundaries.append(lo)
    test = _assemble(wl, cids, poisson_arrivals(wl.rng, n_test, rps))
    return Scenario("topic_drift", train, test,
                    notes=f"{n_phases} disjoint topic phases; only phase 0 "
                          "is in the bootstrap history",
                    extras={"phase_starts": boundaries})


def repeat_heavy(*, dim: int = 32, n_clusters: int = 240, seed: int = 0,
                 n_train: int = 1200, n_test: int = 160,
                 rps: float = 10.0, n_users: int = 24,
                 topics_per_user: int = 4) -> Scenario:
    """Per-user streams with extreme semantic locality: each user keeps
    re-asking fresh paraphrases from a small personal topic set drawn
    from the global popularity. Exact-vector repeats are rare (every ask
    is a new paraphrase), so this separates semantic caching from
    string/vector-identity caching."""
    wl = SyntheticWorkload("quora", dim=dim, n_clusters=n_clusters, seed=seed)
    train = wl.sample(n_train, rps=50.0)
    pop = _zipf_weights(n_clusters, wl.profile.zipf_s)
    user_topics = np.stack([
        wl.rng.choice(n_clusters, size=topics_per_user, p=pop, replace=False)
        for _ in range(n_users)])
    users = wl.rng.integers(0, n_users, size=n_test)
    slot = wl.rng.integers(0, topics_per_user, size=n_test)
    cids = user_topics[users, slot]
    test = _assemble(wl, cids, poisson_arrivals(wl.rng, n_test, rps),
                     users=users)
    return Scenario("repeat_heavy", train, test,
                    notes=f"{n_users} users x {topics_per_user} personal "
                          "topics, every ask a fresh paraphrase",
                    extras={"n_users": n_users})


def multi_tenant(*, dim: int = 32, n_clusters: int = 240, seed: int = 0,
                 n_train: int = 1200, n_test: int = 320,
                 rps: float = 10.0, n_tenants: int = 8,
                 tenant_s: float = 1.2, personal_per_tenant: int = 3,
                 personal_frac: float = 0.5,
                 global_pool: int = 24) -> Scenario:
    """Namespaced traffic (DESIGN.md §14): tenant sizes follow a power
    law (tenant 0 floods, the tail trickles), and each request is either
    a *personal* topic from the tenant's private cluster set — never
    shared across namespaces — or a draw from a small shared popular
    pool. Personal clusters are disjoint across tenants, so any
    cross-tenant hit on a personal topic is an isolation failure by
    construction. ``extras["tenants"]`` carries the per-request
    namespace ids (users == tenants here: one stream per namespace)."""
    wl = SyntheticWorkload("quora", dim=dim, n_clusters=n_clusters, seed=seed)
    train = wl.sample(n_train, rps=50.0)
    need = n_tenants * personal_per_tenant + global_pool
    if need > n_clusters:
        raise ValueError(f"n_clusters={n_clusters} too small for "
                         f"{n_tenants}x{personal_per_tenant} personal + "
                         f"{global_pool} shared clusters")
    # shared pool = the globally popular head; personal sets are carved
    # from the tail so they never collide with the pool or each other
    shared = np.arange(global_pool)
    personal = (global_pool
                + np.arange(n_tenants * personal_per_tenant).reshape(
                    n_tenants, personal_per_tenant))
    tw = _zipf_weights(n_tenants, tenant_s)
    tenants = wl.rng.choice(n_tenants, size=n_test, p=tw)
    pw = _zipf_weights(global_pool, wl.profile.zipf_s)
    cids = np.empty(n_test, np.int64)
    is_personal = wl.rng.random(n_test) < personal_frac
    for i in range(n_test):
        t = tenants[i]
        if is_personal[i]:
            cids[i] = personal[t, wl.rng.integers(personal_per_tenant)]
        else:
            cids[i] = shared[wl.rng.choice(global_pool, p=pw)]
    test = _assemble(wl, cids, poisson_arrivals(wl.rng, n_test, rps),
                     users=tenants)
    return Scenario("multi_tenant", train, test,
                    notes=f"{n_tenants} tenants, zipf(s={tenant_s}) sizes, "
                          f"{personal_frac:.0%} personal topics",
                    extras={"tenants": tenants,
                            "n_tenants": n_tenants,
                            "personal_clusters": personal,
                            "shared_clusters": shared})


SCENARIOS: dict[str, Callable[..., Scenario]] = {
    "poisson": poisson_steady,
    "bursty": bursty_onoff,
    "diurnal": diurnal_ramp,
    "topic_drift": topic_drift,
    "repeat_heavy": repeat_heavy,
    "multi_tenant": multi_tenant,
}


def build_scenario(name: str, **kw) -> Scenario:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name](**kw)
