"""Calibrated synthetic workloads (DESIGN.md §2, §9.1).

The paper's datasets are not redistributable offline, so we generate
embedding-space workloads whose *measured statistics* match the paper's:

  * duplicate-pair median cos-sim ~0.82, non-duplicate ~0.62 (Fig. 2):
    e = normalize(alpha*g + beta*c_k + sigma*n) with a global anisotropy
    direction g, cluster direction c_k, idiosyncratic noise n;
    alpha^2 = base_sim, alpha^2+beta^2 = dup_sim.
  * Zipf cluster popularity with slow Ornstein-Uhlenbeck drift
    (Fig. 5 rank stability: most centroids move <10% in rank over weeks).
  * answers produced by a fixed orthogonal map (inner products preserved ->
    the Fig. 6 input/output similarity correlation holds by construction),
    with extra noise for "complex" queries (coding/brainstorming) whose
    outputs are chaotic in the input (§6).
  * per-profile token-length distributions (Table 3) driving engine cost.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class WorkloadProfile:
    name: str
    base_sim: float = 0.62        # non-duplicate median cosine
    dup_sim: float = 0.82         # duplicate median cosine
    zipf_s: float = 1.05          # cluster popularity skew
    complex_frac: float = 0.07    # chaotic-answer queries (Table 3)
    avg_tokens_in: int = 12
    avg_tokens_out: int = 180
    drift_rho: float = 0.995      # OU persistence per epoch ("week")
    repeat_prob: float = 0.05     # exact resubmission probability
    n_users: int = 512


# Table 3 / §3.1 datasets, calibrated qualitatively
PROFILES: dict[str, WorkloadProfile] = {
    "quora": WorkloadProfile("quora", complex_frac=0.069, avg_tokens_in=12),
    "reddit": WorkloadProfile("reddit", complex_frac=0.431, avg_tokens_in=14,
                              zipf_s=0.9),
    "msmarco": WorkloadProfile("msmarco", complex_frac=0.049, avg_tokens_in=7,
                               zipf_s=1.1),
    "nq": WorkloadProfile("nq", complex_frac=0.041, avg_tokens_in=9,
                          zipf_s=1.1),
    "sharegpt": WorkloadProfile("sharegpt", complex_frac=0.466,
                                avg_tokens_in=112, avg_tokens_out=350,
                                zipf_s=0.8, dup_sim=0.80),
    # duplicate-pair corpora (Fig. 2): thresholds 0.86 / 0.83 / 0.76
    "qqp": WorkloadProfile("qqp", dup_sim=0.86, base_sim=0.60),
    "mrpc": WorkloadProfile("mrpc", dup_sim=0.83, base_sim=0.62),
    "mqp": WorkloadProfile("mqp", dup_sim=0.76, base_sim=0.58),
}


@dataclass
class QueryBatch:
    vectors: np.ndarray        # (n, d) query embeddings
    answers: np.ndarray        # (n, d_a) true LLM answer embeddings
    cluster_ids: np.ndarray    # (n,)
    user_ids: np.ndarray       # (n,)
    arrivals: np.ndarray       # (n,) seconds
    tokens_in: np.ndarray      # (n,)
    tokens_out: np.ndarray     # (n,)
    is_complex: np.ndarray     # (n,) bool


class SyntheticWorkload:
    def __init__(self, profile: str | WorkloadProfile = "quora",
                 dim: int = 64, n_clusters: int = 2000, seed: int = 0):
        self.profile = (PROFILES[profile] if isinstance(profile, str)
                        else profile)
        self.dim = dim
        self.n_clusters = n_clusters
        self.rng = np.random.default_rng(seed)
        p = self.profile
        self.alpha = np.sqrt(p.base_sim)
        self.beta = np.sqrt(max(p.dup_sim - p.base_sim, 1e-6))
        self.sigma = np.sqrt(max(1.0 - p.dup_sim, 1e-6))
        g = self.rng.normal(size=dim)
        self.g = g / np.linalg.norm(g)
        centers = self.rng.normal(size=(n_clusters, dim))
        centers -= np.outer(centers @ self.g, self.g)  # orthogonal to g
        self.centers = centers / np.linalg.norm(centers, axis=1, keepdims=True)
        # Zipf popularity with OU drift state
        self._log_pop = -p.zipf_s * np.log(np.arange(1, n_clusters + 1))
        self._log_pop = self._log_pop[self.rng.permutation(n_clusters)]
        # cluster complexity flags (a cluster is a "topic")
        self.cluster_complex = self.rng.random(n_clusters) < p.complex_frac
        # fixed orthogonal answer map (preserves inner products)
        m = self.rng.normal(size=(dim, dim))
        q_, _ = np.linalg.qr(m)
        self.answer_map = q_.astype(np.float32)

    # ------------------------------------------------------------- embeddings

    def _popularity(self) -> np.ndarray:
        w = np.exp(self._log_pop - self._log_pop.max())
        return w / w.sum()

    def drift_epoch(self) -> None:
        """One 'week' of popularity drift (OU on log-popularity)."""
        p = self.profile
        noise = self.rng.normal(scale=np.std(self._log_pop) + 1e-9,
                                size=self.n_clusters)
        self._log_pop = (p.drift_rho * self._log_pop
                         + np.sqrt(1 - p.drift_rho ** 2) * noise)

    def embed(self, cluster_ids: np.ndarray) -> np.ndarray:
        n = len(cluster_ids)
        noise = self.rng.normal(size=(n, self.dim)) / np.sqrt(self.dim)
        noise = noise / np.linalg.norm(noise, axis=1, keepdims=True)
        e = (self.alpha * self.g[None, :]
             + self.beta * self.centers[cluster_ids]
             + self.sigma * noise)
        return (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)

    def llm_answer(self, vectors: np.ndarray,
                   is_complex: np.ndarray | None = None) -> np.ndarray:
        """The 'LLM': orthogonal map + idiosyncratic noise. Complex queries
        get large noise (small input changes -> very different outputs)."""
        vectors = np.atleast_2d(vectors)
        n = len(vectors)
        if is_complex is None:
            is_complex = np.zeros(n, bool)
        noise_scale = np.where(is_complex, 0.95, 0.30)[:, None]
        z = self.rng.normal(size=(n, self.dim)) / np.sqrt(self.dim)
        a = vectors @ self.answer_map.T + noise_scale * z
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)

    # ---------------------------------------------------------------- streams

    def arrivals(self, n: int, rps: float, cv: float = 1.0,
                 t0: float = 0.0) -> np.ndarray:
        """Arrival times: Poisson (cv=1) or gamma-renewal with the given
        coefficient of variation (paper §5.1 varies CV from 0.1 to 10)."""
        mean_gap = 1.0 / max(rps, 1e-9)
        if abs(cv - 1.0) < 1e-6:
            gaps = self.rng.exponential(mean_gap, size=n)
        else:
            shape = 1.0 / (cv * cv)
            gaps = self.rng.gamma(shape, mean_gap / shape, size=n)
        return t0 + np.cumsum(gaps)

    def sample(self, n: int, rps: float = 10.0, cv: float = 1.0,
               t0: float = 0.0) -> QueryBatch:
        p = self.profile
        pop = self._popularity()
        cids = self.rng.choice(self.n_clusters, size=n, p=pop)
        vecs = self.embed(cids)
        # exact resubmissions
        rep = self.rng.random(n) < p.repeat_prob
        for i in np.where(rep)[0]:
            if i > 0:
                j = self.rng.integers(0, i)
                vecs[i] = vecs[j]
                cids[i] = cids[j]
        is_complex = self.cluster_complex[cids]
        answers = self.llm_answer(vecs, is_complex)
        tokens_in = np.maximum(
            1, self.rng.poisson(p.avg_tokens_in, size=n))
        tokens_out = np.maximum(
            1, self.rng.lognormal(np.log(p.avg_tokens_out), 0.6,
                                  size=n)).astype(np.int64)
        users = self.rng.integers(0, p.n_users, size=n)
        return QueryBatch(vecs, answers, cids, users,
                          self.arrivals(n, rps, cv, t0),
                          tokens_in, tokens_out, is_complex)

    # ------------------------------------------------------------- pair data

    def labeled_pairs(self, n_pairs: int) -> tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
        """(emb1, emb2, is_duplicate) — the QQP/MRPC/MQP-style structure
        used for Fig. 2 and Table 1."""
        half = n_pairs // 2
        dup_c = self.rng.integers(0, self.n_clusters, size=half)
        a = self.embed(dup_c)
        b = self.embed(dup_c)
        c1 = self.rng.integers(0, self.n_clusters, size=n_pairs - half)
        c2 = (c1 + 1 + self.rng.integers(0, self.n_clusters - 1,
                                         size=n_pairs - half)) % self.n_clusters
        x = self.embed(c1)
        y = self.embed(c2)
        emb1 = np.concatenate([a, x])
        emb2 = np.concatenate([b, y])
        label = np.concatenate([np.ones(half, bool),
                                np.zeros(n_pairs - half, bool)])
        return emb1, emb2, label
