"""Port of the SISO loop held against the JAX package: the quickstart
stream (bootstrap, batched lookups with repeat escapes, miss recording,
incremental refresh ticks) gives the identical hit mask; the port's
clustering and merge match the JAX seed reference implementations; and
the tests/test_refresh_pipeline.py pipeline==sync checks hold in the port.
Everything runs on the CPU at dim <= 64 in fp32.
"""
import numpy as np
import pytest
import torch

from repro.core.cache_manager import merge_centroids_reference
from repro.core.clustering import (_neighbor_counts_reference,
                                   community_detection_reference as
                                   j_cd_reference,
                                   intra_cluster_stats_reference)
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro.core.store import CentroidStore as JStore
from repro.data.synth import SyntheticWorkload as JWorkload
from repro_torch.core.cache_manager import MergePlanner, merge_centroids
from repro_torch.core.clustering import (CommunityDetector,
                                         community_detection,
                                         community_detection_reference,
                                         intra_cluster_stats,
                                         neighbor_counts)
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.core.store import CentroidStore
from repro_torch.data.synth import SyntheticWorkload

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _unit(rng, n, d=16):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)


def _clustered(rng, n_topics, per, d=16, noise=0.08):
    base = _unit(rng, n_topics, d)
    v = np.repeat(base, per, axis=0) \
        + noise * rng.normal(size=(n_topics * per, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _assert_clusters_equal(ref, new, emb):
    assert len(ref) == len(new)
    for a, b in zip(ref, new):
        assert np.array_equal(np.sort(a.members), np.sort(b.members))
        assert a.cluster_size == b.cluster_size
        np.testing.assert_allclose(a.centroid, b.centroid, atol=1e-5)
        assert b.representative in b.members
        dots = emb[a.members] @ a.centroid
        assert float(emb[b.representative] @ a.centroid) \
            >= dots.max() - 1e-5


# ---------------------------------------------------------------------------
# the quickstart stream through both packages
# ---------------------------------------------------------------------------


def _quickstart(siso_cls, cfg_cls, wl_cls, backend, **kw):
    wl = wl_cls("quora", dim=64, n_clusters=300, seed=0)
    hist = wl.sample(1000, rps=100.0)
    siso = siso_cls(cfg_cls(dim=64, answer_dim=64, capacity=512,
                            backend=backend, dynamic_threshold=False), **kw)
    siso.bootstrap(hist.vectors, hist.answers, answer_ids=np.arange(1000))
    test = wl.sample(480, rps=20.0)
    hits = []
    for s in range(0, 480, 8):
        r = siso.handle_batch(test.vectors[s:s + 8],
                              now=float(test.arrivals[s]),
                              user_ids=test.user_ids[s:s + 8])
        hits.append(r.hit.copy())
        for j in np.flatnonzero(~r.hit):
            siso.record_llm_answer(test.vectors[s + j], test.answers[s + j],
                                   answer_id=s + j)
        siso.refresh_tick(0.0)
    siso.refresh_drain()
    return siso, np.concatenate(hits)


@pytest.mark.parametrize("backend", ["dense", "pallas", "pallas_q8"])
def test_quickstart_stream_hit_mask_matches_jax(backend):
    js, jh = _quickstart(JSISO, JConfig, JWorkload, backend)
    ts, th = _quickstart(SISO, SISOConfig, SyntheticWorkload, backend, **CPU)
    np.testing.assert_array_equal(th, jh)
    assert 0.5 < th.mean() < 0.95
    assert ts.refreshes_completed == js.refreshes_completed >= 2
    np.testing.assert_array_equal(ts.cache.centroids.answer_id,
                                  js.cache.centroids.answer_id)
    for k in ("hits", "misses", "n_centroids", "n_spill",
              "mirror_generation", "refresh_cycles"):
        assert ts.stats()[k] == js.stats()[k], k


def test_synthetic_workload_is_carried_over_bit_for_bit():
    a = JWorkload("reddit", dim=32, n_clusters=50, seed=3).sample(64)
    b = SyntheticWorkload("reddit", dim=32, n_clusters=50, seed=3).sample(64)
    for f in ("vectors", "answers", "cluster_ids", "user_ids", "arrivals"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


# ---------------------------------------------------------------------------
# clustering and merge == the JAX seed references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "clustered", "tight"])
def test_community_detection_matches_jax_reference(case):
    rng = np.random.default_rng(0)
    if case == "random":
        emb, theta = _unit(rng, 250, 12), 0.75
    elif case == "clustered":
        emb, theta = _clustered(rng, 12, 8), 0.86
    else:
        emb, theta = _clustered(rng, 6, 20, noise=0.02), 0.9
    ref = j_cd_reference(emb, threshold=theta)
    _assert_clusters_equal(ref, community_detection(emb, theta, **CPU), emb)
    _assert_clusters_equal(
        ref, community_detection_reference(emb, theta, **CPU), emb)


def test_incremental_detector_and_counts_match_jax_reference():
    rng = np.random.default_rng(1)
    emb = _clustered(rng, 8, 9)
    det = CommunityDetector(emb, threshold=0.86, count_block=16,
                            seed_block=8, scan_rows=3, finalize_rows=16,
                            fused_counts=False, **CPU)
    units = 0
    while det.step(0.0):
        units += 1
    _assert_clusters_equal(j_cd_reference(emb, threshold=0.86),
                           det.result(), emb)
    assert units > 5
    np.testing.assert_array_equal(neighbor_counts(emb, 0.86, **CPU),
                                  _neighbor_counts_reference(emb, 0.86))


def test_merge_centroids_matches_jax_reference_randomized():
    rng = np.random.default_rng(2)
    for _ in range(12):
        d = int(rng.integers(4, 20))
        n, r = int(rng.integers(0, 30)), int(rng.integers(0, 40))
        theta = float(rng.uniform(0.5, 0.95))
        cv, rv = _unit(rng, n, d), _unit(rng, r, d)
        if r > 4 and n > 2:
            rv[0] = cv[0]
            rv[1] = rv[2]
        stores = []
        for cls in (JStore, CentroidStore):
            cur, repo = cls(d, d), cls(d, d)
            if n:
                cur.add(cv, cv, np.arange(n) + 1.0, answer_id=np.arange(n))
            if r:
                repo.add(rv, rv, np.arange(r) % 7 + 1.0,
                         answer_id=np.arange(r))
            stores.append((cur, repo))
        m_ref, s_ref = merge_centroids_reference(stores[0][0].copy(),
                                                 stores[0][1], theta)
        m_new, s_new = merge_centroids(stores[1][0].copy(), stores[1][1],
                                       theta, **CPU)
        assert (s_ref.merged, s_ref.added) == (s_new.merged, s_new.added)
        np.testing.assert_array_equal(m_new.vectors, m_ref.vectors)
        np.testing.assert_allclose(m_new.cluster_size, m_ref.cluster_size,
                                   rtol=1e-6)
        np.testing.assert_array_equal(m_new.ids, m_ref.ids)


def test_merge_planner_stepping_and_intra_stats():
    rng = np.random.default_rng(3)
    cv, rv = _unit(rng, 20, 8), _unit(rng, 35, 8)
    cur, repo = CentroidStore(8, 8), CentroidStore(8, 8)
    cur.add(cv, cv, np.arange(20) + 1.0)
    repo.add(rv, rv, np.arange(35) % 9 + 1.0)
    ref, _ = merge_centroids(cur.copy(), repo, 0.6, **CPU)
    p = MergePlanner(cur.copy(), repo, 0.6, block=4, **CPU)
    units = 0
    while p.step(0.0):
        units += 1
    out, _ = p.result()
    np.testing.assert_array_equal(ref.vectors, out.vectors)
    assert units > 5
    emb = _clustered(rng, 10, 12)
    clusters = community_detection(emb, threshold=0.86, **CPU)
    np.testing.assert_allclose(intra_cluster_stats(emb, clusters, **CPU),
                               intra_cluster_stats_reference(emb, clusters),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# pipeline == sync (tests/test_refresh_pipeline.py), in the port
# ---------------------------------------------------------------------------


def _mini_siso(rng, refresh_async, capacity=64):
    siso = SISO(SISOConfig(dim=16, answer_dim=16, capacity=capacity,
                           dynamic_threshold=True,
                           refresh_async=refresh_async), **CPU)
    hist = _clustered(rng, 20, 15)
    siso.bootstrap(hist, hist, answer_ids=np.arange(len(hist)))
    return siso


def test_pipeline_converges_to_sync_refresh():
    rng = np.random.default_rng(4)
    sync = _mini_siso(np.random.default_rng(0), refresh_async=False)
    inc = _mini_siso(np.random.default_rng(0), refresh_async=True)
    for v in _unit(rng, 40):
        sync.record_llm_answer(v, v)
        inc.record_llm_answer(v, v)
    stats_sync = sync.refresh()
    stats_inc, ticks = None, 0
    while stats_inc is None and ticks < 10_000:
        stats_inc = inc.refresh_tick(budget_s=0.0)
        ticks += 1
    assert ticks > 3
    assert (stats_sync.merged, stats_sync.added, stats_sync.evicted) \
        == (stats_inc.merged, stats_inc.added, stats_inc.evicted)
    np.testing.assert_array_equal(sync.cache.centroids.vectors,
                                  inc.cache.centroids.vectors)
    np.testing.assert_array_equal(sync.cache.centroids.ids,
                                  inc.cache.centroids.ids)
    np.testing.assert_allclose(sync.t2h.hit_ratios, inc.t2h.hit_ratios,
                               atol=1e-9)
    assert sync.theta_r == inc.theta_r
    probe = _unit(rng, 50)
    ra = sync.cache.lookup(probe, theta_r=0.86, update_counts=False)
    rb = inc.cache.lookup(probe, theta_r=0.86, update_counts=False)
    np.testing.assert_array_equal(ra.hit, rb.hit)
    np.testing.assert_array_equal(ra.entry, rb.entry)


def test_mid_refresh_lookups_one_buffer_generation_and_spill_survives():
    rng = np.random.default_rng(5)
    siso = _mini_siso(rng, refresh_async=True)
    for v in _unit(rng, 40):
        siso.record_llm_answer(v, v)
    probe = _unit(rng, 25)
    pre = siso.cache.lookup(probe, theta_r=0.86, update_counts=False)
    gen0 = siso.cache.generation
    mid = _unit(rng, 3)
    inserted = False
    done = None
    while done is None:
        done = siso.refresh_tick(budget_s=0.0)
        if siso.pipeline.phase == "apply" and not inserted:
            for k, v in enumerate(mid):
                siso.cache.insert_spill(v, v, answer_id=500 + k)
            inserted = True
        if not siso.pipeline.active:
            break
        r = siso.cache.lookup(probe, theta_r=0.86, update_counts=False)
        if siso.pipeline.phase in ("cluster", "plan"):
            assert r.generation == gen0
            np.testing.assert_array_equal(r.entry, pre.entry)
            np.testing.assert_array_equal(r.sim, pre.sim)
        elif siso.pipeline.phase == "t2h":
            assert r.generation == gen0 + 1
    assert inserted and siso.cache.dev_swaps == 1
    res = siso.cache.lookup(mid, theta_r=0.99, update_counts=False)
    assert res.hit.all()
    assert np.array_equal(res.answer_id, [500, 501, 502])


def test_unported_planes_raise():
    """Only the sharded plane is still unported; the tiered hierarchy and
    tenant namespaces build (their parity is tests/test_torch_tiered.py and
    tests/test_torch_tenancy.py)."""
    from repro_torch.core.tenancy import TenancyConfig
    from repro_torch.core.tiered import TieredCache, TieredCacheConfig
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    for shard in (object(), ShardedCacheConfig(n_shards=2)):
        with pytest.raises(NotImplementedError, match="shard"):
            SISO(SISOConfig(shard=shard), **CPU)
    s = SISO(SISOConfig(tiered=TieredCacheConfig(host_capacity=8),
                        tenancy=TenancyConfig()), **CPU)
    assert isinstance(s.cache, TieredCache) and s.registry is not None
