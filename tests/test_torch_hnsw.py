"""Port of the ``hnsw`` backend held against the JAX package: the
locality-ordered HNSW itself (``core/hnsw.py``) and the semantic cache's
graph path (lazy build from centroids + spill, generation stamps, the
stale-index guard, the hnsw-with-shard rejection), ports of
tests/test_core_cache.py's hnsw cases. Top-1 rows must be identical and
sims allclose at 1e-6.
"""
import numpy as np
import pytest
import torch

from repro.core.hnsw import HNSW as JHNSW
from repro.core.semantic_cache import SemanticCache as JCache
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro.core.store import CentroidStore as JStore
from repro.data.synth import SyntheticWorkload as JWorkload
from repro_torch.core.hnsw import HNSW
from repro_torch.core.semantic_cache import SemanticCache as TCache
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.core.store import CentroidStore as TStore
from repro_torch.data.synth import SyntheticWorkload

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

D = 16
FIELDS = ("hit", "answer", "answer_id", "entry", "region", "generation")


def _unit(rng, n, d=D):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _store(cls, vectors, sizes, d=D):
    st = cls(d, d)
    st.add(vectors, vectors, sizes, answer_id=np.arange(len(vectors)))
    return st


def _caches():
    return (JCache(D, D, capacity=64, backend="hnsw"),
            TCache(D, D, capacity=64, backend="hnsw", device="cpu"))


def _assert_same(a, b, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f"{what} {f}")
    np.testing.assert_allclose(b.sim, a.sim, atol=1e-6, err_msg=what)


def test_hnsw_lookup_hit_iff_above_theta_matches_jax():
    rng = np.random.default_rng(0)
    vecs = _unit(rng, 8)
    far = -vecs[:3]
    out = []
    for cache, store_cls in zip(_caches(), (JStore, TStore)):
        cache.set_centroids(_store(store_cls, vecs, np.arange(8) + 1.0))
        out.append([cache.lookup(vecs, theta_r=0.99),
                    cache.lookup(far, theta_r=0.5),
                    cache.lookup(far, theta_r=0.999)])
    for step, (a, b) in enumerate(zip(*out)):
        _assert_same(a, b, f"lookup {step}")
    exact, far_half, far_strict = out[1]
    assert exact.hit.all()
    np.testing.assert_array_equal(far_half.hit, far_half.sim >= 0.5)
    assert (far_half.answer_id[~far_half.hit] == -1).all()
    assert not far_strict.hit.any()


def test_hnsw_fallback_stamps_fresh_generation():
    rng = np.random.default_rng(1)
    vecs, vecs2 = _unit(rng, 8), _unit(rng, 8)
    v = _unit(rng, 1)[0]
    gens = []
    for cache, store_cls in zip(_caches(), (JStore, TStore)):
        cache.set_centroids(_store(store_cls, vecs, np.arange(8) + 1.0))
        g1 = cache.lookup(vecs[:2], theta_r=0.9).generation
        assert g1 == cache.generation > 0       # stamped, not the -1 default
        cache.set_centroids(_store(store_cls, vecs2, np.arange(8) + 1.0))
        g2 = cache.lookup(vecs[:2], theta_r=0.9).generation
        cache.insert_spill(v, v, answer_id=7)
        r3 = cache.lookup(v[None], theta_r=0.9)
        assert g1 < g2 < r3.generation and r3.hit[0]
        gens.append((g1, g2, r3.generation, int(r3.entry[0])))
    assert gens[0] == gens[1]


def test_hnsw_generation_guard_catches_stale_index():
    rng = np.random.default_rng(2)
    vecs = _unit(rng, 8)
    for cache, store_cls in zip(_caches(), (JStore, TStore)):
        cache.set_centroids(_store(store_cls, vecs, np.arange(8) + 1.0))
        cache.lookup(vecs[:1], theta_r=0.9)     # builds the index
        cache.generation += 1                   # simulate an unseen swap
        with pytest.raises(RuntimeError, match="stale"):
            cache.lookup(vecs[:1], theta_r=0.9)


def test_hnsw_graph_invalidated_by_shadow_commit():
    """A double-buffered refresh commit swaps the serving state: the graph
    is rebuilt from the new rows, at the commit's generation."""
    rng = np.random.default_rng(3)
    vecs, new = _unit(rng, 12), _unit(rng, 10)
    out = []
    for cache, store_cls in zip(_caches(), (JStore, TStore)):
        cache.set_centroids(_store(store_cls, vecs, np.arange(12) + 1.0))
        r1 = cache.lookup(new, theta_r=0.99)
        st = _store(store_cls, new, np.arange(10, 0, -1.0))
        cache.begin_shadow(len(st))
        cache.shadow_write(st.vectors, st.answers, st.answer_id)
        cache.commit_shadow(st)
        r2 = cache.lookup(new, theta_r=0.99)
        assert not r1.hit.any() and r2.hit.all()
        assert r2.generation == cache.generation > r1.generation
        out.append((r1, r2))
    for a, b in zip(*out):
        _assert_same(a, b)


def test_hnsw_rejects_a_sharded_plane():
    class Shard:
        n_shards = 2

    for cls, kw in ((JCache, {}), (TCache, {"device": "cpu"})):
        with pytest.raises(ValueError, match="hnsw is host-graph"):
            cls(D, D, 16, backend="hnsw", shard=Shard(), **kw)
        # serving-time guard: a plane set after construction
        cache = cls(D, D, 16, backend="hnsw", **kw)
        cache.insert_spill(np.ones(D, np.float32) / 4.0,
                           np.ones(D, np.float32), answer_id=1)
        cache.shard = Shard()
        with pytest.raises(ValueError, match="hnsw is host-graph"):
            cache.lookup(np.ones((1, D), np.float32) / 4.0, theta_r=0.9)


def test_hnsw_top1_recall_matches_jax():
    rng = np.random.default_rng(0)
    emb = _unit(rng, 400, 32)
    size = rng.integers(1, 100, size=400).astype(np.float64)
    queries = _unit(rng, 50, 32)
    j, t = JHNSW.build(emb, locality=size), HNSW.build(emb, locality=size)
    np.testing.assert_array_equal(t.levels, j.levels)
    assert t.entry == j.entry and t.neighbors == j.neighbors
    agree = 0
    for q in queries:
        rj, rt = j.search(q, k=1), t.search(q, k=1)
        assert [i for i, _ in rt] == [i for i, _ in rj]
        np.testing.assert_allclose([s for _, s in rt], [s for _, s in rj],
                                   atol=1e-6)
        agree += int(rt and rt[0][0] == int(np.argmax(emb @ q)))
    assert agree >= 48      # >=96% top-1 recall
    sj, ij = j.search_batch(queries)
    st, it = t.search_batch(queries)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=1e-6)


def _siso_stream(siso_cls, cfg_cls, wl_cls, **kw):
    """A short SISO stream on the graph backend: bootstrap, batched lookups
    with repeat escapes, misses recorded as spill rows, sync refreshes."""
    wl = wl_cls("quora", dim=D, n_clusters=80, seed=2)
    hist = wl.sample(300, rps=100.0)
    siso = siso_cls(cfg_cls(dim=D, answer_dim=D, capacity=128,
                            backend="hnsw", dynamic_threshold=False,
                            refresh_async=False), **kw)
    siso.bootstrap(hist.vectors, hist.answers, answer_ids=np.arange(300))
    test = wl.sample(96, rps=20.0)
    out = []
    for s in range(0, 96, 8):
        r = siso.handle_batch(test.vectors[s:s + 8],
                              now=float(test.arrivals[s]),
                              user_ids=test.user_ids[s:s + 8])
        out.append(r)
        for j in np.flatnonzero(~r.hit):
            siso.record_llm_answer(test.vectors[s + j], test.answers[s + j],
                                   answer_id=s + j)
        if siso.needs_refresh():
            siso.refresh()
    return siso, out


def test_siso_stream_on_hnsw_matches_jax():
    js, jr = _siso_stream(JSISO, JConfig, JWorkload)
    ts, tr = _siso_stream(SISO, SISOConfig, SyntheticWorkload,
                          device="cpu")
    for step, (a, b) in enumerate(zip(jr, tr)):
        _assert_same(a, b, f"batch {step}")
    hits = np.concatenate([r.hit for r in tr])
    assert 0.3 < hits.mean() < 1.0
    assert ts.refreshes_completed == js.refreshes_completed >= 1
    assert ts.cache.generation == js.cache.generation
