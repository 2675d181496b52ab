"""Port of the semantic cache held against the JAX package: one randomized
interleaved lookup / insert_spill stream with a double-buffered refresh
commit in the middle, run through both packages for every ported backend.

Every LookupResult field must be identical except ``sim``, which is
allclose at atol 1e-5 (f32 dot products summed in another order); the
generation stamp and the mirror counters must match. Inside the port the
reference's own contract holds exactly: pallas_q8 + rescore gives the dense
backend's decisions and sims bit for bit (DESIGN.md §15).
"""
import numpy as np
import pytest
import torch

from repro.core.semantic_cache import SemanticCache as JCache
from repro.core.store import CentroidStore as JStore
from repro_torch.core.semantic_cache import SemanticCache as TCache
from repro_torch.core.store import CentroidStore as TStore

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

D, A = 48, 16
FIELDS = ("hit", "answer", "answer_id", "entry", "region", "generation")


def _unit(rng, n, d=D):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _store(cls, vecs, sizes, aid0):
    st = cls(D, A)
    st.add(vecs, vecs[:, :A], sizes, answer_id=np.arange(len(vecs)) + aid0)
    return st


def _queries(rng, pool, B):
    """Random queries, exact copies and near copies (sim ~0.97) of rows:
    every best sim sits clear of the thetas used."""
    q = _unit(rng, B)
    pick = rng.integers(0, len(pool), size=B)
    kind = rng.integers(0, 3, size=B)
    near = pool[pick] + 0.03 * _unit(rng, B)
    near /= np.linalg.norm(near, axis=1, keepdims=True)
    q[kind == 1] = pool[pick][kind == 1]
    q[kind == 2] = near[kind == 2]
    return q.astype(np.float32)


def _run_stream(cache_cls, store_cls, backend, seed, **kw):
    rng = np.random.default_rng(seed)
    cache = cache_cls(D, A, capacity=760, backend=backend, **kw)
    base = _unit(rng, 700)
    cache.set_centroids(_store(store_cls, base,
                               rng.uniform(1, 50, 700).round(), 0))
    pool = base.copy()
    out = []
    for step in range(14):
        q = _queries(rng, pool, int(rng.integers(1, 12)))
        theta = float(rng.choice([0.6, 0.95, 0.999, -1.0]))
        out.append(cache.lookup(q, theta, update_counts=theta > 0))
        for _ in range(int(rng.integers(0, 9))):      # spill + LRU evict
            v = _unit(rng, 1)[0]
            cache.insert_spill(v, v[:A], answer_id=1000 + step)
            pool = np.vstack([pool, v])
        if step == 6:                                  # shadow refresh
            new = _unit(rng, 300)
            st = _store(store_cls, new, np.arange(300, 0, -1.0), 5000)
            cache.begin_shadow(len(st))
            for s in range(0, 300, 128):
                cache.shadow_write(st.vectors[s:s + 128],
                                   st.answers[s:s + 128],
                                   st.answer_id[s:s + 128])
            cache.commit_shadow(st)
            pool = np.vstack([pool, new])
    return cache, out


@pytest.mark.parametrize("backend", ["dense", "pallas", "pallas_q8"])
def test_stream_matches_jax(backend):
    jc, jr = _run_stream(JCache, JStore, backend, 0)
    tc, tr = _run_stream(TCache, TStore, backend, 0, device="cpu")
    for step, (a, b) in enumerate(zip(jr, tr)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"{step} {f}")
        np.testing.assert_allclose(b.sim, a.sim, atol=1e-5)
    assert sum(r.hit.sum() for r in tr) > 10
    for attr in ("hits", "misses", "generation", "dev_rebuilds",
                 "dev_row_writes", "dev_swaps", "quant_fallbacks"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    assert np.array_equal(tc.spill.answer_id, jc.spill.answer_id)
    np.testing.assert_array_equal(tc.centroids.access_count,
                                  jc.centroids.access_count)
    mt, mj = tc.memory_bytes(), jc.memory_bytes()
    for key in ("rows", "centroid_bytes", "answer_bytes", "codes_bytes",
                "scales_bytes", "host_store_bytes"):
        assert mt[key] == mj[key], key


def test_quant_plane_is_bitwise_dense_in_the_port():
    qc, qr = _run_stream(TCache, TStore, "pallas_q8", 1, device="cpu")
    dc, dr = _run_stream(TCache, TStore, "dense", 1, device="cpu")
    for a, b in zip(qr, dr):
        for f in FIELDS + ("sim",):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert qc.quant_rescored > 0


def _run_q8_dim768(cache_cls, store_cls, **kw):
    """The int8 plane at the embedder's width (dim 768): batches of random
    queries, whose margin windows often hold more than rescore_k rows,
    alternate with batches of copies, which K2 + the exact rescore decide.
    Returns the cache, the results and each lookup's fallback count."""
    d, a, n = 768, 8, 1500
    rng = np.random.default_rng(3)
    cache = cache_cls(d, a, capacity=n + 100, backend="pallas_q8", **kw)
    base = _unit(rng, n, d)
    st = store_cls(d, a)
    st.add(base, base[:, :a], rng.uniform(1, 50, n).round(),
           answer_id=np.arange(n))
    cache.set_centroids(st)
    out, fallbacks = [], []
    for step in range(8):
        q = _unit(rng, 6, d)
        if step % 2:
            q = base[rng.integers(0, n, size=6)]
        f0 = cache.quant_fallbacks
        out.append(cache.lookup(q, 0.95))
        fallbacks.append(cache.quant_fallbacks - f0)
    return cache, out, fallbacks


def test_q8_fallbacks_match_jax_at_dim_768():
    jc, jr, jf = _run_q8_dim768(JCache, JStore)
    tc, tr, tf = _run_q8_dim768(TCache, TStore, device="cpu")
    assert tf == jf
    assert 0 < sum(tf) < len(tf)        # both routes were taken
    for step, (a, b) in enumerate(zip(jr, tr)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"{step} {f}")
        np.testing.assert_allclose(b.sim, a.sim, atol=1e-5)
    assert tc.quant_rescored == jc.quant_rescored


def test_state_dict_and_delta_match_jax_keys():
    jc, _ = _run_stream(JCache, JStore, "pallas_q8", 2)
    tc, _ = _run_stream(TCache, TStore, "pallas_q8", 2, device="cpu")
    js, ts = jc.state_dict(), tc.state_dict()
    assert set(ts) == set(js)
    for key in ("spill_last_use", "spill_clock", "hits", "misses",
                "generation", "dev_rebuilds", "dev_row_writes"):
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
    np.testing.assert_array_equal(ts["quant"]["codes"], js["quant"]["codes"])
    assert set(tc.state_delta()) == set(jc.state_delta())


def test_unported_backends_raise():
    """Every backend and plane is ported now (the name is kept from when
    the sharded plane raised here). A ShardedCacheConfig of two virtual
    CPU shards builds and runs the stream as
    the reference's single-device cache does (a sharded plane decides as
    one device, DESIGN.md §11; the reference's own sharded plane is held
    in tests/test_torch_sharded_cache.py, where it gets its devices). A
    shard config without a mesh factory fails at the first lookup, as in
    the reference."""
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    from repro_torch.launch.mesh import make_cache_mesh
    mesh = make_cache_mesh(2, devices=["cpu"] * 2)
    for backend in ("dense", "pallas"):
        jc, jout = _run_stream(JCache, JStore, backend, 3)
        tc, tout = _run_stream(TCache, TStore, backend, 3, device="cpu",
                               shard=ShardedCacheConfig(n_shards=2,
                                                        mesh=mesh))
        assert tc.shard is not None and tc._dev.n_shards == 2
        for jr, tr in zip(jout, tout):
            for f in ("hit", "answer", "answer_id", "entry", "region"):
                np.testing.assert_array_equal(getattr(tr, f),
                                              getattr(jr, f), err_msg=f)
            np.testing.assert_allclose(tr.sim, jr.sim, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tc._spill_last_use,
                                      jc._spill_last_use)

    class Shard:
        n_shards = 2
    for cls, store, kw in ((TCache, TStore, {"device": "cpu"}),
                           (JCache, JStore, {})):
        c = cls(D, A, 16, shard=Shard(), **kw)
        c.set_centroids(_store(store, _unit(np.random.default_rng(0), 4),
                               np.ones(4), 0))
        with pytest.raises(AttributeError, match="make_mesh"):
            c.lookup(_unit(np.random.default_rng(1), 1), 0.9)
