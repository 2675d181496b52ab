"""The port's sharded cache plane (DESIGN.md §11) held against the
reference's.

The reference plane needs a device per shard, and the xdist worker has
already started jax with one, so the reference side runs once per file in a
subprocess with ``--xla_force_host_platform_device_count=8`` (its
``pallas`` backend in interpret mode there): the module fixture runs every
scenario below through the reference package and writes its arrays to one
``.npz`` each. The port runs the same scenario functions in this process on
S virtual CPU shards (``make_cache_mesh(S, devices=[cpu] * S)``), where
every wrapper runs its kernel's plain version.

Decisions are identical (hit, answer, answer_id, entry, region, the LRU
clocks, counters, generations, layouts, byte counts); sims agree within
atol 1e-6: the reference's own 8-shard sims differ from its 1-device sims
by about one ulp (XLA's contraction order inside ``shard_map``).
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SIM_ATOL = 1e-6
D, A = 32, 16
FIELDS = ("hit", "sim", "answer", "answer_id", "entry", "region")

torch.set_num_threads(2)


# ------------------------------------------------------------ the packages


def _pkg(kind: str) -> SimpleNamespace:
    """The names a scenario uses, from the reference (``ref``) or the port
    (``port``, on virtual CPU shards)."""
    if kind == "ref":
        from repro.checkpoint import CheckpointManager
        from repro.core.semantic_cache import SemanticCache
        from repro.core.siso import SISO
        from repro.core.store import CentroidStore
        from repro.core.tiered import TieredCacheConfig
        from repro.distributed.cache_plane import ShardedCacheConfig
        from repro.serving.config import CacheConfig, ServingConfig
        from repro.serving.gateway import GatewayRequest, ServingGateway

        def shard(S):
            return ShardedCacheConfig(n_shards=S) if S > 1 else None
        kw = {}
    else:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.core.semantic_cache import SemanticCache
        from repro_torch.core.siso import SISO
        from repro_torch.core.store import CentroidStore
        from repro_torch.core.tiered import TieredCacheConfig
        from repro_torch.distributed.cache_plane import ShardedCacheConfig
        from repro_torch.launch.mesh import make_cache_mesh
        from repro_torch.serving.config import CacheConfig, ServingConfig
        from repro_torch.serving.gateway import GatewayRequest, ServingGateway

        def shard(S):
            return ShardedCacheConfig(n_shards=S, mesh=make_cache_mesh(
                S, devices=["cpu"] * S)) if S > 1 else None
        kw = {"device": "cpu"}
    return SimpleNamespace(
        kind=kind, CheckpointManager=CheckpointManager,
        SemanticCache=SemanticCache, SISO=SISO, CentroidStore=CentroidStore,
        TieredCacheConfig=TieredCacheConfig, CacheConfig=CacheConfig,
        ServingConfig=ServingConfig, GatewayRequest=GatewayRequest,
        ServingGateway=ServingGateway, shard=shard, kw=kw)


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _unit(rng, n, d=D):
    return _norm(rng.normal(size=(n, d)).astype(np.float32))


def _cache(P, S, capacity, backend="dense"):
    return P.SemanticCache(D, A, capacity=capacity, backend=backend,
                           shard=P.shard(S), **P.kw)


def _fill(P, cache, vecs, ans, aid0=0):
    st = P.CentroidStore(D, A)
    st.add(vecs, ans, np.arange(len(vecs), 0, -1, dtype=np.float64),
           answer_id=np.arange(len(vecs)) + aid0)
    cache.set_centroids(st)


def _put(out: dict, key: str, res) -> None:
    for f in FIELDS:
        out[f"{key}/{f}"] = np.asarray(getattr(res, f))
    out[f"{key}/generation"] = np.asarray(res.generation)


def _state(out: dict, key: str, c) -> None:
    out[f"{key}/spill_vectors"] = c.spill.vectors
    out[f"{key}/spill_ids"] = c.spill.answer_id
    out[f"{key}/spill_last_use"] = c._spill_last_use
    out[f"{key}/counters"] = np.asarray(
        [c.hits, c.misses, c.dev_rebuilds, c.dev_row_writes, c.dev_swaps,
         c.generation, c.quant_fallbacks, c.quant_rescored])
    lay = c.layout_dict()
    out[f"{key}/layout"] = np.asarray([int(lay[k]) for k in
                                       ("n_shards", "rows", "pad")])
    mem = c.memory_bytes()
    out[f"{key}/memory"] = np.asarray(
        [mem[k] for k in ("centroid_bytes", "answer_bytes", "codes_bytes",
                          "scales_bytes", "meta_bytes", "per_shard_bytes")])


# -------------------------------------------------------------- scenarios


def sc_equiv(P, backend: str, S: int) -> dict:
    """Interleaved lookups (hits and misses) and spill inserts past the
    capacity (LRU victims overwritten in place)."""
    rng = np.random.default_rng(0)
    vecs = _unit(rng, 100)
    ans = rng.normal(size=(100, A)).astype(np.float32)
    c = _cache(P, S, 130, backend)              # spill cap 30 -> victims
    _fill(P, c, vecs, ans)
    pool = _unit(rng, 80)
    out = {}
    for step in range(24):
        B = int(rng.integers(1, 17))
        q = _unit(rng, B)
        if step % 3 == 0:
            q[0] = vecs[int(rng.integers(0, 100))]      # centroid hit
        if step % 5 == 0 and len(c.spill):
            q[-1] = c.spill.vectors[int(rng.integers(0, len(c.spill)))]
        theta = float(rng.uniform(0.5, 0.99))
        _put(out, f"l{step}", c.lookup(q, theta))
        for _ in range(int(rng.integers(0, 4))):       # grow past capacity
            j = int(rng.integers(0, len(pool)))
            c.insert_spill(pool[j], rng.normal(size=(A,)).astype(np.float32),
                           1000 + j)
    _state(out, "end", c)
    return out


def sc_shadow(P, backend: str, S: int) -> dict:
    """A double-buffered refresh: lookups while the shadow is staged serve
    the old generation; spill rows inserted meanwhile outgrow the staged
    headroom (at S=2 the per-shard pad regrows at the commit) and survive
    the swap; lookups after it serve the new region."""
    rng = np.random.default_rng(1)
    vecs = _unit(rng, 90)
    c = _cache(P, S, 160, backend)
    _fill(P, c, vecs, rng.normal(size=(90, A)).astype(np.float32))
    for j in range(2):
        v = _unit(rng, 1)[0]
        c.insert_spill(v, v[:A].copy(), 2000 + j)
    q0 = _unit(rng, 4)
    out = {}
    _put(out, "before", c.lookup(q0, 0.9))
    new = _unit(rng, 120)
    st = P.CentroidStore(D, A)
    st.add(new, rng.normal(size=(120, A)).astype(np.float32),
           np.arange(120, 0, -1, dtype=np.float64),
           answer_id=np.arange(120) + 5000)
    c.begin_shadow(len(st))
    for s in range(0, 120, 32):
        c.shadow_write(st.vectors[s:s + 32], st.answers[s:s + 32],
                       st.answer_id[s:s + 32])
        _put(out, f"mid{s}", c.lookup(q0, 0.9, update_counts=False))
        for _ in range(8):                      # outgrow the headroom
            v = _unit(rng, 1)[0]
            c.insert_spill(v, v[:A].copy(), 3000 + s)
    c.commit_shadow(st)
    for step in range(8):
        q = _unit(rng, 8)
        q[0] = new[step * 11 % 120]
        if step % 2 and len(c.spill):
            q[1] = c.spill.vectors[step % len(c.spill)]
        _put(out, f"after{step}", c.lookup(q, 0.85))
    _state(out, "end", c)
    return out


def sc_q8(P, S: int) -> dict:
    """The int8 plane: K2's candidates per shard, the shared exact rescore,
    spill writes and a shadow commit."""
    rng = np.random.default_rng(2)
    vecs = _unit(rng, 80)
    c = _cache(P, S, 120, "pallas_q8")
    _fill(P, c, vecs, rng.normal(size=(80, A)).astype(np.float32))
    out = {}
    for step in range(14):
        B = int(rng.integers(1, 13))
        q = _unit(rng, B)
        if step % 2 == 0:
            q[0] = vecs[int(rng.integers(0, len(vecs)))]
        theta = float(rng.uniform(0.5, 0.99))
        _put(out, f"l{step}", c.lookup(q, theta))
        if step % 3 == 1:
            v = _unit(rng, 1)[0]
            c.insert_spill(v, rng.normal(size=(A,)).astype(np.float32),
                           3000 + step)
        if step == 7:
            new = _unit(rng, 60)
            st = P.CentroidStore(D, A)
            st.add(new, new[:, :A], np.arange(60, 0, -1, dtype=np.float64),
                   answer_id=np.arange(60) + 7000)
            c.begin_shadow(len(st))
            c.shadow_write(st.vectors, st.answers, st.answer_id)
            c.commit_shadow(st)
            vecs = new
    _state(out, "end", c)
    return out


def sc_siso(P, backend: str, S: int) -> dict:
    """SISO through ServingConfig/from_config: bootstrap, record misses,
    the incremental refresh ticked to its end while a probe batch is looked
    up between ticks (each sees one generation), then a lookup after."""
    rng = np.random.default_rng(3)
    cfg = P.ServingConfig(
        cache=P.CacheConfig(dim=D, answer_dim=A, capacity=128,
                            dynamic_threshold=False, theta_r=0.86,
                            backend=backend),
        sharding=P.shard(S))
    cfg.refresh.min = 24
    s = P.SISO.from_config(cfg, **P.kw)
    base = _unit(rng, 50)                       # 50 topics, 4 paraphrases
    hist = _norm(base[np.arange(200) % 50] + 0.02 * _unit(rng, 200))
    s.bootstrap(hist, hist[:, :A], answer_ids=np.arange(200))
    for v in _unit(rng, 40):
        s.record_llm_answer(v, v[:A], -1)
    assert s.needs_refresh()
    qs = _unit(rng, 6)
    qs[:3] = base[[7, 8, 9]]
    gens, guard = [], 0
    while s.refresh_tick(budget_s=0.0) is None and guard < 10_000:
        gens.append(s.cache.lookup(qs, s.theta_r,
                                   update_counts=False).generation)
        guard += 1
    out = {"gens": np.asarray(gens),
           "shards": np.asarray(s.stats()["cache_shards"]),
           "centroids": s.cache.centroids.vectors}
    _put(out, "post", s.cache.lookup(qs, 0.86))
    _put(out, "batch", s.handle_batch(np.concatenate([base[:3], qs])))
    _state(out, "end", s.cache)
    return out


def sc_restore(P, S: int) -> dict:
    """A snapshot of an S-shard cache through the CheckpointManager,
    restored onto S, another S and one device: each serves like the
    uninterrupted cache."""
    rng = np.random.default_rng(4)
    c1 = _cache(P, S, 64)
    vecs = _unit(rng, 48)
    _fill(P, c1, vecs, vecs[:, :A])
    for t in range(20):
        q = _unit(rng, 3)
        c1.lookup(q, 0.8)
        c1.insert_spill(q[0], q[0][:A], answer_id=100 + t)
    state = c1.state_dict()
    out = {"layout": np.asarray([int(state["layout"][k])
                                 for k in ("n_shards", "rows", "pad")])}
    with tempfile.TemporaryDirectory() as d:
        P.CheckpointManager(d, keep=1).save(1, {"cache": state})
        _, rec = P.CheckpointManager(d, keep=1).restore_latest()
    others = {}
    for name, S2 in (("same", S), ("other", 2 if S != 2 else 8), ("one", 1)):
        c = _cache(P, S2, 64)
        c.load_state(rec["cache"])
        c.rebuild_mirror()
        others[name] = c
    for t in range(12):
        q = _unit(rng, 4)
        q[0] = c1.spill.vectors[t % len(c1.spill)]
        _put(out, f"run{t}", c1.lookup(q, 0.8))
        for name, c in others.items():
            _put(out, f"{name}{t}", c.lookup(q, 0.8))
        for c in (c1, *others.values()):
            c.insert_spill(q[2], q[2][:A], answer_id=300 + t)
    for name, c in (("run", c1), *others.items()):
        _state(out, f"end_{name}", c)
    return out


def sc_gateway(P, S: int) -> dict:
    """ServingGateway.from_config with sharding over a model-free engine:
    served-by per request and the plane's report."""
    rng = np.random.default_rng(5)
    cfg = P.ServingConfig(
        cache=P.CacheConfig(dim=D, answer_dim=D, capacity=96,
                            dynamic_threshold=False, theta_r=0.9,
                            backend="dense"),
        sharding=P.shard(S))
    gw = P.ServingGateway.from_config(
        cfg, engine=_Engine(), embed_fn=lambda vs: np.stack(vs),
        answer_fn=lambda toks: _norm(np.ones(D, np.float32)),
        clock=_Clock())
    train = _unit(rng, 64)
    gw.frontend.bootstrap(train, train, answer_ids=np.arange(64))
    out = {}
    reqs, rid = [], 0
    for b in range(6):
        batch = []
        for _ in range(4):
            v = train[int(rng.integers(0, 64))] if rng.random() < 0.5 \
                else _unit(rng, 1)[0]
            batch.append(P.GatewayRequest(
                rid=rid, model_tokens=np.arange(3), embed_tokens=v,
                max_new=2))
            rid += 1
        gw.submit(batch)
        reqs += batch
    done = sorted(gw.drain(), key=lambda r: r.rid)
    out["served_by"] = np.asarray([r.served_by == "cache" for r in done])
    rep = gw.report()
    out["report"] = np.asarray(
        [rep["completed"], rep["served_cache"], rep["hits"], rep["misses"],
         rep.get("cache_shards", 1), rep.get("cache_rows_per_shard", 0),
         rep["memory"]["per_shard_bytes"], rep["memory"]["n_shards"]])
    return out


def sc_tiered(P, S: int) -> dict:
    """The device tier sharded under the tiered hierarchy: evictions demote
    to the host tier, whose hits promote back."""
    rng = np.random.default_rng(6)
    cfg = P.ServingConfig(
        cache=P.CacheConfig(dim=D, answer_dim=A, capacity=48,
                            dynamic_threshold=False, theta_r=0.9),
        tiering=P.TieredCacheConfig(host_capacity=64),
        sharding=P.shard(S))
    s = P.SISO.from_config(cfg, **P.kw)
    hist = _unit(rng, 40)
    s.bootstrap(hist, hist[:, :A], answer_ids=np.arange(40))
    out = {}
    for step in range(10):
        q = _unit(rng, 6)
        q[0] = hist[step * 3 % 40]
        res = s.handle_batch(q)
        _put(out, f"l{step}", res)
        for v in q[1:3]:
            s.record_llm_answer(v, v[:A], 900 + step)
    st = s.stats()
    tiers = st["tiers"]
    out["tiers"] = np.asarray(
        [st["cache_shards"], st["n_spill"]]
        + [v for _, v in sorted(tiers.items()) if np.isscalar(v)]
        + [v for _, v in sorted(tiers["tier_hits"].items())], np.float64)
    return out


def sc_topk(P, S: int) -> dict:
    """sharded_topk over S contiguous blocks, ties across blocks."""
    rng = np.random.default_rng(7)
    c = _unit(rng, 64)
    c[40] = c[3]                                # a tie across blocks
    q = _unit(rng, 5)
    q[0] = c[3]
    if P.kind == "ref":
        import jax
        from jax.sharding import Mesh
        from repro.distributed.collectives import sharded_topk
        mesh = Mesh(np.asarray(jax.devices()[:S]), ("model",))
        v, i = sharded_topk(q, c, 4, mesh)
    else:
        from repro_torch.distributed.collectives import sharded_topk
        from repro_torch.launch.mesh import make_cache_mesh
        v, i = sharded_topk(torch.from_numpy(q), torch.from_numpy(c), 4,
                            make_cache_mesh(S, devices=["cpu"] * S))
    return {"sim": np.asarray(v), "idx": np.asarray(i)}


def _cross_inputs(S: int):
    """Hand-built shard candidates: ties at the max on several shards,
    empty shards (-inf, row clamped to 0) and a query no shard can
    answer."""
    B, pad = 6, 4
    rng = np.random.default_rng(8)
    best = rng.uniform(0.1, 0.8, size=(B, S)).astype(np.float32)
    local = rng.integers(0, pad, size=(B, S)).astype(np.int32)
    best[0, :] = 0.95                               # every shard tied
    best[1, :2] = 0.97                              # two shards tied:
    local[1, 0], local[1, 1] = 3, 0                 # host rows 3S, 1
    best[2, :] = -np.inf                            # no shard answers
    local[2, :] = 0
    best[3, ::2] = -np.inf                          # empty shards
    local[3, ::2] = 0
    host = local * S + np.arange(S, dtype=np.int32)
    ans = rng.normal(size=(S, pad, 3)).astype(np.float32)
    aid = (100 * np.arange(S)[:, None] + np.arange(pad)).astype(np.int32)
    return best, host, ans, aid


def sc_cross(P, S: int) -> dict:
    best, host, ans, aid = _cross_inputs(S)
    out = {}
    for t, theta in enumerate((0.9, -np.inf)):
        if P.kind == "ref":
            import jax
            from jax.sharding import PartitionSpec as Pspec
            from repro.compat import shard_map
            from repro.distributed.collectives import cross_shard_top1
            from repro.launch.mesh import make_cache_mesh
            fn = jax.jit(shard_map(
                lambda b, r, a, ai: cross_shard_top1(b[:, 0], r[:, 0], a,
                                                     ai, theta),
                mesh=make_cache_mesh(S),
                in_specs=(Pspec(None, "cache"), Pspec(None, "cache"),
                          Pspec("cache", None), Pspec("cache")),
                out_specs=(Pspec(),) * 5))
            res = fn(best, host, ans.reshape(-1, 3), aid.reshape(-1))
        else:
            from repro_torch.distributed.collectives import cross_shard_top1
            res = cross_shard_top1(
                [torch.from_numpy(best[:, s]) for s in range(S)],
                [torch.from_numpy(host[:, s]) for s in range(S)],
                [torch.from_numpy(ans[s]) for s in range(S)],
                [torch.from_numpy(aid[s]) for s in range(S)], theta)
        for name, x in zip(("hit", "sim", "row", "answer", "answer_id"),
                           res):
            out[f"{t}/{name}"] = np.asarray(x)
    return out


NAN_ROW = 3


def sc_nan(P, backend: str, S: int) -> dict:
    """A NaN query row among ordinary ones (a centroid repeat, fresh
    misses): the NaN row is a miss, as the reference's argmin over the
    gathered candidates makes it; the same batch without that row is looked
    up after it for the rest's decisions alone."""
    rng = np.random.default_rng(9)
    vecs = _unit(rng, 60)
    c = _cache(P, S, 80, backend)
    _fill(P, c, vecs, rng.normal(size=(60, A)).astype(np.float32))
    q = _unit(rng, 5)
    q[1] = vecs[7]
    q[NAN_ROW] = np.nan
    out = {}
    _put(out, "nan", c.lookup(q, 0.9))
    _put(out, "rest", c.lookup(np.delete(q, NAN_ROW, axis=0), 0.9))
    _state(out, "end", c)
    return out


SCENARIOS = {
    **{f"equiv_{b}_{S}": (sc_equiv, (b, S))
       for b in ("dense", "pallas") for S in (2, 8)},
    **{f"shadow_{b}_{S}": (sc_shadow, (b, S))
       for b in ("dense", "pallas") for S in (2, 8)},
    **{f"q8_{S}": (sc_q8, (S,)) for S in (2, 8)},
    **{f"siso_{b}": (sc_siso, (b, 8)) for b in ("dense", "pallas")},
    "restore_8": (sc_restore, (8,)),
    "gateway_4": (sc_gateway, (4,)),
    "tiered_2": (sc_tiered, (2,)),
    "topk_8": (sc_topk, (8,)),
    **{f"cross_{S}": (sc_cross, (S,)) for S in (2, 8)},
    **{f"nan_{b}_2": (sc_nan, (b, 2)) for b in ("dense", "pallas")},
}


class _Engine:
    """A model-free engine: every request decodes max_new tokens."""

    def __init__(self, n_slots=2, max_len=64):
        self.n_slots, self.max_len = n_slots, max_len
        self.pos = np.zeros(n_slots, np.int64)
        self._free = set(range(n_slots))
        self.device = "cpu"

    def free_slots(self):
        return sorted(self._free)

    def prefill_into(self, slot, tokens):
        self._free.discard(slot)
        self.pos[slot] = len(tokens)
        return 1

    def decode_active(self, tokens):
        self.pos += 1
        return np.full(self.n_slots, 2, np.int64)

    def release(self, slot):
        self._free.add(slot)
        self.pos[slot] = 0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01
        return self.t


def reference_main(out_dir: str) -> None:
    """Run every scenario through the reference (in the subprocess)."""
    P = _pkg("ref")
    for name, (fn, args) in SCENARIOS.items():
        np.savez(os.path.join(out_dir, f"{name}.npz"), **fn(P, *args))


_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_sharded_cache as T
T.reference_main(sys.argv[2])
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT / "tests"),
                          str(out)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0 and "REF_OK" in res.stdout, res.stderr[-4000:]
    return lambda name: dict(np.load(out / f"{name}.npz"))


def _port(name: str) -> dict:
    fn, args = SCENARIOS[name]
    return fn(_pkg("port"), *args)


def _assert_same(port: dict, ref: dict, ctx: str = "") -> None:
    """Every array equal, sims (keys ending in ``sim``) within SIM_ATOL."""
    assert set(port) == set(ref), (ctx, set(port) ^ set(ref))
    for k in sorted(ref):
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (ctx, k, a.shape, b.shape)
        if k.endswith("sim"):
            assert np.array_equal(np.isfinite(a), np.isfinite(b)), (ctx, k)
            fin = np.isfinite(b)
            assert np.array_equal(a[~fin], b[~fin], equal_nan=True), \
                (ctx, k)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                       atol=SIM_ATOL, err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {k}")


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(reference, name):
    """Each scenario through both packages: identical decisions, LRU
    state, counters, generations, layouts and byte counts; sims within
    atol 1e-6."""
    _assert_same(_port(name), reference(name), name)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_nan_query_is_a_miss_beside_the_reference(reference, backend):
    """A NaN query row through a 2-shard cache is a miss (hit False, sim
    NaN, answer zero, answer id -1), as in the reference, where the
    merge's argmin falls back to shard 0's candidate; the other rows decide
    as the same batch without it does. The winning row is an index into
    the gathered candidates, not a key: a NaN max once made it INT32_MAX
    and the answer gather raised."""
    name = f"nan_{backend}_2"
    port = _port(name)
    _assert_same(port, reference(name), name)
    assert not port["nan/hit"][NAN_ROW]
    assert np.isnan(port["nan/sim"][NAN_ROW])
    assert port["nan/answer_id"][NAN_ROW] == -1
    assert not port["nan/answer"][NAN_ROW].any()
    assert port["nan/hit"][1], "the centroid repeat must hit"
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.delete(port[f"nan/{f}"], NAN_ROW, axis=0), port[f"rest/{f}"],
            err_msg=f)


def test_shadow_regrows_the_staged_pad_at_two_shards():
    """The S=2 shadow scenario outgrows its staged per-shard pad, so the
    commit takes the regrow path (the reference's too, as the layouts
    compared above are equal)."""
    out = _port("shadow_dense_2")
    n_shards, rows, pad = out["end/layout"]
    assert n_shards == 2 and pad == 128 and rows == 256


def test_owner_mapping_and_shard_pad_match_reference():
    from repro.distributed import cache_plane as J
    from repro_torch.distributed import cache_plane as T
    rows = np.arange(1000)
    for S in (1, 2, 4, 8):
        s, l = T.owner_shard(rows, S), T.shard_local_row(rows, S)
        np.testing.assert_array_equal(l * S + s, rows)
        np.testing.assert_array_equal(s, J.owner_shard(rows, S))
        np.testing.assert_array_equal(l, J.shard_local_row(rows, S))
        for n in (0, 1, 31, 100, 257, 36114):
            for floor in (4, 32, 128):
                assert T.shard_pad(n, S, floor) == J.shard_pad(n, S, floor)
    assert T.SHARD_PAD_FLOOR == J.SHARD_PAD_FLOOR
    assert T.shard_pad(100, 8, floor=4) == 16


def test_one_shard_degrades_to_the_single_device_path():
    from repro.core.semantic_cache import SemanticCache as JCache
    from repro.core.store import CentroidStore as JStore
    from repro.distributed.cache_plane import ShardedCacheConfig as JShard
    from repro_torch.core.semantic_cache import SemanticCache, _DeviceState
    from repro_torch.core.store import CentroidStore
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    vecs = _unit(np.random.default_rng(0), 20, 16)
    plain = SemanticCache(16, 16, capacity=32, device="cpu")
    one = SemanticCache(16, 16, capacity=32, device="cpu",
                        shard=ShardedCacheConfig(n_shards=1))
    jone = JCache(16, 16, capacity=32, shard=JShard(n_shards=1))
    assert one.shard is None and jone.shard is None
    for c, st in ((plain, CentroidStore), (one, CentroidStore),
                  (jone, JStore)):
        s = st(16, 16)
        s.add(vecs, vecs, np.ones(len(vecs)))
        c.set_centroids(s)
    q = vecs[:5] + 0.0
    r1, r2, rj = (c.lookup(q, 0.9) for c in (plain, one, jone))
    assert isinstance(one._dev, _DeviceState)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    _assert_same({f: getattr(r2, f) for f in FIELDS},
                 {f: getattr(rj, f) for f in FIELDS})
    assert r1.generation == r2.generation == rj.generation
    assert int(one.layout_dict()["n_shards"]) == 1


def test_hnsw_rejected_at_construction_and_serving_time():
    from repro.core.semantic_cache import SemanticCache as JCache
    from repro.distributed.cache_plane import ShardedCacheConfig as JShard
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    with pytest.raises(ValueError, match="hnsw"):
        SemanticCache(16, 16, capacity=32, backend="hnsw", device="cpu",
                      shard=ShardedCacheConfig(n_shards=2))
    with pytest.raises(ValueError, match="hnsw"):
        JCache(16, 16, capacity=32, backend="hnsw",
               shard=JShard(n_shards=2))
    P = _pkg("port")
    for pkg, shard in ((P, P.shard(2)),
                       (_pkg("ref"), JShard(n_shards=2))):
        c = pkg.SemanticCache(16, 16, capacity=32, backend="hnsw", **pkg.kw)
        st = pkg.CentroidStore(16, 16)
        v = _unit(np.random.default_rng(1), 8, 16)
        st.add(v, v, np.ones(8))
        c.set_centroids(st)
        c.shard = shard                 # mutated after construction
        with pytest.raises(ValueError, match="hnsw"):
            c.lookup(v[:2], 0.9)


@pytest.mark.parametrize("shape", [(3, 32, 32), (4, 33, 32), (5, 600, 48),
                                   (1, 1100, 16)])
def test_cosine_top1_local_matches_reference(shape):
    """K1's shard-local mode against the reference's (interpret mode): the
    best sim and local row, an all-invalid block reporting -inf at row 0,
    blocks shorter than one 512-row tile and longer than two."""
    from repro.kernels.cosine_topk.ops import cosine_top1_local as jlocal
    from repro_torch.kernels.cosine_topk import ops, ref
    B, N, d = shape
    rng = np.random.default_rng(N)
    rows = _unit(rng, N, d)
    q = _unit(rng, B, d)
    q[0] = rows[N - 1]
    before = ops.cosine_top1_local.launches
    for valid in (rng.random(N) > 0.3, np.zeros(N, bool)):
        jb, jl = jlocal(q, rows, valid, interpret=True)
        tb, tl = ops.cosine_top1_local(torch.from_numpy(q),
                                       torch.from_numpy(rows),
                                       torch.from_numpy(valid))
        pb, pl = ref.cosine_top1_local_ref(torch.from_numpy(q),
                                           torch.from_numpy(rows),
                                           torch.from_numpy(valid))
        assert tl.dtype == torch.int32 and tb.dtype == torch.float32
        assert torch.equal(tb, pb) and torch.equal(tl, pl)
        _assert_same({"sim": tb.numpy(), "row": tl.numpy()},
                     {"sim": np.asarray(jb), "row": np.asarray(jl)})
        if not valid.any():
            assert np.isneginf(tb.numpy()).all() and (tl.numpy() == 0).all()
    assert ops.cosine_top1_local.launches == before     # plain version here


# ------------------------------------------------------------ port only


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("S", [2, 8])
def test_sharded_decides_as_unsharded_in_the_port(backend, S):
    """Inside the port, S shards decide as one device: every field but the
    generation (the planes regrow at different row counts) is equal, sims
    within SIM_ATOL."""
    P = _pkg("port")
    sharded = sc_equiv(P, backend, S)
    single = sc_equiv(P, backend, 1)
    keep = [k for k in single if k.split("/")[1] in FIELDS
            or k in ("end/spill_vectors", "end/spill_ids",
                     "end/spill_last_use")]
    _assert_same({k: sharded[k] for k in keep}, {k: single[k] for k in keep})


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_q8_is_bitwise_dense(S):
    """DESIGN.md §15 on the sharded int8 plane: q8 + the exact rescore
    decides as the dense f32 cache, sims bit for bit."""
    P = _pkg("port")
    rng = np.random.default_rng(9)
    vecs = _unit(rng, 80)
    ans = rng.normal(size=(80, A)).astype(np.float32)
    q8, dense = _cache(P, S, 120, "pallas_q8"), _cache(P, 1, 120, "dense")
    for c in (q8, dense):
        _fill(P, c, vecs, ans)
    for step in range(12):
        q = _unit(rng, int(rng.integers(1, 13)))
        q[0] = vecs[int(rng.integers(0, 80))]
        theta = float(rng.uniform(0.5, 0.99))
        r1, r2 = q8.lookup(q, theta), dense.lookup(q, theta)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
        v = _unit(rng, 1)[0]
        for c in (q8, dense):
            c.insert_spill(v, v[:A].copy(), 3000 + step)
    assert q8.dev_row_writes > 0 and q8.quant_rescored > 0


def test_plane_writes_under_no_grad():
    """The HTTP front end serves under torch.no_grad() (grad mode is per
    thread): a plane built there is patched in place there and outside."""
    P = _pkg("port")
    rng = np.random.default_rng(10)
    vecs = _unit(rng, 20)
    with torch.no_grad():
        c = _cache(P, 4, 40, "pallas")
        _fill(P, c, vecs, vecs[:, :A])
        c.lookup(vecs[:2], 0.9)
        c.insert_spill(_unit(rng, 1)[0], vecs[0, :A], 77)
    c.insert_spill(_unit(rng, 1)[0], vecs[1, :A], 78)
    with torch.no_grad():
        c.update_spill_row(0, _unit(rng, 1)[0], vecs[2, :A])
    assert c.dev_row_writes == 3 and c.dev_rebuilds == 1
    r = c.lookup(c.spill.vectors, 0.99)
    assert r.hit.all() and list(r.answer_id) == [77, 78]


def test_cache_mesh_devices_and_errors():
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    from repro_torch.launch.mesh import make_cache_mesh
    m = make_cache_mesh(3, devices=["cpu"] * 3)
    assert m.axis_names == ("cache",) and len(m.devices) == 3
    assert m.lead == torch.device("cpu")
    assert ShardedCacheConfig(n_shards=3, mesh=m).make_mesh() is m
    with pytest.raises(ValueError, match="devices"):
        make_cache_mesh(2, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_cache_mesh(2)
        cfg = ShardedCacheConfig(n_shards=2)
        with pytest.raises(ValueError, match="CUDA devices"):
            cfg.make_mesh()
        assert cfg.mesh is None         # never falls back to the CPU
