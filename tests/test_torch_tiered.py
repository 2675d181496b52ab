"""Port of the tiered hierarchy (device -> host -> disk, DESIGN.md §13)
held against the JAX package: each scenario of tests/test_tiered_cache.py
runs through both packages on the same numpy inputs, and the port must
give the identical hit masks, regions, entries, answer ids, tier
membership and tier stats (sims allclose) besides the reference's own
properties: the fall-through order, promotion and its undo, lossless
demotion through disk, host overflow, 1-tier bit-identity, random
interleavings, Algorithm-1 refreshes, the host tier's HNSW path, and a
SIGKILL -> warm_start drill of the port alone.
Everything runs on the CPU at dim <= 32 in fp32.
"""
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import tiered as JT
from repro.core.semantic_cache import SemanticCache as JCache
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro.core.store import CentroidStore as JStore
from repro_torch.core import tiered as PT
from repro_torch.core.semantic_cache import SemanticCache as PCache
from repro_torch.core.siso import SISO as PSISO, SISOConfig as PConfig
from repro_torch.core.store import CentroidStore as PStore

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
DIM, ADIM = 16, 8

J = SimpleNamespace(
    name="jax", T=JT, Store=JStore, Config=JConfig,
    cache=lambda *a, **k: JCache(*a, **k),
    siso=lambda cfg, **k: JSISO(cfg, **k))
P = SimpleNamespace(
    name="torch", T=PT, Store=PStore, Config=PConfig,
    cache=lambda *a, **k: PCache(*a, device="cpu", **k),
    siso=lambda cfg, **k: PSISO(cfg, device="cpu", **k))


def norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def unit(rng, n, d=DIM):
    return norm(rng.normal(size=(n, d)).astype(np.float32))


def _plain(x):
    """Observable value -> comparable python/numpy (LookupResults and
    dataclass-free dicts)."""
    if hasattr(x, "hit") and hasattr(x, "region"):
        return {f: getattr(x, f) for f in ("hit", "sim", "answer",
                                            "answer_id", "entry", "region",
                                            "generation")}
    return x


def assert_same(a, b, path=""):
    """Port result == reference result: exact, except sims (allclose)."""
    a, b = _plain(a), _plain(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if path.endswith("sim"):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def lockstep(scenario, tmp_path, **kw):
    """Run ``scenario(pkg, dir, **kw)`` through both packages and hold the
    port's observations to the reference's; returns the port's."""
    ref = scenario(J, tmp_path / "jax", **kw)
    out = scenario(P, tmp_path / "torch", **kw)
    assert_same(ref, out)
    return out


def mk_tiered(pkg, d, capacity=8, host=16, disk=64, **kw):
    cfg = pkg.T.TieredCacheConfig(
        host_capacity=host, disk_capacity=disk,
        disk_dir=str(d / "cold") if disk else None, **kw)
    return pkg.T.TieredCache(pkg.cache(DIM, ADIM, capacity), cfg)


def fill_centroids(pkg, cache, rng, n, id_base=0):
    v = unit(rng, n)
    st = pkg.Store(DIM, ADIM)
    st.add(v, rng.normal(size=(n, ADIM)).astype(np.float32),
           np.arange(n, 0, -1, dtype=np.float64),
           answer_id=np.arange(id_base, id_base + n))
    cache.set_centroids(st)
    return v


def state(cache) -> dict:
    return {"membership": cache.tier_membership(),
            "stats": cache.tier_stats(), "clock": cache.clock,
            "counts": (cache.hits, cache.misses),
            "promo": list(cache._promo)}


def live_ids(cache):
    m = cache.tier_membership()
    return {k: set(np.asarray(v)[np.asarray(v) >= 0].tolist())
            for k, v in m.items()}


# ---------------------------------------------------------------------------
# fall-through, promotion, undo, demotion
# ---------------------------------------------------------------------------


def _fall_through(pkg, d):
    rng = np.random.default_rng(0)
    cache = mk_tiered(pkg, d)
    fill_centroids(pkg, cache, rng, 4)
    host_vec, disk_vec = unit(rng, 1), unit(rng, 1)
    ans = rng.normal(size=(2, ADIM)).astype(np.float32)
    cache.host.add(host_vec, ans[:1], np.array([100]), np.array([3.0]),
                   np.array([0.0]), clock=0)
    cache.disk.append(disk_vec, ans[1:], np.array([200]), np.array([1.0]),
                      np.array([0.0]), clock=0)
    out = {"host": cache.lookup(host_vec, 0.9),
           "probe": cache.lookup(disk_vec, 0.9, update_counts=False),
           "probe_state": state(cache),
           "disk_pending": cache.lookup(disk_vec, 0.9)}
    cache.disk.flush()
    out["disk_flushed"] = cache.lookup(disk_vec, 0.9)
    out["miss"] = cache.lookup(unit(rng, 2), 0.999)
    out["state"] = state(cache)
    return out


def test_fall_through_device_host_disk_and_miss_once(tmp_path):
    out = lockstep(_fall_through, tmp_path)
    assert out["host"].region[0] == PT.REGION_HOST
    assert out["host"].answer_id[0] == 100
    assert out["probe"].region[0] == PT.REGION_DISK
    assert out["probe_state"]["counts"] == (1, 0)     # probe: no effects
    assert out["probe_state"]["clock"] == 1 and out["probe_state"]["promo"] \
        == [(PT.REGION_HOST, 0)]
    for k in ("disk_pending", "disk_flushed"):
        assert out[k].region[0] == PT.REGION_DISK and out[k].answer_id[0] \
            == 200
    assert not out["miss"].hit.any()
    assert out["state"]["counts"] == (3, 2)       # one miss per query
    assert out["state"]["stats"]["tier_hits"] == {"device": 0, "host": 1,
                                                  "disk": 2}


def _promote(pkg, d, source):
    rng = np.random.default_rng(1)
    cache = mk_tiered(pkg, d)
    fill_centroids(pkg, cache, rng, 4)          # spill room: 8 - 4 = 4
    vec = unit(rng, 1)
    ans = rng.normal(size=(1, ADIM)).astype(np.float32)
    if source == "host":
        cache.host.add(vec, ans, np.array([100]), np.array([5.0]),
                       np.array([2.0]), clock=0)
    else:
        cache.disk.append(vec, ans, np.array([100]), np.array([5.0]),
                          np.array([0.0]), clock=0)
        cache.disk.flush()
    cache.lookup(unit(rng, 2), 0.9)             # materialize the mirror
    out = {"first": cache.lookup(vec, 0.9), "writes0": cache.dev_row_writes,
           "rebuilds0": cache.dev_rebuilds}
    out["promoted"] = cache.promote_tick()
    out["writes1"] = cache.dev_row_writes
    out["rebuilds1"] = cache.dev_rebuilds
    out["spill"] = (cache.device.spill.answer_id.copy(),
                    cache.device.spill.answers.copy(),
                    cache.device.spill.cluster_size.copy())
    out["second"] = cache.lookup(vec, 0.9)
    out["state"] = state(cache)
    return out


@pytest.mark.parametrize("source", ["host", "disk"])
def test_promotion_is_one_row_patch_with_exact_bytes(tmp_path, source):
    out = lockstep(_promote, tmp_path, source=source)
    assert out["promoted"] == 1
    # one in-place row patch of the device mirror, never a rebuild
    assert out["writes1"] == out["writes0"] + 1
    assert out["rebuilds1"] == out["rebuilds0"]
    assert out["second"].region[0] == 1          # now a spill hit
    np.testing.assert_array_equal(out["second"].answer, out["first"].answer)
    assert out["state"]["stats"]["host_rows"] == 0
    assert out["state"]["stats"]["disk_rows"] == 0


def _undo(pkg, d):
    rng = np.random.default_rng(2)
    cache = mk_tiered(pkg, d)
    fill_centroids(pkg, cache, rng, 4)
    vec = unit(rng, 1)
    cache.host.add(vec, np.ones((1, ADIM), np.float32), np.array([9]),
                   np.array([1.0]), np.array([0.0]), clock=0)
    res = cache.lookup(vec, 0.9)
    before = state(cache)
    cache.undo_tier_hit(int(res.entry[0]), int(res.region[0]))
    return {"res": res, "before": before, "after": state(cache),
            "access": cache.host.store.access_count.copy()}


def test_undo_tier_hit_reverts_promotion_and_popularity(tmp_path):
    out = lockstep(_undo, tmp_path)
    assert len(out["before"]["promo"]) == 1 and not out["after"]["promo"]
    assert out["after"]["stats"]["tier_hits"]["host"] == 0
    assert out["access"][0] == 0.0


def _demote(pkg, d):
    rng = np.random.default_rng(3)
    cache = mk_tiered(pkg, d, capacity=4, host=0, disk=64)   # disk only
    fill_centroids(pkg, cache, rng, 2)                        # spill: 2
    vecs = unit(rng, 3)
    answers = rng.normal(size=(3, ADIM)).astype(np.float32)
    for i in range(3):                  # the third insert evicts the LRU
        cache.insert_spill(vecs[i], answers[i], answer_id=500 + i)
    out = {"after_insert": state(cache),
           "pending": cache.lookup(vecs[0:1], 0.99)}
    cache.disk.flush()
    out["flushed"] = cache.lookup(vecs[0:1], 0.99)
    cache.promote_drain()
    out["promoted"] = cache.lookup(vecs[0:1], 0.99)
    out["answers"] = answers
    out["state"] = state(cache)
    return out


def test_demotion_round_trips_through_disk_losslessly(tmp_path):
    out = lockstep(_demote, tmp_path)
    st = out["after_insert"]["stats"]
    assert st["demotions_disk"] == 1 and st["tier_drops"] == 0
    for k in ("pending", "flushed"):
        assert out[k].region[0] == PT.REGION_DISK
        np.testing.assert_array_equal(out[k].answer[0], out["answers"][0])
    assert out["promoted"].region[0] == 1
    np.testing.assert_array_equal(out["promoted"].answer[0],
                                  out["answers"][0])


def _overflow(pkg, d):
    rng = np.random.default_rng(4)
    cache = mk_tiered(pkg, d, capacity=4, host=4, disk=64)
    fill_centroids(pkg, cache, rng, 4)       # device full: inserts go warm
    for i, v in enumerate(unit(rng, 6)):
        cache.insert_spill(v, np.full(ADIM, float(i), np.float32),
                           answer_id=700 + i)
    return state(cache)


def test_host_overflow_demotes_coldest_to_disk(tmp_path):
    out = lockstep(_overflow, tmp_path)
    assert out["stats"]["host_rows"] == 4 and out["stats"]["disk_rows"] == 2
    assert out["stats"]["tier_drops"] == 0


def test_config_requires_disk_dir_and_policy_clamps_inf():
    with pytest.raises(ValueError, match="disk_dir"):
        PT.TieredCache(PCache(DIM, ADIM, 8, device="cpu"),
                       PT.TieredCacheConfig(disk_capacity=10))
    args = (np.array([4.0]), np.array([np.inf]), np.array([0]), 10,
            np.array([64.0]))
    hot = PT.TierPolicy().hotness(*args)
    assert np.isfinite(hot).all()
    np.testing.assert_array_equal(hot, JT.TierPolicy().hotness(*args))


# ---------------------------------------------------------------------------
# 1-tier degradation: bit-identical to the bare SemanticCache
# ---------------------------------------------------------------------------


def _one_tier(pkg, d, wrap):
    r = np.random.default_rng(5)
    cache = pkg.cache(DIM, ADIM, 8)
    if wrap:
        cache = pkg.T.TieredCache(cache, pkg.T.TieredCacheConfig())
        assert cache.device.evict_sink is None   # no demotion tap
    v = unit(r, 6)
    st = pkg.Store(DIM, ADIM)
    st.add(v, r.normal(size=(6, ADIM)).astype(np.float32),
           np.arange(6, 0, -1, dtype=np.float64), answer_id=np.arange(6))
    cache.set_centroids(st)
    for i in range(8):                         # overflows the 2-row spill
        cache.insert_spill(unit(r, 1)[0],
                           r.normal(size=ADIM).astype(np.float32),
                           answer_id=10 + i)
    dev = cache.device if wrap else cache
    return {"res": [cache.lookup(unit(r, 3), th) for th in (0.3, 0.7, 0.95)],
            "counts": (cache.hits, cache.misses),
            "spill": dev.spill.answer_id.copy(),
            "lru": dev._spill_last_use.copy()}


@pytest.mark.parametrize("pkg", [J, P], ids=["jax", "torch"])
def test_single_tier_config_is_bit_identical(tmp_path, pkg):
    plain = _one_tier(pkg, tmp_path, wrap=False)
    wrapped = _one_tier(pkg, tmp_path, wrap=True)
    for a, b in zip(plain["res"], wrapped["res"]):
        for f in ("hit", "sim", "answer", "answer_id", "entry", "region",
                  "generation"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for k in ("counts", "spill", "lru"):
        np.testing.assert_array_equal(plain[k], wrapped[k])
    if pkg is P:     # and the port's wrapped run equals the reference's
        assert_same(_one_tier(J, tmp_path, wrap=True), wrapped)


# ---------------------------------------------------------------------------
# the membership invariant under random interleavings, in lockstep
# ---------------------------------------------------------------------------


def check_invariants(cache, inserted):
    ids = live_ids(cache)
    assert not ids["device"] & ids["host"]
    assert not ids["device"] & ids["disk"]
    assert not ids["host"] & ids["disk"]
    live = ids["device"] | ids["host"] | ids["disk"]
    assert live <= inserted
    assert len(inserted) == len(live) + cache.drops
    if cache.host is not None:
        assert len(cache.host.last_use) == len(cache.host.store)


def _interleave(pkg, d, seed, hnsw_min=4096):
    rng = np.random.default_rng(seed)
    cache = mk_tiered(pkg, d, capacity=6, host=8 if hnsw_min > 64 else 40,
                      disk=24, flush_rows=7, sweep_every=16,
                      hnsw_min=hnsw_min,
                      policy=pkg.T.TierPolicy(base_ttl=24.0))
    vecs = fill_centroids(pkg, cache, rng, 3)
    inserted = set(range(3))
    history = [(vecs[i], i) for i in range(3)]
    next_id, trace = 3, []
    for step in range(300):
        op = rng.integers(0, 10)
        if op < 4:                         # insert a fresh identity
            v = unit(rng, 1)[0]
            cache.insert_spill(v, rng.normal(size=ADIM).astype(np.float32),
                               answer_id=next_id)
            history.append((v, next_id))
            inserted.add(next_id)
            next_id += 1
        elif op < 8:                       # revisit an old query
            v, _ = history[int(rng.integers(len(history)))]
            trace.append(cache.lookup(v[None, :], 0.95))
        elif op == 8:                      # async promotion work
            trace.append(cache.promote_tick(budget=int(rng.integers(1, 4))))
        else:                              # cold probe (miss path)
            trace.append(cache.lookup(unit(rng, 2), 0.999))
        if step % 20 == 0:
            check_invariants(cache, inserted)
            trace.append(state(cache))
    cache.promote_drain()
    check_invariants(cache, inserted)
    trace.append(state(cache))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tier_invariant_random_interleaving(tmp_path, seed):
    lockstep(_interleave, tmp_path, seed=seed)


def test_host_tier_hnsw_path(tmp_path):
    """The host tier switches to its HNSW above hnsw_min rows: with
    hnsw_min = 16 and up to 40 host rows the interleaving serves through
    the graph (and its brute-force tail) in both packages, identically."""
    out = lockstep(_interleave, tmp_path, seed=7, hnsw_min=16)
    assert max(s["stats"]["host_rows"] for s in out
               if isinstance(s, dict) and "stats" in s) > 16


def _siso_refreshes(pkg, d, refresh_async):
    rng = np.random.default_rng(5)
    cfg = pkg.Config(dim=DIM, answer_dim=ADIM, capacity=24, theta_r=0.9,
                     dynamic_threshold=False, refresh_async=refresh_async,
                     tiered=pkg.T.TieredCacheConfig(
                         host_capacity=32, disk_capacity=128,
                         disk_dir=str(d / "cold"), device_reserve=6,
                         promote_budget=4))
    s = pkg.siso(cfg)
    vb = unit(rng, 32)
    s.bootstrap(vb, rng.normal(size=(32, ADIM)).astype(np.float32),
                answer_ids=np.arange(32))
    history, trace = list(vb), []
    for i in range(150):
        if rng.integers(0, 3) == 0:
            v = unit(rng, 1)
            trace.append(s.handle_batch(v))
            s.record_llm_answer(v[0],
                                rng.normal(size=ADIM).astype(np.float32),
                                answer_id=1000 + i)
            history.append(v[0])
        else:
            v = history[int(rng.integers(len(history)))]
            trace.append(s.handle_batch(v[None, :]))
        if refresh_async:
            s.refresh_tick(0.0)     # one unit a tick: deterministic pacing
        elif s.needs_refresh():
            s.refresh()
        if i % 25 == 0:
            trace.append(state(s.cache))
    s.refresh_drain()
    ids = live_ids(s.cache)
    assert not ids["device"] & ids["host"] and not ids["host"] & ids["disk"]
    assert not ids["device"] & ids["disk"]
    trace.append({"final": state(s.cache), "refreshes":
                  s.refreshes_completed, "gen": s.cache.generation})
    return trace


@pytest.mark.parametrize("refresh_async", [False, True])
def test_tier_invariant_under_siso_refreshes(tmp_path, refresh_async):
    out = lockstep(_siso_refreshes, tmp_path, refresh_async=refresh_async)
    fin = out[-1]
    assert fin["refreshes"] >= 2
    assert fin["final"]["stats"]["host_rows"] <= 32
    assert fin["final"]["stats"]["demotions_host"] \
        + fin["final"]["stats"]["demotions_disk"] > 0


# ---------------------------------------------------------------------------
# the port's own save -> SIGKILL -> warm_start drill
# ---------------------------------------------------------------------------

# the child and the in-process reference run execute the SAME construction
# and stream code, so a divergence is a restore fault, never a code drift
_SCAFFOLD = """
import numpy as np
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.core.tiered import TieredCacheConfig

def norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)

def make(disk_dir):
    # blocking refresh: a mid-cycle async refresh legally restarts on
    # restore, so a cross-process lockstep drill takes the synchronous path
    cfg = SISOConfig(dim=16, answer_dim=16, capacity=24, refresh_min=8,
                     refresh_async=False,
                     tiered=TieredCacheConfig(host_capacity=32,
                                              disk_capacity=128,
                                              disk_dir=disk_dir,
                                              device_reserve=6,
                                              promote_budget=4))
    return SISO(cfg, slo_latency=1.0, llm_latency=0.5, device="cpu")

def drive(s, seed, t0, steps):
    rng = np.random.default_rng(seed)
    for k in range(steps):
        q = norm(rng.normal(size=(4, 16)).astype(np.float32))
        res = s.handle_batch(q.copy(), now=float(t0 + k),
                             user_ids=np.arange(4) % 3)
        for b in range(4):
            if not res.hit[b]:
                s.record_llm_answer(q[b], q[b],
                                    answer_id=10_000 + 4 * (t0 + k) + b)
        s.observe_completion(0.3, 0.2)
        s.refresh_tick(0.0)

def populate(s):
    rng = np.random.default_rng(11)
    train = norm(rng.normal(size=(120, 16)).astype(np.float32))
    s.bootstrap(train, train, answer_ids=np.arange(120))
    drive(s, 12, 0, 40)
"""

_CHILD = _SCAFFOLD + """
import os, signal, sys
import torch
torch.set_num_threads(2)
from repro_torch.checkpoint import CheckpointManager

base = os.environ["TIERED_DRILL_DIR"]
s = make(os.path.join(base, "cold"))
populate(s)
CheckpointManager(os.path.join(base, "ckpt"), keep=2).save(
    1, {"siso": s.state_dict()})
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules)
# a hard crash: no atexit, no flush; the snapshot alone must carry the
# three-tier hierarchy
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_tiered_save_sigkill_warmstart_equivalence(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["TIERED_DRILL_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == -signal.SIGKILL, out.stderr[-3000:]
    ns = {}
    exec(compile(_SCAFFOLD, "<tiered-scaffold>", "exec"), ns)
    s1 = ns["make"](str(tmp_path / "ref_cold"))
    ns["populate"](s1)
    step, rec = CheckpointManager(str(tmp_path / "ckpt")).restore_latest()
    assert step == 1
    s2 = ns["make"](str(tmp_path / "cold"))
    s2.load_state(rec["siso"])
    s2.warm_start()
    m1, m2 = s1.cache.tier_membership(), s2.cache.tier_membership()
    assert_same(m1, m2)
    assert len(m1["host"]) > 0 and len(m1["disk"]) > 0   # really 3 tiers

    def stats_no_layout(cache):
        # a snapshot force-flushes the pending disk buffer, so the restored
        # run legally carries one more segment file
        st = cache.tier_stats()
        st.pop("disk_segments")
        return st

    assert stats_no_layout(s1.cache) == stats_no_layout(s2.cache)
    assert (s1.cache.hits, s1.cache.misses, s1.cache.clock) \
        == (s2.cache.hits, s2.cache.misses, s2.cache.clock)
    ns["drive"](s1, 13, 40, 15)
    ns["drive"](s2, 13, 40, 15)
    assert_same(s1.cache.tier_membership(), s2.cache.tier_membership())
    assert s1.cache.tier_stats() == s2.cache.tier_stats()
    assert s1.stats() == s2.stats()
