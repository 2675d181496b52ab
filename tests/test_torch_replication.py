"""Port of the replica plane (DESIGN.md §16) held against the JAX package:
each scenario of tests/test_replication.py runs through both packages on
the same numpy inputs by one ``lockstep(scenario)`` helper, and the port
must give the identical hit masks, regions, entries, answer ids, merge
counters (``applied``, ``merged_rows``, ``merged_access``,
``rejected_epoch``, ``reconciles``, ``gap_reconciles``), publish stamps,
cursors and log positions, with sims allclose (atol 1e-5). The gateway
and HTTP scenarios run over the reduced qwen3 in fp32 with the
reference's weights carried across (``repro_torch.weights``): statuses,
headers, response JSON (``tokens_out`` included) and ``/healthz`` equal.
``update_spill_row`` is held against the reference on every backend.
Everything runs on the CPU at dim 16.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro.distributed import replication as JR
from repro.launch import serve as JServe
from repro.models import lm as JLM
from repro.serving import config as JC
from repro.serving.engine import ModelEngine as JEngine
from repro.serving.gateway import (GatewayRequest as JRequest,
                                   ServingGateway as JGateway)
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.core.siso import SISO as PSISO, SISOConfig as PConfig
from repro_torch.distributed import replication as PR
from repro_torch.launch import serve as PServe
from repro_torch.serving import config as PC
from repro_torch.serving.engine import ModelEngine as PEngine
from repro_torch.serving.gateway import (GatewayRequest as PRequest,
                                         ServingGateway as PGateway)

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

D = 16
SIM_ATOL = 1e-5

J = SimpleNamespace(
    name="jax", R=JR, C=JC, serve=JServe, Gateway=JGateway,
    Request=JRequest,
    siso=lambda cfg: JSISO(cfg), Config=JConfig)
P = SimpleNamespace(
    name="torch", R=PR, C=PC, serve=PServe, Gateway=PGateway,
    Request=PRequest,
    siso=lambda cfg: PSISO(cfg, device="cpu"), Config=PConfig)


def norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def unit(rng, n, d=D):
    return norm(rng.normal(size=(n, d))).astype(np.float32)


def make_siso(pkg, train, theta=0.9, backend="dense"):
    siso = pkg.siso(pkg.Config(dim=D, answer_dim=D, capacity=64,
                               dynamic_threshold=False, theta_r=theta,
                               refresh_min=10_000, backend=backend))
    siso.bootstrap(train, train, answer_ids=np.arange(len(train)))
    return siso


class FakeGateway:
    """The slice of ServingGateway a Replica touches in unit tests."""

    def __init__(self, siso):
        self.frontend = siso
        self.t = 0.0
        self.clock = lambda: self.t

    def submit(self, batch, now=None):
        raise NotImplementedError   # unit tests publish/apply directly

    def drain(self):
        pass


def make_pair(pkg, rng, n_train=24):
    train = unit(rng, n_train)
    group = pkg.R.ReplicaGroup(pkg.R.ReplicationConfig(apply_budget=64))
    ra = group.add("a", FakeGateway(make_siso(pkg, train)))
    rb = group.add("b", FakeGateway(make_siso(pkg, train)))
    return group, ra, rb


COUNTERS = ("seq", "applied", "merged_rows", "merged_access",
            "rejected_epoch", "reconciles", "gap_reconciles")


def rep_view(rep) -> dict:
    """A replica's observable merge state."""
    c = rep.gw.frontend.cache
    return {**{f: getattr(rep, f) for f in COUNTERS},
            "cursor": rep.cursor, "stamps": dict(rep._stamps),
            "epoch": int(rep.gw.frontend.refresh_epoch),
            "access": c.centroids.access_count.copy(),
            "spill_ids": c.spill.answer_id.copy(),
            "spill_answers": c.spill.answers.copy(),
            "counts": (c.hits, c.misses)}


def res_view(res) -> dict:
    return {f: np.asarray(getattr(res, f)) for f in
            ("hit", "sim", "answer", "answer_id", "entry", "region")}


def assert_same(a, b, path=""):
    """Port observation == reference observation: exact, except sims and
    floats that came out of a cosine (allclose)."""
    if hasattr(a, "hit") and hasattr(a, "region"):
        a, b = res_view(a), res_view(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(
            b, key=str), (path, sorted(a, key=str), sorted(b, key=str))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if path.endswith("sim"):
            np.testing.assert_allclose(a, b, atol=SIM_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif path.endswith("sim"):
        assert abs(a - b) <= SIM_ATOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def lockstep(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` through both packages and hold the
    port's observations to the reference's; returns the port's."""
    ref = scenario(J, *args, **kw)
    out = scenario(P, *args, **kw)
    assert_same(ref, out)
    return out


# ---------------------------------------------------------------------------
# merge semantics
# ---------------------------------------------------------------------------


def _merge_access_max_wins(pkg):
    group, ra, rb = make_pair(pkg, np.random.default_rng(0))
    fa, fb = ra.gw.frontend, rb.gw.frontend
    fa.handle_batch(np.repeat(fa.cache.centroids.vectors[:1], 5, axis=0))
    fb.handle_batch(np.repeat(fb.cache.centroids.vectors[1:2], 3, axis=0))
    want = np.maximum(fa.cache.centroids.access_count,
                      fb.cache.centroids.access_count)
    ra.publish(now=1.0)
    rb.publish(now=1.0)
    ra.apply_pending(None)
    rb.apply_pending(None)
    np.testing.assert_array_equal(fa.cache.centroids.access_count, want)
    np.testing.assert_array_equal(fb.cache.centroids.access_count, want)
    assert ra.merged_access > 0 and rb.merged_access > 0
    first = (rep_view(ra), rep_view(rb))
    ra.publish(now=2.0)
    rb.apply_pending(None)
    np.testing.assert_array_equal(fb.cache.centroids.access_count, want)
    return {"first": first, "second": (rep_view(ra), rep_view(rb))}


def test_merge_access_max_wins():
    lockstep(_merge_access_max_wins)


def _merge_access_id_intersection(pkg):
    group, ra, rb = make_pair(pkg, np.random.default_rng(0))
    cache = rb.gw.frontend.cache
    local = cache.centroids.access_count.copy()
    ghost = cache.centroids.ids + 10_000
    raised = cache.merge_access(ghost, np.full(len(ghost), 99.0))
    assert raised == 0
    np.testing.assert_array_equal(cache.centroids.access_count, local)
    # half the ids shared: only those can be raised
    ids = cache.centroids.ids.copy()
    ids[::2] += 10_000
    raised2 = cache.merge_access(ids, np.arange(len(ids), dtype=float) + 5)
    return {"raised": (raised, raised2),
            "access": cache.centroids.access_count.copy()}


def test_merge_access_id_intersection():
    out = lockstep(_merge_access_id_intersection)
    assert out["raised"][1] > 0


def _same_answer_id_newest_wins(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    aid = 7_000
    old, new = unit(rng, 1)[0], unit(rng, 1)[0]
    ra.gw.t = 1.0
    fa.record_llm_answer(old, old, answer_id=aid)
    ra.publish(now=1.0)
    rb.apply_pending(None)
    row = int(np.nonzero(fb.cache.spill.answer_id == aid)[0][0])
    np.testing.assert_array_equal(fb.cache.spill.answers[row], old)
    rb.gw.t = 5.0
    fb.record_llm_answer(new, new, answer_id=aid)
    rb.publish(now=5.0)
    ra.apply_pending(None)
    arow = int(np.nonzero(fa.cache.spill.answer_id == aid)[0][-1])
    np.testing.assert_array_equal(fa.cache.spill.answers[arow], new)
    ra.publish(now=6.0)
    rb.apply_pending(None)
    brow = int(np.nonzero(fb.cache.spill.answer_id == aid)[0][-1])
    np.testing.assert_array_equal(fb.cache.spill.answers[brow], new)
    probe = norm(np.stack([old, new]) + 0.01 * unit(rng, 2))
    return {"a": rep_view(ra), "b": rep_view(rb),
            "probe_a": fa.handle_batch(probe.astype(np.float32)),
            "probe_b": fb.handle_batch(probe.astype(np.float32))}


def test_same_answer_id_newest_wins():
    lockstep(_same_answer_id_newest_wins)


def _update_spill_row(pkg, backend):
    rng = np.random.default_rng(0)
    siso = make_siso(pkg, unit(rng, 16), backend=backend)
    v1, v2, v3 = unit(rng, 3)
    siso.record_llm_answer(v1, v1, answer_id=42)
    siso.record_llm_answer(v3, v3, answer_id=43)
    cache = siso.cache
    cache.lookup(v1[None], 0.9)           # the mirror is live
    row = int(np.nonzero(cache.spill.answer_id == 42)[0][0])
    lru = cache._spill_last_use.copy()
    writes = cache.dev_row_writes
    cache.update_spill_row(row, v2, v2)
    assert int(cache.spill.answer_id[row]) == 42
    np.testing.assert_array_equal(cache.spill.vectors[row], v2)
    np.testing.assert_array_equal(cache._spill_last_use, lru)
    assert cache._hnsw is None and cache._quant_restore is None
    res = cache.lookup(np.stack([v2, v1, v3]), 0.9)
    assert bool(res.hit[0]) and int(res.answer_id[0]) == 42
    np.testing.assert_array_equal(res.answer[0], v2)
    assert not res.hit[1] and int(res.answer_id[2]) == 43
    return {"res": res, "lru": lru,
            "row_writes": cache.dev_row_writes - writes,
            "rebuilds": cache.dev_rebuilds, "gen": cache.generation}


@pytest.mark.parametrize("backend", ["dense", "pallas", "hnsw", "pallas_q8"])
def test_update_spill_row_keeps_identity_and_recency(backend):
    lockstep(_update_spill_row, backend)


def _wrong_epoch_rejected(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    fb.record_llm_answer(*(unit(rng, 1)[0],) * 2, answer_id=500)
    fb.refresh()
    assert fb.refresh_epoch == fa.refresh_epoch + 1
    fa.record_llm_answer(*(unit(rng, 1)[0],) * 2, answer_id=501)
    rec = ra.publish(now=1.0)
    before = rep_view(rb)
    assert not rb.apply(rec)
    assert rb.rejected_epoch == 1 and not rb._reconcile_due
    after = rep_view(rb)
    for k in ("spill_ids", "access"):
        np.testing.assert_array_equal(before[k], after[k])
    return {"record": (rec.origin, rec.seq, rec.epoch, rec.stamp,
                       rec.row_stamps), "b": after}


def test_wrong_epoch_rejected_and_state_unchanged():
    lockstep(_wrong_epoch_rejected)


def _newer_epoch_reconcile(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    fb.record_llm_answer(*(unit(rng, 1)[0],) * 2, answer_id=600)
    fb.refresh()
    rb.publish(now=2.0)
    ra.apply_pending(None)
    assert ra.reconciles == 1 and fa.refresh_epoch == fb.refresh_epoch
    probe = unit(rng, 8)
    r1, r2 = fa.handle_batch(probe.copy()), fb.handle_batch(probe.copy())
    for f in ("hit", "sim", "answer", "answer_id", "entry", "region"):
        assert np.array_equal(getattr(r1, f), getattr(r2, f)), f
    return {"a": rep_view(ra), "b": rep_view(rb), "probe": r1}


def test_newer_epoch_triggers_reconcile_to_donor():
    lockstep(_newer_epoch_reconcile)


def _rejoin_reconcile(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    for i, v in enumerate(unit(rng, 6)):
        (fa if i % 2 else fb).record_llm_answer(v, v, answer_id=100 + i)
    group.sync_all(now=3.0)
    train = unit(np.random.default_rng(0), 24)
    rc = group.add("c", FakeGateway(make_siso(pkg, train)), reconcile=True)
    fc = rc.gw.frontend
    donor = group.donor_for(rc)
    assert fc.cache.spill.vectors is not donor.gw.frontend.cache.spill.vectors
    dcache = donor.gw.frontend.cache
    base = np.concatenate([dcache.centroids.vectors[:6],
                           dcache.spill.vectors[:4], unit(rng, 6)])
    probe = norm(base + 0.02 * unit(rng, len(base))).astype(np.float32)
    r_d = donor.gw.frontend.handle_batch(probe.copy(), now=4.0)
    r_c = fc.handle_batch(probe.copy(), now=4.0)
    for f in ("hit", "sim", "answer", "answer_id", "entry", "region"):
        assert np.array_equal(getattr(r_d, f), getattr(r_c, f)), f
    assert r_d.hit.any()
    return {"donor": donor.name, "c": rep_view(rc), "probe": r_c,
            "group": {n: rep_view(r) for n, r in group.replicas.items()}}


def test_rejoin_reconcile_matches_never_killed_replica():
    lockstep(_rejoin_reconcile)


def _peer_insert_counters(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    fa, fb = ra.gw.frontend, rb.gw.frontend
    fa.handle_batch(unit(rng, 10))
    ra.publish(now=1.0)
    h, m = fb.cache.hits, fb.cache.misses
    rb.apply_pending(None)
    assert (fb.cache.hits, fb.cache.misses) == (h, m)
    return {"a": rep_view(ra), "b": rep_view(rb)}


def test_peer_insert_does_not_distort_counters():
    lockstep(_peer_insert_counters)


# ---------------------------------------------------------------------------
# the interleaved stream, the bounded log, the late joiner
# ---------------------------------------------------------------------------


def _interleaved_stream(pkg):
    """The reference's lockstep stream (budget-sliced applies, an epoch
    divergence and its reconcile, traffic after it), probed at each
    checkpoint; the probes are part of the stream."""
    rng = np.random.default_rng(0)
    train = unit(rng, 24)
    group = pkg.R.ReplicaGroup(pkg.R.ReplicationConfig(apply_budget=64))
    w = {"a": group.add("a", FakeGateway(make_siso(pkg, train))),
         "b": group.add("b", FakeGateway(make_siso(pkg, train)))}
    out = {}

    def check(ctx):
        probe = unit(np.random.default_rng(99), 12)
        out[ctx] = {n: (w[n].gw.frontend.handle_batch(probe.copy()),
                        rep_view(w[n])) for n in ("a", "b")}

    vecs = unit(rng, 10)
    w["a"].gw.frontend.handle_batch(train[:6].copy())
    for i in range(4):
        name, other = ("a", "b") if i % 2 == 0 else ("b", "a")
        w[name].gw.t = float(i + 1)
        w[name].gw.frontend.record_llm_answer(vecs[i], vecs[i],
                                              answer_id=900 + i)
        w[name].publish(now=float(i + 1))
        w[other].apply_pending(1)
    check("phase1-sliced")
    w["a"].apply_pending(None)
    w["b"].apply_pending(None)
    check("phase1-drained")
    w["b"].gw.t = 9.0
    w["b"].gw.frontend.record_llm_answer(vecs[8], vecs[8], answer_id=980)
    w["b"].gw.frontend.refresh()
    w["b"].publish(now=9.0)
    w["a"].apply_pending(None)
    check("phase2-reconciled")
    assert w["a"].reconciles == 1
    w["a"].gw.t = 11.0
    w["a"].gw.frontend.record_llm_answer(vecs[9], vecs[9], answer_id=990)
    w["a"].publish(now=11.0)
    w["b"].apply_pending(None)
    w["b"].publish(now=12.0)
    w["a"].apply_pending(None)
    check("phase3-tail")
    out["log"] = (group.log.base, group.log.total, len(group.log),
                  dict(group.log.cursors))
    return out


def test_lockstep_interleaved_stream_matches_jax():
    lockstep(_interleaved_stream)


def _log_bounded(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    log = group.log
    peak = 0
    for i in range(200):
        ra.gw.t = rb.gw.t = float(i)
        if i % 5 == 0:
            v = unit(rng, 1)[0]
            ra.gw.frontend.record_llm_answer(v, v, answer_id=2000 + i)
        ra.publish(now=float(i))
        rb.publish(now=float(i))
        ra.apply_pending(None)
        rb.apply_pending(None)
        peak = max(peak, len(log.records))
    assert log.total == 400 and peak <= 4 and log.base >= log.total - 4
    assert ra.cursor == rb.cursor == log.total
    return {"peak": peak, "log": (log.base, log.total, len(log)),
            "a": rep_view(ra), "b": rep_view(rb)}


def test_replication_log_stays_bounded():
    lockstep(_log_bounded)


def _late_joiner(pkg):
    rng = np.random.default_rng(0)
    group, ra, rb = make_pair(pkg, rng)
    for i in range(8):
        v = unit(rng, 1)[0]
        ra.gw.t = float(i)
        ra.gw.frontend.record_llm_answer(v, v, answer_id=3000 + i)
        ra.publish(now=float(i))
        rb.publish(now=float(i))
        ra.apply_pending(None)
        rb.apply_pending(None)
    assert group.log.base > 0
    rc = group.add("c", FakeGateway(make_siso(
        pkg, unit(np.random.default_rng(1), 24))))
    rc.apply_pending(None)
    assert rc.gap_reconciles == 1 and rc.reconciles == 1
    donor = group.donor_for(rc)
    probe = unit(rng, 8)
    r_d = donor.gw.frontend.handle_batch(probe.copy())
    r_c = rc.gw.frontend.handle_batch(probe.copy())
    for f in ("hit", "sim", "answer", "answer_id", "entry", "region"):
        assert np.array_equal(getattr(r_d, f), getattr(r_c, f)), f
    return {"donor": donor.name, "c": rep_view(rc), "probe": r_c}


def test_late_joiner_after_compaction_reconciles():
    lockstep(_late_joiner)


def test_deep_copy_clones_tensors_and_keeps_namedtuples():
    """The port's clone copies tensor leaves (a restored bf16 leaf is a
    CPU tensor) and rebuilds NamedTuples; nothing aliases the donor."""
    tree = {"a": np.arange(3.0), "t": torch.ones(2, dtype=torch.bfloat16),
            "l": [np.zeros(2), (np.ones(1),)], "n": None}
    got = PR._deep_copy_state(tree)
    got["a"][0] = 9.0
    got["t"][0] = 5.0
    got["l"][1][0][0] = 7.0
    assert tree["a"][0] == 0.0 and float(tree["t"][0]) == 1.0
    assert tree["l"][1][0][0] == 1.0 and isinstance(got["l"][1], tuple)
    assert got["n"] is None


# ---------------------------------------------------------------------------
# gateway-level warming and the HTTP front end, over the reduced qwen3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The reduced qwen3 in fp32 for both packages, the reference's weights
    carried into the port."""
    jcfg = j_get_config("qwen3-14b").reduced().replace(remat=False,
                                                       dtype="float32")
    pcfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    jp = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), pcfg, "cpu")

    def make(pkg):
        if pkg is J:
            return JEngine(jp, jcfg, n_slots=2, max_len=48)
        return PEngine(tp, pcfg, n_slots=2, max_len=48, device="cpu")
    return make


def _cross_replica_warming(pkg, engines):
    rng = np.random.default_rng(0)
    engine = engines(pkg)
    train = unit(rng, 24)
    t = {"now": 0.0}
    clock = lambda: t["now"]     # noqa: E731
    group = pkg.R.ReplicaGroup(pkg.R.ReplicationConfig(sync_every=1,
                                                       apply_budget=64))
    mk = lambda: pkg.Gateway(make_siso(pkg, train), engine,   # noqa: E731
                             embed_fn=lambda vs: np.stack(vs), clock=clock)
    ra, rb = group.add("a", mk()), group.add("b", mk())
    fresh = unit(rng, 1)[0]
    near = norm(fresh + 0.02 * unit(rng, 1)[0]).astype(np.float32)
    toks = np.asarray([1, 2, 3], np.int32)
    hit = ra.submit([pkg.Request(rid=1000, model_tokens=toks,
                                 embed_tokens=fresh, max_new=4,
                                 answer_vec=fresh)], now=0.0)
    assert not hit[0]
    ra.drain()
    t["now"] = 1.0
    ra.publish(now=1.0)
    hit_b = rb.submit([pkg.Request(rid=1001, model_tokens=toks,
                                   embed_tokens=near, max_new=4)], now=1.0)
    assert hit_b[0] and rb.merged_rows >= 1
    rb.drain()
    done = {r.rid: (r.served_by, list(map(int, r.out)) if r.out is not None
                    else None) for g in (ra.gw, rb.gw) for r in g.done}
    return {"hit": (bool(hit[0]), bool(hit_b[0])), "done": done,
            "a": rep_view(ra), "b": rep_view(rb),
            "report": group.report()}


def test_cross_replica_warming_through_gateways(engines):
    lockstep(_cross_replica_warming, engines)


class _Server:
    """A package's CacheHTTPServer on an OS-assigned port, on a thread;
    closed on exit."""

    def __init__(self, pkg, targets, names):
        self.server = pkg.serve.CacheHTTPServer(("127.0.0.1", 0), targets,
                                                names)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)

    def query(self, tokens, **extra):
        req = urllib.request.Request(
            f"{self.url}/v1/query",
            data=json.dumps({"tokens": tokens, "max_new": 4,
                             **extra}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60.0) as r:
                return r.status, _x_headers(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, _x_headers(e.headers), json.loads(e.read())

    def health(self):
        with urllib.request.urlopen(f"{self.url}/healthz",
                                    timeout=60.0) as r:
            return health_view(json.loads(r.read()))


# the gateway report's counts (a bare gateway's /healthz entry carries its
# whole report, whose latency fields are wall-clock)
GATEWAY_COUNTS = ("submitted", "completed", "served_cache", "served_engine",
                  "refreshes", "hits", "misses", "n_centroids", "n_spill",
                  "dev_rebuilds", "dev_row_writes", "dev_swaps")


def health_view(h: dict) -> dict:
    """``/healthz`` without its wall-clock fields: a Replica's report is
    kept whole, a bare gateway's report keeps its counts."""
    h.pop("kernel_launches", None)      # the port's own observability
    for entry in h["replicas"].values():
        rep = entry.get("replication")
        if rep is not None and "published" not in rep:
            entry["replication"] = {k: rep[k] for k in GATEWAY_COUNTS}
    return h


def _x_headers(headers) -> dict:
    return {k: v for k, v in headers.items()
            if k.startswith("X-") or k == "Retry-After"}


def _http_config(pkg):
    return pkg.C.ServingConfig(
        cache=pkg.C.CacheConfig(dim=D, answer_dim=D, capacity=64,
                                dynamic_threshold=False),
        refresh=pkg.C.RefreshConfig(min=10_000))


def _http_gateway(pkg, engine, cfg=None):
    embed = pkg.serve.hash_embed_fn(D)
    return pkg.Gateway.from_config(cfg or _http_config(pkg), engine=engine,
                                   embed_fn=embed,
                                   answer_fn=lambda t: embed([t])[0])


def _http_headers_and_drain(pkg, engines):
    gw = _http_gateway(pkg, engines(pkg))
    out = []
    with _Server(pkg, [gw], ["r0"]) as srv:
        out.append(srv.query([5, 6, 7]))
        out.append(srv.query([5, 6, 7]))
        out.append(srv.health())
        srv.server.begin_drain()
        out.append(srv.query([9, 9, 9]))
        out.append(srv.health())
    (s1, h1, b1), (s2, h2, b2) = out[0], out[1]
    assert s1 == 200 and h1["X-Cache"] == "MISS" and b1["tokens_out"]
    assert s2 == 200 and h2["X-Cache"] == "HIT"
    assert b2["served_by"] == "cache" and out[2]["status"] == "serving"
    assert out[3][0] == 503 and out[3][1]["Retry-After"] == "1"
    assert out[4]["status"] == "draining"
    return out


def test_http_front_end_headers_and_drain(engines):
    lockstep(_http_headers_and_drain, engines)


def _http_cross_replica(pkg, engines):
    engine = engines(pkg)
    group = pkg.R.ReplicaGroup(pkg.R.ReplicationConfig(sync_every=1,
                                                       apply_budget=64))
    reps = [group.add(n, _http_gateway(pkg, engine)) for n in ("r0", "r1")]
    out = []
    with _Server(pkg, reps, ["r0", "r1"]) as srv:
        out.append(srv.query([5, 6, 7]))          # anonymous: r0
        out.append(srv.query([5, 6, 7]))          # r1, warmed by r0
        out.append(srv.query([8, 8], user=4))     # user-sticky: r0
        out.append(srv.query([8, 8], user=5))     # r1: peer hit
        out.append(srv.query([8, 8], user=5))     # r1 again
        out.append(srv.health())
    assert out[0][1]["X-Cache"] == "MISS" and out[0][1]["X-Replica"] == "r0"
    assert out[1][1]["X-Cache"] == "HIT" and out[1][1]["X-Replica"] == "r1"
    assert out[3][1]["X-Cache"] == "HIT" and out[3][1]["X-Replica"] == "r1"
    assert out[3][1]["X-Cache-Region"] == "spill"
    assert reps[1].merged_rows >= 1
    assert sorted(out[5]["replicas"]) == ["r0", "r1"]
    return out


def test_http_front_end_cross_replica_hit(engines):
    out = lockstep(_http_cross_replica, engines)
    rep = out[5]["replicas"]["r1"]["replication"]
    assert rep["merged_rows"] >= 2 and rep["transport"]["kind"] == "inproc"


def test_http_isolated_replicas_never_publish(engines):
    """``sync_every=0`` is an isolated replica: the port's front end does
    not publish after a miss (the reference's publishes regardless), so
    the repeat on the peer misses, and nothing was merged."""
    engine = engines(P)
    group = PR.ReplicaGroup(PR.ReplicationConfig(sync_every=0))
    reps = [group.add(n, _http_gateway(P, engine)) for n in ("r0", "r1")]
    with _Server(P, reps, ["r0", "r1"]) as srv:
        first = srv.query([5, 6, 7], user=0)
        again = srv.query([5, 6, 7], user=1)
        health = srv.health()
    assert first[1]["X-Cache"] == "MISS" and first[1]["X-Replica"] == "r0"
    assert again[1]["X-Cache"] == "MISS" and again[1]["X-Replica"] == "r1"
    for name in ("r0", "r1"):
        rep = health["replicas"][name]["replication"]
        assert rep["published"] == 0 and rep["merged_rows"] == 0


def _concurrent_drain(pkg, engines, d):
    """Six clients through a drain: every status a clean 200 or 503, both
    seen, a snapshot written, post-drain queries refused. Thread timing
    decides the mix, so each package is held to the properties."""
    cfg = _http_config(pkg)
    cfg.persistence = pkg.C.PersistenceConfig(directory=str(d),
                                              async_write=False,
                                              delta_every=4)
    gw = _http_gateway(pkg, engines(pkg), cfg)
    steps0 = list(gw.ckpt.all_steps())
    statuses, lock, stop = [], threading.Lock(), threading.Event()
    with _Server(pkg, [gw], ["r0"]) as srv:
        def client(cid):
            i = 0
            while not stop.is_set():
                st = srv.query([cid, i % 3])[0]
                with lock:
                    statuses.append(st)
                if st == 503:
                    return
                i += 1

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while True:
            with lock:
                if len(statuses) >= 6:
                    break
            assert time.monotonic() < deadline, "clients stalled"
            time.sleep(0.01)
        srv.server.begin_drain()
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "client thread wedged"
        assert set(statuses) <= {200, 503} and 200 in statuses
        post = [srv.query([99, c])[0] for c in range(3)]
    assert post == [503] * 3
    assert list(gw.ckpt.all_steps())[-1] > (steps0[-1] if steps0 else 0)
    return post


def test_concurrent_clients_during_drain(engines, tmp_path):
    ref = _concurrent_drain(J, engines, tmp_path / "jax")
    assert _concurrent_drain(P, engines, tmp_path / "torch") == ref


def test_handler_failure_answers_500_and_stops_the_server():
    """No fallback hides a failed gateway path: the request answers 500,
    and the server stops serving (the launcher then exits 1)."""
    class Broken:
        done, last_result = [], None

        def submit(self, batch, now=None):
            raise RuntimeError("CUDA error: device-side assert triggered")

    with _Server(P, [Broken()], ["r0"]) as srv:
        st, _, body = srv.query([1, 2])
        assert st == 500 and "device-side assert" in body["error"]
        srv.thread.join(timeout=10)
        assert not srv.thread.is_alive(), "server kept serving"
        assert isinstance(srv.server.failed, RuntimeError)
