"""Port of crash-safe persistence held against the JAX package (DESIGN.md
§12): both packages' SISO state trees are equal key for key on every
backend; the port's CheckpointManager keeps the reference's on-disk
format (a directory written by either package restores in the other); a
checkpoint written by the reference SISO or gateway warm-starts in the
port and serves a phase B in lockstep with the reference's uninterrupted
run, and the reverse.
Everything runs on the CPU at dim <= 32 in fp32.
"""
import os
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as j_flatten
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro_torch.core.siso import SISO, SISOConfig

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

CPU = {"device": "cpu"}
BACKENDS = ("dense", "pallas", "hnsw", "pallas_q8")


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)


def _clustered(rng, n, d, n_topics=48, noise=0.12):
    base = _unit(rng, n_topics, d)
    v = base[rng.integers(0, n_topics, size=n)] \
        + noise * rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _assert_trees_equal(a, b, ctx="", skip=()):
    fa, fb = j_flatten(a), j_flatten(b)
    assert sorted(fa) == sorted(fb), (ctx, sorted(set(fa) ^ set(fb)))
    for k in fa:
        if k in skip:
            continue
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        if x.dtype.kind == "f" and "sim" in k:
            np.testing.assert_allclose(x, y, atol=1e-5, err_msg=f"{ctx} {k}")
        else:
            assert x.shape == y.shape and np.array_equal(x, y), (ctx, k, x, y)


# ---------------------------------------------------------------------------
# the state tree, key for key, on all four backends
# ---------------------------------------------------------------------------


def _stream_pair(backend, rng_seed=0, dim=32, capacity=64):
    """Both packages through the same bootstrap and stream: 400 bootstrap
    queries, 8 batches of 8 with record_llm_answer on every miss."""
    rng = np.random.default_rng(rng_seed)
    hist = _clustered(rng, 400, dim)
    kw = dict(dim=dim, answer_dim=dim, capacity=capacity, backend=backend,
              refresh_async=False, dynamic_threshold=True)
    j, p = JSISO(JConfig(**kw)), SISO(SISOConfig(**kw), **CPU)
    for s in (j, p):
        s.bootstrap(hist, hist, answer_ids=np.arange(400))
    for b in range(8):
        q = _clustered(rng, 8, dim)
        rj = j.handle_batch(q.copy(), now=float(b), user_ids=np.arange(8) % 5)
        rp = p.handle_batch(q.copy(), now=float(b), user_ids=np.arange(8) % 5)
        np.testing.assert_array_equal(rj.hit, rp.hit)
        for i in np.flatnonzero(~rj.hit):
            for s in (j, p):
                s.record_llm_answer(q[i], q[i], answer_id=1000 + 8 * b + i)
        for s in (j, p):
            s.observe_completion(0.3, 0.2)
            s.refresh_tick()
    return j, p


@pytest.mark.parametrize("backend", BACKENDS)
def test_state_trees_equal_key_for_key(backend):
    j, p = _stream_pair(backend)
    _assert_trees_equal(j.state_dict(), p.state_dict(), "full")
    _assert_trees_equal(j.state_dict(delta=True), p.state_dict(delta=True),
                        "delta")


# ---------------------------------------------------------------------------
# the checkpoint format, shared between the packages
# ---------------------------------------------------------------------------


class Pair(NamedTuple):
    """A NamedTuple of this module: both packages' restores resolve it."""
    step: np.ndarray
    moments: dict


def _format_tree(bf16):
    return {"pair": Pair(np.asarray(3), {"w": np.arange(6.0).reshape(2, 3)}),
            "mixed": {"lst": [np.arange(3.0) + i for i in range(12)],
                      "tup": (np.ones(2), np.zeros(3, np.int32)),
                      "s": np.asarray("full")},
            "half": bf16}


_BF16_VALUES = np.asarray([1.0, -2.5, 3.140625, 0.0078125], np.float32)


def _check_format_tree(rec, half_to_f32):
    assert isinstance(rec["pair"], Pair) and int(rec["pair"].step) == 3
    np.testing.assert_array_equal(rec["pair"].moments["w"],
                                  np.arange(6.0).reshape(2, 3))
    lst = rec["mixed"]["lst"]
    assert isinstance(lst, list) and len(lst) == 12     # "10" < "2" trap
    for i, a in enumerate(lst):
        np.testing.assert_array_equal(a, np.arange(3.0) + i)
    assert isinstance(rec["mixed"]["tup"], tuple)
    assert rec["mixed"]["tup"][1].dtype == np.int32
    assert str(rec["mixed"]["s"]) == "full"
    np.testing.assert_array_equal(half_to_f32(rec["half"]), _BF16_VALUES)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_directory_restores_in_the_other_package(writer,
                                                            tmp_path):
    """Same MANIFEST/spec/npz layout both ways; a bf16 leaf keeps the
    reference's ``__bf16`` uint16 tag (a torch bf16 tensor in the port, an
    ml_dtypes array in the reference)."""
    import ml_dtypes
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointManager as PManager
    if writer == "torch":
        half = torch.tensor(_BF16_VALUES).to(torch.bfloat16)
        PManager(str(tmp_path), keep=1).save(4, _format_tree(half))
        _, rec = JManager(str(tmp_path)).restore_latest()
        _check_format_tree(rec, lambda h: np.asarray(h, np.float32))
        assert rec["half"].dtype == ml_dtypes.bfloat16
    else:
        half = _BF16_VALUES.astype(ml_dtypes.bfloat16)
        JManager(str(tmp_path), keep=1).save(4, _format_tree(half))
        _, rec = PManager(str(tmp_path)).restore_latest()
        _check_format_tree(rec, lambda h: h.float().numpy())
        assert rec["half"].dtype == torch.bfloat16
    # and each package reads its own file back the same way
    own = (PManager if writer == "torch" else JManager)(str(tmp_path))
    _check_format_tree(own.restore(4), (lambda h: h.float().numpy())
                       if writer == "torch"
                       else (lambda h: np.asarray(h, np.float32)))


def test_class_refs_of_the_reference_map_to_the_port():
    from repro_torch.checkpoint.manager import _import_class, _unflatten
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.core.tenancy import TenancyConfig
    assert _import_class("repro.core.tenancy:TenancyConfig") \
        is TenancyConfig
    from repro_torch.training.optimizer import AdamWState
    assert _import_class("repro.training.optimizer:AdamWState") \
        is AdamWState
    # a reference module the port does not have yet
    assert _import_class("repro.distributed.pipeline:PipelineSpec") is None
    assert _import_class("jax.numpy:ndarray") is None
    assert _import_class("ml_dtypes:bfloat16") is None
    # specless (legacy) paths rebuild lists in numeric order
    tree = {"seq": [np.full((1,), float(i)) for i in range(12)]}
    rebuilt = _unflatten(_flatten(tree))
    assert [float(a[0]) for a in rebuilt["seq"]] == list(map(float,
                                                            range(12)))


def test_checkpoint_async_write_does_not_alias_live_buffers(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    live = {"x": np.zeros(4096), "t": torch.zeros(64)}
    cm.save(1, live)
    live["x"][:] = 777.0          # mutate right after the enqueue
    live["t"].fill_(5.0)
    cm.wait()
    _, rec = cm.restore_latest()
    np.testing.assert_array_equal(rec["x"], np.zeros(4096))
    np.testing.assert_array_equal(rec["t"], np.zeros(64, np.float32))


def test_tmp_gc_spares_live_writers_reaps_dead_and_aged(tmp_path):
    from repro_torch.checkpoint import CheckpointManager, manager
    try:        # a pid strictly beyond pid_max can never name a process
        dead_pid = int(open("/proc/sys/kernel/pid_max").read()) + 7
    except OSError:
        dead_pid = 2 ** 30
    d = str(tmp_path)
    live = os.path.join(d, "step_00000005.tmp-1")        # pid 1: alive
    dead = os.path.join(d, f"step_00000006.tmp-{dead_pid}")
    aged = os.path.join(d, "step_00000007.tmp-1")        # alive but old
    for p in (live, dead, aged):
        os.makedirs(p)
    old = time.time() - 2 * manager.TMP_GC_AGE_S
    os.utime(aged, (old, old))
    cm = CheckpointManager(d, keep=3)
    cm.save(1, {"x": np.ones(2)})
    names = os.listdir(d)
    assert os.path.basename(live) in names
    assert os.path.basename(dead) not in names
    assert os.path.basename(aged) not in names
    assert cm.all_steps() == [1]


# ---------------------------------------------------------------------------
# SemanticCache: restore, generation, the restored int8 plane
# ---------------------------------------------------------------------------


def _fill(cache, store_cls, rng, n, d=16):
    vecs = _unit(rng, n, d)
    st = store_cls(d, d)
    st.add(vecs, vecs, np.arange(n, 0, -1, dtype=np.float64),
           answer_id=np.arange(n))
    cache.set_centroids(st)
    return vecs


def _assert_results_equal(a, b, ctx=""):
    for f in ("hit", "answer", "answer_id", "entry", "region"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(a.sim, b.sim, atol=1e-5, err_msg=ctx)
    assert a.generation == b.generation, ctx


@pytest.mark.parametrize("backend", BACKENDS)
def test_semantic_cache_restore_serves_as_the_reference(backend):
    """The reference cache runs uninterrupted; the port cache, restored
    mid-stream from its own snapshot (taken in lockstep), then serves the
    rest identically, spill victims included."""
    from repro.core.semantic_cache import SemanticCache as JCache
    from repro.core.store import CentroidStore as JStore
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    rng = np.random.default_rng(3)
    j = JCache(16, 16, capacity=40, backend=backend)
    p = SemanticCache(16, 16, capacity=40, backend=backend, **CPU)
    seed = int(rng.integers(1 << 30))
    vj = _fill(j, JStore, np.random.default_rng(seed), 32)
    _fill(p, CentroidStore, np.random.default_rng(seed), 32)
    for t in range(30):         # churn: count updates, LRU overwrites
        q = _unit(rng, 3, 16)
        q[0] = vj[t % 32]
        _assert_results_equal(j.lookup(q, 0.8), p.lookup(q, 0.8), t)
        for c in (j, p):
            c.insert_spill(q[1], q[1], answer_id=100 + t)
    r = SemanticCache(16, 16, capacity=40, backend=backend, **CPU)
    r.load_state(p.state_dict())
    r.rebuild_mirror()
    for t in range(20):
        q = _unit(rng, 4, 16)
        q[0] = vj[(3 * t) % 32]
        _assert_results_equal(j.lookup(q, 0.8), r.lookup(q, 0.8), t)
        assert int(np.argmin(j._spill_last_use)) \
            == int(np.argmin(r._spill_last_use))
        for c in (j, r):
            c.insert_spill(q[1], q[1], answer_id=500 + t)
        np.testing.assert_array_equal(j.spill.answer_id, r.spill.answer_id)
    assert j.hit_ratio == r.hit_ratio


def test_restore_does_not_advance_generation():
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    rng = np.random.default_rng(4)
    c1 = SemanticCache(16, 16, capacity=32, **CPU)
    vecs = _fill(c1, CentroidStore, rng, 16)
    gen = c1.lookup(vecs[:2], 0.9).generation
    c2 = SemanticCache(16, 16, capacity=32, **CPU)
    c2.load_state(c1.state_dict())
    assert c2.lookup(vecs[:2], 0.9).generation == gen
    c2.rebuild_mirror()     # idempotent: already built by the lookup
    assert c2.lookup(vecs[:2], 0.9).generation == gen
    _fill(c2, CentroidStore, rng, 16)   # a real refresh IS a new state
    assert c2.lookup(vecs[:2], 0.9).generation == gen + 1
    # a snapshot taken with an invalidation pending bumps on restore, as
    # the uninterrupted run bumps on its next lookup
    c1.set_centroids(c1.centroids.copy())
    c3 = SemanticCache(16, 16, capacity=32, **CPU)
    c3.load_state(c1.state_dict())
    assert c3.lookup(vecs[:2], 0.9).generation \
        == c1.lookup(vecs[:2], 0.9).generation == gen + 1


def test_q8_restore_serves_the_snapshot_codes():
    """A restored pallas_q8 plane is built from the snapshot's own codes
    and scales (no requantization), and keeps deciding as dense does."""
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    rng = np.random.default_rng(5)
    c1 = SemanticCache(32, 32, capacity=48, backend="pallas_q8", **CPU)
    d1 = SemanticCache(32, 32, capacity=48, backend="dense", **CPU)
    seed = int(rng.integers(1 << 30))
    vecs = _fill(c1, CentroidStore, np.random.default_rng(seed), 40, 32)
    _fill(d1, CentroidStore, np.random.default_rng(seed), 40, 32)
    for c in (c1, d1):
        c.insert_spill(vecs[0], vecs[0], answer_id=99)
        c.lookup(vecs[:2], 0.9)             # a live mirror at snapshot time
    st = c1.state_dict()
    c2 = SemanticCache(32, 32, capacity=48, backend="pallas_q8", **CPU)
    c2.load_state(st)
    c2.rebuild_mirror()
    n = len(st["quant"]["codes"])
    np.testing.assert_array_equal(c2._dev.codes[:n].numpy(),
                                  st["quant"]["codes"])
    np.testing.assert_array_equal(c2._dev.scales[:n].numpy(),
                                  st["quant"]["scales"])
    assert c2.generation == c1.generation
    q = np.concatenate([vecs[:6] + 0.01 * _unit(rng, 6, 32),
                        _unit(rng, 2, 32)])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a, b = d1.lookup(q, 0.9), c2.lookup(q, 0.9)
    np.testing.assert_array_equal(a.sim, b.sim)      # bitwise dense
    np.testing.assert_array_equal(a.entry, b.entry)
    # the restore really takes the snapshot's codes: a marked code row
    # reaches the mirror as it is
    st["quant"]["codes"] = st["quant"]["codes"].copy()
    st["quant"]["codes"][0, 0] ^= 1
    c3 = SemanticCache(32, 32, capacity=48, backend="pallas_q8", **CPU)
    c3.load_state(st)
    c3.rebuild_mirror()
    assert int(c3._dev.codes[0, 0]) == int(st["quant"]["codes"][0, 0])


# ---------------------------------------------------------------------------
# SISO: delta composition, epochs, mid-cycle restore
# ---------------------------------------------------------------------------


def _siso(pkg="torch", refresh_async=False, backend="dense", **kw):
    cfg_cls, cls = (SISOConfig, SISO) if pkg == "torch" \
        else (JConfig, JSISO)
    cfg = cfg_cls(dim=16, answer_dim=16, capacity=64, refresh_min=8,
                  refresh_async=refresh_async, backend=backend, **kw)
    extra = CPU if pkg == "torch" else {}
    return cls(cfg, slo_latency=1.0, llm_latency=0.5, **extra)


def _queries(rng, k, hist):
    """Revisits (noise 0.01: sim ~0.999) and fresh random queries (best
    sim well below the theta grid's top): clear of theta and of ties."""
    q = _unit(rng, 4, 16)
    q[:2] = hist[rng.integers(0, len(hist), size=2)] \
        + 0.01 * rng.normal(size=(2, 16)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _serve(sisos, rng, t0, steps, hist):
    """Drive SISOs in lockstep on the same queries; returns the results
    of the first, asserting the others equal it."""
    out = []
    for k in range(steps):
        t = float(t0 + k)
        q = _queries(rng, k, hist)
        res = [s.handle_batch(q.copy(), now=t, user_ids=np.arange(4) % 3)
               for s in sisos]
        for r in res[1:]:
            _assert_results_equal(res[0], r, k)
        for s in sisos:
            for b in np.flatnonzero(~res[0].hit):
                s.record_llm_answer(q[b], q[b], answer_id=1000 + 4 * k + b)
            s.observe_completion(0.3, 0.2)
            s.refresh_tick(0.0)
        thetas = {s.theta_r for s in sisos}
        assert len(thetas) == 1, (k, thetas)
        out.append(res[0])
    return out


def test_siso_delta_snapshot_composition():
    rng = np.random.default_rng(8)
    s1 = _siso(refresh_frac=100.0)   # no refresh due in the window
    hist = _unit(rng, 200, 16)
    s1.bootstrap(hist, hist, answer_ids=np.arange(200))
    _serve([s1], rng, 0, 10, hist)
    full, epoch0 = s1.state_dict(), s1.refresh_epoch
    _serve([s1], rng, 10, 12, hist)
    assert s1.refresh_epoch == epoch0
    delta = s1.state_dict(delta=True)
    s2 = _siso(refresh_frac=100.0)
    s2.load_state(full)
    s2.load_state(delta, delta=True)
    s2.warm_start()
    assert s2.stats() == s1.stats()
    _serve([s1, s2], rng, 22, 15, hist)


def test_delta_against_wrong_epoch_is_rejected():
    rng = np.random.default_rng(9)
    s1 = _siso()
    train = _unit(rng, 64, 16)
    s1.bootstrap(train, train, answer_ids=np.arange(64))
    delta = s1.state_dict(delta=True)
    train2 = _unit(rng, 24, 16)
    s1.bootstrap(train2, train2, answer_ids=np.arange(24))
    s2 = _siso()
    s2.load_state(s1.state_dict())
    with pytest.raises(ValueError, match="epoch"):
        s2.load_state(delta, delta=True)


def _active_pipeline(rng, phase_target):
    s = _siso(refresh_async=True)
    train = _unit(rng, 120, 16)
    s.bootstrap(train, train, answer_ids=np.arange(120))
    for t in range(60):
        q = _unit(rng, 2, 16)
        res = s.handle_batch(q, now=float(t))
        for b in np.flatnonzero(~res.hit):
            s.record_llm_answer(q[b], q[b], answer_id=200 + t)
        if not s.pipeline.active:
            s.refresh_tick(0.0)
        if s.pipeline.active:
            break
    assert s.pipeline.active
    while phase_target is not None and s.pipeline.phase != phase_target:
        s.pipeline.step(0.0)
        assert s.pipeline.active
    return s


@pytest.mark.parametrize("phase_target", [None, "plan", "apply", "t2h"])
def test_pipeline_midcycle_restore_converges_identically(phase_target):
    rng = np.random.default_rng(11)
    s1 = _active_pipeline(rng, phase_target)
    s2 = _siso(refresh_async=True)
    s2.load_state(s1.state_dict())
    s2.warm_start()
    assert s2.refresh_epoch == s1.refresh_epoch
    st1, st2 = s1.pipeline.finish(), s2.pipeline.finish()
    assert (st1.merged, st1.added, st1.evicted) \
        == (st2.merged, st2.added, st2.evicted)
    for f in ("vectors", "answers", "cluster_size", "access_count",
              "answer_id", "ids"):
        np.testing.assert_array_equal(getattr(s1.cache.centroids, f),
                                      getattr(s2.cache.centroids, f))
    assert s1.theta_r == s2.theta_r
    assert s1.cache.generation == s2.cache.generation


# ---------------------------------------------------------------------------
# across the packages: a checkpoint of either restores in the other
# ---------------------------------------------------------------------------


def _phase_a(s, seed):
    rng = np.random.default_rng(seed)
    hist = _clustered(rng, 160, 16, n_topics=40, noise=0.05)
    s.bootstrap(hist, hist, answer_ids=np.arange(160))
    _serve([s], rng, 0, 24, hist)
    return rng, hist


@pytest.mark.parametrize("backend", ["dense", "pallas", "pallas_q8"])
def test_reference_checkpoint_warm_starts_in_the_port(backend, tmp_path):
    """The reference SISO writes a full snapshot and a later same-epoch
    delta through its CheckpointManager and runs on; the port restores
    both from the directory, warm-starts, and serves phase B in lockstep
    with the reference's uninterrupted run."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointManager
    j = _siso("jax", backend=backend, refresh_frac=100.0)
    rng, hist = _phase_a(j, 21)
    jm = JManager(str(tmp_path), keep=3)
    jm.save(1, {"siso": j.state_dict(), "epoch": np.asarray(
        j.refresh_epoch)})
    _serve([j], rng, 24, 6, hist)
    jm.save(2, {"siso": j.state_dict(delta=True),
                "epoch": np.asarray(j.refresh_epoch)})
    pm = CheckpointManager(str(tmp_path))
    full, delta = pm.restore(1), pm.restore(2)
    assert int(full["epoch"]) == int(delta["epoch"])
    p = _siso("torch", backend=backend, refresh_frac=100.0)
    p.load_state(full["siso"])
    p.load_state(delta["siso"], delta=True)
    p.warm_start()
    # the restore's one mirror build is this process's own rebuild
    rebuilds = ("cache/dev_rebuilds",)
    assert p.cache.dev_rebuilds == j.cache.dev_rebuilds + 1
    _assert_trees_equal(j.state_dict(), p.state_dict(), "restored",
                        skip=rebuilds)
    assert p.stats() == j.stats()
    _serve([j, p], rng, 30, 20, hist)
    _assert_trees_equal(j.state_dict(), p.state_dict(), "after phase B",
                        skip=rebuilds)


@pytest.mark.parametrize("backend", ["dense", "pallas_q8"])
def test_port_checkpoint_restores_in_the_reference(backend, tmp_path):
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointManager
    p = _siso("torch", backend=backend)
    rng, hist = _phase_a(p, 22)
    CheckpointManager(str(tmp_path)).save(1, {"siso": p.state_dict()})
    _, rec = JManager(str(tmp_path)).restore_latest()
    j = _siso("jax", backend=backend)
    j.load_state(rec["siso"])
    j.warm_start()
    _assert_trees_equal(p.state_dict(), j.state_dict(), "restored",
                        skip=("cache/dev_rebuilds",))
    _serve([p, j], rng, 24, 20, hist)


# ---------------------------------------------------------------------------
# the gateway: snapshots at commits/drains/deltas, warm_start across both
# ---------------------------------------------------------------------------


class _Engine:
    """A deterministic engine for the scheduler: every request decodes
    max_new tokens in as many ticks; no model."""

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
        return self.t


def _gateway(pkg, persist_dir=None, bootstrap=None, delta_every=2):
    if pkg == "torch":
        from repro_torch.serving.config import (CacheConfig, PersistenceConfig,
                                                RefreshConfig, ServingConfig)
        from repro_torch.serving.gateway import ServingGateway
    else:
        from repro.serving.config import (CacheConfig, PersistenceConfig,
                                          RefreshConfig, ServingConfig)
        from repro.serving.gateway import ServingGateway
    cfg = ServingConfig(
        cache=CacheConfig(dim=16, answer_dim=16, capacity=48, theta_r=0.86,
                          dynamic_threshold=True),
        refresh=RefreshConfig(async_pipeline=False, frac=0.1),
        persistence=(PersistenceConfig(directory=persist_dir,
                                       async_write=False,
                                       delta_every=delta_every)
                     if persist_dir else None),
        slo_latency=0.4, llm_latency=0.06)
    clock = _Clock()
    gw = ServingGateway.from_config(cfg, engine=_Engine(),
                                    embed_fn=lambda vs: np.stack(vs),
                                    clock=clock)
    gw.frontend.threshold.lambda_window = 2.0
    if bootstrap is not None:
        gw.frontend.bootstrap(bootstrap, bootstrap,
                              answer_ids=np.arange(len(bootstrap)))
    return gw, clock


def _drive_gateway(gw, clock, vecs, lo, hi, chunk=4):
    """Submit requests [lo, hi) one chunk a 0.05 s tick; returns the per
    batch hit masks."""
    if gw.frontend.__class__.__module__.startswith("repro_torch"):
        from repro_torch.serving.gateway import GatewayRequest
    else:
        from repro.serving.gateway import GatewayRequest
    hits = []
    for s in range(lo, hi, chunk):
        batch = [GatewayRequest(rid=i, model_tokens=np.arange(4) + i,
                                embed_tokens=vecs[i], user_id=i % 5,
                                max_new=3, answer_vec=vecs[i])
                 for i in range(s, min(s + chunk, hi))]
        hits.append(gw.submit(batch, now=clock.t).copy())
        clock.t += 0.05
    gw.drain()
    return hits


def test_reference_gateway_checkpoint_warm_starts_in_the_port(tmp_path):
    """bench_restart's drill across the packages: the reference gateway
    serves phase A with persistence attached (a refresh commit in it),
    drains (a full snapshot) and writes a delta; the port's gateway
    warm-starts from a copy of the directory ("full+delta") and serves
    phase B in lockstep with the reference's uninterrupted run: per-batch
    hit masks, lifetime counters, theta trace and generation."""
    import shutil
    rng = np.random.default_rng(31)
    hist = _clustered(rng, 96, 16, n_topics=24, noise=0.05)
    stream = _clustered(rng, 120, 16, n_topics=24, noise=0.05)
    live, survivor = str(tmp_path / "live"), str(tmp_path / "survivor")
    j, jc = _gateway("jax", live, bootstrap=hist)
    _drive_gateway(j, jc, stream, 0, 64)
    assert j.stats.refreshes >= 1           # phase A holds a commit
    j.snapshot(full=False)                  # a delta at the boundary
    j.ckpt.wait()
    shutil.copytree(live, survivor)
    boundary = jc.t
    ref = _drive_gateway(j, jc, stream, 64, 120)
    p, pc = _gateway("torch", survivor)
    meta = p.warm_start()
    assert meta["kind"] == "full+delta"
    pc.t = boundary
    out = _drive_gateway(p, pc, stream, 64, 120)
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    rj, rp = j.report(), p.report()
    for k in ("hits", "misses", "submitted", "completed", "served_cache",
              "served_engine", "mirror_generation", "theta_trace",
              "refreshes"):
        assert rj[k] == rp[k], k
    assert 0 < sum(int(h.sum()) for h in out) < 56


def test_attach_persistence_base_full_and_retention(tmp_path):
    """A fresh directory gets a base full at attach time; after a restart
    the restored base stays protected through delta churn past keep."""
    rng = np.random.default_rng(20)
    hist = _unit(rng, 64, 16)
    d = str(tmp_path)
    gw, _ = _gateway("torch", d)
    assert gw.ckpt.all_steps() == [1]       # laid down at attach time
    gw.frontend.bootstrap(hist, hist, answer_ids=np.arange(64))
    gw.snapshot(full=True)                  # the bootstrap's new epoch
    gw.snapshot(full=False)
    gw2, _ = _gateway("torch", d)
    assert gw2.warm_start()["kind"] == "full+delta"
    assert len(gw2.frontend.cache.centroids) == len(gw.frontend.cache.centroids)
    for _ in range(6):                  # delta churn past keep = 3
        gw2.snapshot(full=False)
    gw3, _ = _gateway("torch", d)
    assert gw3.warm_start()["kind"] == "full+delta"
    assert gw3.frontend.stats() == gw2.frontend.stats()
