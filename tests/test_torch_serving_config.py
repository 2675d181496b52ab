"""Port of the ServingConfig construction surface held against the JAX
package (ports of tests/test_serving_config.py): the nested config lowers
to and rises from the flat SISOConfig field for field as the reference's
does; ``SISO.from_config`` is bit-identical to old-style construction and
decides as the reference does; every frontend satisfies the
CacheFrontend protocol; every plane that is not ported yet (sharding over
more than one shard, replication) raises ``NotImplementedError`` naming
it; and the ported planes (tiering, tenancy, persistence) build through
``ServingGateway.from_config`` as the reference's do.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.siso import SISO as JSISO
from repro.core.tenancy import TenancyConfig as JTenancy
from repro.core.tiered import TieredCacheConfig as JTiered
from repro.distributed.cache_plane import ShardedCacheConfig as JSharded
from repro.distributed.replication import ReplicationConfig as JReplication
from repro.distributed.transport import TransportConfig as JTransport
from repro.serving import config as J
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.core.tiered import TieredCacheConfig
from repro_torch.distributed.cache_plane import ShardedCacheConfig
from repro_torch.distributed.replication import ReplicationConfig
from repro_torch.distributed.transport import TransportConfig
from repro_torch.serving import CacheFrontend
from repro_torch.serving.baselines import NoCache, VectorCache
from repro_torch.serving.config import (CacheConfig, PersistenceConfig,
                                        RefreshConfig, ServingConfig)

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

D = 16
CPU = {"device": "cpu"}


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _asdict(cfg) -> dict:
    """Field dict of a config; the reference's jax ``mesh`` field has no
    counterpart in the port."""
    return dataclasses.asdict(cfg, dict_factory=lambda kv: {
        k: v for k, v in kv if k != "mesh"})


# ------------------------------------------------------------ field mapping


@pytest.mark.parametrize("cls,jcls", [
    (CacheConfig, J.CacheConfig), (RefreshConfig, J.RefreshConfig),
    (PersistenceConfig, J.PersistenceConfig),
    (TieredCacheConfig, JTiered), (TenancyConfig, JTenancy),
    (ShardedCacheConfig, JSharded), (ReplicationConfig, JReplication),
    (TransportConfig, JTransport)])
def test_config_dataclasses_carried_over_field_for_field(cls, jcls):
    assert _asdict(cls()) == _asdict(jcls())


def _pair(**over):
    """The same nested config built in both packages."""
    cache = dict(dim=8, answer_dim=24, capacity=99, backend="hnsw",
                 spill_lru=False, rescore_k=8, theta_c=0.8, theta_r=0.91,
                 dynamic_threshold=False, repeat_sim=0.97,
                 repeat_window=30.0)
    refresh = dict(frac=0.2, min=7, async_pipeline=False, budget_s=0.01,
                   t2h_sample_frac=0.1)
    planes = over.pop("planes", False)
    t = ServingConfig(
        cache=CacheConfig(**cache), refresh=RefreshConfig(**refresh),
        tiering=TieredCacheConfig(host_capacity=64) if planes else None,
        tenancy=TenancyConfig(overlay_capacity=8) if planes else None,
        sharding=ShardedCacheConfig(n_shards=1) if planes else None,
        slo_latency=2.5, llm_latency=0.7)
    j = J.ServingConfig(
        cache=J.CacheConfig(**cache), refresh=J.RefreshConfig(**refresh),
        tiering=JTiered(host_capacity=64) if planes else None,
        tenancy=JTenancy(overlay_capacity=8) if planes else None,
        sharding=JSharded(n_shards=1) if planes else None,
        slo_latency=2.5, llm_latency=0.7)
    return t, j


@pytest.mark.parametrize("case", ["defaults", "custom", "custom_planes"])
def test_to_and_from_siso_config_match_jax(case):
    if case == "defaults":
        t, j = ServingConfig(), J.ServingConfig()
    else:
        t, j = _pair(planes=case == "custom_planes")
    low_t, low_j = t.to_siso_config(), j.to_siso_config()
    assert [f.name for f in dataclasses.fields(low_t)] \
        == [f.name for f in dataclasses.fields(low_j)]
    for f in dataclasses.fields(low_j):
        a, b = getattr(low_t, f.name), getattr(low_j, f.name)
        if dataclasses.is_dataclass(b):
            assert _asdict(a) == _asdict(b), f.name
        else:
            assert a == b, f.name
    back_t = ServingConfig.from_siso_config(low_t, 2.5, 0.7)
    back_j = J.ServingConfig.from_siso_config(low_j, 2.5, 0.7)
    assert _asdict(back_t) == _asdict(back_j)
    assert back_t.to_siso_config() == low_t
    # answer_dim None defaults to dim on lowering
    assert ServingConfig(cache=CacheConfig(dim=8)).to_siso_config() \
        .answer_dim == 8


# ------------------------------------------------------------- equivalence


def _drive(fe, seed, train):
    """Interleaved lookup/record stream (random queries and near copies of
    the bootstrap rows); returns the full result trace."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        q = _unit(rng, 3)
        near = train[rng.integers(0, len(train), size=2)] \
            + 0.05 * _unit(rng, 2)
        q[:2] = near / np.linalg.norm(near, axis=1, keepdims=True)
        res = fe.handle_batch(q, now=float(i),
                              user_ids=np.asarray([1, 2, 3]))
        out.append(res)
        if i % 3 == 0:
            v = _unit(rng, 1)[0]
            fe.record_llm_answer(v, v, answer_id=1000 + i)
    return out


def test_old_style_vs_from_config_bit_identical_and_matches_jax():
    train = _unit(np.random.default_rng(7), 48)
    kw = dict(capacity=64, theta_r=0.88, dynamic_threshold=False)
    old = SISO(SISOConfig(dim=D, answer_dim=D, refresh_min=10_000, **kw),
               **CPU)
    cfg = ServingConfig(cache=CacheConfig(dim=D, answer_dim=D, **kw),
                        refresh=RefreshConfig(min=10_000))
    new = SISO.from_config(cfg, **CPU)
    ref = JSISO.from_config(J.ServingConfig(
        cache=J.CacheConfig(dim=D, answer_dim=D, **kw),
        refresh=J.RefreshConfig(min=10_000)))
    for fe in (old, new, ref):
        fe.bootstrap(train, train, answer_ids=np.arange(len(train)))
    t_old, t_new, t_ref = (_drive(fe, 11, train) for fe in (old, new, ref))
    assert 0 < sum(r.hit.sum() for r in t_new) < 36   # hits and misses
    for i, (a, b, r) in enumerate(zip(t_old, t_new, t_ref)):
        for f in ("hit", "sim", "answer", "answer_id", "entry", "region"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"step {i} {f} old-new")
        for f in ("hit", "answer", "answer_id", "entry", "region"):
            np.testing.assert_array_equal(getattr(b, f), getattr(r, f),
                                          err_msg=f"step {i} {f} vs jax")
        np.testing.assert_allclose(b.sim, r.sim, atol=1e-6)


def test_sharding_over_one_shard_is_the_single_device_path():
    cfg = ServingConfig(cache=CacheConfig(dim=D, answer_dim=D, capacity=32),
                        sharding=ShardedCacheConfig(n_shards=1))
    siso = SISO.from_config(cfg, **CPU)
    assert siso.cache.shard is None and siso.device.type == "cpu"


# ---------------------------------------------------------------- protocol


def _make_frontends():
    rng = np.random.default_rng(7)
    train = _unit(rng, 32)
    siso = SISO.from_config(ServingConfig(
        cache=CacheConfig(dim=D, answer_dim=D, capacity=64,
                          dynamic_threshold=False),
        refresh=RefreshConfig(min=10_000)), **CPU)
    siso.bootstrap(train, train, answer_ids=np.arange(len(train)))
    return {"nocache": NoCache(), "vector": VectorCache(D, D, 64),
            "siso": siso}


@pytest.mark.parametrize("kind", ["nocache", "vector", "siso"])
def test_cache_frontend_protocol_conformance(kind):
    """Every serving frontend satisfies the structural protocol and the
    methods actually run (isinstance alone only checks names exist)."""
    fe = _make_frontends()[kind]
    assert isinstance(fe, CacheFrontend)
    v = _unit(np.random.default_rng(1), 2)
    res = fe.lookup(v)
    assert res.hit.shape == (2,)
    fe.record(v[0], v[0], answer_id=500)
    assert isinstance(fe.state_dict(), dict)
    assert "hit_ratio" in fe.stats()


def test_protocol_rejects_non_frontends():
    assert not isinstance(object(), CacheFrontend)
    assert not isinstance({"lookup": 1}, CacheFrontend)


# -------------------------------------------------------- unported planes


@pytest.mark.parametrize("plane", ["sharding", "replication"])
def test_each_set_plane_raises_naming_it(plane):
    value = {"sharding": ShardedCacheConfig(n_shards=2),
             "replication": ReplicationConfig(
                 transport=TransportConfig(kind="socket"))}[plane]
    cfg = ServingConfig(cache=CacheConfig(dim=D, answer_dim=D, capacity=32),
                        **{plane: value})
    with pytest.raises(NotImplementedError, match=plane):
        SISO.from_config(cfg, **CPU)


# --------------------------------------------------------- ported planes


class _Stub:
    """An engine the gateway wires but never runs."""
    n_slots, max_len = 1, 8
    pos = np.zeros(1, np.int32)
    device = "cpu"

    def free_slots(self):
        return []


def _plane_pair(plane, tmp_path):
    """The same plane config in both packages (directories apart)."""
    def dirs(pkg):
        return str(tmp_path / pkg / "cold"), str(tmp_path / pkg / "snap")
    if plane == "tiering":
        kw = dict(host_capacity=16, disk_capacity=32, device_reserve=4,
                  promote_budget=3, flush_rows=5)
        return ({"tiering": TieredCacheConfig(disk_dir=dirs("t")[0], **kw)},
                {"tiering": JTiered(disk_dir=dirs("j")[0], **kw)})
    if plane == "tenancy":
        kw = dict(overlay_capacity=4, registry_cap=99, max_tenants=3)
        return ({"tenancy": TenancyConfig(**kw)},
                {"tenancy": JTenancy(**kw)})
    kw = dict(keep=2, async_write=False, delta_every=3)
    return ({"persistence": PersistenceConfig(directory=dirs("t")[1], **kw)},
            {"persistence": J.PersistenceConfig(directory=dirs("j")[1],
                                                **kw)})


@pytest.mark.parametrize("plane", ["tiering", "tenancy", "persistence"])
def test_each_ported_plane_builds_like_the_reference(plane, tmp_path):
    """ServingGateway.from_config builds each newly ported plane as the
    reference's from_config does, field for field."""
    from repro.serving.gateway import ServingGateway as JGateway
    from repro_torch.serving.gateway import ServingGateway
    t_plane, j_plane = _plane_pair(plane, tmp_path)
    cache = dict(dim=D, answer_dim=D, capacity=32)
    embed = lambda vs: np.stack(vs)     # noqa: E731
    t = ServingGateway.from_config(
        ServingConfig(cache=CacheConfig(**cache), slo_latency=2.0,
                      **t_plane), engine=_Stub(), embed_fn=embed)
    j = JGateway.from_config(
        J.ServingConfig(cache=J.CacheConfig(**cache), slo_latency=2.0,
                        **j_plane), engine=_Stub(), embed_fn=embed)
    ts, js = t.frontend, j.frontend
    ta, ja = _asdict(ts.cfg), _asdict(js.cfg)
    if ta["tiered"] is not None:        # directories differ by design
        ta["tiered"].pop("disk_dir"), ja["tiered"].pop("disk_dir")
    assert ta == ja
    assert type(ts.cache).__name__ == type(js.cache).__name__
    assert ts.centroid_capacity == js.centroid_capacity
    assert t.slo_latency == j.slo_latency
    assert (ts.registry is None) == (js.registry is None)
    if ts.registry is not None:
        assert ts.registry.cap == js.registry.cap
    assert (ts.tenant_of is None) == (js.tenant_of is None)
    tdev, jdev = ts.cache, js.cache
    if plane == "tiering":
        tdev, jdev = ts.cache.device, js.cache.device
        for tier in ("host", "disk"):
            assert (getattr(ts.cache, tier) is None) \
                == (getattr(js.cache, tier) is None), tier
        assert ts.cache.host.hnsw_min == js.cache.host.hnsw_min
        assert ts.cache.disk.flush_rows == js.cache.disk.flush_rows
        assert ts.cache.tier_stats() == js.cache.tier_stats()
    assert (tdev.evict_sink is None) == (jdev.evict_sink is None)
    assert tdev.fair_share_eviction == jdev.fair_share_eviction
    assert (t.ckpt is None) == (j.ckpt is None)
    if plane == "persistence":
        for attr in ("_delta_every", "_snap_step", "_snap_epoch",
                     "_since_snap"):
            assert getattr(t, attr) == getattr(j, attr), attr
        assert list(t._full_steps) == list(j._full_steps)
        assert t.ckpt.keep == j.ckpt.keep
        assert t.ckpt.protect == j.ckpt.protect
        assert t.ckpt.all_steps() == j.ckpt.all_steps() == [1]
        # the base full each wrote holds the same tree
        from repro.checkpoint.manager import _flatten
        ft = _flatten(t.ckpt.restore(1))
        fj = _flatten(j.ckpt.restore(1))
        assert sorted(ft) == sorted(fj)
        for k in fj:
            np.testing.assert_array_equal(np.asarray(ft[k]),
                                          np.asarray(fj[k]), err_msg=k)
