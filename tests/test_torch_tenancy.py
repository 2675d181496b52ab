"""Port of multi-tenant namespaces (DESIGN.md §14) held against the JAX
package: fair_share_take on random inputs; a tenancy-configured port
serving tenant-free traffic is bit-identical to the tenancy-free one and
to the reference; and each scenario of tests/test_tenancy.py (repeat
escapes in mixed batches, anonymous rows, fair-share spill eviction,
per-tenant theta, overlay-only personal answers, the tenancy state round
trip, pre-tenancy snapshots) runs through both packages in lockstep:
identical hit masks, regions, answer ids, tenant stats and registry (sims
allclose). Ends with the port's own SIGKILL -> warm_start drill of a
multi-tenant three-tier SISO.
Everything runs on the CPU at dim 16 in fp32.
"""
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import tenancy as JTen
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro_torch.core import tenancy as PTen
from repro_torch.core.siso import SISO as PSISO, SISOConfig as PConfig

from test_torch_tiered import assert_same

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
D = 16

J = SimpleNamespace(Ten=JTen, Config=JConfig,
                    siso=lambda cfg, **k: JSISO(cfg, **k))
P = SimpleNamespace(Ten=PTen, Config=PConfig,
                    siso=lambda cfg, **k: PSISO(cfg, device="cpu", **k))


def _unit(rng, n, d=D):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _siso(pkg, capacity=16, tenancy="on", **kw):
    ten = (pkg.Ten.TenancyConfig() if tenancy == "on"
           else None if tenancy == "off" else tenancy)
    cfg = pkg.Config(dim=D, answer_dim=D, capacity=capacity, theta_r=0.9,
                     dynamic_threshold=False, refresh_async=False,
                     tenancy=ten, **kw)
    return pkg.siso(cfg, slo_latency=1.0, llm_latency=0.5)


def lockstep(scenario, **kw):
    ref = scenario(J, **kw)
    out = scenario(P, **kw)
    assert_same(ref, out)
    return out


def tenant_view(s) -> dict:
    return {"stats": s.tenant_stats(),
            "registry": list(s.registry._map.items()),
            "overlays": {t: ts.overlay.answer_id.copy()
                         for t, ts in s._tenants.items()},
            "spill": s.cache.spill.answer_id.copy(),
            "counts": (s.cache.hits, s.cache.misses)}


# ---------------------------------------------------------------------------
# fair_share_take
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fair_share_take_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    tenants = rng.integers(-1, 4, size=n)
    key = rng.permutation(n).astype(np.float64)
    for k in (0, 1, n // 2, n, n + 3):
        for incoming in (None, -1, 0, 3, 9):
            np.testing.assert_array_equal(
                PTen.fair_share_take(tenants, key, k, incoming=incoming),
                JTen.fair_share_take(tenants, key, k, incoming=incoming))
    # water-filling: the largest namespace gives up rows first
    v = PTen.fair_share_take(np.asarray([0, 0, 0, 0, 1, 1, 2]),
                             np.arange(7.0), 3)
    assert sorted(v.tolist()) == [0, 1, 2]


# ---------------------------------------------------------------------------
# tenant-free traffic through a tenancy-configured SISO
# ---------------------------------------------------------------------------


def _no_tenant(pkg, tenancy):
    rng = np.random.default_rng(0)
    s = _siso(pkg, capacity=12, tenancy=tenancy)
    hist = _unit(rng, 30)
    s.bootstrap(hist.copy(), hist.copy(), answer_ids=np.arange(30))
    out = []
    for k in range(40):                     # plenty of spill evictions
        q = _unit(rng, 3)
        if k % 4 == 3:                      # revisits of recorded misses
            q[:2] = hist[rng.integers(0, 30, size=2)]
        res = s.handle_batch(q.copy(), now=float(k),
                             user_ids=np.asarray([0, 1, -1]))
        out.append(res)
        for j in np.flatnonzero(~res.hit):
            s.record_llm_answer(q[j], q[j], answer_id=100 + 3 * k + j)
    out.append({"spill": s.cache.spill.answer_id.copy(),
                "lru": s.cache._spill_last_use.copy(),
                "counts": (s.cache.hits, s.cache.misses)})
    return out


def test_no_tenant_lookups_bit_identical():
    off = _no_tenant(P, "off")
    on = lockstep(_no_tenant, tenancy="on")
    assert_same(off, on)
    assert 0 < sum(int(r.hit.sum()) for r in on[:-1]) < 120


# ---------------------------------------------------------------------------
# mixed batches, anonymous rows, fair-share spill, overlays
# ---------------------------------------------------------------------------


def _repeat_escape(pkg):
    rng = np.random.default_rng(1)
    s = _siso(pkg, capacity=8)
    q = _unit(rng, 1)[0]
    s.record_llm_answer(q, q, answer_id=5)
    ids = np.asarray([7]), np.asarray([3])
    r1 = s.handle_batch(q[None], now=0.0, user_ids=ids[0], tenant_ids=ids[1])
    lru = s.cache._spill_last_use.copy()
    r2 = s.handle_batch(q[None], now=1.0, user_ids=ids[0], tenant_ids=ids[1])
    return {"r1": r1, "r2": r2, "lru_hit": lru,
            "lru_escape": s.cache._spill_last_use.copy(),
            "view": tenant_view(s)}


def test_mixed_batch_repeat_escape_restores_spill_recency():
    out = lockstep(_repeat_escape)
    assert out["r1"].hit[0] and out["r1"].region[0] == 1
    assert not out["r2"].hit[0]
    np.testing.assert_array_equal(out["lru_hit"], out["lru_escape"])
    st = out["view"]["stats"][3]
    assert (st["hits"], st["misses"]) == (1, 1)


def _anonymous(pkg):
    rng = np.random.default_rng(2)
    s = _siso(pkg, capacity=8)
    q = _unit(rng, 2)
    s.record_llm_answer(q[0], q[0], answer_id=1)
    res = s.handle_batch(q, now=0.0, user_ids=np.asarray([-1, 9]),
                         tenant_ids=np.asarray([-1, 4]))
    s.record_llm_answer(q[1], q[1], answer_id=2)
    r2 = s.handle_batch(q[0][None], now=1.0, user_ids=np.asarray([-1]),
                        tenant_ids=np.asarray([-1]))
    return {"res": res, "r2": r2, "users": sorted(s._user_last),
            "tenants": sorted(s._tenants),
            "of": s.tenants_of(np.asarray([1, 2])), "view": tenant_view(s)}


def test_anonymous_rows_create_no_tenant_state():
    out = lockstep(_anonymous)
    assert out["users"] == [9] and out["tenants"] == [4]
    assert out["of"].tolist() == [-1, -1] and out["r2"].hit[0]


def _fair_share(pkg, mode):
    rng = np.random.default_rng(3)
    vb, va = _unit(rng, 2), _unit(rng, 10)
    s = _siso(pkg, capacity=8, tenancy=mode)
    for i, v in enumerate(vb):          # the small tenant (1) writes first
        s.record_llm_answer(v, v, answer_id=100 + i,
                            tenant=1 if mode == "on" else None)
    for i, v in enumerate(va):          # then the flood (0)
        s.record_llm_answer(v, v, answer_id=200 + i,
                            tenant=0 if mode == "on" else None)
    return {"spill": s.cache.spill.answer_id.copy(),
            "lru": s.cache._spill_last_use.copy()}


def test_fair_share_spill_protects_small_tenant():
    on = lockstep(_fair_share, mode="on")
    off = lockstep(_fair_share, mode="off")
    assert {100, 101} <= set(on["spill"].tolist())
    assert not {100, 101} & set(off["spill"].tolist())


def _overlay(pkg):
    rng = np.random.default_rng(4)
    s = _siso(pkg, capacity=16)
    v1 = _unit(rng, 1)[0]
    v2 = v1 + 0.02 * rng.normal(size=D).astype(np.float32)
    v2 /= np.linalg.norm(v2)
    s.record_llm_answer(v1, v1, answer_id=1, tenant=2)   # shared spill
    s.record_llm_answer(v2, v2, answer_id=2, tenant=2)   # personal
    own = s.handle_batch(v2[None], now=0.0, tenant_ids=np.asarray([2]))
    other = s.handle_batch(v2[None], now=0.0, tenant_ids=np.asarray([-1]))
    return {"own": own, "other": other, "log": len(s._log_vecs),
            "view": tenant_view(s)}


def test_personal_answers_live_in_overlay_only():
    out = lockstep(_overlay)
    assert out["own"].region[0] == PTen.REGION_OVERLAY
    assert out["own"].answer_id[0] == 2
    assert out["other"].region[0] != PTen.REGION_OVERLAY
    assert out["other"].answer_id[0] == 1 and out["log"] == 1
    assert 2 not in out["view"]["spill"]
    assert out["view"]["stats"][2]["overlay_hits"] == 1


# ---------------------------------------------------------------------------
# per-tenant theta through SISO (the controller is tests/test_torch_siso's)
# ---------------------------------------------------------------------------


def _per_tenant_theta(pkg):
    rng = np.random.default_rng(5)
    cfg = pkg.Config(dim=D, answer_dim=D, capacity=48, theta_r=0.86,
                     dynamic_threshold=True, refresh_async=False,
                     refresh_min=10_000, tenancy=pkg.Ten.TenancyConfig())
    s = pkg.siso(cfg, slo_latency=1.0, llm_latency=0.9)
    s.threshold.lambda_window = 2.0
    hist = _unit(rng, 40)
    # a T2H sample whose best sims spread over the theta grid
    probe = hist + rng.uniform(0.0, 0.8, size=(40, 1)).astype(np.float32) \
        * rng.normal(size=(40, D)).astype(np.float32)
    s.bootstrap(hist, hist, answer_ids=np.arange(40),
                t2h_sample=probe / np.linalg.norm(probe, axis=1,
                                                  keepdims=True))
    out = []
    for k in range(30):             # tenant 1 floods, tenant 0 trickles
        tids = np.asarray([1, 1, 1, 0] if k % 3 else [1, 1, 1, 1])
        q = hist[rng.integers(0, 40, size=4)] \
            + 0.01 * rng.normal(size=(4, D)).astype(np.float32)
        q[::2] = rng.normal(size=(2, D))        # and fresh queries
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        res = s.handle_batch(q, now=0.5 * k, tenant_ids=tids)
        used = np.asarray([s.tenant_theta(int(t)) for t in tids])
        margin = float(np.abs(res.sim - used).min())
        for j in np.flatnonzero(~res.hit):
            s.record_llm_answer(q[j], q[j], answer_id=1000 + 4 * k + j,
                                tenant=int(tids[j]))
        s.observe_completion(0.9 if k % 2 else 0.1, 0.3, tenant=1)
        out.append({"res": res, "theta": (s.tenant_theta(0),
                                          s.tenant_theta(1), s.theta_r),
                    "margin": margin})
    out.append(tenant_view(s))
    return out


def test_per_tenant_theta_in_lockstep():
    out = lockstep(_per_tenant_theta)
    thetas = [o["theta"] for o in out[:-1]]
    assert any(t0 != t1 for t0, t1, _ in thetas)    # namespaces diverged
    # the inputs keep every best sim clear of the theta it was held to
    assert min(o["margin"] for o in out[:-1]) > 1e-4


# ---------------------------------------------------------------------------
# persistence of the tenancy plane
# ---------------------------------------------------------------------------


def _serve_tenants(s, rng, k0, k1, extra_tenant=-1):
    out = []
    for k in range(k0, k1):
        q = _unit(rng, 2)
        tids = np.asarray([k % 3, extra_tenant])
        res = s.handle_batch(q.copy(), now=float(k),
                             user_ids=np.asarray([0, 1]), tenant_ids=tids)
        out.append(res)
        for j in range(2):
            if not res.hit[j]:
                t = int(tids[j])
                s.record_llm_answer(q[j], q[j], answer_id=100 + 2 * k + j,
                                    tenant=t if t >= 0 else None)
    return out


def _roundtrip(pkg, restore_in):
    """Phase A in ``pkg``; its state restored into a fresh ``restore_in``
    SISO (the same or the other package); phase B on both."""
    rng = np.random.default_rng(6)
    a = _siso(pkg, capacity=12)
    hist = _unit(rng, 20)
    a.bootstrap(hist, hist, answer_ids=np.arange(20))
    _serve_tenants(a, rng, 0, 15)
    v = _unit(rng, 1)[0]
    a.record_llm_answer(v, v, answer_id=500, tenant=0)  # a personal answer
    a.record_llm_answer(v, v, answer_id=501, tenant=0)
    assert any(len(ts.overlay) for ts in a._tenants.values())
    b = _siso(restore_in, capacity=12)
    b.load_state(a.state_dict())
    b.warm_start()
    assert_same(tenant_view(a), tenant_view(b))
    state = np.random.default_rng(7)
    phase_a = _serve_tenants(a, state, 15, 25, extra_tenant=1)
    state = np.random.default_rng(7)
    phase_b = _serve_tenants(b, state, 15, 25, extra_tenant=1)
    assert_same(phase_a, phase_b)
    assert_same(tenant_view(a), tenant_view(b))
    assert a.stats() == b.stats()
    return phase_b + [tenant_view(b)]


def test_tenancy_state_roundtrip_and_lockstep():
    """Round trip within the port, in lockstep with the reference's own
    round trip; and a reference state restored into the port serves as the
    reference does."""
    ref = _roundtrip(J, J)
    assert_same(ref, _roundtrip(P, P))
    assert_same(ref, _roundtrip(J, P))


def test_pre_tenancy_snapshot_loads_clean():
    rng = np.random.default_rng(8)
    old = _siso(P, capacity=12, tenancy="off")
    hist = _unit(rng, 20)
    old.bootstrap(hist, hist, answer_ids=np.arange(20))
    st = old.state_dict()
    assert "tenancy" not in st
    new = _siso(P, capacity=12)
    new.load_state(st)
    assert new._tenants == {}
    assert new.handle_batch(_unit(rng, 1), now=0.0).hit.shape == (1,)


# ---------------------------------------------------------------------------
# the port's own save -> SIGKILL -> warm_start drill (tenants + three tiers)
# ---------------------------------------------------------------------------

_SCAFFOLD = """
import numpy as np
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.core.tiered import TieredCacheConfig

def norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)

def make(disk_dir):
    cfg = SISOConfig(dim=16, answer_dim=16, capacity=24, refresh_min=8,
                     refresh_async=False, tenancy=TenancyConfig(),
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
                             user_ids=np.arange(4) % 3,
                             tenant_ids=np.asarray([0, 1, 2, -1]))
        for b in range(4):
            if not res.hit[b]:
                s.record_llm_answer(q[b], q[b],
                                    answer_id=10_000 + 4 * (t0 + k) + b,
                                    tenant=int([0, 1, 2, -1][b]))
        s.observe_completion(0.3, 0.2, tenant=int(k % 3))
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

base = os.environ["TENANT_DRILL_DIR"]
s = make(os.path.join(base, "cold"))
populate(s)
CheckpointManager(os.path.join(base, "ckpt"), keep=2).save(
    1, {"siso": s.state_dict()})
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_tenant_save_sigkill_warmstart_equivalence(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["TENANT_DRILL_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == -signal.SIGKILL, out.stderr[-3000:]
    ns = {}
    exec(compile(_SCAFFOLD, "<tenant-scaffold>", "exec"), ns)
    s1 = ns["make"](str(tmp_path / "ref_cold"))
    ns["populate"](s1)
    step, rec = CheckpointManager(str(tmp_path / "ckpt")).restore_latest()
    assert step == 1
    s2 = ns["make"](str(tmp_path / "cold"))
    s2.load_state(rec["siso"])
    s2.warm_start()
    assert_same(tenant_view(s1), tenant_view(s2))
    assert_same(s1.cache.tier_membership(), s2.cache.tier_membership())
    ns["drive"](s1, 13, 40, 15)
    ns["drive"](s2, 13, 40, 15)
    assert_same(tenant_view(s1), tenant_view(s2))
    assert s1.stats() == s2.stats()
    assert_same(s1.cache.tier_membership(), s2.cache.tier_membership())
