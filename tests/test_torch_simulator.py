"""Port of the analytic serving model held against the JAX package: the
analytic engine for every configuration, the scenario library, the
vector-cache baselines and the paper's four-system SLO comparison
(vLLM / GPTCache / SISO-NoDTA / SISO) through the discrete-event
simulator, on the CPU at the reference tests' sizes.

The analytic engine takes the reference's device profile
(``repro.serving.engine.PEAK_FLOPS``/``HBM_BW``, eight devices) so both
packages compute the same sums; the port's own default profile is one
H100. Decisions (hit masks, hit ratios, SLO attainment, theta traces) must
be identical; other floats are held within rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.synth import SyntheticWorkload as JWorkload
from repro.serving import engine as JEng
from repro.serving.baselines import VectorCache as JVectorCache
from repro.serving.simulator import (ServingSimulator as JSimulator,
                                     bootstrap_frontend as j_bootstrap,
                                     build_system as j_build_system)
from repro.serving.workloads import build_scenario as j_build_scenario
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data.synth import SyntheticWorkload
from repro_torch.serving.baselines import NoCache, VectorCache
from repro_torch.serving.engine import (H100_BF16_FLOPS, H100_HBM_BW,
                                        AnalyticEngine, EngineModel)
from repro_torch.serving.simulator import (ServingSimulator,
                                           bootstrap_frontend, build_system)
from repro_torch.serving.workloads import SCENARIOS, build_scenario

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

REF_PROFILE = {"n_chips": 8, "peak_flops": JEng.PEAK_FLOPS,
               "hbm_bw": JEng.HBM_BW}
SYSTEMS = ["vllm", "gptcache", "siso-nodta", "siso"]
EXACT = ("name", "n", "hit_ratio", "slo_attainment", "theta_trace",
         "extras")
CLOSE = ("mean_e2e", "p99_e2e", "mean_wait", "mean_quality",
         "slo_weighted_quality")


def _model(arch="qwen3-14b"):
    return EngineModel.from_config(get_config(arch), **REF_PROFILE)


def _j_model(arch="qwen3-14b"):
    return JEng.EngineModel.from_config(j_get_config(arch), n_chips=8)


# ---------------------------------------------------------------------------
# analytic engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_model_matches_jax_for_every_arch(arch):
    t, j = _model(arch), _j_model(arch)
    for f in ("name", "n_active_params", "n_chips", "kv_bytes_per_token",
              "weight_bytes", "mfu_prefill", "bwu_decode", "overhead_s"):
        assert getattr(t, f) == getattr(j, f), f
    for tin in (1, 12, 480.5, 4096):
        np.testing.assert_allclose(t.ttft(tin), j.ttft(tin), rtol=1e-12)
        for batch in (1, 3, 4):
            np.testing.assert_allclose(t.tbt(tin, batch), j.tbt(tin, batch),
                                       rtol=1e-12)
            for tout in (1, 2, 180, 1000):
                np.testing.assert_allclose(t.e2e(tin, tout, batch),
                                           j.e2e(tin, tout, batch),
                                           rtol=1e-12)


def test_engine_model_defaults_to_one_h100():
    m = EngineModel.from_config(get_config("qwen3-14b"))
    assert (m.n_chips, m.peak_flops, m.hbm_bw) == (1, H100_BF16_FLOPS,
                                                   H100_HBM_BW)
    # one H100 decodes a 14.8B bf16 model more slowly than the reference's
    # eight devices
    assert m.tbt(100.0) > _model().tbt(100.0)


@pytest.mark.parametrize("concurrency", [1, 4])
def test_analytic_engine_submit_sequence_matches_jax(concurrency):
    rng = np.random.default_rng(5)
    arrivals = np.cumsum(rng.exponential(0.2, size=200))
    tin = rng.integers(1, 600, size=200)
    tout = rng.integers(1, 900, size=200)
    t = AnalyticEngine(_model(), concurrency)
    j = JEng.AnalyticEngine(_j_model(), concurrency)
    for a, i, o in zip(arrivals, tin, tout):
        assert t.submit(float(a), int(i), int(o)) \
            == j.submit(float(a), int(i), int(o))
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.mean_service_time(12.0, 180.0) \
        == j.mean_service_time(12.0, 180.0)


# ---------------------------------------------------------------------------
# scenario library
# ---------------------------------------------------------------------------


def _assert_batches_equal(a, b, what):
    for f in ("vectors", "answers", "cluster_ids", "user_ids", "arrivals",
              "tokens_in", "tokens_out", "is_complex"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f"{what} {f}")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_match_jax_array_for_array(name):
    kw = dict(dim=16, n_clusters=120, seed=4, n_train=200, n_test=96)
    j, t = j_build_scenario(name, **kw), build_scenario(name, **kw)
    assert (t.name, t.notes) == (j.name, j.notes)
    _assert_batches_equal(j.train, t.train, f"{name} train")
    _assert_batches_equal(j.test, t.test, f"{name} test")
    assert set(t.extras) == set(j.extras)
    for key, val in j.extras.items():
        np.testing.assert_array_equal(t.extras[key], val, err_msg=key)


def test_unknown_scenario_raises():
    with pytest.raises(ValueError, match="unknown scenario"):
        build_scenario("nope")


# ---------------------------------------------------------------------------
# vector-cache baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["lru", "lfu", "fifo", "rr", "optimal"])
def test_vector_cache_stream_matches_jax(policy):
    def run(cls):
        rng = np.random.default_rng(11)
        base = rng.normal(size=(40, 16)).astype(np.float32)
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        vc = cls(16, 16, capacity=24, policy=policy, theta_r=0.9)
        out = []
        for step in range(60):
            pick = rng.integers(0, 40, size=int(rng.integers(1, 6)))
            q = base[pick] + 0.05 * rng.normal(size=(len(pick), 16))
            q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
                np.float32)
            res = vc.lookup(q)
            out.append(res)
            for b in np.flatnonzero(~res.hit):
                vc.record(q[b], q[b], answer_id=100 * step + int(b))
        return vc, out

    j, jr = run(JVectorCache)
    t, tr = run(VectorCache)
    for a, b in zip(jr, tr):
        for f in ("hit", "sim", "answer", "answer_id", "entry", "region"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert t.stats() == j.stats()
    for key, val in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[key], val, err_msg=key)
    assert sum(r.hit.sum() for r in tr) > 20


# ---------------------------------------------------------------------------
# the four-system comparison (tests/test_serving.py's sizes)
# ---------------------------------------------------------------------------


def _four_systems(jax_side: bool, backend="dense", n_test=500):
    wl_cls = JWorkload if jax_side else SyntheticWorkload
    wl = wl_cls("quora", dim=32, n_clusters=300, seed=0)
    train = wl.sample(3000, rps=50)
    test = wl.sample(n_test, rps=12, cv=0.1)
    model = _j_model() if jax_side else _model()
    eng_cls = JEng.AnalyticEngine if jax_side else AnalyticEngine
    L = model.e2e(12, 180)
    out = {}
    kinds = SYSTEMS if backend == "dense" else ["siso"]
    for kind in kinds:
        kw = dict(dim=32, capacity=200, slo_latency=1.3 * L, llm_latency=L,
                  backend=backend)
        if jax_side:
            fe = j_build_system(kind, **kw)
            j_bootstrap(fe, train)
            sim = JSimulator(eng_cls(model, concurrency=4), fe)
        else:
            fe = build_system(kind, device="cpu", **kw)
            bootstrap_frontend(fe, train)
            sim = ServingSimulator(eng_cls(model, concurrency=4), fe)
        out[kind] = sim.run(test, name=kind)
    return out


@pytest.fixture(scope="module")
def port_results():
    return _four_systems(False)


def _assert_results_equal(j, t):
    for f in EXACT:
        assert getattr(t, f) == getattr(j, f), (t.name, f)
    for f in CLOSE:
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-6,
                                   err_msg=f"{t.name} {f}")


def test_four_system_comparison_matches_jax(port_results):
    ref = _four_systems(True)
    for kind in SYSTEMS:
        _assert_results_equal(ref[kind], port_results[kind])
    assert len(port_results["siso"].theta_trace) == 500
    assert min(port_results["siso"].theta_trace) \
        < max(port_results["siso"].theta_trace)      # theta_R adapted


def test_siso_pallas_matches_jax_interpret():
    """Backend pallas: the reference's Pallas kernel (interpret mode on the
    CPU) against the port's K1 wrapper, which runs its plain version on a
    CPU tensor."""
    ref = _four_systems(True, backend="pallas", n_test=100)["siso"]
    got = _four_systems(False, backend="pallas", n_test=100)["siso"]
    _assert_results_equal(ref, got)
    dense = _four_systems(False, n_test=100)["siso"]
    _assert_results_equal(dense, got)


# the paper's system ordering (tests/test_serving.py), on the port


def test_siso_highest_hit_ratio(port_results):
    r = port_results
    assert r["siso"].hit_ratio >= r["siso-nodta"].hit_ratio \
        >= r["gptcache"].hit_ratio > r["vllm"].hit_ratio == 0.0


def test_siso_highest_slo_attainment(port_results):
    r = port_results
    assert r["siso"].slo_attainment >= r["gptcache"].slo_attainment
    assert r["siso"].slo_attainment > r["vllm"].slo_attainment


def test_caching_reduces_latency(port_results):
    assert port_results["siso"].mean_e2e < port_results["vllm"].mean_e2e


def test_slo_weighted_quality_ordering(port_results):
    r = port_results
    assert r["siso"].slo_weighted_quality > r["vllm"].slo_weighted_quality


def test_vllm_quality_is_exact(port_results):
    assert port_results["vllm"].mean_quality == pytest.approx(1.0)


def test_straggler_hedging_matches_jax():
    def run(jax_side, hedge):
        wl = (JWorkload if jax_side else SyntheticWorkload)(
            "quora", dim=16, n_clusters=100, seed=1)
        test = wl.sample(300, rps=2.0)
        sim_cls = JSimulator if jax_side else ServingSimulator
        eng = (JEng.AnalyticEngine(_j_model(), 4) if jax_side
               else AnalyticEngine(_model(), 4))
        fe = None if jax_side else NoCache()
        return sim_cls(eng, fe, jitter_cv=1.0, hedge_threshold=hedge,
                       seed=3).run(test, "hedged" if hedge else "base")

    rb, rh = run(False, 0.0), run(False, 1.5)
    assert rh.extras["hedged"] > 0
    assert rh.p99_e2e <= rb.p99_e2e * 1.05
    _assert_results_equal(run(True, 1.5), rh)
