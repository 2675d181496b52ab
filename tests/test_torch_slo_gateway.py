"""The live SLO harness through both packages: the scenario library's
streams driven through the real ``ServingGateway`` over a continuous-
batching ``ModelEngine`` (reduced qwen3, fp32, on the CPU) under a virtual
clock, for SISO (built with ``ServingGateway.from_config``), VectorCache
and NoCache, at ``benchmarks/bench_slo.py --smoke``'s configuration.

Per request id the serving path must be identical, and so must the
theta_R trace and the report's counts; SISO must reach at least
VectorCache's hit ratio and SLO attainment (bench_slo's own checks).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import lm as JLM
from repro.serving.baselines import NoCache as JNoCache, \
    VectorCache as JVectorCache
from repro.serving.config import CacheConfig as JCacheConfig, \
    RefreshConfig as JRefreshConfig, ServingConfig as JServingConfig
from repro.serving.engine import ModelEngine as JEngine
from repro.serving.gateway import GatewayRequest as JRequest, \
    ServingGateway as JGateway
from repro.serving.simulator import bootstrap_frontend as j_bootstrap
from repro.serving.workloads import build_scenario as j_build_scenario
from repro_torch.configs.base import get_config
from repro_torch.models import lm as TLM
from repro_torch.serving import CacheFrontend
from repro_torch.serving.baselines import NoCache, VectorCache
from repro_torch.serving.config import CacheConfig, RefreshConfig, \
    ServingConfig
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.gateway import GatewayRequest, ServingGateway
from repro_torch.serving.simulator import bootstrap_frontend
from repro_torch.serving.workloads import build_scenario

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

# bench_slo's settings; --smoke sizes
DIM, N_CLUSTERS, CAPACITY, THETA_R = 32, 240, 160, 0.86
N_SLOTS, MAX_NEW, TICK_S, LAMBDA_WINDOW = 2, 6, 0.05, 2.0
SLO_S = 1.3 * MAX_NEW * TICK_S
N_TRAIN, N_TEST = 240, 40
SYSTEMS = ("siso", "vectorcache", "nocache")
COUNTS = ("submitted", "completed", "served_cache", "served_engine",
          "refreshes", "slo_attainment", "hit_ratio")


class VirtualClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def drive(gw, request_cls, clock, batch, vocab, seed=0, chunk=8,
          max_ticks=20_000):
    """bench_slo's discrete-event drive loop: submit arrivals as they come
    due, one engine tick per TICK_S of virtual time, jump idle gaps."""
    rng = np.random.default_rng(seed)
    n = len(batch.vectors)
    toks = rng.integers(0, vocab, size=(n, 6)).astype(np.int32)
    i = 0
    for _ in range(max_ticks):
        if i >= n and not gw.sched.queue and not gw.sched.active:
            return
        due = []
        while i < n and batch.arrivals[i] <= clock.t:
            due.append(request_cls(
                rid=i, model_tokens=toks[i], embed_tokens=batch.vectors[i],
                user_id=int(batch.user_ids[i]), max_new=MAX_NEW,
                answer_vec=batch.answers[i]))
            i += 1
        if due:
            for j in range(0, len(due), chunk):
                gw.submit(due[j: j + chunk], now=clock.t)
                clock.t += TICK_S
        else:
            gw.step()
            clock.t += TICK_S
        if (not gw.sched.active and not gw.sched.queue and i < n
                and batch.arrivals[i] > clock.t):
            clock.t = float(batch.arrivals[i])
    raise RuntimeError("drive loop exceeded max_ticks")


def _serving_config(jax_side):
    C, R, S = ((JCacheConfig, JRefreshConfig, JServingConfig) if jax_side
               else (CacheConfig, RefreshConfig, ServingConfig))
    return S(cache=C(dim=DIM, answer_dim=DIM, capacity=CAPACITY,
                     theta_r=THETA_R, dynamic_threshold=True),
             refresh=R(async_pipeline=False),
             slo_latency=SLO_S, llm_latency=0.2 * MAX_NEW * TICK_S)


def _run(jax_side, scenario):
    build = j_build_scenario if jax_side else build_scenario
    scn = build(scenario, dim=DIM, n_clusters=N_CLUSTERS, seed=0,
                n_train=N_TRAIN, n_test=N_TEST)
    if jax_side:
        cfg = j_get_config("qwen3-14b").reduced().replace(remat=False,
                                                          dtype="float32")
        eng = JEngine(JLM.init_params(jax.random.PRNGKey(0), cfg), cfg,
                      n_slots=N_SLOTS, max_len=48)
    else:
        cfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
        eng = ModelEngine(TLM.init_params(torch.Generator().manual_seed(0),
                                          cfg, device="cpu"),
                          cfg, n_slots=N_SLOTS, max_len=48, device="cpu")
    gw_cls, req_cls, boot = ((JGateway, JRequest, j_bootstrap) if jax_side
                             else (ServingGateway, GatewayRequest,
                                   bootstrap_frontend))
    out = {}
    for kind in SYSTEMS:
        clock = VirtualClock()
        embed = lambda vs: np.stack(vs)      # noqa: E731 (pre-embedded)
        if kind == "siso":
            gw = gw_cls.from_config(_serving_config(jax_side), engine=eng,
                                    embed_fn=embed, clock=clock)
            gw.frontend.threshold.lambda_window = LAMBDA_WINDOW
        else:
            fe = ((JNoCache if jax_side else NoCache)() if kind == "nocache"
                  else (JVectorCache if jax_side else VectorCache)(
                      DIM, DIM, CAPACITY, policy="lru", theta_r=THETA_R))
            gw = gw_cls(fe, eng, embed_fn=embed, clock=clock,
                        slo_latency=SLO_S)
        boot(gw.frontend, scn.train)
        drive(gw, req_cls, clock, scn.test, cfg.vocab_size, seed=1)
        rep = gw.report()
        out[kind] = {"served": {r.rid: r.served_by for r in gw.done},
                     "theta": rep.get("theta_trace"), "report": rep,
                     "frontend": gw.frontend, "virtual_s": clock.t}
    return out


@pytest.mark.parametrize("scenario", ["repeat_heavy", "topic_drift"])
def test_live_slo_harness_matches_jax(scenario):
    ref, got = _run(True, scenario), _run(False, scenario)
    for kind in SYSTEMS:
        r, g = ref[kind], got[kind]
        assert isinstance(g["frontend"], CacheFrontend)
        assert g["served"] == r["served"], kind
        assert len(g["served"]) == N_TEST, kind
        assert g["theta"] == r["theta"], kind
        assert g["virtual_s"] == r["virtual_s"], kind
        for key in COUNTS:
            assert g["report"].get(key) == r["report"].get(key), (kind, key)
    s, v = got["siso"]["report"], got["vectorcache"]["report"]
    assert s["served_cache"] > 0 and s["served_engine"] > 0
    assert s["hit_ratio"] >= v["hit_ratio"]
    assert s["slo_attainment"] >= v["slo_attainment"]
    assert got["nocache"]["report"]["served_cache"] == 0
    assert got["siso"]["frontend"].device.type == "cpu"   # the engine's
