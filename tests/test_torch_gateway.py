"""Port of the serving front (gateway + continuous-batching scheduler +
ModelEngine) held against the JAX package on a short serve_with_siso-style
stream: text -> hash tokens -> embedder -> SISO lookup -> hit inline or
engine miss -> answer recorded back -> refresh. Per request id the
serving path and the generated tokens must be identical, and so must the
report's counts. Reduced configs in fp32, on the CPU.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
from repro.models import embedder as JE, lm as JLM
from repro.serving.engine import ModelEngine as JEngine
from repro.serving.gateway import (GatewayRequest as JRequest,
                                   ServingGateway as JGateway)
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import embedder as TE
from repro_torch.serving.config import (CacheConfig, PersistenceConfig,
                                        ServingConfig)
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.gateway import GatewayRequest, ServingGateway

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

TOPICS = {
    "caching": ["what is semantic caching", "explain semantic caching",
                "how does a semantic cache work"],
    "slo": ["what is an slo", "explain service level objectives"],
    "llm": ["how do llms generate text", "explain llm decoding"],
    "weather": ["will it rain tomorrow in seoul"],
}


def _stream(n=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        topic = rng.choice(list(TOPICS))
        out.append(str(rng.choice(TOPICS[topic])))
    return out


def _serve(jax_side: bool, backend: str):
    ecfg = get_config("siso-embedder").reduced().replace(dtype="float32")
    mcfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    jecfg = j_get_config("siso-embedder").reduced().replace(dtype="float32")
    jmcfg = j_get_config("qwen3-14b").reduced().replace(dtype="float32")
    jep = JE.init_params(jax.random.PRNGKey(1), jecfg)
    jmp = JLM.init_params(jax.random.PRNGKey(2), jmcfg)
    tok = HashTokenizer(vocab_size=ecfg.vocab_size, max_len=24)
    if jax_side:
        jit_encode = jax.jit(lambda p, i, m: JE.encode(p, jecfg, i, m))

        def encode(ids, mask):
            return np.asarray(jit_encode(jep, jnp.asarray(ids),
                                         jnp.asarray(mask)))
        engine = JEngine(jmp, jmcfg, n_slots=3, max_len=48)
        siso_cls, cfg_cls, gw_cls, req_cls, kw = (JSISO, JConfig, JGateway,
                                                  JRequest, {})
    else:
        tep = weights.convert_embedder(jax.tree.map(np.asarray, jep), "cpu")
        tmp = weights.convert_lm(jax.tree.map(np.asarray, jmp), mcfg, "cpu")

        def encode(ids, mask):
            return TE.encode(tep, ecfg, torch.from_numpy(ids),
                             torch.from_numpy(mask)).numpy()
        engine = ModelEngine(tmp, mcfg, n_slots=3, max_len=48, device="cpu")
        siso_cls, cfg_cls, gw_cls, req_cls, kw = (SISO, SISOConfig,
                                                  ServingGateway,
                                                  GatewayRequest,
                                                  {"device": "cpu"})
    siso = siso_cls(cfg_cls(dim=ecfg.d_model, answer_dim=ecfg.d_model,
                            capacity=64, theta_r=0.95, backend=backend,
                            dynamic_threshold=False, refresh_min=8), **kw)

    def embed_tokens(batches):
        return encode(np.stack([t[0] for t in batches]),
                      np.stack([t[1] for t in batches]))

    def answer_embed(out_tokens):
        ids, mask = tok.encode_batch([" ".join(f"t{t}" for t in out_tokens)])
        return encode(ids, mask)[0]

    ticks = itertools.count()
    gw = gw_cls(siso, engine, embed_fn=embed_tokens, answer_fn=answer_embed,
                clock=lambda: float(next(ticks)))
    texts = _stream()
    for base in range(0, len(texts), 4):
        reqs = []
        for rid, text in enumerate(texts[base:base + 4], start=base):
            ids, mask = tok.encode_batch([text])
            # fixed-length prompts: one prefill shape for the JAX jit
            prompt = np.resize(np.asarray(tok.tokenize(text), np.int32),
                               8) % mcfg.vocab_size
            reqs.append(req_cls(rid=rid, model_tokens=prompt,
                                embed_tokens=(ids[0], mask[0]), max_new=5))
        gw.submit(reqs)
    done = gw.drain()
    return {r.rid: (r.served_by, list(map(int, r.out))) for r in done}, \
        gw.report()


COUNTS = ("submitted", "completed", "served_cache", "served_engine",
          "refreshes", "hits", "misses", "n_centroids", "n_spill",
          "dev_rebuilds", "dev_row_writes", "dev_swaps")


def test_gateway_stream_matches_jax():
    jd, jrep = _serve(True, "pallas")
    td, trep = _serve(False, "pallas")
    assert td == jd
    for key in COUNTS:
        assert trep[key] == jrep[key], key
    assert trep["served_cache"] > 0 and trep["served_engine"] > 0
    assert trep["completed"] == 24


def test_port_backends_serve_identically():
    """dense, K1 and K2 + rescore give the same serving decisions."""
    ref, rrep = _serve(False, "dense")
    for backend in ("pallas", "pallas_q8"):
        out, rep = _serve(False, backend)
        assert out == ref, backend
        for key in COUNTS:
            assert rep[key] == rrep[key], (backend, key)
    assert rep["quant_fallbacks"] == 0 and rep["quant_rescored"] > 0


def test_gateway_edge_paths():
    class Stub:
        n_slots, max_len = 1, 8
        pos = np.zeros(1, np.int32)

        def free_slots(self):
            return []

    siso = SISO(SISOConfig(dim=8, answer_dim=8, capacity=8), device="cpu")
    gw = ServingGateway(siso, Stub(), embed_fn=lambda vs: np.stack(vs))
    assert gw.submit([]).shape == (0,)
    with pytest.raises(ValueError, match="mixed batch"):
        gw.submit([GatewayRequest(0, np.ones(2), np.ones(8)),
                   GatewayRequest(1, np.ones(8))])
    with pytest.raises(NotImplementedError):
        gw.attach_persistence("unused")
    cfg = ServingConfig(cache=CacheConfig(dim=8, answer_dim=8, capacity=8),
                        persistence=PersistenceConfig(directory="snapshots"))
    with pytest.raises(NotImplementedError, match="persistence"):
        ServingGateway.from_config(cfg, engine=Stub(),
                                   embed_fn=lambda vs: np.stack(vs))
