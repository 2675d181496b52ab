"""The port's examples (``examples/torch_{quickstart,serve_with_siso,
train_embedder}.py``) on the CPU, held against the reference's.

* quickstart: the reference script at its own size (``runpy``, its
  printed lines read back) and the port's ``run(device="cpu")``: the
  same printed lines word for word (bootstrap, hit/miss counts, hit
  answer quality to its printed digits, no refresh), then the launches.
* serve_with_siso: the reference's script draws bf16 weights from jax's
  PRNG and reads the wall clock, so at its 40 requests the port's
  ``run`` is held against the reference's library calls in the script's
  flow, both on the reference's weights (the port's carried over by
  ``weights``) in f32 and on one tick clock: per request id the same
  path and tokens, and the same report counts. The port's script itself
  runs on its own weights.
* train_embedder: the reference's script at its 400 steps takes minutes,
  so its loop (its own ``make_corpus``/``info_nce``, the reference's
  AdamW, one numpy stream) at 12 steps of 16 pairs is held against
  ``launch.train_embedder.train`` from the same weights: losses and the
  dup/non-dup medians within 2e-4, the gap's sign and widening the same.
  The port's script runs at 100 steps, where its own weights widen the
  gap.

Each script prints its kernel launches last; on the CPU they are 0.
"""
import importlib.util
import io
import itertools
import json
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import weights

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "").replace("-", "_"), EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *a, **k):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue().splitlines()


def _launches(lines) -> dict:
    assert lines[-1].startswith("kernel launches: "), lines[-1]
    return json.loads(lines[-1][len("kernel launches: "):])


def test_quickstart_matches_the_reference():
    port = _load("torch_quickstart.py")
    _, ref_lines = _run(runpy.run_path, str(EXAMPLES / "quickstart.py"))
    res, lines = _run(port.run, "cpu", "dense")
    # the reference's lines, word for word, then the launches (0 on CPU)
    assert lines[:-1] == ref_lines, (lines, ref_lines)
    assert _launches(lines) == {"cosine_topk": 0, "cosine_topk_q8": 0}
    s = res["stats"]
    assert s["hits"] + s["misses"] == 2000 == len(res["hits"])
    assert s["hits"] == sum(res["hits"])
    assert abs(res["quality"] - float(ref_lines[1].rsplit("=", 1)[1])) \
        <= 5e-4


# ---------------------------------------------------------------------------
# serve_with_siso
# ---------------------------------------------------------------------------

N_SERVE = 40


def _serve_reference(stream, jep, jmp, jecfg, jmcfg):
    """The reference script's flow, by its library calls, at the stream's
    size, on a tick clock."""
    from repro.core.siso import SISO as JSISO, SISOConfig as JConfig
    from repro.data.tokenizer import HashTokenizer as JTok
    from repro.models import embedder as JE
    from repro.serving.engine import ModelEngine as JEngine
    from repro.serving.gateway import (GatewayRequest as JRequest,
                                       ServingGateway as JGateway)
    tok = JTok(vocab_size=jecfg.vocab_size, max_len=24)
    engine = JEngine(jmp, jmcfg, n_slots=3, max_len=96)
    encode = jax.jit(lambda p, i, m: JE.encode(p, jecfg, i, m))

    def enc(ids, mask):
        return np.asarray(encode(jep, jnp.asarray(ids), jnp.asarray(mask)))

    def embed_tokens(batches):
        return enc(np.stack([t[0] for t in batches]),
                   np.stack([t[1] for t in batches]))

    def answer_embed(out_tokens):
        return enc(*tok.encode_batch([" ".join(f"t{t}"
                                               for t in out_tokens)]))[0]
    siso = JSISO(JConfig(dim=jecfg.d_model, answer_dim=jecfg.d_model,
                         capacity=64, theta_r=0.95, dynamic_threshold=False,
                         refresh_min=16))
    ticks = itertools.count()
    gw = JGateway(siso, engine, embed_fn=embed_tokens,
                  answer_fn=answer_embed, clock=lambda: float(next(ticks)))
    for base in range(0, len(stream), 4):
        reqs = []
        for off, (_, text) in enumerate(stream[base:base + 4]):
            ids, mask = tok.encode_batch([text])
            prompt = np.asarray(tok.tokenize(text)[:12], np.int32) \
                % jmcfg.vocab_size
            reqs.append(JRequest(rid=base + off, model_tokens=prompt,
                                 embed_tokens=(ids[0], mask[0]), max_new=8))
        gw.submit(reqs)
    done = gw.drain()
    return ({r.rid: (r.served_by, [int(t) for t in r.out]) for r in done},
            gw.report(), siso.stats())


COUNTS = ("submitted", "completed", "served_cache", "served_engine",
          "refreshes", "hits", "misses", "n_centroids", "n_spill",
          "dev_rebuilds", "dev_row_writes", "dev_swaps")


def test_serve_with_siso_matches_the_reference():
    from repro.configs.base import get_config as j_get_config
    from repro.models import embedder as JE, lm as JLM
    from repro_torch.configs.base import get_config
    port = _load("torch_serve_with_siso.py")
    jecfg = j_get_config("siso-embedder").reduced().replace(dtype="float32")
    jmcfg = j_get_config("qwen3-14b").reduced().replace(remat=False,
                                                        dtype="float32")
    jep = JE.init_params(jax.random.PRNGKey(1), jecfg)
    jmp = JLM.init_params(jax.random.PRNGKey(2), jmcfg)
    mcfg = get_config("qwen3-14b").reduced().replace(remat=False,
                                                     dtype="float32")
    stream = port.make_stream(N_SERVE)
    ref_served, ref_rep, ref_stats = _serve_reference(stream, jep, jmp,
                                                      jecfg, jmcfg)
    ticks = itertools.count()
    res, lines = _run(
        port.run, "cpu", "dense", N_SERVE,
        eparams=weights.convert_embedder(jax.tree.map(np.asarray, jep),
                                         "cpu"),
        mparams=weights.convert_lm(jax.tree.map(np.asarray, jmp), mcfg,
                                   "cpu"),
        mcfg=mcfg, clock=lambda: float(next(ticks)))
    assert res["served"] == ref_served
    for k in COUNTS:
        assert res["report"][k] == ref_rep[k], k
    for k in ("hits", "misses", "n_centroids", "n_spill", "refresh_cycles"):
        assert res["stats"][k] == ref_stats[k], k
    assert 0 < res["report"]["served_cache"] < N_SERVE
    assert lines[0].startswith(f"served {N_SERVE} requests in ")
    assert _launches(lines) == dict.fromkeys(port.LAUNCHES, 0)


def test_serve_with_siso_script_runs_on_the_cpu():
    port = _load("torch_serve_with_siso.py")
    rc, lines = _run(port.main, ["--device", "cpu"])
    assert rc == 0
    assert lines[0].startswith("served 40 requests in ")
    assert lines[3].startswith("sample engine completion (rid=")
    assert _launches(lines) == dict.fromkeys(port.LAUNCHES, 0)


# ---------------------------------------------------------------------------
# train_embedder
# ---------------------------------------------------------------------------

EMB_STEPS, EMB_BATCH, EMB_LR = 12, 16, 2e-3


def _embedder_reference(jp, jcfg, seed: int = 0):
    """The reference script's loop at EMB_STEPS steps of EMB_BATCH pairs:
    (before, after, losses), each (dup, nondup) the medians."""
    from repro.data.tokenizer import HashTokenizer as JTok
    from repro.models import embedder as JE
    from repro.training import optimizer as jopt
    ref = _load("train_embedder.py")
    tok = JTok(vocab_size=jcfg.vocab_size, max_len=24)
    rng = np.random.default_rng(seed)
    sentence = ref.make_corpus(rng)
    state = jopt.init_state(jp)
    optc = jopt.AdamWConfig(lr=EMB_LR, warmup_steps=5, total_steps=EMB_STEPS,
                            weight_decay=0.01)

    @jax.jit
    def step(params, state, a_ids, a_mask, b_ids, b_mask):
        loss, grads = jax.value_and_grad(ref.info_nce)(
            params, jcfg, a_ids, a_mask, b_ids, b_mask)
        params, state, _ = jopt.apply_updates(params, grads, state, optc)
        return params, state, loss

    def gap(params, n=128):
        topics = rng.integers(0, 64, size=n)
        a = [sentence(t) for t in topics]
        b = [sentence(t) for t in topics]
        c = [sentence((t + 1 + rng.integers(62)) % 64) for t in topics]
        z = [JE.encode(params, jcfg, *map(jnp.asarray, tok.encode_batch(x)))
             for x in (a, b, c)]
        return (float(jnp.median(jnp.sum(z[0] * z[1], -1))),
                float(jnp.median(jnp.sum(z[0] * z[2], -1))))

    params = jp
    before = gap(params)
    losses = []
    for _ in range(EMB_STEPS):
        topics = rng.integers(0, 64, size=EMB_BATCH)
        a = [sentence(t) for t in topics]
        b = [sentence(t) for t in topics]
        ai, am = tok.encode_batch(a)
        bi, bm = tok.encode_batch(b)
        params, state, loss = step(params, state, *map(jnp.asarray,
                                                       (ai, am, bi, bm)))
        losses.append(float(loss))
    return before, gap(params), losses


def test_train_embedder_matches_the_reference():
    from repro.configs.base import get_config as j_get_config
    from repro.models import embedder as JE
    from repro_torch.launch import train_embedder
    jcfg = j_get_config("siso-embedder").reduced().replace(dtype="float32")
    jp = JE.init_params(jax.random.PRNGKey(0), jcfg)
    before, after, losses = _embedder_reference(jp, jcfg)
    res, _ = _run(train_embedder.train, EMB_STEPS, EMB_BATCH, EMB_LR, 0,
                  device="cpu", log_every=0,
                  params=weights.convert_embedder(
                      jax.tree.map(np.asarray, jp), "cpu"))
    np.testing.assert_allclose(res["losses"], losses, atol=2e-4)
    for got, want in ((res["before"], before), (res["after"], after)):
        np.testing.assert_allclose(got, want, atol=2e-4)
        assert (got[0] > got[1]) == (want[0] > want[1])
    widened = lambda b, a: (a[0] - a[1]) > (b[0] - b[1])
    assert widened(res["before"], res["after"]) == widened(before, after)


def test_train_embedder_script_runs_on_the_cpu():
    port = _load("torch_train_embedder.py")
    rc, lines = _run(port.main, ["--device", "cpu", "--steps", "100"])
    assert rc == 0
    assert lines[0].startswith("before: dup=")
    assert lines[-3].startswith("after:  dup=")
    assert lines[-2] == "gap widened — embedder learned paraphrase " \
                        "similarity."
    assert _launches(lines) == {"flash_attention_f32": 0,
                                "flash_attention_bwd_f32_one_pass": 0}
