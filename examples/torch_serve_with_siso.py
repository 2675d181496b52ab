"""End-to-end serving driver with the PyTorch port: TEXT requests ->
ServingGateway over a real (reduced) qwen3 model (the port of
``examples/serve_with_siso.py``).

  PYTHONPATH=src python examples/torch_serve_with_siso.py
  PYTHONPATH=src python examples/torch_serve_with_siso.py --device cpu
  PYTHONPATH=src python examples/torch_serve_with_siso.py --backend pallas

The full Fig. 8 pipeline with real tensors end to end, wired through the
one-object gateway (DESIGN.md §7):
  * requests are strings, tokenized twice: hash tokens for the ALBERT
    embedder (cache key) and model tokens for the LLM;
  * the gateway embeds each batch once, runs one batched cache lookup,
    answers paraphrase repeats inline, and feeds only the miss stream to
    prefill and the batched decode;
  * completed answers are recorded back (answer embedding = embedder over
    the generated tokens) and the Algorithm-1 refresh fires automatically
    once enough new queries accumulate.

The models and the cache live on ``--device`` (``cuda`` by default: K4
in the embedder and the prefill, K3 in every decode step; on ``cpu``
their plain versions). ``--backend`` picks the lookup as in
``torch_quickstart.py`` (``pallas``: K1, ``pallas_q8``: K2). The last
line gives the kernels' launches.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.launch.serve import kernel_launches
from repro_torch.models import embedder as E, lm
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.gateway import GatewayRequest, ServingGateway

SEED = 0
TOPICS = {
    "caching":   ["what is semantic caching", "explain semantic caching",
                  "how does a semantic cache work", "define semantic caching"],
    "slo":       ["what is an slo", "explain service level objectives",
                  "service level objective meaning"],
    "llm":       ["how do llms generate text", "explain llm decoding",
                  "how does an llm produce output"],
    "weather":   ["will it rain tomorrow in seoul",
                  "seoul weather forecast tomorrow"],
}
LAUNCHES = ("cosine_topk", "cosine_topk_q8", "flash_attention",
            "flash_attention_f32", "decode_attention")


def make_stream(n: int, seed: int = SEED) -> list:
    """(topic, text) pairs, paraphrase-heavy like a production log."""
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(n):
        topic = rng.choice(list(TOPICS))
        stream.append((topic, str(rng.choice(TOPICS[topic]))))
    return stream


def run(device="cuda", backend: str = "dense", n_requests: int = 40,
        eparams=None, mparams=None, mcfg=None, clock=None) -> dict:
    """Serve ``n_requests`` requests; returns the report, the served-by and
    tokens per request id, the cache's stats and the launches. The
    parameters (``eparams``, ``mparams``, the model's ``mcfg``) and the
    gateway's ``clock`` are drawn here unless given (a test passes the
    reference's weights and a tick clock)."""
    dev = resolve_device(device)
    base = kernel_launches()
    # --- models ---
    ecfg = get_config("siso-embedder").reduced().replace(dtype="float32")
    if eparams is None:
        eparams = E.init_params(torch.Generator(device=dev).manual_seed(1),
                                ecfg, dev)
    tok = HashTokenizer(vocab_size=ecfg.vocab_size, max_len=24)
    mcfg = mcfg or get_config("qwen3-14b").reduced().replace(remat=False)
    if mparams is None:
        mparams = lm.init_params(torch.Generator(device=dev).manual_seed(2),
                                 mcfg, dev)
    engine = ModelEngine(mparams, mcfg, n_slots=3, max_len=96, device=dev)

    @torch.no_grad()
    def encode(ids, mask) -> np.ndarray:
        return E.encode(eparams, ecfg, torch.from_numpy(ids).to(dev),
                        torch.from_numpy(mask).to(dev)).cpu().numpy()

    def embed_texts(texts: list[str]) -> np.ndarray:
        return encode(*tok.encode_batch(texts))

    def embed_tokens(token_batches) -> np.ndarray:
        """Gateway embed hook: pre-tokenized (ids, mask) rows, one batched
        encoder call for the whole request batch."""
        return encode(np.stack([t[0] for t in token_batches]),
                      np.stack([t[1] for t in token_batches]))

    siso = SISO(SISOConfig(dim=ecfg.d_model, answer_dim=ecfg.d_model,
                           capacity=64, theta_r=0.95,
                           dynamic_threshold=False, backend=backend,
                           refresh_min=16),   # small cold-start floor so a
                device=dev)                   # refresh fires within the demo

    def answer_embed(out_tokens: np.ndarray) -> np.ndarray:
        text = " ".join(f"t{t}" for t in out_tokens)
        return embed_texts([text])[0]

    gw = ServingGateway(siso, engine, embed_fn=embed_tokens,
                        answer_fn=answer_embed, clock=clock)

    stream = make_stream(n_requests)
    t0 = time.time()
    batch_size = 4
    for base_rid in range(0, len(stream), batch_size):
        chunk = stream[base_rid: base_rid + batch_size]
        reqs = []
        for off, (topic, text) in enumerate(chunk):
            rid = base_rid + off
            ids, mask = tok.encode_batch([text])
            prompt = np.asarray(tok.tokenize(text)[:12], np.int32) \
                % mcfg.vocab_size
            reqs.append(GatewayRequest(rid=rid, model_tokens=prompt,
                                       embed_tokens=(ids[0], mask[0]),
                                       max_new=8))
        gw.submit(reqs)
    done = gw.drain()
    dt = time.time() - t0

    rep = gw.report()
    print(f"served {rep['completed']} requests in {dt:.1f}s — "
          f"{rep['served_cache']} from cache, "
          f"{rep['served_engine']} through the engine")
    print(f"lookup latency: p50={rep['lookup']['p50_ms']:.2f}ms "
          f"p99={rep['lookup']['p99_ms']:.2f}ms | device mirror: "
          f"{rep['dev_rebuilds']} rebuilds, {rep['dev_row_writes']} row "
          f"patches")
    stats = siso.stats()
    print(f"cache stats: {stats}")
    sample = [r for r in done if r.served_by == "engine"][0]
    print(f"sample engine completion (rid={sample.rid}): {sample.out}")
    now = kernel_launches()
    launches = {k: now[k] - base[k] for k in LAUNCHES}
    print(f"kernel launches: {json.dumps(launches)}")
    return {"report": rep, "stats": stats, "launches": launches,
            "served": {r.rid: (r.served_by, [int(t) for t in r.out])
                       for r in done}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "pallas", "pallas_q8"])
    args = ap.parse_args(argv)
    res = run(args.device, args.backend)
    rep = res["report"]
    assert rep["completed"] == 40
    assert rep["served_cache"] > 0, "paraphrase repeats should hit the cache"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
