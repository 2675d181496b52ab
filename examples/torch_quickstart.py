"""Quickstart with the PyTorch port: the SISO semantic cache in ~60 lines
(the port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
  PYTHONPATH=src python examples/torch_quickstart.py --backend pallas

1. Generate a calibrated query workload (stand-in for a production log).
2. SISO-Cluster: cluster history into centroids; fill the cache.
3. Serve: lookups at theta_R; misses go to the "LLM" and are logged.
4. SISO-CacheManager: refresh (Algorithm 1) when +10% new queries arrive.

The cache's device mirror lives on ``--device`` (``cuda`` by default; on
``cpu`` every lookup runs the kernels' plain versions). ``--backend``
picks the lookup: ``dense`` (the reference's default, a torch matmul),
``pallas`` (K1, the f32 cosine top-k kernel) or ``pallas_q8`` (K2, the
int8 kernel, with the exact rescore). The last line gives the kernels'
launches.
"""
import argparse
import json

import numpy as np

from repro_torch.core.siso import SISO, SISOConfig
from repro_torch.data.synth import SyntheticWorkload
from repro_torch.device import resolve_device
from repro_torch.kernels.cosine_topk import ops as ctk_ops

DIM = 64


def run(device="cuda", backend: str = "dense") -> dict:
    dev = resolve_device(device)
    k1, k2 = ctk_ops.cosine_topk.launches, ctk_ops.cosine_topk_q8.launches
    # --- 1. history + system -------------------------------------------------
    wl = SyntheticWorkload("quora", dim=DIM, n_clusters=800, seed=0)
    history = wl.sample(20_000, rps=100.0)
    siso = SISO(SISOConfig(dim=DIM, answer_dim=DIM, capacity=1024,
                           theta_c=0.86, theta_r=0.86,
                           dynamic_threshold=False, backend=backend),
                device=dev)

    # --- 2. offline path: cluster history into the cache ----------------------
    stats = siso.bootstrap(history.vectors, history.answers,
                           answer_ids=np.arange(len(history.vectors)))
    print(f"bootstrap: +{stats.added} centroids, {stats.evicted} filtered -> "
          f"{len(siso.cache.centroids)} cached (capacity "
          f"{siso.cfg.capacity})")

    # --- 3. online path --------------------------------------------------------
    test = wl.sample(2_000, rps=20.0)
    quality, hits = [], []
    for i in range(len(test.vectors)):
        res = siso.handle_batch(test.vectors[i], now=float(test.arrivals[i]),
                                user_ids=test.user_ids[i:i + 1])
        hits.append(bool(res.hit[0]))
        if res.hit[0]:
            quality.append(float(res.answer[0] @ test.answers[i]))
        else:  # miss -> "LLM" generates the answer; SISO logs it
            siso.record_llm_answer(test.vectors[i], test.answers[i],
                                   answer_id=i)

    s = siso.stats()
    print(f"serving:   hit_ratio={s['hit_ratio']:.3f} "
          f"({s['hits']} hits / {s['misses']} misses), "
          f"hit answer quality={np.mean(quality):.3f}")

    # --- 4. periodic refresh (Algorithm 1) -------------------------------------
    refresh = None
    if siso.needs_refresh():
        r = siso.refresh()
        refresh = (r.merged, r.added, r.evicted)
        print(f"refresh:   merged={r.merged} added={r.added} "
              f"evicted={r.evicted} -> {len(siso.cache.centroids)} centroids")
    print("done.")
    launches = {"cosine_topk": ctk_ops.cosine_topk.launches - k1,
                "cosine_topk_q8": ctk_ops.cosine_topk_q8.launches - k2}
    print(f"kernel launches: {json.dumps(launches)}")
    return {"bootstrap": (stats.added, stats.evicted,
                          len(siso.cache.centroids)),
            "stats": s, "quality": float(np.mean(quality)), "hits": hits,
            "refresh": refresh, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "pallas", "pallas_q8"])
    args = ap.parse_args(argv)
    run(args.device, args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
