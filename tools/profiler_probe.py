#!/usr/bin/env python3
"""Count the device records torch.profiler returns for sessions of known
work on one CUDA card.

    KINETO_LOG_LEVEL=1 python3 tools/profiler_probe.py [--out FILE]

Each of SESSIONS sessions profiles CALLS launches of one elementwise kernel
and must hold CALLS device records; every EVERY sessions a session of BIG
launches runs first (the traces late in chip_smoke follow long profiled
runs). The script prints how many sessions came back short and by how
much, and with ``KINETO_LOG_LEVEL=1`` in the environment the profiler's own
log gives, per session, the GPU records it processed and why it dropped
some ("Record counts: Out-of-range = ..."). ``--out`` writes every
session's count as JSON. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

SESSIONS, CALLS, BIG, EVERY = 1500, 20, 20000, 300


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profiler_probe.py: no CUDA device", file=sys.stderr)
        return 2
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.randn(1 << 16, device="cuda")

    def session(n: int) -> int:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(n):
                x.mul(2.0)
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))

    t0 = time.perf_counter()
    counts, big = [], []
    for i in range(SESSIONS):
        if i % EVERY == 0:
            big.append(session(BIG))
        print(f"=== session {i}", file=sys.stderr, flush=True)
        counts.append(session(CALLS))
        if counts[-1] != CALLS:
            print(f"=== short session {i}: {counts[-1]} of {CALLS} "
                  f"records", file=sys.stderr, flush=True)
    short = [(i, c) for i, c in enumerate(counts) if c != CALLS]
    held = dict(collections.Counter(c for _, c in short))
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}: "
          f"{len(short)} of {SESSIONS} sessions of {CALLS} "
          f"launches came back short (records held: sessions {held}); big "
          f"sessions of {BIG}: {big}; "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"counts": counts, "big": big, "calls": CALLS}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
