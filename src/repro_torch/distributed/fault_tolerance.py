"""Host-side fault tooling (port of the host parts of
``repro/distributed/fault_tolerance.py``, DESIGN.md §6 and §17).

Two pieces, both plain Python with no device work:

* :class:`NetworkFaultHooks` — deterministic link-level fault injection
  (delay, drop every Nth record, partitions that heal) consulted by
  ``SocketTransport``'s sender threads;
* :func:`spawn_and_kill` — run a child and SIGKILL it the moment a
  readiness probe fires: the machinery behind the kill-and-recover drills.

The reference module's training side (elastic re-meshing, resharding,
``FaultInjector``, ``StepWatchdog``, ``ElasticRunner``) is not ported
here; it comes with the training plane.
"""
from __future__ import annotations

import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# network fault injection (socket replication transport, DESIGN.md §17)
# ---------------------------------------------------------------------------


@dataclass
class NetworkFaultHooks:
    """Deterministic link-level fault injection for ``SocketTransport``.

    The transport consults these on its sender threads, per (origin,
    peer) link: ``delay`` stalls a send, ``drop`` discards the record
    before it hits the wire (the receiver sees a sequence gap and flags a
    reconcile), ``partitioned`` makes the peer unreachable until
    ``heal``-ed (the outbox absorbs traffic, then sheds oldest-first).

    Deterministic by construction — drops fire on a fixed cadence per
    link rather than a coin flip — so convergence drills are replayable.
    """
    delay_s: float = 0.0          # fixed per-record send delay
    drop_every: int = 0           # drop every Nth record per link (0=off)
    partitions: set = field(default_factory=set)   # {(origin, peer)}
    _counts: dict = field(default_factory=dict)    # link -> records seen
    dropped: int = 0
    delayed: int = 0

    def delay(self, origin: str, peer: str) -> float:
        if self.delay_s > 0:
            self.delayed += 1
        return self.delay_s

    def drop(self, origin: str, peer: str) -> bool:
        if self.drop_every <= 0:
            return False
        k = (origin, peer)
        n = self._counts.get(k, 0) + 1
        self._counts[k] = n
        if n % self.drop_every == 0:
            self.dropped += 1
            return True
        return False

    def partitioned(self, origin: str, peer: str) -> bool:
        return (origin, peer) in self.partitions

    def partition(self, origin: str, peer: str,
                  both_ways: bool = True) -> None:
        self.partitions.add((origin, peer))
        if both_ways:
            self.partitions.add((peer, origin))

    def heal(self, origin: Optional[str] = None,
             peer: Optional[str] = None) -> None:
        """Heal one link (both directions) or, with no args, all."""
        if origin is None:
            self.partitions.clear()
            return
        self.partitions.discard((origin, peer))
        self.partitions.discard((peer, origin))


# ---------------------------------------------------------------------------
# hard-crash simulation (SIGKILL — no atexit, no flush, no goodbye)
# ---------------------------------------------------------------------------


def spawn_and_kill(argv: list[str], ready: Callable[[], bool],
                   env: Optional[dict] = None, grace_s: float = 0.0,
                   timeout_s: float = 300.0, poll_s: float = 0.05
                   ) -> tuple[bool, float]:
    """Run ``argv`` as a child and SIGKILL it the moment ``ready()`` turns
    true (plus ``grace_s``): the machinery behind kill-and-recover drills
    (benchmarks/bench_restart.py, DESIGN.md §12). SIGKILL — not SIGTERM —
    so the child gets no chance to finish an in-flight snapshot write;
    whatever survives on disk is exactly what a power loss would leave.

    Returns (killed_while_alive, seconds_the_child_ran). If the child
    exits on its own before ``ready()``, returns (False, elapsed); if
    ``ready()`` never fires within ``timeout_s``, the child is killed and
    a TimeoutError raised.
    """
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, env=env)
    try:
        while True:
            if proc.poll() is not None:
                return False, time.perf_counter() - t0
            if ready():
                break
            if time.perf_counter() - t0 > timeout_s:
                raise TimeoutError(f"child not ready after {timeout_s}s")
            time.sleep(poll_s)
        if grace_s:
            time.sleep(grace_s)
        alive = proc.poll() is None
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        return alive, time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


__all__ = ["NetworkFaultHooks", "spawn_and_kill"]
