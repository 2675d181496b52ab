"""Fault tolerance and elastic scaling (port of
``repro/distributed/fault_tolerance.py``, DESIGN.md §6 and §17).

The recovery contract:

  1. every state object (params, optimizer moments, the step) flows
     through the checkpoint manager (``repro_torch.checkpoint``) on a
     cadence;
  2. on failure, the coordinator rebuilds a mesh over the surviving
     devices (``remesh``) and re-places the host-side state onto it
     (``reshard``): device counts may differ from save time;
  3. stragglers are flagged by a step-time watchdog (``StepWatchdog``).

The "cluster" is a list of torch devices driven by this one process; a
device may repeat (virtual devices on one card), so failures are
*simulated* by building meshes over device subsets, which runs the same
re-place path a real loss would. Between meshes the state is on the host
(``to_host``).

The host tooling of the replica drills: :class:`NetworkFaultHooks` —
deterministic link-level fault injection (delay, drop every Nth record,
partitions that heal) consulted by ``SocketTransport``'s sender threads;
:func:`spawn_and_kill` — run a child and SIGKILL it the moment a
readiness probe fires.
"""
from __future__ import annotations

import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------


def largest_mesh_shape(n_devices: int, model_parallel: int
                       ) -> tuple[int, int]:
    """Biggest (data, model) grid over surviving devices, keeping the model
    axis intact (TP groups must stay whole; losing one chip of a TP group
    kills the whole group)."""
    data = n_devices // model_parallel
    if data < 1:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{n_devices} devices")
    return data, model_parallel


def remesh(devices: list, model_parallel: int,
           axis_names: tuple[str, str] = ("data", "model")) -> Mesh:
    """Build a fresh mesh over an explicit device list (survivors)."""
    data, model = largest_mesh_shape(len(devices), model_parallel)
    grid = np.asarray(devices[: data * model], dtype=object)
    return Mesh(grid.reshape(data, model), axis_names)


def to_host(tree: Any) -> Any:
    """Device -> host: every tensor (placed ones gathered whole) as a CPU
    tensor, bf16 kept bit for bit (as the checkpoint manager stores and
    restores it); the representation that survives a re-mesh."""
    def one(x):
        if isinstance(x, shd.Placed):
            x = shd.gather(x, "cpu")
        return x.detach().to("cpu", copy=True) \
            if isinstance(x, torch.Tensor) else x
    return shd.tree_map(one, tree)


def reshard(tree_host: Any, specs: Any, mesh) -> Any:
    """Host state -> new mesh under the given PartitionSpecs (numpy arrays
    become tensors first)."""
    return shd.tree_map(
        lambda x, s: shd.device_put(torch.as_tensor(x),
                                    shd.NamedSharding(mesh, s)),
        tree_host, specs)


# ---------------------------------------------------------------------------
# failure simulation + watchdog
# ---------------------------------------------------------------------------


@dataclass
class FailureEvent:
    step: int
    kind: str                 # "node_loss" | "straggler" | "restart"
    detail: str = ""


@dataclass
class FaultInjector:
    """Deterministic failure schedule for integration tests: at step s,
    drop `lose` devices (forcing a re-mesh) or stall (watchdog path)."""
    node_loss_steps: dict[int, int] = field(default_factory=dict)
    events: list[FailureEvent] = field(default_factory=list)

    def check(self, step: int, devices: list) -> list:
        lose = self.node_loss_steps.get(step, 0)
        if lose:
            self.events.append(FailureEvent(step, "node_loss",
                                            f"lost {lose} devices"))
            return devices[:-lose]
        return devices


@dataclass
class StepWatchdog:
    """Detects straggling steps: if a step exceeds `factor` x the trailing
    median, it is flagged (real deployments would hedge/evict the slow
    host; here the signal feeds the test assertions + logs)."""
    factor: float = 3.0
    window: int = 16
    _times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if len(self._times) >= 4:
            med = float(np.median(self._times[-self.window:]))
            slow = dt > self.factor * med
            if slow:
                self.flagged.append((step, dt, med))
        self._times.append(dt)
        return slow


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


# ---------------------------------------------------------------------------
# recovery orchestration
# ---------------------------------------------------------------------------


def _visible_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device visible; pass devices= (CPU "
                           "devices run the plain versions)")
    return [torch.device("cuda", i) for i in range(n)]


class ElasticRunner:
    """Drives train/serve steps with failure handling.

    make_step(mesh) -> (step_fn, shard(state_host) -> state_dev,
                        unshard(state_dev) -> state_host)
    On injected node loss: state -> host, remesh over survivors,
    reshard, continue. Checkpoints via the provided manager every
    `ckpt_every` steps; restart-from-checkpoint is `resume()`. The
    devices default to the visible CUDA devices.
    """

    def __init__(self, make_step: Callable, devices: Optional[list] = None,
                 model_parallel: int = 1,
                 injector: Optional[FaultInjector] = None,
                 ckpt_manager=None, ckpt_every: int = 50):
        self.make_step = make_step
        self.devices = list(devices or _visible_devices())
        self.model_parallel = model_parallel
        self.injector = injector or FaultInjector()
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.watchdog = StepWatchdog()
        self.mesh = remesh(self.devices, model_parallel)
        self.step_fn, self.shard, self.unshard = make_step(self.mesh)
        self.log: list[str] = []

    def run(self, state_host: Any, n_steps: int, start_step: int = 0) -> Any:
        state = self.shard(state_host)
        for step in range(start_step, start_step + n_steps):
            survivors = self.injector.check(step, self.devices)
            if len(survivors) != len(self.devices):      # node failure
                self.log.append(f"step {step}: remesh "
                                f"{len(self.devices)}->{len(survivors)}")
                state_host = self.unshard(state)
                self.devices = survivors
                self.mesh = remesh(self.devices, self.model_parallel)
                self.step_fn, self.shard, self.unshard = \
                    self.make_step(self.mesh)
                state = self.shard(state_host)
            t0 = time.perf_counter()
            state = self.step_fn(state)
            self.watchdog.observe(step, time.perf_counter() - t0)
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self.unshard(state))
        return self.unshard(state)

    def resume(self) -> tuple[int, Any]:
        assert self.ckpt is not None
        self.ckpt.wait()
        step, state_host = self.ckpt.restore_latest()
        return step, state_host


__all__ = ["ElasticRunner", "FailureEvent", "FaultInjector",
           "NetworkFaultHooks", "StepWatchdog", "largest_mesh_shape",
           "remesh", "reshard", "spawn_and_kill", "to_host"]
