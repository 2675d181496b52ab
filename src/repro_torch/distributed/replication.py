"""Delta-streamed cache replication across gateway replicas (port of
``repro/distributed/replication.py``, DESIGN.md §16; transport plane §17).

Production serving is N gateway replicas behind a load balancer; a hit
learned on one replica should warm all of them. Each :class:`Replica`
wraps a ``ServingGateway``, periodically publishes its device-tier
``state_delta()`` as a :class:`DeltaRecord`, and folds peer records in on
its own budget-sliced refresh tick. Dissemination goes through a
transport (``repro_torch.distributed.transport``): ``InProcessTransport``
over the shared :class:`ReplicationLog`, or ``SocketTransport`` over TCP.

Merge policy (per record, applied only when the record's refresh epoch
matches the receiver's — the refresh commit is the reconciliation
barrier, so a delta never straddles a store swap):

* centroid region — per-id **max access count** wins
  (:meth:`SemanticCache.merge_access`);
* spill region — per answer identity, **newest answer wins** by publish
  stamp: an unknown identity is inserted through the normal LRU path, a
  known identity is overwritten in place
  (:meth:`SemanticCache.update_spill_row`, which patches the live device
  mirror), an identity already promoted into the receiver's centroid
  region is left alone;
* hit/miss counters and recency state are **never** merged.

A record from a *newer* epoch — or a transport-level sequence gap — flags
a reconcile: the lagging replica clones the group's freshest replica
wholesale (deep-copied full ``state_dict()``), or, with no in-process
donor, fetches the same payload over the transport
(``SocketTransport.fetch_state``). The same clone serves SIGKILL'd
replicas rejoining the group (``ReplicaGroup.add(..., reconcile=True)``
after a disk ``warm_start()``).

Everything here is host bookkeeping over numpy state trees; the device
work happens inside the wrapped gateway's cache (lookups, row patches,
mirror rebuilds after a clone).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:                       # no import cycle: transport.py
    from repro_torch.distributed.transport import TransportConfig  # noqa


@dataclass
class ReplicationConfig:
    """Knobs for the replication plane (nested under
    ``ServingConfig.replication``)."""
    n_replicas: int = 2      # replicas a launch-time group builds
    sync_every: int = 1      # publish a delta every N submitted batches
                             # (0 = never publish: an isolated replica)
    apply_budget: int = 8    # peer records folded in per refresh tick;
                             # drain folds everything pending
    transport: Optional["TransportConfig"] = None
                             # None -> in-process shared log (DESIGN.md
                             # §17; kind="socket" for the TCP backend)


@dataclass
class DeltaRecord:
    """One replication-stream entry: a device-tier ``state_delta()``
    payload plus the routing/ordering envelope."""
    origin: str              # publishing replica's name
    seq: int                 # per-origin sequence number
    epoch: int               # origin's refresh epoch at publish time
    stamp: float             # publish time (serving clock)
    payload: dict            # deep-copied SemanticCache.state_delta()
    row_stamps: Dict[int, float] = field(default_factory=dict)
    # row_stamps: answer_id -> the stamp of the publish that first carried
    # this row's current answer — the "newest answer wins" tiebreaker.


class ReplicationLog:
    """Append-only in-process replication bus with **per-consumer
    committed cursors** and compaction: a record every registered
    consumer has committed past is dropped, so memory stays bounded
    under an endless publish/apply stream (positions are global — the
    stream offset, not the list index — so compaction never renumbers).
    A reconcile that jumps a consumer's cursor to its donor's commits
    the skipped span too, which is what lets the log compact across a
    full-clone rejoin."""

    def __init__(self) -> None:
        self.records: List[DeltaRecord] = []
        self.base = 0                     # stream position of records[0]
        self.total = 0                    # records ever published
        self.cursors: Dict[str, int] = {}  # consumer -> committed position

    def register(self, name: str) -> int:
        """Add a consumer; returns its start position. A consumer joining
        after compaction starts at the base (history before it is only
        reachable through a reconcile clone)."""
        pos = self.cursors.get(name, self.base)
        self.cursors[name] = pos
        return pos

    def publish(self, rec: DeltaRecord) -> None:
        self.records.append(rec)
        self.total += 1

    def read(self, pos: int) -> Optional[DeltaRecord]:
        if pos < self.base:
            raise IndexError(f"position {pos} compacted away "
                             f"(base={self.base})")
        i = pos - self.base
        return self.records[i] if i < len(self.records) else None

    def commit(self, name: str, pos: int) -> None:
        self.cursors[name] = max(self.cursors.get(name, 0), pos)
        self.compact()

    def seek(self, name: str, pos: int) -> None:
        """Non-monotone cursor move — the reconcile-adopt path. A clone
        adopts its donor's position, which may sit *behind* the clone's
        own committed cursor (the donor has not consumed its own just-
        published records); the committed cursor must rewind with it or
        compaction would strand the reader behind ``base``."""
        self.cursors[name] = max(self.base, pos)
        self.compact()

    def compact(self) -> int:
        """Drop records below every consumer's committed cursor; returns
        how many were dropped."""
        if not self.cursors:
            return 0
        lo = min(self.cursors.values())
        n = min(max(0, lo - self.base), len(self.records))
        if n:
            del self.records[:n]
            self.base += n
        return n

    def __len__(self) -> int:
        return len(self.records)


def _deep_copy_state(obj):
    """Deep-copy a state tree. ``CentroidStore.from_state`` aliases the
    arrays it is handed (cheap for the disk path, where the arrays are
    freshly deserialized) — an in-process clone must therefore copy, or
    the receiver's in-place mutations would corrupt the donor. Tensors
    (a restored bf16 leaf is a CPU ``torch.bfloat16``) are cloned too."""
    if isinstance(obj, dict):
        return {k: _deep_copy_state(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # NamedTuple
        return type(obj)(*(_deep_copy_state(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_deep_copy_state(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    return obj


def _device_cache(frontend):
    """The device-tier SemanticCache of a frontend — the store whose
    ``state_delta()`` is the replication payload. For a tiered frontend
    only the device tier replicates (warm/cold tiers refill from local
    traffic; shipping disk tiers over the log would swamp it)."""
    cache = frontend.cache
    # a TieredCache's ``device`` is its device-tier cache; a SemanticCache's
    # is the torch device it lives on
    tier = getattr(cache, "device", None)
    return tier if hasattr(tier, "state_delta") else cache


class Replica:
    """One gateway in a :class:`ReplicaGroup`.

    Wraps ``submit()`` to publish a delta every ``sync_every`` batches,
    and shadows the frontend's ``refresh_tick``/``refresh_drain`` (via
    instance attributes — the gateway's ``_maybe_refresh`` already calls
    through these on every submit) so peer records are folded in on the
    same budget-sliced slot, at most ``apply_budget`` per tick.

    ``transport`` is anything satisfying the Transport surface
    (publish / next_record / ack / take_gap / …); a bare
    :class:`ReplicationLog` is wrapped in an ``InProcessTransport``.
    """

    def __init__(self, name: str, gateway, transport,
                 cfg: Optional[ReplicationConfig] = None) -> None:
        self.name = name
        self.gw = gateway
        if isinstance(transport, ReplicationLog):
            from repro_torch.distributed.transport import InProcessTransport
            transport = InProcessTransport(transport, name)
        self.transport = transport
        self.cfg = cfg or ReplicationConfig()
        self.group: Optional["ReplicaGroup"] = None
        self.seq = 0             # next record number to publish
        self._since_pub = 0
        self._reconcile_due = False
        # answer_id -> stamp of the publish that carried its current
        # answer; locally recorded rows are stamped at their first publish
        self._stamps: Dict[int, float] = {}
        # origin -> newest epoch seen in its records (remote-donor pick)
        self._peer_epochs: Dict[str, int] = {}
        # merge observability (Replica.report / gateway report)
        self.applied = 0
        self.merged_rows = 0
        self.merged_access = 0
        self.rejected_epoch = 0
        self.reconciles = 0
        self.gap_reconciles = 0
        self._wrap_refresh()

    @property
    def cursor(self) -> int:
        """Consumed-record position (the log cursor for the in-process
        backend, a consumed count over sockets)."""
        return self.transport.position()

    # ------------------------------------------------------------ refresh tap
    def _wrap_refresh(self) -> None:
        """Shadow the frontend's refresh/record entry points with instance
        attributes. The gateway already calls ``fe.refresh_tick()`` once
        per submit, so peer application rides the budget-sliced refresh
        slot; ``record_llm_answer`` is tapped to stamp locally recorded
        answers at record time (their newest-wins timestamp)."""
        fe = self.gw.frontend
        self._tick0 = getattr(fe, "refresh_tick", None)
        if self._tick0 is not None:
            fe.refresh_tick = self._refresh_tick
        self._drain0 = getattr(fe, "refresh_drain", None)
        if self._drain0 is not None:
            fe.refresh_drain = self._refresh_drain
        self._rec0 = getattr(fe, "record_llm_answer", None)
        if self._rec0 is not None:
            fe.record_llm_answer = self._record_llm_answer

    def _refresh_tick(self, budget_s: Optional[float] = None):
        self.apply_pending(self.cfg.apply_budget)
        return self._tick0(budget_s)

    def _refresh_drain(self):
        self.apply_pending(None)     # drain is a barrier: fold everything
        return self._drain0()

    def _record_llm_answer(self, vector, answer, answer_id: int = -1,
                           tenant=None):
        out = self._rec0(vector, answer, answer_id=answer_id, tenant=tenant)
        if answer_id >= 0:
            # a (re-)recorded answer is the newest content for its id —
            # stamp now, not at the next publish
            self._stamps[int(answer_id)] = float(self.gw.clock())
        return out

    # --------------------------------------------------------------- serving
    def submit(self, batch, now: Optional[float] = None) -> np.ndarray:
        # apply peer deltas at the batch edge so this very batch can hit
        # peer-warmed entries (the gateway's refresh tick runs only after
        # its lookup); mid-pipeline the tick stays the only apply point,
        # keeping the commit-epoch barrier intact across store swaps
        pipe = getattr(self.gw.frontend, "pipeline", None)
        if pipe is None or getattr(pipe, "phase", "idle") == "idle":
            self.apply_pending(self.cfg.apply_budget)
        hit = self.gw.submit(batch, now=now)
        if self.cfg.sync_every > 0:
            self._since_pub += 1
            if self._since_pub >= self.cfg.sync_every:
                self.publish(self.gw.clock() if now is None else now)
        return hit

    # ------------------------------------------------------------- publishing
    def publish(self, now: float) -> DeltaRecord:
        """Publish this replica's current device-tier delta. The payload
        is deep-copied: ``state_delta()`` returns live arrays, and a
        record must describe the instant of publish, not track the
        producer's future mutations."""
        fe = self.gw.frontend
        cache = _device_cache(fe)
        payload = _deep_copy_state(cache.state_delta())
        aids = np.asarray(payload["spill"]["answer_id"], np.int64)
        row_stamps: Dict[int, float] = {}
        for a in aids:
            aid = int(a)
            if aid < 0:
                continue
            if aid not in self._stamps:      # recorded locally since the
                self._stamps[aid] = float(now)   # last publish
            row_stamps[aid] = self._stamps[aid]
        rec = DeltaRecord(origin=self.name, seq=self.seq,
                          epoch=int(getattr(fe, "refresh_epoch", 0)),
                          stamp=float(now), payload=payload,
                          row_stamps=row_stamps)
        self.seq += 1
        self._since_pub = 0
        self.transport.publish(rec)
        return rec

    # ---------------------------------------------------------------- merging
    def apply_pending(self, budget: Optional[int]) -> int:
        """Consume peer records from the transport, applying at most
        ``budget`` (None = all); each consumed record is acked (the
        cursor commit / delivered-watermark signal). Runs a flagged
        reconcile afterwards — i.e. at the refresh-tick barrier, never
        mid-lookup."""
        applied = 0
        while budget is None or applied < budget:
            rec = self.transport.next_record()
            if rec is None:
                break
            self._peer_epochs[rec.origin] = max(
                self._peer_epochs.get(rec.origin, 0), int(rec.epoch))
            if self.apply(rec):
                applied += 1
            self.transport.ack(rec)
        if self.transport.take_gap():
            # lost records upstream (outbox overflow, injected drop,
            # partition): deltas are history, so the only safe repair is
            # the full-clone reconcile path
            self._reconcile_due = True
            self.gap_reconciles += 1
        if self._reconcile_due:
            self._run_reconcile()
        return applied

    def apply(self, rec: DeltaRecord) -> bool:
        """Fold one peer record into the local cache. Returns False (and
        counts the rejection) when the record's epoch does not match —
        the epoch barrier. A *newer*-epoch record additionally flags a
        full reconcile from the group's freshest replica."""
        fe = self.gw.frontend
        my_epoch = int(getattr(fe, "refresh_epoch", 0))
        if rec.epoch != my_epoch:
            self.rejected_epoch += 1
            if rec.epoch > my_epoch:
                self._reconcile_due = True
            return False
        cache = _device_cache(fe)
        self.merged_access += cache.merge_access(
            rec.payload["centroid_ids"], rec.payload["centroid_access"])

        sp = rec.payload["spill"]
        aids = np.asarray(sp["answer_id"], np.int64)
        self.applied += 1
        if not len(aids):
            return True
        vecs = np.asarray(sp["vectors"], np.float32)
        answers = np.asarray(sp["answers"], np.float32)
        csize = np.asarray(sp["cluster_size"], np.float64)
        # stale -> fresh, so the peer's most-recent rows end up most
        # recent locally when several insert through the LRU path
        order = np.argsort(np.asarray(rec.payload["spill_last_use"]),
                           kind="stable")
        # a re-recorded identity can hold several peer rows (insert_spill
        # does not dedupe); only the freshest one is that id's content —
        # applying a staler duplicate after it would clobber the merge
        freshest = {}
        for j in order:
            if int(aids[j]) >= 0:
                freshest[int(aids[j])] = j
        cent_ids = set(int(a) for a in cache.centroids.answer_id if a >= 0)
        spill_row = {int(a): r for r, a in enumerate(cache.spill.answer_id)
                     if a >= 0}
        for j in order:
            aid = int(aids[j])
            if aid < 0 or freshest[aid] != j:
                continue        # anonymous row / superseded duplicate
            stamp = float(rec.row_stamps.get(aid, rec.stamp))
            known = self._stamps.get(aid)
            if known is not None and stamp <= known:
                continue        # we already hold this answer (or newer)
            if aid in cent_ids:
                # identity already promoted into our centroid region; the
                # centroid copy is authoritative until the next commit
                self._stamps[aid] = stamp
                continue
            row = spill_row.get(aid)
            if row is not None:     # known identity: newest answer wins
                cache.update_spill_row(row, vecs[j], answers[j])
            else:                   # unknown: normal LRU insert
                cache.insert_spill(vecs[j], answers[j], answer_id=aid,
                                   cluster_size=float(csize[j]))
                rows = np.nonzero(cache.spill.answer_id == aid)[0]
                if len(rows):
                    r = int(rows[-1])
                    # the insert may have evicted a victim: drop whatever
                    # identity previously mapped to that slot
                    spill_row = {a: rr for a, rr in spill_row.items()
                                 if rr != r}
                    spill_row[aid] = r
            self._stamps[aid] = stamp
            self.merged_rows += 1
        return True

    # -------------------------------------------------------------- reconcile
    def _reconcile_payload(self, copy: bool = True) -> tuple:
        """(env, state) a lagging peer needs to clone this replica: the
        full frontend state plus the stamps/cursor bookkeeping. Served
        both in-process (``ReplicaGroup.reconcile``) and over the wire
        (``SocketTransport`` state_provider)."""
        cur = self.transport.sync_state()
        if isinstance(cur, dict):
            # the clone must also expect OUR future records from seq on
            cur = {**cur, self.name: self.seq}
        env = {"origin": self.name,
               "epoch": int(getattr(self.gw.frontend, "refresh_epoch", 0)),
               "stamps": {str(k): float(v)
                          for k, v in self._stamps.items()},
               "cursor": cur}
        state = self.gw.frontend.state_dict()
        return env, (_deep_copy_state(state) if copy else state)

    def _adopt_reconcile(self, env: dict, state) -> None:
        fe = self.gw.frontend
        fe.load_state(state)
        if hasattr(fe, "warm_start"):
            fe.warm_start()
        self._stamps = {int(k): float(v)
                        for k, v in env.get("stamps", {}).items()}
        if env.get("cursor") is not None:
            self.transport.adopt(env["cursor"])
        self._reconcile_due = False
        self.reconciles += 1

    def _run_reconcile(self) -> bool:
        """Group donor first (deep-copied in-process clone); with no
        donor in this process, reconcile over the transport."""
        if self.group is not None and self.group.donor_for(self) is not None:
            return self.group.reconcile(self)
        return self._remote_reconcile()

    def _remote_reconcile(self) -> bool:
        """Fetch a full clone from the freshest peer over the transport
        (separate-process deployments). A timeout leaves the reconcile
        flagged — the next apply barrier retries."""
        fetch = getattr(self.transport, "fetch_state", None)
        peers = self.transport.peers()
        if fetch is None or not peers:
            self._reconcile_due = False      # nobody to reconcile from
            return False
        target = max(peers, key=lambda p: (self._peer_epochs.get(p, 0), p))
        got = fetch(target)
        if got is None:
            return False                     # retry at the next barrier
        env, state = got
        self._adopt_reconcile(env, state)
        return True

    # ------------------------------------------------------------------ misc
    def drain(self) -> None:
        """Drain the wrapped gateway; the refresh_drain shadow folds all
        pending peer records first. Publish afterwards: answers for this
        batch's misses are recorded during the drain, so the submit-time
        record always ships them one publish late — a request/response
        front end (submit -> drain per request) would otherwise never
        warm a peer with the answer it just computed."""
        self.gw.drain()
        if self.cfg.sync_every > 0:
            self.publish(self.gw.clock())

    def report(self) -> dict:
        return {"published": self.seq, "cursor": self.cursor,
                "applied": self.applied, "merged_rows": self.merged_rows,
                "merged_access": self.merged_access,
                "rejected_epoch": self.rejected_epoch,
                "reconciles": self.reconciles,
                "gap_reconciles": self.gap_reconciles,
                "epoch": int(getattr(self.gw.frontend, "refresh_epoch", 0)),
                "transport": self.transport.stats()}

    def close(self) -> None:
        self.transport.close()


class ReplicaGroup:
    """N gateway replicas sharing one replication transport fabric.

    The default fabric is the in-process shared log; pass a
    ``ReplicationConfig`` whose ``transport.kind == "socket"`` (or an
    explicit ``transport_factory``) for the TCP backend — the group then
    wires a full mesh (every replica connects to every other) and
    installs each replica's reconcile state_provider.
    """

    def __init__(self, cfg: Optional[ReplicationConfig] = None,
                 transport_factory=None, fault_hooks=None) -> None:
        self.cfg = cfg or ReplicationConfig()
        self.fault_hooks = fault_hooks
        tcfg = self.cfg.transport
        self.kind = "inproc" if tcfg is None else tcfg.kind
        self.log: Optional[ReplicationLog] = None
        if transport_factory is not None:
            self._factory = transport_factory
            self.kind = "custom"
        elif self.kind == "socket":
            from repro_torch.distributed.transport import SocketTransport
            self._factory = lambda name: SocketTransport(
                name, tcfg, hooks=fault_hooks)
        else:
            from repro_torch.distributed.transport import InProcessTransport
            self.log = ReplicationLog()
            self._factory = lambda name: InProcessTransport(self.log, name)
        self.replicas: Dict[str, Replica] = {}

    def add(self, name: str, gateway, reconcile: bool = False) -> Replica:
        """Attach a gateway as a named replica. ``reconcile=True`` is the
        rejoin path: the newcomer clones the group's freshest replica
        instead of replaying history (records published before the join
        are superseded by the clone, so its cursor starts at the
        donor's)."""
        if name in self.replicas:
            raise ValueError(f"replica {name!r} already in group")
        transport = self._factory(name)
        rep = Replica(name, gateway, transport, self.cfg)
        rep.group = self
        if getattr(transport, "kind", None) == "socket":
            transport.state_provider = \
                lambda r=rep: r._reconcile_payload(copy=False)
            for other in self.replicas.values():
                other.transport.connect(name, transport.address)
                transport.connect(other.name, other.transport.address)
        self.replicas[name] = rep
        if reconcile and len(self.replicas) > 1:
            self.reconcile(rep)
        return rep

    def donor_for(self, rep: Replica) -> Optional[Replica]:
        """The freshest peer: highest (refresh epoch, published seq),
        name as the deterministic tiebreaker."""
        peers = [r for r in self.replicas.values() if r is not rep]
        if not peers:
            return None
        return max(peers, key=lambda r: (
            int(getattr(r.gw.frontend, "refresh_epoch", 0)), r.seq, r.name))

    def reconcile(self, rep: Replica) -> bool:
        """Clone the freshest peer's full frontend state into ``rep`` —
        the warm-restart path with an in-process donor. Invoked at the
        refresh-tick barrier (via apply_pending) or at join."""
        donor = self.donor_for(rep)
        rep._reconcile_due = False
        if donor is None:
            return False
        env, state = donor._reconcile_payload(copy=True)
        rep._adopt_reconcile(env, state)
        return True

    def sync_all(self, now: float, timeout_s: float = 30.0) -> None:
        """Offline barrier for benches/tests: every replica publishes,
        then every replica folds everything pending. Over sockets the
        barrier additionally pumps apply loops until every transport's
        outbox is drained and applied-acked."""
        for rep in self.replicas.values():
            rep.publish(now)
        if self.kind == "inproc":
            for rep in self.replicas.values():
                rep.apply_pending(None)
        else:
            self.barrier(timeout_s)

    def barrier(self, timeout_s: float = 30.0) -> bool:
        """Pump every replica's apply loop until all transports report
        flushed (outboxes empty, newest sent records applied-acked) —
        the networked analog of the in-process drain barrier."""
        import time
        deadline = time.monotonic() + timeout_s
        while True:
            for rep in self.replicas.values():
                rep.apply_pending(None)
            if all(r.transport.flush(0.0) for r in self.replicas.values()):
                # one more pass folds anything that landed mid-check
                for rep in self.replicas.values():
                    rep.apply_pending(None)
                if all(r.transport.flush(0.0)
                       for r in self.replicas.values()):
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    def drain_all(self) -> None:
        for rep in self.replicas.values():
            rep.drain()
        if self.kind != "inproc":
            self.barrier()

    def report(self) -> dict:
        return {name: rep.report() for name, rep in self.replicas.items()}

    def close(self) -> None:
        for rep in self.replicas.values():
            rep.close()


__all__ = ["ReplicationConfig", "DeltaRecord", "ReplicationLog",
           "Replica", "ReplicaGroup"]
