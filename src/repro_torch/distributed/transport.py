"""Pluggable replication transport (port of
``repro/distributed/transport.py``, DESIGN.md §17).

Dissemination of :class:`DeltaRecord`s sits behind one Transport surface
(publish / next_record / ack / take_gap / position / sync_state / adopt /
peers / flush / fetch_state / stats / close) with two backends:

* :class:`InProcessTransport` — a cursor over the shared
  ``ReplicationLog``. Acking commits the consumer's cursor into the log,
  which is what lets the log compact records every consumer has seen.

* :class:`SocketTransport` — length-prefixed framed records over TCP.
  Per-peer bounded outboxes (overflow drops the oldest record and the
  resulting sequence gap flags the receiver for the epoch-barrier
  reconcile path, DESIGN.md §16.2), connect/send retry with exponential
  backoff + jitter, ACK frames driving the sender's delivered-seq
  watermark (the ``/healthz`` lag signal), and a state-fetch frame pair
  so a lagging replica with no in-process donor can reconcile **over the
  transport**. Payloads serialize through the checkpoint plane's
  flatten/spec walk (DESIGN.md §12).

The wire format is the reference's, byte for byte: a frame is
``[>I len][type byte][body]`` with the five types below, and a record's
body is ``[>I head_len][JSON head][npz]``. A port replica and a reference
replica exchange records, acks and state over one link.

Failure model:

* records from one origin arrive **in order** on a live connection; a
  reconnect may re-deliver the frame in flight — duplicates are detected
  by sequence and dropped;
* any *loss* (outbox overflow, injected drop, a partition outliving the
  outbox) surfaces as a sequence gap at the receiver, never as silent
  divergence;
* delivery is **at-least-once below, exactly-once above**;
* a dead peer costs bounded memory (the outbox cap) and a background
  thread in capped backoff, never a stalled serving path.

Threads: the accept, reader and sender threads handle bytes and numpy
only. The state provider a reader thread calls for a ``STATE_REQ`` is the
owner's to serialize against its serving path (``launch/serve.py`` takes
the front end's lock, bounded).

Fault injection (delays, drops, partitions) hooks in via
``repro_torch.distributed.fault_tolerance.NetworkFaultHooks``.
"""
from __future__ import annotations

import io
import json
import select
import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import (_flatten, _map_leaves, _tree_spec,
                                            _unflatten_spec)
from repro_torch.distributed.replication import DeltaRecord, ReplicationLog

# frame types (one byte after the length prefix)
_F_HELLO = 0x01      # body: utf-8 peer name (first frame on a connection)
_F_DELTA = 0x02      # body: encoded DeltaRecord
_F_ACK = 0x03        # body: >Q applied seq (receiver -> sender)
_F_STATE_REQ = 0x04  # body: empty (lagging replica -> donor)
_F_STATE = 0x05      # body: encoded (env, state) reconcile payload
_LEN = struct.Struct(">I")
_SEQ = struct.Struct(">Q")
_MAX_FRAME = 1 << 30


@dataclass
class TransportConfig:
    """Knobs for the replication transport (nested under
    ``ReplicationConfig.transport``; ``None`` means in-process)."""
    kind: str = "inproc"          # inproc | socket
    host: str = "127.0.0.1"
    port: int = 0                 # listen port (0 = OS-assigned)
    outbox_cap: int = 64          # per-peer pending records before the
                                  # oldest is dropped (backpressure)
    inbox_cap: int = 512          # received-but-unapplied records before
                                  # arrivals are dropped (slow consumer)
    connect_timeout_s: float = 1.0
    send_timeout_s: float = 5.0
    backoff_base_s: float = 0.05  # first retry delay
    backoff_max_s: float = 2.0    # exponential cap
    backoff_jitter: float = 0.25  # +/- fraction of the delay
    fetch_timeout_s: float = 10.0  # reconcile state-fetch deadline


# ---------------------------------------------------------------------------
# wire serialization: checkpoint flatten/spec machinery over npz bytes
# ---------------------------------------------------------------------------


def _numpy_leaf(v):
    if isinstance(v, torch.Tensor):
        raise TypeError(f"a torch.Tensor leaf ({v.dtype}, {v.device}) "
                        "cannot cross the transport; send numpy")
    return v


def encode_tree(env: dict, tree) -> bytes:
    """(JSON-able envelope, numpy pytree) -> bytes. The tree flattens
    through the checkpoint plane's walk so the exact container types
    (lists, tuples, NamedTuples) round-trip; arrays ride in one npz
    blob. Layout: [>I header_len][header JSON][npz] — the reference's
    bytes, so either package decodes the other's frames. Leaves must be
    numeric numpy (or Python scalars): a tensor or an object array raises
    ``TypeError``."""
    _map_leaves(tree, _numpy_leaf)
    flat = {}
    for k, v in _flatten(tree).items():
        v = np.asarray(v)
        if v.dtype == object:
            raise TypeError(f"non-numeric leaf at {k!r} cannot cross "
                            "the transport")
        flat[k] = v
    buf = io.BytesIO()
    np.savez(buf, **flat)
    head = json.dumps({"env": env, "spec": _tree_spec(tree)}).encode()
    return _LEN.pack(len(head)) + head + buf.getvalue()


def decode_tree(data: bytes) -> Tuple[dict, object]:
    (hlen,) = _LEN.unpack_from(data, 0)
    head = json.loads(data[4: 4 + hlen].decode())
    with np.load(io.BytesIO(data[4 + hlen:]), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return head["env"], _unflatten_spec(flat, head["spec"])


def encode_record(rec: DeltaRecord) -> bytes:
    env = {"origin": rec.origin, "seq": int(rec.seq),
           "epoch": int(rec.epoch), "stamp": float(rec.stamp),
           "row_stamps": {str(k): float(v)
                          for k, v in rec.row_stamps.items()}}
    return encode_tree(env, rec.payload)


def decode_record(data: bytes) -> DeltaRecord:
    env, payload = decode_tree(data)
    return DeltaRecord(
        origin=env["origin"], seq=int(env["seq"]), epoch=int(env["epoch"]),
        stamp=float(env["stamp"]), payload=payload,
        row_stamps={int(k): float(v)
                    for k, v in env["row_stamps"].items()})


# ---------------------------------------------------------------------------
# in-process backend
# ---------------------------------------------------------------------------


class InProcessTransport:
    """Cursor over a shared :class:`ReplicationLog` behind the Transport
    surface. ``next_record`` silently consumes this
    replica's own records (the old loop's ``continue``); ``ack`` commits
    the cursor into the log so fully-consumed records can compact."""

    kind = "inproc"

    def __init__(self, log: ReplicationLog, name: str) -> None:
        self.log = log
        self.name = name
        self._pos = log.register(name)
        # joining a log that already compacted history means records are
        # unreachable: surface it as a gap (reconcile), like the wire
        self._gap = self._pos > 0

    def publish(self, rec: DeltaRecord) -> None:
        self.log.publish(rec)

    def next_record(self) -> Optional[DeltaRecord]:
        while True:
            rec = self.log.read(self._pos)
            if rec is None:
                return None
            self._pos += 1
            if rec.origin == self.name:
                # own record: consumed without application — commit so
                # compaction never waits on the publisher itself
                self.log.commit(self.name, self._pos)
                continue
            return rec

    def ack(self, rec: DeltaRecord) -> None:
        self.log.commit(self.name, self._pos)

    def take_gap(self) -> bool:
        gap, self._gap = self._gap, False
        return gap

    def position(self) -> int:
        return self._pos

    def sync_state(self):
        """Opaque cursor state a reconcile clone adopts from its donor."""
        return self._pos

    def adopt(self, state) -> None:
        self._pos = int(state)
        self.log.seek(self.name, self._pos)

    def peers(self) -> List[str]:
        return [n for n in self.log.cursors if n != self.name]

    def flush(self, timeout_s: float = 0.0) -> bool:
        return True               # publish lands synchronously

    def stats(self) -> dict:
        return {"kind": self.kind, "cursor": self._pos,
                "log_base": self.log.base, "log_live": len(self.log.records),
                "log_total": self.log.total,
                "pending": max(0, self.log.base + len(self.log.records)
                               - self._pos)}

    def fetch_state(self, origin: str, timeout_s: float = 0.0):
        return None               # in-process groups reconcile by donor

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# socket backend
# ---------------------------------------------------------------------------


class _Peer:
    """Sender-side view of one peer: bounded outbox + delivery thread."""

    def __init__(self, name: str, addr: Tuple[str, int],
                 cfg: TransportConfig) -> None:
        self.name = name
        self.addr = addr
        self.cfg = cfg
        self.outbox: deque = deque()     # (seq_or_None, bytes)
        self.cv = threading.Condition()
        self.sock: Optional[socket.socket] = None
        self.last_enqueued = -1          # newest delta seq ever enqueued
        self.last_sent = -1              # newest delta seq actually sent
        self.acked = -1                  # newest seq the peer ACKed (applied)
        self.sent = 0
        self.retries = 0
        self.backoffs = 0
        self.dropped = 0                 # outbox-overflow drops
        self.thread: Optional[threading.Thread] = None

    def depth(self) -> int:
        with self.cv:
            return len(self.outbox)


class SocketTransport:
    """Framed DeltaRecords over TCP loopback (or any reachable host).

    One listener per transport; one outbound connection + sender thread
    per peer. The serving thread only ever touches deques under locks —
    all blocking I/O lives on background threads, so a dead or slow peer
    never stalls ``submit()``.
    """

    kind = "socket"

    def __init__(self, name: str, cfg: Optional[TransportConfig] = None,
                 hooks=None,
                 state_provider: Optional[Callable[[], tuple]] = None):
        self.name = name
        self.cfg = cfg or TransportConfig(kind="socket")
        self.hooks = hooks            # NetworkFaultHooks or None
        # () -> (env dict, state tree) serialized for a reconcile request
        self.state_provider = state_provider
        self._stop = threading.Event()
        self._peers: Dict[str, _Peer] = {}
        self._lock = threading.Lock()         # peers map + inbox
        self._inbox: deque = deque()          # decoded DeltaRecords
        self._in_conns: Dict[str, tuple] = {} # origin -> (sock, write_lock)
        self._expected: Dict[str, int] = {}   # origin -> next delta seq
        self._applied: Dict[str, int] = {}    # origin -> last applied seq
        self._gap = False
        self._consumed = 0
        self.inbox_dropped = 0
        self.gaps = 0
        self.dups = 0
        self._state_resp: Dict[str, bytes] = {}
        self._state_ev: Dict[str, threading.Event] = {}
        self._srv = socket.create_server((self.cfg.host, self.cfg.port))
        self._srv.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"xport-accept-{name}")
        self._accept_thread.start()

    # ------------------------------------------------------------- topology
    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._srv.getsockname()[:2]
        return host, port

    def connect(self, peer_name: str, addr: Tuple[str, int]) -> None:
        """Register a peer; delivery starts in the background (connect
        retries with backoff, so peer startup order is irrelevant)."""
        with self._lock:
            if peer_name in self._peers:
                self._peers[peer_name].addr = tuple(addr)
                return
            peer = _Peer(peer_name, tuple(addr), self.cfg)
            self._peers[peer_name] = peer
        peer.thread = threading.Thread(
            target=self._sender_loop, args=(peer,), daemon=True,
            name=f"xport-send-{self.name}->{peer_name}")
        peer.thread.start()

    def peers(self) -> List[str]:
        with self._lock:
            return list(self._peers)

    # ------------------------------------------------------------ transport
    def publish(self, rec: DeltaRecord) -> None:
        data = _frame(_F_DELTA, encode_record(rec))
        with self._lock:
            targets = list(self._peers.values())
        for peer in targets:
            with peer.cv:
                if len(peer.outbox) >= self.cfg.outbox_cap:
                    # backpressure: drop the oldest pending record — the
                    # receiver sees the seq gap and reconciles
                    peer.outbox.popleft()
                    peer.dropped += 1
                peer.outbox.append((rec.seq, data))
                peer.last_enqueued = max(peer.last_enqueued, rec.seq)
                peer.cv.notify()

    def next_record(self) -> Optional[DeltaRecord]:
        with self._lock:
            if not self._inbox:
                return None
            rec = self._inbox.popleft()
        self._consumed += 1
        return rec

    def ack(self, rec: DeltaRecord) -> None:
        """Applied-ack: tells the origin its record was folded in, which
        advances the sender-side watermark (`acked`) that flush() and
        the /healthz lag stats read."""
        self._applied[rec.origin] = max(
            self._applied.get(rec.origin, -1), rec.seq)
        conn = self._in_conns.get(rec.origin)
        if conn is None:
            return
        sock, wlock = conn
        try:
            with wlock:
                sock.sendall(_frame(_F_ACK, _SEQ.pack(rec.seq)))
        except OSError:
            pass                  # ack is best-effort lag telemetry

    def take_gap(self) -> bool:
        with self._lock:
            gap, self._gap = self._gap, False
        return gap

    def position(self) -> int:
        return self._consumed

    def sync_state(self):
        """Per-origin applied/expected seqs; a clone adopts its donor's
        so already-superseded records do not re-flag a gap."""
        with self._lock:
            return dict(self._expected)

    def adopt(self, state) -> None:
        donor = {o: int(nxt) for o, nxt in dict(state).items()}
        acks: Dict[str, int] = {}
        with self._lock:
            for origin, nxt in donor.items():
                self._expected[origin] = max(
                    self._expected.get(origin, 0), nxt)
                floor = nxt - 1
                if floor > self._applied.get(origin, -1):
                    # the clone embodies everything below the donor's
                    # expected seq: advance the applied watermark so the
                    # origin's flush() does not stall on records we will
                    # now never individually apply
                    self._applied[origin] = floor
                    acks[origin] = floor
            kept: deque = deque()
            while self._inbox:
                rec = self._inbox.popleft()
                if rec.seq < donor.get(rec.origin, 0):
                    # superseded by the donor clone: drop, but still ack
                    acks[rec.origin] = max(acks.get(rec.origin, -1),
                                           rec.seq)
                else:
                    kept.append(rec)   # newer than the clone: still apply
            self._inbox = kept
            self._gap = False
        for origin, seq in acks.items():
            conn = self._in_conns.get(origin)
            if conn is None:
                continue
            sock, wlock = conn
            try:
                with wlock:
                    sock.sendall(_frame(_F_ACK, _SEQ.pack(seq)))
            except OSError:
                pass              # ack is best-effort lag telemetry

    def flush(self, timeout_s: float = 0.0) -> bool:
        """True once every peer's outbox is empty and its newest *sent*
        record has been applied-ACKed. Callers must keep the receivers'
        apply loops pumping while waiting — acks only flow on apply."""
        deadline = _now() + timeout_s
        while True:
            done = True
            with self._lock:
                peers = list(self._peers.values())
            for p in peers:
                with p.cv:
                    if p.outbox or p.acked < p.last_sent:
                        done = False
            if done:
                return True
            if _now() >= deadline:
                return False
            self._stop.wait(0.002)

    # ------------------------------------------------------------ reconcile
    def fetch_state(self, origin: str, timeout_s: Optional[float] = None):
        """Reconcile-over-transport: ask ``origin`` for its full state.
        Returns (env, state) or None on timeout/unknown peer."""
        timeout_s = self.cfg.fetch_timeout_s if timeout_s is None \
            else timeout_s
        with self._lock:
            peer = self._peers.get(origin)
        if peer is None:
            return None
        ev = self._state_ev.setdefault(origin, threading.Event())
        ev.clear()
        self._state_resp.pop(origin, None)
        with peer.cv:
            peer.outbox.append((None, _frame(_F_STATE_REQ, b"")))
            peer.cv.notify()
        if not ev.wait(timeout_s):
            return None
        data = self._state_resp.pop(origin, None)
        return None if data is None else decode_tree(data)

    # ----------------------------------------------------------------- misc
    def stats(self) -> dict:
        with self._lock:
            peers = {
                name: {"pending": len(p.outbox), "sent": p.sent,
                       "acked_seq": p.acked, "last_sent_seq": p.last_sent,
                       "retries": p.retries, "backoffs": p.backoffs,
                       "outbox_dropped": p.dropped}
                for name, p in self._peers.items()}
            return {"kind": self.kind, "addr": list(self.address),
                    "peers": peers,
                    "inbox_depth": len(self._inbox),
                    "inbox_dropped": self.inbox_dropped,
                    "gaps": self.gaps, "dups": self.dups,
                    "last_applied": dict(self._applied)}

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            with p.cv:
                p.cv.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass
        for p in peers:
            if p.sock is not None:
                try:
                    p.sock.close()
                except OSError:
                    pass
            if p.thread is not None:
                p.thread.join(timeout=2.0)
        for sock, _ in list(self._in_conns.values()):
            try:
                sock.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=2.0)

    # -------------------------------------------------------------- threads
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._reader_loop, args=(conn,),
                             daemon=True,
                             name=f"xport-read-{self.name}").start()

    def _reader_loop(self, conn: socket.socket) -> None:
        """Inbound connection: HELLO identifies the origin, then DELTA
        frames stream in (plus STATE_REQ when the peer reconciles off
        us). A torn frame (sender died mid-send) just ends the loop —
        the next connection re-delivers from the sender's outbox."""
        conn.settimeout(0.5)
        wlock = threading.Lock()
        origin = None
        try:
            while not self._stop.is_set():
                got = _recv_frame(conn, self._stop)
                if got is None:
                    return
                ftype, body = got
                if ftype == _F_HELLO:
                    origin = body.decode()
                    self._in_conns[origin] = (conn, wlock)
                    # a reconnect may follow a conn drop that ate acks in
                    # flight; restate the applied watermark so the
                    # sender's flush() can settle without new traffic
                    applied = self._applied.get(origin, -1)
                    if applied >= 0:
                        try:
                            with wlock:
                                conn.sendall(
                                    _frame(_F_ACK, _SEQ.pack(applied)))
                        except OSError:
                            pass
                elif ftype == _F_DELTA:
                    self._on_delta(body, conn, wlock)
                elif ftype == _F_STATE_REQ:
                    self._on_state_req(conn, wlock)
                # ACK/STATE never arrive on inbound connections
        except OSError:
            return
        finally:
            if origin is not None and \
                    self._in_conns.get(origin, (None,))[0] is conn:
                self._in_conns.pop(origin, None)
            try:
                conn.close()
            except OSError:
                pass

    def _on_delta(self, body: bytes, conn, wlock) -> None:
        rec = decode_record(body)
        ack_now = False
        with self._lock:
            expected = self._expected.get(rec.origin, 0)
            if rec.seq < expected:
                self.dups += 1            # reconnect re-delivery
                ack_now = True            # already applied (or superseded)
            else:
                if rec.seq > expected:
                    self.gaps += 1        # lost records upstream
                    self._gap = True
                self._expected[rec.origin] = rec.seq + 1
                if len(self._inbox) >= self.cfg.inbox_cap:
                    # slow consumer: drop the arrival, reconcile later —
                    # still acked, since the reconcile clone supersedes it
                    self.inbox_dropped += 1
                    self._gap = True
                    ack_now = True
                else:
                    self._inbox.append(rec)
        if ack_now:
            # dropped records never reach Replica.ack; ack here so the
            # sender's flush watermark cannot stall on a record that will
            # never be individually applied
            try:
                with wlock:
                    conn.sendall(_frame(_F_ACK, _SEQ.pack(rec.seq)))
            except OSError:
                pass

    def _on_state_req(self, conn: socket.socket, wlock) -> None:
        provider = self.state_provider
        if provider is None:
            return
        payload = provider()
        if payload is None:
            return                       # busy donor: requester times out
        env, state = payload
        try:
            with wlock:
                conn.sendall(_frame(_F_STATE, encode_tree(env, state)))
        except OSError:
            pass

    def _sender_loop(self, peer: _Peer) -> None:
        backoff = self.cfg.backoff_base_s
        while not self._stop.is_set():
            with peer.cv:
                item = peer.outbox[0] if peer.outbox else None
            if item is None:
                # idle: keep draining acks/state replies, then sleep on
                # the condition until the next publish. If a conn drop
                # ate the final acks on this link, nothing left to send
                # would ever reconnect — do it here (the peer re-acks
                # its applied watermark on HELLO, letting flush settle).
                if peer.sock is None and peer.acked < peer.last_sent and \
                        not (self.hooks is not None and
                             self.hooks.partitioned(self.name, peer.name)):
                    try:
                        peer.sock = socket.create_connection(
                            peer.addr, timeout=self.cfg.connect_timeout_s)
                        peer.sock.settimeout(self.cfg.send_timeout_s)
                        peer.sock.sendall(
                            _frame(_F_HELLO, self.name.encode()))
                        backoff = self.cfg.backoff_base_s
                    except OSError:
                        peer.sock = None
                        peer.retries += 1
                        peer.backoffs += 1
                        self._stop.wait(self._jittered(backoff))
                        backoff = min(backoff * 2, self.cfg.backoff_max_s)
                        continue
                self._drain_replies(peer)
                with peer.cv:
                    if not peer.outbox:
                        peer.cv.wait(0.05)
                continue
            seq, data = item                  # peek: pop only on success
            if self.hooks is not None and \
                    self.hooks.partitioned(self.name, peer.name):
                # partition: behaves like an unreachable host — back off
                # and retry while the outbox absorbs (or drops) traffic
                self._drop_conn(peer)
                peer.backoffs += 1
                self._stop.wait(self._jittered(backoff))
                backoff = min(backoff * 2, self.cfg.backoff_max_s)
                continue
            if peer.sock is None:
                try:
                    peer.sock = socket.create_connection(
                        peer.addr, timeout=self.cfg.connect_timeout_s)
                    peer.sock.settimeout(self.cfg.send_timeout_s)
                    peer.sock.sendall(
                        _frame(_F_HELLO, self.name.encode()))
                except OSError:
                    peer.sock = None
                    peer.retries += 1
                    peer.backoffs += 1
                    self._stop.wait(self._jittered(backoff))
                    backoff = min(backoff * 2, self.cfg.backoff_max_s)
                    continue
            if seq is not None and self.hooks is not None and \
                    self.hooks.drop(self.name, peer.name):
                with peer.cv:             # injected loss: gap at receiver
                    if peer.outbox and peer.outbox[0][1] is data:
                        peer.outbox.popleft()
                continue
            if self.hooks is not None:
                d = self.hooks.delay(self.name, peer.name)
                if d > 0:
                    self._stop.wait(d)
            try:
                peer.sock.sendall(data)
            except OSError:
                self._drop_conn(peer)
                peer.retries += 1
                self._stop.wait(self._jittered(backoff))
                backoff = min(backoff * 2, self.cfg.backoff_max_s)
                continue
            backoff = self.cfg.backoff_base_s
            with peer.cv:
                if peer.outbox and peer.outbox[0][1] is data:
                    peer.outbox.popleft()
                peer.sent += 1
                if seq is not None:
                    peer.last_sent = max(peer.last_sent, seq)
            self._drain_replies(peer)

    def _drain_replies(self, peer: _Peer) -> None:
        """Non-blocking read of ACK/STATE frames flowing back on the
        outbound connection."""
        sock = peer.sock
        if sock is None:
            return
        try:
            while select.select([sock], [], [], 0)[0]:
                got = _recv_frame(sock, self._stop)
                if got is None:
                    self._drop_conn(peer)
                    return
                ftype, body = got
                if ftype == _F_ACK:
                    (seq,) = _SEQ.unpack(body)
                    with peer.cv:
                        peer.acked = max(peer.acked, seq)
                elif ftype == _F_STATE:
                    self._state_resp[peer.name] = body
                    ev = self._state_ev.get(peer.name)
                    if ev is not None:
                        ev.set()
        except OSError:
            self._drop_conn(peer)

    def _drop_conn(self, peer: _Peer) -> None:
        if peer.sock is not None:
            try:
                peer.sock.close()
            except OSError:
                pass
            peer.sock = None

    def _jittered(self, backoff: float) -> float:
        j = self.cfg.backoff_jitter
        if j <= 0:
            return backoff
        # deterministic-enough jitter without consuming global RNG state
        frac = (hash((self.name, threading.get_ident(),
                      int(backoff * 1e6))) % 1000) / 1000.0
        return backoff * (1.0 - j + 2.0 * j * frac)


def _frame(ftype: int, body: bytes) -> bytes:
    return _LEN.pack(len(body) + 1) + bytes([ftype]) + body


def _recv_frame(sock: socket.socket, stop: threading.Event
                ) -> Optional[Tuple[int, bytes]]:
    head = _recv_exact(sock, 4, stop)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if not 1 <= n <= _MAX_FRAME:
        return None
    body = _recv_exact(sock, n, stop)
    if body is None:
        return None
    return body[0], body[1:]


def _recv_exact(sock: socket.socket, n: int, stop: threading.Event
                ) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        if stop.is_set():
            return None
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            continue
        except OSError:
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _now() -> float:
    import time
    return time.monotonic()


__all__ = ["TransportConfig", "InProcessTransport", "SocketTransport",
           "encode_record", "decode_record", "encode_tree", "decode_tree"]
