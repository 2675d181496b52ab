"""Replication transport (port of ``repro/distributed/transport.py``,
DESIGN.md §17): configuration only.

The in-process and socket transports come with ROADMAP Queue A item 4
(replica plane and HTTP front end). Until then this module holds what
``ReplicationConfig.transport`` nests: :class:`TransportConfig`, carried
over field for field.
"""
from __future__ import annotations

from dataclasses import dataclass


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
