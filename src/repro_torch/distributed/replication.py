"""Replication plane (port of ``repro/distributed/replication.py``,
DESIGN.md §16): configuration only.

Replicas, the delta log and the merge policy come with ROADMAP Queue A
item 4 (replica plane and HTTP front end). Until then this module holds
what ``serving/config.py`` nests: :class:`ReplicationConfig`, carried over
field for field. Setting ``ServingConfig.replication`` raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

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
