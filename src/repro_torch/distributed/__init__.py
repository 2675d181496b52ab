"""Distributed planes, ported: delta replication across gateway replicas
(``replication``), its in-process and socket transports (``transport``)
and the host-side fault tooling the drills use (``fault_tolerance``:
network fault hooks, the SIGKILL helper). The sharded cache plane
(``cache_plane``) holds its configuration until ROADMAP Queue A item 5."""
from repro_torch.distributed.fault_tolerance import (NetworkFaultHooks,
                                                     spawn_and_kill)
from repro_torch.distributed.replication import (DeltaRecord, Replica,
                                                 ReplicaGroup,
                                                 ReplicationConfig,
                                                 ReplicationLog)
from repro_torch.distributed.transport import (InProcessTransport,
                                               SocketTransport,
                                               TransportConfig)

__all__ = ["DeltaRecord", "InProcessTransport", "NetworkFaultHooks",
           "Replica", "ReplicaGroup", "ReplicationConfig", "ReplicationLog",
           "SocketTransport", "TransportConfig", "spawn_and_kill"]
