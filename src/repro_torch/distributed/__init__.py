"""Distributed planes, ported: the sharded cache plane (``cache_plane``,
its merges in ``collectives``), delta replication across gateway replicas
(``replication``), its in-process and socket transports (``transport``)
and the host-side fault tooling the drills use (``fault_tolerance``:
network fault hooks, the SIGKILL helper)."""
from repro_torch.distributed.cache_plane import (ShardedCacheConfig,
                                                 ShardedDeviceState,
                                                 ShardedQuantState,
                                                 owner_shard,
                                                 shard_local_row, shard_pad)
from repro_torch.distributed.collectives import (cross_shard_top1,
                                                 local_topk, sharded_topk)
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
           "ShardedCacheConfig", "ShardedDeviceState", "ShardedQuantState",
           "SocketTransport", "TransportConfig", "cross_shard_top1",
           "local_topk", "owner_shard", "shard_local_row", "shard_pad",
           "sharded_topk", "spawn_and_kill"]
