"""Distributed planes, ported: the sharded cache plane (``cache_plane``,
its merges in ``collectives``), delta replication across gateway replicas
(``replication``), its in-process and socket transports (``transport``);
the parallel training plane (``sharding``'s rules and placements, the
sharded train step in ``sharded_train``, ``ring_allreduce_schedule``,
gradient ``compression``, the GPipe ``pipeline``) and ``fault_tolerance``
(elastic re-meshing, ``ElasticRunner``, the watchdog, network fault
hooks, the SIGKILL helper)."""
from repro_torch.distributed.cache_plane import (ShardedCacheConfig,
                                                 ShardedDeviceState,
                                                 ShardedQuantState,
                                                 owner_shard,
                                                 shard_local_row, shard_pad)
from repro_torch.distributed.collectives import (cross_shard_top1,
                                                 local_topk,
                                                 ring_allreduce_schedule,
                                                 sharded_topk)
from repro_torch.distributed.compression import (compressed_psum,
                                                 dequantize_int8,
                                                 init_residuals,
                                                 quantize_int8,
                                                 relative_error,
                                                 topk_psum_with_feedback,
                                                 topk_sparsify)
from repro_torch.distributed.fault_tolerance import (ElasticRunner,
                                                     FailureEvent,
                                                     FaultInjector,
                                                     NetworkFaultHooks,
                                                     StepWatchdog,
                                                     largest_mesh_shape,
                                                     remesh, reshard,
                                                     spawn_and_kill, to_host)
from repro_torch.distributed.pipeline import (bubble_fraction,
                                              pipeline_forward, stage_spans)
from repro_torch.distributed.replication import (DeltaRecord, Replica,
                                                 ReplicaGroup,
                                                 ReplicationConfig,
                                                 ReplicationLog)
from repro_torch.distributed.sharded_train import (ShardedTrainStep,
                                                   init_placed_state,
                                                   make_sharded_train_step,
                                                   place_batch, place_params)
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              PartitionSpec, Placed,
                                              batch_specs, cache_spec_tree,
                                              cache_specs, device_put, gather,
                                              named, opt_state_specs,
                                              param_specs)
from repro_torch.distributed.transport import (InProcessTransport,
                                               SocketTransport,
                                               TransportConfig)

__all__ = ["DeltaRecord", "ElasticRunner", "FailureEvent", "FaultInjector",
           "InProcessTransport", "NamedSharding", "NetworkFaultHooks", "P",
           "PartitionSpec", "Placed", "Replica", "ReplicaGroup",
           "ReplicationConfig", "ReplicationLog", "ShardedCacheConfig",
           "ShardedDeviceState", "ShardedQuantState", "ShardedTrainStep",
           "SocketTransport", "StepWatchdog", "TransportConfig",
           "batch_specs", "bubble_fraction", "cache_spec_tree",
           "cache_specs", "compressed_psum", "cross_shard_top1",
           "dequantize_int8", "device_put", "gather", "init_placed_state",
           "init_residuals", "largest_mesh_shape", "local_topk",
           "make_sharded_train_step", "named", "opt_state_specs",
           "owner_shard", "param_specs", "pipeline_forward", "place_batch",
           "place_params", "quantize_int8", "relative_error", "remesh",
           "reshard", "ring_allreduce_schedule", "shard_local_row",
           "shard_pad", "sharded_topk", "spawn_and_kill", "stage_spans",
           "to_host", "topk_psum_with_feedback", "topk_sparsify"]
