"""Batch data parallelism over ``torch.distributed`` (one process per GPU),
the counterpart of the JAX package's device-mesh sharding."""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    BatchMesh,
    gather_batch,
    initialize_distributed,
    make_batch_mesh,
    replicate,
    shard_batch,
    sharded_adaptive_hetero,
    sharded_fused_rollout,
    sharded_fused_solve,
    sharded_hetero_solve,
    sharded_hstream_solve,
    sharded_cascade_solve,
    sharded_stream_solve,
    sharded_solve,
    summarize_stats,
)
