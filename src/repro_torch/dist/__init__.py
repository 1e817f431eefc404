"""Distribution substrate of the PyTorch port: the fault fabric of the
sharded streaming scan (retry classification, backoff, the straggler
watchdog, seeded fault injection), byte-range partitioning, and the
collectives the sharded merge rides on.

The counterparts of ``repro.dist``'s scan modules; its model sharding
tables, gradient compression and embedding exchange belong to the training
scaffold and are not ported yet.
"""

from repro_torch.dist.compat import (
    process_allgather_ragged,
    process_allsum,
    rank_and_world,
    sum_across_devices,
)
from repro_torch.dist.fault_injection import (
    FaultEvent,
    FaultPlan,
    FaultyChunkSource,
    FaultyRangeSource,
    InjectedReadError,
)
from repro_torch.dist.fault_tolerance import (
    BackoffPolicy,
    FatalScanError,
    InjectedFault,
    ShardRetry,
    StepWatchdog,
    StragglerAbort,
    default_is_retryable,
    run_with_retries,
)
from repro_torch.dist.sharding import (
    StreamShardSpec,
    complement_ranges,
    make_stream_shard_spec,
    merge_ranges,
    range_partition,
)

__all__ = [
    "BackoffPolicy",
    "FatalScanError",
    "FaultEvent",
    "FaultPlan",
    "FaultyChunkSource",
    "FaultyRangeSource",
    "InjectedFault",
    "InjectedReadError",
    "ShardRetry",
    "StepWatchdog",
    "StragglerAbort",
    "StreamShardSpec",
    "complement_ranges",
    "default_is_retryable",
    "make_stream_shard_spec",
    "merge_ranges",
    "process_allgather_ragged",
    "process_allsum",
    "range_partition",
    "rank_and_world",
    "run_with_retries",
    "sum_across_devices",
]
