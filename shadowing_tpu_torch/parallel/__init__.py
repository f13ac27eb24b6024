"""The mesh on ``torch.distributed``: row-sharded search and data-parallel
synthesis, one process per mesh position."""
from shadowing_tpu_torch.parallel.multihost import (
    host_row_range,
    initialize,
    rank_device,
    shard_dataset_from_local,
    task_split,
)
from shadowing_tpu_torch.parallel.sharding import (
    CTX_AXIS,
    DATA_AXIS,
    LAST_MERGE_PAYLOAD,
    Mesh,
    data_ctx_mesh,
    data_mesh,
    shard_dataset,
    sharded_fused_search,
    sharded_synthesis_step,
)
