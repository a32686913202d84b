"""Data and tensor parallelism of the port (counterpart of
samplenet_tpu/parallel): the ('data', 'model') mesh and its collectives
(mesh.py), the per-rank input pipeline (input_pipeline.py), spawning a
group of ranks (launch.py) and the multi-device dry run (dryrun.py)."""

from samplenet_tpu_torch.parallel.input_pipeline import (  # noqa: F401
    global_batches,
    host_shard,
)
from samplenet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_sum,
    batch_rows,
    copy_to_model,
    data_parallel,
    gather_from_model,
    initialize_distributed,
    make_mesh,
    param_sharding_rules,
    replicated,
    shard_batch,
    shard_params,
    sharded_state_dict,
)
