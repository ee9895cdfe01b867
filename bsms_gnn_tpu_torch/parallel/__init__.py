"""Multi-rank scaling over `torch.distributed` (counterpart of
`bsms_gnn_tpu/parallel/`): process groups, data parallelism, the
edge-partitioned halo path and the edge-sharded step.

- `multihost.init_distributed` starts the runtime (NCCL by default, one
  card per rank; gloo when asked), `mesh.make_groups` splits the ranks into
  the `data` and `graph` groups.
- `partition.build_partition` → `partition.shard_hierarchy` (or
  `halo.rank_hierarchy`): each rank's shard of a bi-stride hierarchy, whose
  edges belong to their receiver's shard; sender rows cross ranks through
  one static halo `all_to_all_single` per gather (`halo.py`).
- `halo.halo_forward`, `halo.halo_rollout`, `halo.halo_train_step` /
  `halo.HaloTrainer`: the sharded model on the rank's shard of the node
  arrays (`partition.partition_nodes`, with or without a batch axis).
- `edge_shard.edge_partition` → `edge_shard.edge_shard_hierarchy` (or
  `edge_rank_hierarchy`): every node row replicated, each rank a range of
  every level's and operator's edge slots; `edge_shard_forward` and
  `edge_shard_train_step` (composed with `data`) run the model with each
  GMP's and conv's partial sums summed over `graph` (GSPMD's edge
  sharding of the JAX package's `edge_shard.py`, written out).
- `data_parallel.data_parallel_step`: the batch split over the ranks of
  `data`, the state replicated.
"""

from bsms_gnn_tpu_torch.parallel.data_parallel import (  # noqa: F401
    data_parallel_step,
    replicate_state,
    shard_batch,
)
from bsms_gnn_tpu_torch.parallel.edge_shard import (  # noqa: F401
    EdgePlan,
    edge_partition,
    edge_rank_hierarchy,
    edge_shard,
    edge_shard_forward,
    edge_shard_hierarchy,
    edge_shard_train_step,
    eshard_method,
)
from bsms_gnn_tpu_torch.parallel.halo import (  # noqa: F401
    HaloTrainer,
    halo_forward,
    halo_method,
    halo_rollout,
    halo_train_step,
    rank_hierarchy,
)
from bsms_gnn_tpu_torch.parallel.mesh import make_groups  # noqa: F401
from bsms_gnn_tpu_torch.parallel.multihost import init_distributed  # noqa: F401
from bsms_gnn_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionPlan,
    build_partition,
    partition_nodes,
    shard_hierarchy,
    unpartition_nodes,
)
