"""Multi-rank scaling: meshes, shard layouts, sharded scheduling steps.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/parallel``.
Scale comes from a 2-D ``(dp, tp)`` mesh of ranks, one per process:

- ``dp`` shards the pending-pod axis of the score tiles (batch data
  parallelism);
- ``tp`` shards the node axis — the ``N x N`` latency/bandwidth planes,
  capacities and metric columns split across ranks.

The cross-shard reductions (the assignment argmax across node shards,
the per-node acceptance across pod shards, the global normalizers) are
explicit ``torch.distributed`` collectives in the SPMD conflict loop
(:func:`~..core.assign.assign_parallel_spmd`).
"""

from kubernetesnetawarescheduler_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    pods_sharding,
    sharded_schedule_step,
    state_sharding,
)
from kubernetesnetawarescheduler_tpu_torch.parallel.multihost import (  # noqa: F401
    global_mesh,
    init_multihost,
)
