"""Fleet-of-clusters serving.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/fleet/``.
Many logical clusters (tenants), one device dispatch: every tenant's
planes are stacked along a leading lane axis and the conflict loop runs
over it in one call (:func:`~..core.assign.assign_parallel_lanes`), one
host sync per round for all tenants.

- :mod:`.batch` — the lane-axis step: the serving dispatch and the fused
  step with its per-lane commit.
- :mod:`.server` — :class:`FleetServer`: a SchedulerLoop per tenant over
  the shared dispatch, with power-of-two node-count padding buckets.
- :mod:`.transfer` — :class:`TransferRegistry`: promoted scoring
  policies warm-start new tenants by size/topology match; promotion
  stays per tenant.

Isolation contract: every tenant's placements equal the same tenant
served alone, bit for bit, including under another tenant's injected
state faults.
"""

from kubernetesnetawarescheduler_tpu_torch.fleet.batch import (  # noqa: F401
    fleet_assign,
    fleet_assign_lanes,
    fleet_fused_step,
    node_bucket,
    stack_statics,
)
from kubernetesnetawarescheduler_tpu_torch.fleet.server import (  # noqa: F401
    FleetServer,
    Tenant,
)
from kubernetesnetawarescheduler_tpu_torch.fleet.transfer import (  # noqa: F401
    DonorRecord,
    TransferRegistry,
)
