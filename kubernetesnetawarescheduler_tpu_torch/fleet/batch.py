"""Lane-axis device step: the fleet's one shared dispatch.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/fleet/batch.py``.
Every tenant in a padding bucket shares one ``SchedulerConfig`` shape
(``cfg.max_nodes`` = the bucket's power-of-two node count), so their
states stack leaf for leaf along a NEW leading lane axis
(:func:`~..core.state.stack_trees`) and the per-batch decision runs over
it in one call.

``torch.func.vmap`` cannot batch the conflict loop's data-dependent
rounds, so the lane axis lives in the loop itself:
:func:`~..core.assign.assign_parallel_lanes` runs every lane's rounds
together, one host sync per round for all lanes, and a bucket cycle costs
the largest lane's rounds, not their sum (what ``vmap`` of
``lax.while_loop`` costs in JAX).  Under ``score_backend="pallas"`` the
lanes' static scores come from one lane launch of the static kernel.

- :func:`fleet_assign` — the serving dispatch: assignment and rounds per
  lane, no commit (durable usage flows through each tenant's bind path).
- :func:`fleet_fused_step` — assign plus a per-lane
  ``commit_assignments``, for state chains the caller owns.  torch has
  no buffer donation: the new states are returned, sharing every plane
  the commit does not touch with the input.
- :func:`fleet_assign_lanes` — the serving dispatch from K per-tenant
  triples, stacked here.

Idle lanes are inert: an ``init_pod_batch`` lane has ``pod_valid`` all
False, so it is UNASSIGNED everywhere and its commit is the identity.
"""

from __future__ import annotations

import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.assign import (
    assign_parallel_lanes,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    PodBatch,
    commit_assignments,
    index_tree,
    stack_trees,
)

# The planes commit_assignments writes; every other plane of a lane's
# state is shared with the input across a fused step.
_COMMITTED = ("used", "group_bits", "resident_anti", "gz_counts", "az_anti")


def node_bucket(n_nodes: int, floor: int = 64) -> int:
    """The padding bucket for a tenant with ``n_nodes`` nodes: the next
    power of two >= max(n_nodes, floor)."""
    if n_nodes < 1:
        raise ValueError("n_nodes must be >= 1")
    b = max(int(floor), 1)
    while b < n_nodes:
        b *= 2
    return b


def fleet_assign(states: ClusterState, pods: PodBatch, statics,
                 cfg: SchedulerConfig):
    """The serving dispatch over the leading lane axis: ``states``,
    ``pods`` and ``statics`` are :func:`stack_trees` results; returns
    ``(assignment i32[K, P], rounds i32[K])``, each lane equal to
    ``assign_parallel`` on that tenant alone."""
    return assign_parallel_lanes(states, pods, cfg, statics)


def fleet_fused_step(states: ClusterState, pods: PodBatch, statics,
                     cfg: SchedulerConfig):
    """Assign plus the usage commit per lane.  Returns ``(new_states,
    assignment i32[K, P], rounds i32[K])``; each lane equals the solo
    ``fused_schedule_step`` on it, committed planes included (the
    commit runs per lane, the solo path's own call)."""
    assignment, rounds = assign_parallel_lanes(states, pods, cfg, statics)
    commits = [commit_assignments(index_tree(states, k), index_tree(pods, k),
                                  assignment[k])
               for k in range(assignment.shape[0])]
    new_states = states.replace(**{
        f: torch.stack([getattr(c, f) for c in commits]) for f in _COMMITTED})
    return new_states, assignment, rounds


def fleet_assign_lanes(states, pods, statics, cfg: SchedulerConfig):
    """The serving dispatch as one call per bucket cycle: ``states``,
    ``pods`` and ``statics`` are length-K sequences of per-tenant trees
    (K = the bucket's padded lane count), stacked here."""
    return assign_parallel_lanes(stack_trees(list(states)),
                                 stack_trees(list(pods)), cfg,
                                 stack_statics(statics))


def stack_statics(statics):
    """Stack per-tenant assign statics (``compute_assign_static`` or
    ``compute_assign_static_incremental`` results) along the lane axis;
    scalar leaves become tensors first."""
    return stack_trees(list(statics))
