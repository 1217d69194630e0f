"""Multi-process SERVING: rank 0 is the one controller, and every rank
joins each cycle's sharded assign.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/parallel/
serve_multihost.py``.  Serving stays SINGLE-CONTROLLER: exactly one
informer, queue, encoder and binder, on rank 0, because independent
control planes would watch divergent API-server streams and post
duplicate Bindings.  What is distributed is the COMPUTE: every rank runs
the same SPMD assign (:func:`~.sharding.sharded_assign_fn`) on its shard.

Protocol, each payload a ``torch.distributed.broadcast`` from rank 0:

1. the header ``i32[3] = (opcode, big_sync, seq)``, ``big_sync`` a bit
   mask over :data:`BIG_FIELDS`;
2. the topology-scale leaves (``lat``/``bw``, capacities, label/taint
   bits, zones, metrics) whose bit is set: each leaf is sent only when
   its identity changed since it was last sent, so a metrics ingest
   re-sends the O(N) metric columns and not the N×N planes;
3. every cycle, the placement-mutable leaves (:data:`MUT_FIELDS`) and the
   encoded :class:`~..core.state.PodBatch`;
4. every rank runs the same sharded assign; the whole assignment goes to
   the controller's binder, and followers drop theirs.

``OP_STOP`` ends the followers, which otherwise block in the header
broadcast while the controller is idle.  Bool leaves travel as
``uint8`` and are cast back to the template's dtype.  Followers receive
into host memory; their devices hold only their shards (the placer
slices the node rows).  Under NCCL the two-dimensional leaves travel in
``tp`` row blocks, so no device holds a whole N×N plane in transit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    PodBatch,
    init_cluster_state,
    init_pod_batch,
)
from kubernetesnetawarescheduler_tpu_torch.parallel.sharding import (
    Mesh,
    sharded_assign_fn,
)

OP_STEP = 0
OP_STOP = 1

# ClusterState leaves that change at topology/ingest cadence, each sent
# only when its identity changed...
BIG_FIELDS = ("lat", "bw", "cap", "label_bits", "taint_bits",
              "node_zone", "node_numeric", "metrics", "metrics_age",
              "node_valid")
# ...and the placement-mutable leaves, sent every cycle.
MUT_FIELDS = ("used", "group_bits", "resident_anti", "gz_counts",
              "az_anti")
POD_FIELDS = tuple(f.name for f in dataclasses.fields(PodBatch))


def _bcast(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` of rank 0 on every rank, as a host tensor of ``x``'s dtype
    (``x`` is rank 0's payload, or a template of its shape elsewhere)."""
    blocks = (mesh.tp if mesh.backend == "nccl" and x.dim() >= 2
              and x.shape[0] % mesh.tp == 0 else 1)
    out = []
    for part in x.chunk(blocks, dim=0) if blocks > 1 else (x,):
        wire = mesh.wire(part)
        dist.broadcast(wire, src=0)
        out.append(wire.cpu())
    mesh.collectives += len(out)
    return torch.cat(out).reshape(x.shape).to(x.dtype)


class MultihostController:
    """Wraps the mesh-sharded assign callable with the broadcast
    protocol.  Installed as ``loop._assign`` on rank 0, so the ordinary
    :class:`~..core.loop.SchedulerLoop` machinery (informer, queue,
    binder, preemption, events) runs unchanged while every other rank
    joins its assign."""

    def __init__(self, cfg: SchedulerConfig, mesh: Mesh, assign_fn) -> None:
        self._cfg = cfg
        self._mesh = mesh
        self._assign_fn = assign_fn
        # The last-sent BIG leaves, held by strong reference: the
        # encoder's snapshot returns the SAME tensor objects while a
        # leaf's dirty group is clean, so identity against the cycle's
        # own state detects exactly the changes that cycle consumed.
        self._synced_big: tuple = (None,) * len(BIG_FIELDS)
        self._seq = 0
        self.big_syncs = 0
        self.big_sent = dict.fromkeys(BIG_FIELDS, 0)

    def __call__(self, state: ClusterState, pods: PodBatch, cfg=None, *,
                 with_stats: bool = False):
        mesh = self._mesh
        big = tuple(getattr(state, f) for f in BIG_FIELDS)
        big_sync = sum(1 << i for i, (a, b) in enumerate(
            zip(big, self._synced_big)) if a is not b)
        self._seq += 1
        _bcast(mesh, torch.tensor([OP_STEP, big_sync, self._seq % (2 ** 31)],
                                  dtype=torch.int32))
        if big_sync:
            for i, (f, x) in enumerate(zip(BIG_FIELDS, big)):
                if big_sync >> i & 1:
                    _bcast(mesh, x)
                    self.big_sent[f] += 1
            self._synced_big = big
            self.big_syncs += 1
        for f in MUT_FIELDS:
            _bcast(mesh, getattr(state, f))
        for f in POD_FIELDS:
            _bcast(mesh, getattr(pods, f))
        return self._assign_fn(state, pods, with_stats=with_stats)

    def stop(self) -> None:
        """Release the followers blocked in their header broadcast."""
        _bcast(self._mesh, torch.tensor([OP_STOP, 0, 0], dtype=torch.int32))


def install_controller(loop, cfg: SchedulerConfig,
                       mesh: Mesh) -> MultihostController:
    """Swap rank 0's serving-loop assign for the broadcasting controller
    (the loop was built with ``mesh=``, so ``loop._assign`` is already
    the sharded callable).

    The webhook's sharded score and the backlog burst are turned off:
    followers join only the per-batch assign broadcasts, so a webhook
    wave or a burst on rank 0 would wait forever at its first collective.
    Webhook scoring therefore runs on rank 0's device alone, and serving
    stays per batch."""
    ctl = MultihostController(cfg, mesh, loop._assign)
    loop._assign = ctl
    loop.sharded_score = None
    loop.burst_batches = 1
    loop._sharded_burst = None
    return ctl


def run_follower(cfg: SchedulerConfig, mesh: Mesh, method: str = "parallel",
                 max_steps: int | None = None) -> int:
    """The follower loop of ranks 1..R-1: receive, assemble, join the
    sharded assign, repeat until ``OP_STOP``.  Returns the step count.
    Each BIG leaf is kept as received until it is sent again, so the
    placer and the static cache see a new object exactly where the
    controller's do."""
    assign_fn = sharded_assign_fn(cfg, mesh, method)
    template = init_cluster_state(cfg, device="cpu")
    batch = init_pod_batch(cfg, device="cpu")
    header = torch.zeros((3,), dtype=torch.int32)
    big: dict[str, torch.Tensor] = {}
    steps = 0
    while max_steps is None or steps < max_steps:
        h = _bcast(mesh, header)
        if int(h[0]) == OP_STOP:
            break
        mask = int(h[1])
        for i, f in enumerate(BIG_FIELDS):
            if mask >> i & 1:
                big[f] = _bcast(mesh, getattr(template, f))
        mut = {f: _bcast(mesh, getattr(template, f)) for f in MUT_FIELDS}
        pods = PodBatch(**{f: _bcast(mesh, getattr(batch, f))
                           for f in POD_FIELDS})
        state = template.replace(**big, **mut)
        assign_fn(state, pods, with_stats=(method == "parallel"))
        steps += 1
    return steps


__all__ = ["OP_STEP", "OP_STOP", "BIG_FIELDS", "MUT_FIELDS",
           "MultihostController", "install_controller", "run_follower"]
