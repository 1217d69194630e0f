"""FleetServer: a SchedulerLoop per tenant over one shared dispatch.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/fleet/server.py``.
Each tenant keeps a FULL :class:`~..core.loop.SchedulerLoop` (its own
encoder, queue, checkpoint directory, SLO engine, quality observer,
flight recorder and scoring policy), so every host-side contract (watch
ingest, gang gating, bind/assume, explain capture, span commit) is the
solo loop's own code.  What the fleet changes is ONLY the device
dispatch: per cycle, each tenant's encode half runs through
``SchedulerLoop._cycle_inputs`` (as solo), the per-tenant ``(state,
pod batch, static)`` triples are stacked along the lane axis, ONE
lane-batched dispatch scores and conflict-resolves every tenant
(:func:`~.batch.fleet_assign_lanes`), and each tenant's bind half runs
through ``SchedulerLoop._cycle_outputs`` (as solo).

Padding buckets: tenants are grouped by power-of-two node count
(:func:`~.batch.node_bucket`, floored at ``cfg.fleet_bucket_min``), and
each bucket's lane count is itself padded to a power of two with inert
filler lanes (empty pod batches: every pod UNASSIGNED).

Isolation: tenants share nothing mutable.  Lane ``k``'s result depends
only on lane ``k``'s inputs, so each tenant's placements equal its solo
serving bit for bit, including under another tenant's injected state
faults.  Every tenant loop and filler lives on the fleet's ``device``.

Gangs keep their solo path: a released gang schedules through its own
tenant's ``_schedule_gang``; only the per-pod serial path is batched.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.loop import (
    SchedulerLoop,
    _to_host,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    init_cluster_state,
    init_pod_batch,
    resolve_device,
)
from kubernetesnetawarescheduler_tpu_torch.fleet.batch import (
    fleet_assign_lanes,
    node_bucket,
)
from kubernetesnetawarescheduler_tpu_torch.fleet.transfer import (
    TransferRegistry,
)
from kubernetesnetawarescheduler_tpu_torch.utils import tracing


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class Tenant:
    """One logical cluster served by the fleet."""

    name: str
    loop: SchedulerLoop
    bucket_nodes: int
    checkpoint_dir: str | None = None
    # Donor provenance when this tenant's policy was warm-started
    # (None = cold start); promotion is still gated per tenant.
    transfer_donor: dict[str, Any] | None = None
    # Donor promoted_version last pushed to the registry (so maintain
    # re-registers only on a NEW promotion).
    _registered_version: int = 0


class _Bucket:
    """All tenants sharing one padded node-count config, on one
    device."""

    def __init__(self, cfg: SchedulerConfig, device) -> None:
        self.cfg = cfg
        self.device = device
        self.tenants: list[Tenant] = []
        self._filler = None  # (state, batch, static), built lazily

    @property
    def capacity(self) -> int:
        """Lane count of the batched dispatch: tenants padded to the
        next power of two (min 1)."""
        return _pow2(max(1, len(self.tenants)))

    def filler(self):
        """The inert lane: empty state, empty (all-invalid) pod batch,
        and the static computed from the empty state.  Built once per
        bucket; its lane outputs are ignored."""
        if self._filler is None:
            from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
                compute_assign_static_incremental,
            )

            state = init_cluster_state(self.cfg, self.device)
            batch = init_pod_batch(self.cfg, self.device)
            static, _ = compute_assign_static_incremental(
                state, self.cfg, None, None, None)
            self._filler = (state, batch, static)
        return self._filler


class FleetServer:
    """Serve many logical clusters from one lane-batched dispatch.

    Typical lifecycle::

        fleet = FleetServer(device="cuda")
        fleet.add_tenant("blue", client_a, cfg_a, checkpoint_dir=da)
        fleet.add_tenant("green", client_b, cfg_b, checkpoint_dir=db)
        while serving:
            fleet.step()        # one batched cycle across all buckets
            fleet.maintain()    # per-tenant maintain + donor registry
    """

    def __init__(self, registry: TransferRegistry | None = None,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self._buckets: dict[SchedulerConfig, _Bucket] = {}
        self._tenants: dict[str, Tenant] = {}
        self.registry = registry if registry is not None \
            else TransferRegistry()
        self.cycles_total = 0
        self.dispatches_total = 0
        self.dispatch_lanes_total = 0

    # -- onboarding ---------------------------------------------------

    def add_tenant(self, name: str, client, cfg: SchedulerConfig,
                   *, n_nodes: int | None = None,
                   checkpoint_dir: str | None = None,
                   warm_start: bool = True,
                   **loop_kwargs) -> Tenant:
        """Onboard a logical cluster.

        ``cfg`` is the tenant's OWN config; its ``max_nodes`` is rounded
        up to the power-of-two padding bucket (floored at
        ``cfg.fleet_bucket_min``), picked by ``n_nodes`` (the actual node
        count, default ``cfg.max_nodes``).  The tenant's loop is built on
        the fleet's device; a ``device`` in ``loop_kwargs`` that differs
        from its bucket's raises.

        With ``warm_start`` and a learned-score config, the tenant's
        policy is seeded from the closest promoted donor in the transfer
        registry once its encoder has topology (retried on
        :meth:`maintain` until then); the seeded policy still serves
        shadow-only until it wins this tenant's own gate."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        device = resolve_device(loop_kwargs.pop("device", self.device))
        bucket_nodes = node_bucket(
            int(n_nodes if n_nodes is not None else cfg.max_nodes),
            cfg.fleet_bucket_min)
        bcfg = (cfg if cfg.max_nodes == bucket_nodes
                else dataclasses.replace(cfg, max_nodes=bucket_nodes))
        bucket = self._buckets.get(bcfg)
        if bucket is None:
            if device != self.device:
                raise ValueError(
                    f"tenant {name!r} asks for {device}, the fleet serves "
                    f"on {self.device}")
        elif device != bucket.device:
            raise ValueError(
                f"tenant {name!r} asks for {device}, its bucket serves on "
                f"{bucket.device}")
        loop = SchedulerLoop(client, bcfg, method="parallel", device=device,
                             **loop_kwargs)
        loop.cluster_id = name
        # Surfaced so a tenant's own /debug/fleet renders the fleet view.
        loop.fleet = self
        tenant = Tenant(name=name, loop=loop, bucket_nodes=bucket_nodes,
                        checkpoint_dir=checkpoint_dir)
        if bucket is None:
            bucket = self._buckets[bcfg] = _Bucket(bcfg, device)
        bucket.tenants.append(tenant)
        self._tenants[name] = tenant
        if warm_start and loop.policy is not None:
            self._try_warm_start(tenant)
        return tenant

    def remove_tenant(self, name: str) -> None:
        tenant = self._tenants.pop(name)
        for bucket in self._buckets.values():
            if tenant in bucket.tenants:
                bucket.tenants.remove(tenant)
        tenant.loop.stop_bind_worker()

    def tenant(self, name: str) -> Tenant:
        return self._tenants[name]

    def _try_warm_start(self, tenant: Tenant) -> None:
        """Seed the tenant's policy from the closest promoted donor: a
        no-op until the tenant's encoder has nodes to fingerprint
        (maintain retries) or when the registry has no usable donor."""
        loop = tenant.loop
        if tenant.transfer_donor is not None or loop.policy is None:
            return
        features = loop.encoder.topology_features()
        if features["nodes"] <= 0:
            return
        rec = self.registry.warm_start(loop.policy, features,
                                       exclude=tenant.name)
        if rec is not None:
            tenant.transfer_donor = rec.to_dict()

    # -- serving ------------------------------------------------------

    def step(self) -> int:
        """One batched cycle across every bucket; returns pods bound
        fleet-wide."""
        self.cycles_total += 1
        bound = 0
        for bucket in self._buckets.values():
            bound += self._step_bucket(bucket)
        return bound

    def _step_bucket(self, bucket: _Bucket) -> int:
        cfg = bucket.cfg
        lanes = []   # (tenant, sb, pods, batch, state, static, version,
        #              node_table)
        gangs = []   # (tenant, ready)
        for tenant in bucket.tenants:
            loop = tenant.loop
            # Same per-cycle prologue as SchedulerLoop.run_once.
            budget = getattr(loop.client, "retry_budget", None)
            if budget is not None:
                budget.begin_cycle()
            if loop._relist_needed:
                loop.relist_audit()
            if loop._parked_binds:
                loop._drain_parked_binds()
            pods = loop.queue.pop_batch(cfg.max_pods, 0.0)
            pods, ready = loop._gang_gate(pods)
            if ready:
                gangs.append((tenant, ready))
            if not pods:
                loop._emit_degraded_events()
                continue
            sb = loop._span_begin("fleet")
            batch, state, version, node_table = \
                loop._cycle_inputs(sb, pods)
            static = loop._static_for(state, version)
            lanes.append((tenant, sb, pods, batch, state, static,
                          version, node_table))
        bound = 0
        if lanes:
            filler = bucket.filler()
            states = [w[4] for w in lanes]
            batches = [w[3] for w in lanes]
            statics = [w[5] for w in lanes]
            while len(states) < bucket.capacity:
                states.append(filler[0])
                batches.append(filler[1])
                statics.append(filler[2])
            t0 = time.perf_counter()
            asg_dev, rounds_dev = fleet_assign_lanes(states, batches,
                                                     statics, cfg)
            asg = _to_host(asg_dev)
            rounds = _to_host(rounds_dev)
            dt = time.perf_counter() - t0
            self.dispatches_total += 1
            self.dispatch_lanes_total += len(lanes)
            for k, (tenant, sb, pods, batch, state, static, version,
                    node_table) in enumerate(lanes):
                loop = tenant.loop
                # Every tenant's span carries the SHARED dispatch wall:
                # the whole bucket waits on one call, so that wall IS
                # each tenant's score_assign cost this cycle.
                with loop._cycle(sb):
                    tracing.record("score_assign", t0, dt)
                cycle_rounds = int(rounds[k])
                with loop._round_lock:
                    loop.round_samples.append(cycle_rounds)
                bound += loop._cycle_outputs(
                    sb, pods, batch, state, static, node_table, asg[k],
                    cycle_rounds, version, path="fleet")
        for tenant, ready in gangs:
            for key, members in ready:
                bound += tenant.loop._schedule_gang(key, members)
        return bound

    # -- maintenance --------------------------------------------------

    def maintain(self) -> None:
        """Per-tenant maintain (the solo cadence) plus fleet
        bookkeeping: pending warm starts retried, fresh promotions
        registered as donors."""
        for tenant in self._tenants.values():
            tenant.loop.maintain()
            self._try_warm_start(tenant)
            self.register_donor(tenant.name)

    def register_donor(self, name: str) -> bool:
        """Push ``name``'s policy into the transfer registry if it holds
        a promotion the registry has not seen."""
        tenant = self._tenants[name]
        policy = tenant.loop.policy
        if policy is None:
            return False
        pv = int(policy.promoted_version)
        if pv <= 0 or pv == tenant._registered_version:
            return False
        rec = self.registry.register(
            name, tenant.loop.encoder.topology_features(), policy)
        if rec is None:
            return False
        tenant._registered_version = pv
        return True

    def save_tenant(self, name: str) -> None:
        """Checkpoint one tenant into ITS OWN directory, stamped with
        the tenant identity via ``extra_meta``."""
        from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
            save_checkpoint,
        )

        tenant = self._tenants[name]
        if tenant.checkpoint_dir is None:
            raise ValueError(f"tenant {name!r} has no checkpoint_dir")
        save_checkpoint(tenant.checkpoint_dir, tenant.loop.encoder,
                        policy=tenant.loop.policy,
                        extra_meta={"fleet": {"cluster_id": name}})

    def close(self) -> None:
        for tenant in list(self._tenants.values()):
            tenant.loop.stop_bind_worker()
            tenant.loop.stop_static_refresher()

    # -- observability ------------------------------------------------

    def summary(self) -> dict[str, Any]:
        """One-shot stats block for /debug/fleet and selfmetrics."""
        buckets = {}
        for cfg, bucket in self._buckets.items():
            buckets[str(cfg.max_nodes)] = {
                "capacity": bucket.capacity,
                "tenants": [t.name for t in bucket.tenants],
            }
        tenants = {}
        for name, tenant in self._tenants.items():
            loop = tenant.loop
            tenants[name] = {
                "bucket_nodes": tenant.bucket_nodes,
                "queue_depth": len(loop.queue),
                "scheduled": int(loop.scheduled),
                "transfer_donor": tenant.transfer_donor,
                "slo": (loop.slo.snapshot()
                        if loop.slo is not None else None),
            }
        return {
            "enabled": True,
            "cycles_total": self.cycles_total,
            "dispatches_total": self.dispatches_total,
            "dispatch_lanes_total": self.dispatch_lanes_total,
            "buckets": buckets,
            "tenants": tenants,
            "transfer": self.registry.summary(),
        }
