"""Control-plane chaos: seeded fault schedules over the fake apiserver.

The PyTorch package's copy of the JAX package's ``k8s/chaos.py``, on the
port's own client, breaker and retry budget (``k8s/kubeclient.py``); the
soak drives the port's :class:`SchedulerLoop` on ``device``.

The reference scheduler died the moment its control plane misbehaved
(nil-body read on a failed scrape, scheduler.go:397-405).  This module
makes control-plane misbehaviour a *first-class, reproducible input*:

- :class:`ChaosFault` / :class:`ChaosSchedule` — a declarative,
  seed-generated fault timeline (which fault class, when, how hard).
- :class:`ChaosKubeProxy` — a :class:`ClusterClient` that wraps the
  in-process :class:`FakeCluster` and executes the schedule against
  every API call: 5xx bursts, connection resets, added per-request
  latency (slowloris), watch-stream drops, resourceVersion expiry
  (410 Gone), partial bind-fanout failure, and the nastiest class —
  ``bind_blackhole``, where the bind IS applied server-side but the
  response is lost, so the scheduler's retry collides with its own
  earlier success mid-pipeline-retire.
- :func:`check_invariants` — the post-fault truth audit: no pod bound
  twice, no pod silently lost, usage ledger == server truth.
- :func:`run_chaos_soak` — drives a full :class:`SchedulerLoop` on
  VIRTUAL time through the schedule and emits the ``chaos_soak``
  benchmark document (time-to-recover, throughput-under-brownout,
  invariant counters).

Everything is deterministic from the seed: the schedule, the per-call
fault draws, the workload, and therefore the recovery trace.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Sequence

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.k8s.client import ClusterClient
from kubernetesnetawarescheduler_tpu_torch.k8s.kubeclient import (
    ApiServerError,
    CircuitBreaker,
    RetryBudget,
    _brownout_error,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
    Binding,
    Event,
    Node,
    Pod,
)

#: Every fault class the proxy knows how to inject.  ``watch_410``
#: models resourceVersion expiry (the server compacts history and the
#: watch must relist); ``bind_blackhole`` models an applied-but-
#: unacknowledged bind landing mid-pipeline-retire.
FAULT_CLASSES = ("http_5xx", "conn_reset", "latency", "watch_drop",
                 "watch_410", "bind_partial", "bind_blackhole")

_WATCH_KINDS = ("watch_drop", "watch_410")


@dataclasses.dataclass(frozen=True, slots=True)
class ChaosFault:
    """One fault window on the schedule timeline.

    ``probability`` gates per-request injection for the unary faults
    (a brownout is rarely 100% loss); ``fail_fraction`` plays the same
    role for the per-binding faults; ``latency_s`` is the added
    per-request delay for the ``latency`` class.  Times are seconds on
    the proxy's (virtual) clock.
    """

    kind: str
    start_s: float
    duration_s: float
    probability: float = 1.0
    latency_s: float = 0.0
    fail_fraction: float = 1.0

    def active(self, now: float) -> bool:
        return self.start_s <= now < self.start_s + self.duration_s

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True, slots=True)
class ChaosSchedule:
    """A seed-derived fault timeline: one window per requested class,
    spaced so each fault gets a clean recovery runway (overlapping
    windows are legal — hand-build the ``faults`` tuple for that)."""

    seed: int
    faults: tuple[ChaosFault, ...]

    @classmethod
    def generate(cls, seed: int,
                 classes: Sequence[str] = FAULT_CLASSES,
                 start_after_s: float = 2.0,
                 spacing_s: float = 6.0,
                 base_duration_s: float = 2.0) -> "ChaosSchedule":
        unknown = [c for c in classes if c not in FAULT_CLASSES]
        if unknown:
            raise ValueError(f"unknown fault classes: {unknown}")
        rng = np.random.default_rng(seed)
        faults: list[ChaosFault] = []
        t = float(start_after_s)
        for kind in classes:
            dur = float(base_duration_s) * float(rng.uniform(0.75, 1.5))
            faults.append(ChaosFault(
                kind=kind,
                start_s=round(t, 3),
                duration_s=round(dur, 3),
                probability=(float(rng.uniform(0.6, 0.95))
                             if kind in ("http_5xx", "conn_reset")
                             else 1.0),
                latency_s=(float(rng.uniform(0.05, 0.3))
                           if kind == "latency" else 0.0),
                fail_fraction=(float(rng.uniform(0.4, 0.8))
                               if kind in ("bind_partial",
                                           "bind_blackhole")
                               else 1.0)))
            t += float(spacing_s)
        return cls(seed=int(seed), faults=tuple(faults))

    def active(self, now: float) -> list[ChaosFault]:
        return [f for f in self.faults if f.active(now)]

    @property
    def end_s(self) -> float:
        return max((f.end_s for f in self.faults), default=0.0)

    @property
    def classes(self) -> list[str]:
        seen: list[str] = []
        for f in self.faults:
            if f.kind not in seen:
                seen.append(f.kind)
        return seen

    def to_dicts(self) -> list[dict]:
        return [f.to_dict() for f in self.faults]


class ChaosKubeProxy(ClusterClient):
    """A fault-injecting apiserver proxy around :class:`FakeCluster`.

    Sits where the real apiserver would: every read/write the
    scheduler issues passes through :meth:`_unary_fault` (raising
    :class:`ApiServerError` 503s / :class:`ConnectionResetError`
    during active windows), the bind fanout gets per-binding verdicts
    (fail / blackhole / ok), and watch fanout is suppressed during
    ``watch_drop``/``watch_410`` windows with the gap surfaced to
    :meth:`on_watch_gap` handlers when the window ends (a real client
    notices the gap at reconnect).

    The proxy owns the breaker + retry budget the loop reads — the
    same objects a real :class:`KubeClient` would own — fed from the
    *observed* outcome of every call, injected or genuine.  Time is a
    manual virtual clock (:meth:`advance`), shared with the breaker so
    cooldowns elapse deterministically in a soak.
    """

    def __init__(self, inner, schedule: ChaosSchedule,
                 failure_threshold: int = 5, window_s: float = 30.0,
                 cooldown_s: float = 2.0, retry_budget: int = 8) -> None:
        self.inner = inner
        self.schedule = schedule
        self._now = 0.0
        self._time_lock = threading.Lock()
        self.breaker = CircuitBreaker(
            failure_threshold=failure_threshold, window_s=window_s,
            cooldown_s=cooldown_s, clock=self.clock)
        self.retry_budget = RetryBudget(retry_budget)
        # Per-call draws come from a stream derived from (not equal
        # to) the schedule seed, so schedule shape and draw sequence
        # are independent.
        self._rng = np.random.default_rng(
            np.random.SeedSequence(schedule.seed).spawn(1)[0])
        self._rng_lock = threading.Lock()
        # Watch interposition: outer handlers per channel; we register
        # one fan-out shim per channel with the inner cluster.
        self._handlers: dict[str, list] = {
            "pod_added": [], "node_added": [], "pod_deleted": [],
            "node_deleted": [], "pdb_changed": []}
        self._interposed: set[str] = set()
        self._gap_handlers: list[Callable[[str], None]] = []
        self._prev_watch_active: set[ChaosFault] = set()
        # Injection ledger (inspected by tests and the soak doc).
        self.injected: dict[str, int] = {k: 0 for k in FAULT_CLASSES}
        self.injected_latency_s = 0.0
        self.dropped_watch_events = 0
        self.dropped_event_posts = 0
        self.blackholed_binds = 0

    # ---- virtual time --------------------------------------------

    def clock(self) -> float:
        with self._time_lock:
            return self._now

    def advance(self, dt: float) -> None:
        """Advance virtual time and deliver end-of-window effects
        (watch gaps fire when their window closes)."""
        with self._time_lock:
            self._now += float(dt)
        self.tick()

    def tick(self) -> None:
        """Fire watch-gap notifications for watch windows that just
        ended — the moment a reconnecting client would discover its
        resourceVersion no longer resumes."""
        now = self.clock()
        active = {f for f in self.schedule.faults
                  if f.kind in _WATCH_KINDS and f.active(now)}
        ended = self._prev_watch_active - active
        self._prev_watch_active = active
        for fault in sorted(ended, key=lambda f: f.start_s):
            reason = ("watch: 410 Gone (resourceVersion expired)"
                      if fault.kind == "watch_410"
                      else "watch: stream dropped")
            for handler in list(self._gap_handlers):
                try:
                    handler(reason)
                except Exception:
                    pass

    # ---- fault plumbing ------------------------------------------

    def _draw(self) -> float:
        with self._rng_lock:
            return float(self._rng.random())

    def _watch_suppressed(self) -> bool:
        now = self.clock()
        return any(f.kind in _WATCH_KINDS and f.active(now)
                   for f in self.schedule.faults)

    def _unary_fault(self, op: str) -> None:
        """Raise the injected failure for a plain request, if any
        active window draws one; otherwise record the success."""
        now = self.clock()
        for fault in self.schedule.active(now):
            if (fault.kind == "http_5xx"
                    and self._draw() < fault.probability):
                self.injected["http_5xx"] += 1
                self.breaker.record_failure()
                raise ApiServerError(
                    f"injected 503 on {op}", status=503)
            if (fault.kind == "conn_reset"
                    and self._draw() < fault.probability):
                self.injected["conn_reset"] += 1
                self.breaker.record_failure()
                raise ConnectionResetError(
                    f"injected connection reset on {op}")
            if fault.kind == "latency":
                self.injected["latency"] += 1
                self.injected_latency_s += fault.latency_s
        self.breaker.record_success()

    def _bind_verdict(self) -> tuple[str, Exception | None]:
        """Per-binding fate: ``("ok", None)``, ``("fail", exc)`` (not
        applied), or ``("blackhole", None)`` (applied, response
        lost)."""
        now = self.clock()
        for fault in self.schedule.active(now):
            if (fault.kind == "http_5xx"
                    and self._draw() < fault.probability):
                self.injected["http_5xx"] += 1
                return "fail", ApiServerError(
                    "injected 503 on bind", status=503)
            if (fault.kind == "conn_reset"
                    and self._draw() < fault.probability):
                self.injected["conn_reset"] += 1
                return "fail", ConnectionResetError(
                    "injected connection reset on bind")
            if (fault.kind == "bind_partial"
                    and self._draw() < fault.fail_fraction):
                self.injected["bind_partial"] += 1
                return "fail", ApiServerError(
                    "injected 503 mid bind fanout", status=503)
            if (fault.kind == "bind_blackhole"
                    and self._draw() < fault.fail_fraction):
                self.injected["bind_blackhole"] += 1
                return "blackhole", None
            if fault.kind == "latency":
                self.injected["latency"] += 1
                self.injected_latency_s += fault.latency_s
        return "ok", None

    def _record_outcome(self, exc: Exception | None) -> None:
        if exc is None or not _brownout_error(exc):
            self.breaker.record_success()
        else:
            self.breaker.record_failure()

    # ---- watch registration (interposed) -------------------------

    def _interpose(self, channel: str, register) -> None:
        if channel not in self._interposed:
            self._interposed.add(channel)

            def fan(*args, _ch=channel):
                if self._watch_suppressed():
                    self.dropped_watch_events += 1
                    return
                for handler in list(self._handlers[_ch]):
                    handler(*args)

            register(fan)

    def on_pod_added(self, handler) -> None:
        self._handlers["pod_added"].append(handler)
        self._interpose("pod_added", self.inner.on_pod_added)

    def on_node_added(self, handler) -> None:
        self._handlers["node_added"].append(handler)
        self._interpose("node_added", self.inner.on_node_added)

    def on_pod_deleted(self, handler) -> None:
        self._handlers["pod_deleted"].append(handler)
        self._interpose("pod_deleted", self.inner.on_pod_deleted)

    def on_node_deleted(self, handler) -> None:
        self._handlers["node_deleted"].append(handler)
        self._interpose("node_deleted", self.inner.on_node_deleted)

    def on_pdb_changed(self, handler) -> None:
        self._handlers["pdb_changed"].append(handler)
        self._interpose("pdb_changed", self.inner.on_pdb_changed)

    def on_watch_gap(self, handler) -> None:
        self._gap_handlers.append(handler)

    # ---- reads ----------------------------------------------------

    def list_nodes(self) -> Sequence[Node]:
        self._unary_fault("list nodes")
        return self.inner.list_nodes()

    def list_pending_pods(self) -> Sequence[Pod]:
        self._unary_fault("list pending pods")
        return self.inner.list_pending_pods()

    def list_all_pods(self):
        self._unary_fault("list all pods")
        return self.inner.list_all_pods()

    def list_pdbs(self):
        self._unary_fault("list pdbs")
        return self.inner.list_pdbs()

    # node_of / get_pod model warm watch-cache reads (KubeClient
    # serves them from its informer cache, no round trip): no fault.
    def node_of(self, pod_name: str) -> str:
        return self.inner.node_of(pod_name)

    def get_pod(self, pod_name: str):
        return self.inner.get_pod(pod_name)

    # ---- writes ---------------------------------------------------

    def bind(self, binding: Binding) -> None:
        err = self.bind_many([binding])[0]
        if err is not None:
            raise err

    def bind_many(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        if not bindings:
            return []
        out: list[Exception | None] = [None] * len(bindings)
        apply_idx: list[int] = []
        blackhole_idx: list[int] = []
        for i in range(len(bindings)):
            fate, exc = self._bind_verdict()
            if fate == "fail":
                out[i] = exc
            else:
                apply_idx.append(i)
                if fate == "blackhole":
                    blackhole_idx.append(i)
        inner_out = self.inner.bind_many(
            [bindings[i] for i in apply_idx])
        for i, err in zip(apply_idx, inner_out):
            out[i] = err
        for i in blackhole_idx:
            if out[i] is None:
                # Applied server-side, acknowledgement lost: the
                # caller sees a transport error and will retry into
                # its own earlier success (the 409-heal path).
                self.blackholed_binds += 1
                out[i] = ConnectionResetError(
                    "injected reset after bind applied")
        for err in out:
            self._record_outcome(err)
        return out

    def bind_gang(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        # The gang bind is one transaction: a drawn fault fails the
        # whole call without applying anything (all-or-nothing holds
        # under chaos too).
        fate, exc = self._bind_verdict()
        if fate == "fail":
            self._record_outcome(exc)
            return [exc] * len(bindings)
        if fate == "blackhole":
            out = self.inner.bind_gang(bindings)
            if all(err is None for err in out):
                self.blackholed_binds += len(bindings)
                lost = ConnectionResetError(
                    "injected reset after gang bind applied")
                out = [lost] * len(bindings)
            for err in out:
                self._record_outcome(err)
            return out
        out = self.inner.bind_gang(bindings)
        for err in out:
            self._record_outcome(err)
        return out

    def create_event(self, event: Event) -> None:
        # Event POSTs are best-effort in KubeClient (never raise); a
        # browned-out server just loses them.
        now = self.clock()
        for fault in self.schedule.active(now):
            if (fault.kind in ("http_5xx", "conn_reset")
                    and self._draw() < fault.probability):
                self.dropped_event_posts += 1
                self.breaker.record_failure()
                return
        self.inner.create_event(event)

    def create_events(self, events: Sequence[Event]) -> None:
        for event in events:
            self.create_event(event)

    def delete_pod(self, name: str, namespace: str = "default",
                   grace_period_seconds: int | None = None) -> None:
        self._unary_fault("delete pod")
        self.inner.delete_pod(
            name, namespace=namespace,
            grace_period_seconds=grace_period_seconds)

    # ---- harness passthrough (test setup, not API traffic) --------

    def add_node(self, node: Node) -> None:
        self.inner.add_node(node)

    def add_pod(self, pod: Pod) -> None:
        self.inner.add_pod(pod)

    def add_pods(self, pods) -> None:
        self.inner.add_pods(pods)

    def delete_node(self, name: str) -> None:
        self.inner.delete_node(name)

    @property
    def bindings(self):
        return self.inner.bindings

    @property
    def events(self):
        return self.inner.events


def check_invariants(loop, cluster) -> dict[str, int]:
    """Audit scheduler state against server truth after the fault
    clears.  All four counters must be zero for a healthy recovery:

    - ``pods_double_bound``: a pod name appears in >1 binding.
    - ``pods_lost``: a pending pod the scheduler is responsible for
      with NO trace — not queued, not parked, not gang-gated, not
      awaiting preemption, and no Warning event telling an operator
      why.  Silent loss is the one unforgivable failure.
    - ``ledger_orphans``: usage committed for a pod not actually
      bound on the server (phantom usage -> under-scheduling).
    - ``ledger_missing``: a bound pod with no committed usage
      (invisible load -> over-scheduling).
    """
    from kubernetesnetawarescheduler_tpu_torch.core.gang import gang_key_of

    names = [b.pod_name for b in cluster.bindings]
    double_bound = len(names) - len(set(names))

    enc = loop.encoder
    with enc._lock:
        committed = set(enc._committed)
    all_pods = cluster.list_all_pods() or []
    bound = {p.uid for p in all_pods if p.node_name}
    ledger_orphans = len(committed - bound)
    ledger_missing = len(bound - committed)

    warned = {e.involved_pod for e in cluster.events
              if e.type == "Warning"}
    queued = set(getattr(loop.queue, "_queued", ()))
    lost = 0
    for pod in cluster.list_pending_pods():
        if pod.scheduler_name != loop.cfg.scheduler_name:
            continue
        if (pod.uid in loop._parked_uids
                or pod.uid in loop._awaiting_preemption
                or f"{pod.namespace}/{pod.name}" in queued
                or pod.name in warned
                or (loop.gangs is not None and gang_key_of(pod))):
            continue
        lost += 1
    return {"pods_double_bound": double_bound,
            "pods_lost": lost,
            "ledger_orphans": ledger_orphans,
            "ledger_missing": ledger_missing}


def run_chaos_soak(seed: int = 0, num_nodes: int = 32,
                   num_pods: int = 192,
                   classes: Sequence[str] = FAULT_CLASSES,
                   cycle_s: float = 0.25,
                   recovery_limit_s: float = 120.0,
                   pipelined: bool = True,
                   spacing_s: float = 6.0,
                   base_duration_s: float = 2.0,
                   state_faults: bool = False,
                   device="cuda") -> dict:
    """Drive a full SchedulerLoop through a seeded fault schedule on
    virtual time and return the ``chaos_soak`` benchmark document.

    Pods arrive in waves across the fault horizon so every brownout
    window sees live traffic; after the last window the loop keeps
    cycling until the backlog drains and the breaker closes (or
    ``recovery_limit_s`` of virtual time elapses — reported, not
    raised, so the artifact shows the failure).

    ``state_faults=True`` layers the state-layer chaos on top of
    the control-plane schedule: a seeded
    :class:`~..core.state_chaos.StateChaosInjector` corrupts the
    device planes mid-soak and an
    :class:`~..core.integrity.IntegrityAuditor` (driven inline every
    maintain interval, not on its own thread — virtual time) must
    detect and repair each one; the counters land in
    ``detail["integrity"]``.  The loop runs the config's default
    ``score_backend="xla"``: the dense torch path on ``device``.
    """
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop

    cfg = SchedulerConfig(max_nodes=max(num_nodes, 8), max_pods=16,
                          max_peers=4,
                          queue_capacity=num_pods + 64)
    schedule = ChaosSchedule.generate(
        seed, classes=classes, spacing_s=spacing_s,
        base_duration_s=base_duration_s)
    proxy, lat, bw = build_fake_cluster(
        ClusterSpec(num_nodes=num_nodes, seed=seed + 1),
        chaos=schedule)
    loop = SchedulerLoop(proxy, cfg, method="parallel",
                         burst_batches=4, pipelined=pipelined,
                         device=device)
    loop.encoder.set_network(lat, bw)
    feed_metrics(proxy.inner, loop.encoder,
                 np.random.default_rng(seed + 2))
    pods = generate_workload(
        WorkloadSpec(num_pods=num_pods, seed=seed + 3, services=8,
                     peer_fraction=0.4, affinity_fraction=0.1,
                     anti_fraction=0.1),
        scheduler_name=cfg.scheduler_name)

    auditor = injector = None
    if state_faults:
        from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
            IntegrityAuditor,
        )
        from kubernetesnetawarescheduler_tpu_torch.core.state_chaos import (
            StateChaosInjector,
        )

        auditor = IntegrityAuditor(loop.encoder, loop)
        injector = StateChaosInjector(loop.encoder, seed=seed + 4,
                                      loop=loop)
        loop.integrity = auditor
        loop.state_chaos = injector

    horizon = schedule.end_s + 1.0
    # Wave arrivals: evenly spread over the horizon so each window
    # browns out live traffic (index by arrival cycle).
    arrivals: dict[int, list] = {}
    total_cycles = max(1, int(horizon / cycle_s))
    for i, pod in enumerate(pods):
        arrivals.setdefault(i * total_cycles // len(pods),
                            []).append(pod)

    healthy_cycles = healthy_assumed = 0
    brownout_cycles = brownout_assumed = 0
    degraded_cycles = 0
    last_fault_end = schedule.end_s
    recovered_at: float | None = None
    cycle = 0
    while True:
        now = proxy.clock()
        if cycle in arrivals:
            proxy.add_pods(arrivals.pop(cycle))
        faulted = bool(schedule.active(now))
        assumed = loop.run_once()
        if loop.degraded:
            degraded_cycles += 1
        if now < horizon:
            if faulted:
                brownout_cycles += 1
                brownout_assumed += assumed
            else:
                healthy_cycles += 1
                healthy_assumed += assumed
        if cycle % 16 == 15:
            loop.maintain()
            if injector is not None and now < horizon:
                # One state fault per maintain interval, audited
                # inline right after — the soak proves repair keeps
                # pace with injection under live traffic.
                injector.inject_random()
                auditor.audit_once()
        proxy.advance(cycle_s)
        cycle += 1
        now = proxy.clock()
        if now >= horizon and not arrivals:
            done = (len(loop.queue) == 0
                    and not loop._parked_binds
                    and loop._pipe_inflight is None
                    and loop.breaker.state == "closed")
            if done:
                # One settling pass: retire anything the bind worker
                # still holds, then confirm nothing reappeared.
                loop.flush_binds()
                loop.run_once()
                if (len(loop.queue) == 0 and not loop._parked_binds
                        and loop._pipe_inflight is None):
                    recovered_at = proxy.clock()
                    break
            if now - horizon > recovery_limit_s:
                break
    # Final settle on healthy control plane.
    loop.flush_binds()
    loop.maintain()
    loop.run_until_drained(max_cycles=50)
    loop.flush_binds()
    loop.stop_bind_worker()

    invariants = check_invariants(loop, proxy.inner)
    time_to_recover = (max(0.0, recovered_at - last_fault_end)
                       if recovered_at is not None else None)
    return {
        "metric": "chaos_soak",
        "seed": int(seed),
        "fault_classes": list(schedule.classes),
        "schedule": schedule.to_dicts(),
        "invariants": invariants,
        "recovered": recovered_at is not None,
        "time_to_recover_s": time_to_recover,
        "detail": {
            "virtual_cycle_s": cycle_s,
            "cycles": cycle,
            "pods": num_pods,
            "nodes": num_nodes,
            "scheduled": loop.scheduled,
            "unschedulable": loop.unschedulable,
            "bound": len(proxy.inner.bindings),
            "healthy": {"cycles": healthy_cycles,
                        "assumed": healthy_assumed,
                        "assumed_per_cycle": (
                            healthy_assumed / healthy_cycles
                            if healthy_cycles else 0.0)},
            "brownout": {"cycles": brownout_cycles,
                         "assumed": brownout_assumed,
                         "assumed_per_cycle": (
                             brownout_assumed / brownout_cycles
                             if brownout_cycles else 0.0)},
            "degraded_cycles": degraded_cycles,
            "binds_parked_total": loop.binds_parked_total,
            "breaker_opens": loop.breaker.opens_total,
            "watch_gaps": loop.watch_gaps,
            "relists": loop.relists,
            "relist_repairs": loop.relist_repairs,
            "parked_dropped": loop.parked_dropped,
            "injected": dict(proxy.injected),
            "injected_latency_s": round(proxy.injected_latency_s, 4),
            "dropped_watch_events": proxy.dropped_watch_events,
            "dropped_event_posts": proxy.dropped_event_posts,
            "blackholed_binds": proxy.blackholed_binds,
            **({"integrity": {
                "state_faults_injected": dict(injector.injected),
                "audits": auditor.audits_total,
                "drift_detected": auditor.drift_detected_total,
                "repairs": dict(auditor.repairs),
                "unrepaired": auditor.unrepaired_total,
            }} if auditor is not None else {}),
        },
    }
