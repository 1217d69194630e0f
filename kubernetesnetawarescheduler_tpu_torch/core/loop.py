"""The watch -> queue -> score -> bind loop.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/core/loop.py``:
the same :class:`SchedulerLoop`, with the serial, burst, pipelined and
multicycle cycle paths, gangs, preemption, async and coalesced binds,
the static cache and its refresher, and the degraded-mode, relist and
reconcile paths.  What differs from the JAX loop:

- Each device step launches its own operations (``assign_parallel``'s
  conflict loop syncs with the host once per round), so a "dispatch"
  runs the whole step before it returns; the pipelined path's overlap
  is the encode-ahead of the next burst against the retire of the last.
- The assignment reaches the host through ``.cpu()`` (:func:`_to_host`),
  which waits for the kernels that wrote it.
- A ``mesh`` (``parallel/sharding.py``) runs the cycle's assign, the
  webhook's score and the backlog burst as explicit SPMD over its ranks
  (``serving_fns``); every rank of the mesh must join each call, which
  ``parallel/serve_multihost.py`` arranges for the ranks that are not
  rank 0.  Placement quality, SLOs, the learned policy with its promotion gate
  (whose replay leg runs ``policy_eval_trace`` on the loop's device)
  and rebalancing are ported; a device fault inside a maintain-time
  tick or at the commit seam propagates instead of being swallowed with
  the host-side errors the JAX loop swallows.
- Explain capture (``enable_explain``) works under both score backends
  (the JAX loop records nothing under ``score_backend="pallas"``), and
  a capture dropped on a host-side error is counted in the flight
  recorder's ``explains_failed`` instead of vanishing.
- torch keeps no executable cache, so ``jit_cache_miss_total`` stays 0.

Two threads besides the cycle thread touch tensors: the static
refresher (``enable_async_static``) builds the static prep, and the
bind workers only read host data.  Every thread enqueues on the
device's current stream, which torch shares across threads unless one
is set, so a static published by the refresher (under ``_static_cv``)
is ordered before every kernel the cycle thread enqueues after reading
it.  The pipelined path's encode-ahead thread does host work only;
``finalize_stream`` uploads on the cycle thread.

The reference's ``Schedule()`` cycle (scheduler.go:189-237) popped ONE
pod, re-scraped the whole cluster synchronously, picked a node and
POSTed a Binding plus a "Scheduled" Event.  This loop keeps the same
external contract — pods in, Bindings + Events out — but pops a *batch*
from the queue, encodes it once, runs the fused score/assign kernel on
device, then emits one Binding/Event per pod.  Telemetry arrives
asynchronously through the :class:`~.encode.Encoder`, never inside the
cycle.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.assign import (
    assign_greedy,
    assign_parallel,
)
from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
from kubernetesnetawarescheduler_tpu_torch.core.gang import (
    GangRegistry,
    gang_key_of,
    gang_shapes_of,
    place_gang,
    place_gang_shaped,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    host_sync,
    is_device_error,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.client import ClusterClient
from kubernetesnetawarescheduler_tpu_torch.k8s.informer import Informer, PodQueue
from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
    Binding,
    Node,
    Pod,
    failed_event,
    scheduled_event,
)
from kubernetesnetawarescheduler_tpu_torch.utils import tracing
from kubernetesnetawarescheduler_tpu_torch.utils.flight import (
    NULL_SPAN,
    FlightRecorder,
)
from kubernetesnetawarescheduler_tpu_torch.utils.timeseries import (
    HistogramPhaseTimer,
    LogHistogram,
)


def _observation_guard(exc: BaseException) -> None:
    """The JAX loop swallows every error of a maintain-time layer or of
    the commit seam's observers; the port swallows host errors only and
    re-raises a fault of the device."""
    if is_device_error(exc):
        raise exc


class SchedulerLoop:
    """Owns the informer, encoder and queue; drives scheduling cycles."""

    def __init__(self, client: ClusterClient, cfg: SchedulerConfig,
                 method: str = "parallel", decision_log=None,
                 encoder: Encoder | None = None, mesh=None,
                 async_bind: bool = False,
                 burst_batches: int = 8,
                 pipelined: bool = False,
                 multicycle: int | None = None,
                 device="cuda") -> None:
        self.cfg = cfg
        self.client = client
        self.method = method
        # Three-stage software pipeline over the burst cycle: encode
        # of burst k+1 (host thread) overlaps the retire of burst k,
        # whose assignments are only fetched when the NEXT cycle
        # starts, while the network bind of burst k-1 drains on the
        # async-bind worker.  Commit/assume semantics are unchanged —
        # usage is committed at retire time, after the fetch, exactly
        # as the serial burst does — so assignments are bit-identical
        # to serial mode on the same feed.  Implies async_bind: without
        # the bind worker the third stage would re-serialize behind the
        # cycle.
        self.pipelined = bool(pipelined)
        async_bind = async_bind or self.pipelined
        # Backlog burst mode: when the queue holds at least two full
        # batches, drain up to ``burst_batches`` of them through ONE
        # replay call (the replay's per-batch step) and ONE
        # device->host assignment fetch, one encode and one snapshot.
        # Semantics are the per-batch cycle's: the replay step is the
        # SAME score->assign->commit body, and in-stream peers resolve
        # against earlier batches' placements exactly as sequential
        # cycles would.  0 or 1 disables.
        self.burst_batches = burst_batches
        # Persistent multi-cycle serving window: under a deep backlog,
        # encode a K-wave window ONCE, stage the waves through a device
        # ring (core/encode.DeviceWaveRing) and run ONE replay over all
        # K logical cycles.  Waves are RETIRED (fetch + assume + bind
        # enqueue) one logical cycle per retire; usage commits ONLY at
        # retire, so a mid-window crash restores to the last retired
        # cycle with no half-committed wave.  K=1 (the default) is the
        # burst/serial path; K>1 places every pod where K sequential
        # per-batch steps would.
        self.multicycle = int(multicycle if multicycle is not None
                              else getattr(cfg, "multicycle", 1))
        # Assume-then-bind (kube-scheduler's own cache pattern): the
        # cycle commits usage to the encoder IMMEDIATELY after the
        # kernel decides ("assume") and hands the network bind to a
        # worker thread, so the next cycle's snapshot sees the
        # placements without waiting a bind_many round-trip.  A bind
        # that the API server later rejects is rolled back via the
        # ledger-driven encoder.release.  Off by default: the
        # synchronous cycle is the reference's shape
        # (scheduler.go:196-233) and what most tests pin; serve.py
        # enables it via --async-bind / config.
        self.async_bind = async_bind
        # Optional core.checkpoint.DecisionLog: records the kernel's
        # choice per pod (node or "" for unschedulable) at decision
        # time, the replayable record behind restart-determinism.
        self.decision_log = decision_log
        # A restored encoder (core.checkpoint.load_checkpoint) can be
        # injected to resume from a snapshot instead of re-ingesting.
        # Otherwise the loop builds one on ``device``; the device step
        # runs wherever the encoder's snapshots live.
        self.encoder = (encoder if encoder is not None
                        else Encoder(cfg, device=device))
        # HistogramPhaseTimer = PhaseTimer + per-phase log-bucketed
        # histograms (utils/timeseries.py): the summary families keep
        # their series while /metrics gains native _hist buckets.
        self.timer = HistogramPhaseTimer()
        # Decision-level tracing (utils/flight.py): every serving cycle
        # commits one CycleSpan into this bounded ring buffer, and the
        # queue stamps each popped pod into its per-pod ring.
        # Observation only — nothing here feeds back into scoring.
        # cfg.flight_recorder_size=0 disables the recorder entirely
        # (NULL_SPAN no-ops).
        self.flight: FlightRecorder | None = (
            FlightRecorder(cfg.flight_recorder_size, cfg.explain_retain,
                           cfg.flight_pod_records)
            if cfg.flight_recorder_size > 0 else None)
        self.queue = PodQueue(cfg.queue_capacity, records=(
            self.flight.pods if self.flight is not None else None))
        # Last-seen cumulative snapshot-upload byte counters, so spans
        # carry per-cycle delta-vs-full increments.
        self._flight_bytes = (0, 0)
        self.scheduled = 0
        self.unschedulable = 0
        self.burst_cycles = 0  # backlog bursts served (observability)
        self.bind_failures = 0
        self.preemptions = 0
        # Control-plane brownout resilience (see k8s/chaos.py and
        # docs/OPERATIONS.md "Failure modes & runbook"): the
        # transport's circuit breaker (None for plain in-memory
        # clients — every degraded-mode path is then dormant).  OPEN
        # means degraded mode: scoring/encode continue, decided binds
        # PARK (usage stays committed at assume, so later cycles score
        # exactly what the serial oracle would), and the backlog
        # drains FIFO on half-open/closed.
        self.breaker = getattr(client, "breaker", None)
        self.parked_dropped = 0    # _unsched_parked maxlen evictions
        self.watch_gaps = 0        # gap notifications from the client
        self.relists = 0           # relist audits run
        self.relist_repairs = 0    # drift items repaired by audits
        self.binds_parked_total = 0  # pods whose bind parked (breaker)
        self.binds_adopted = 0     # bound-elsewhere conflicts adopted
        self.binds_redirected = 0  # re-routed to the ledger's node
        self._relist_needed = False
        # State integrity & self-healing (core/integrity.py): serve.py
        # attaches the anti-entropy auditor under --audit-interval and
        # the seeded fault injector under --state-chaos; /metrics and
        # the chaos soak read the counters through these handles.
        self.integrity = None
        self.state_chaos = None
        # Outcome observability (obs/): the placement-quality observer
        # joins score-time predictions against later probe truth at the
        # commit seam; the SLO engine evaluates the declarative
        # objectives over multi-window burn rates.  Both are
        # observation-only (placements identical on or off) and
        # cfg-gated off by default.
        if cfg.enable_quality_obs:
            from kubernetesnetawarescheduler_tpu_torch.obs.quality import (
                QualityObserver,
            )

            self.quality: "QualityObserver | None" = QualityObserver(cfg)
        else:
            self.quality = None
        if cfg.enable_slo:
            from kubernetesnetawarescheduler_tpu_torch.obs.slo import (
                SLOEngine,
            )

            self.slo: "SLOEngine | None" = SLOEngine(cfg)
        else:
            self.slo = None
        self._slo_last_eval = 0.0
        self._quality_last_harvest = 0.0
        # Learned scoring policy (policy/): trains term multipliers off
        # the explain/outcome join on the encoder's device and
        # shadow-scores recorded decisions; candidate weights reach the
        # live scorer ONLY through the counterfactual promotion gate.
        # Disabled (default) nothing is constructed and scoring uses
        # cfg.weights.
        if cfg.enable_learned_score:
            from kubernetesnetawarescheduler_tpu_torch.policy import (
                PolicyDataset,
                ScoringPolicy,
            )

            self.policy: "ScoringPolicy | None" = ScoringPolicy(
                cfg, device=self.encoder.device)
            self.policy_dataset: "PolicyDataset | None" = (
                PolicyDataset(cfg, self.policy.k_pad))
        else:
            self.policy = None
            self.policy_dataset = None
        # Replay trace the eval tick's promotion gate replays; no
        # trace -> the gate refuses every promotion (shadow-only
        # fail-safe).
        self.policy_eval_trace: str | None = None
        self._policy_last_train = 0.0
        self._policy_last_eval = 0.0
        # Last-seen cumulative shadow-disagreement count, for the
        # per-span delta, and the newest explain t_wall already
        # shadow-ranked (the eval tick must not re-count records).
        self._policy_shadow_last = 0
        self._policy_shadow_twall = 0.0
        # Continuous rebalancing (core/rebalance.py): the budgeted
        # descheduler acts on the degradation signals the ingest only
        # measures.  Off by default; with budget 0 or the flag off,
        # placements are identical to no rebalancer at all.
        if cfg.enable_rebalance:
            from kubernetesnetawarescheduler_tpu_torch.core.rebalance import (
                Rebalancer,
            )

            self.rebalance: "Rebalancer | None" = Rebalancer(
                cfg, self.encoder, self.client)
        else:
            self.rebalance = None
        self._rebalance_last = (0, 0)
        # One-shot span tag set by StateChaosInjector._record: the
        # next committed cycle span carries the injected fault class,
        # so a trace reader sees WHICH cycle first ran on corrupted
        # state.
        self._state_fault_pending: str | None = None
        # Scenario replay (scenario/replay.py) sets these before each
        # cycle so committed spans carry the trace join key; outside a
        # replay they keep their pre-r13 defaults and spans serialize
        # unchanged.
        self.scenario_phase: str | None = None
        self.trace_offset = 0
        # Fleet tenancy (r15): the FleetServer stamps each tenant
        # loop with its logical cluster name so committed spans carry
        # the tenant join key; solo loops keep None and spans
        # serialize unchanged (pre-r15 traces still lint clean).
        self.cluster_id: str | None = None
        # "fresh" | "restored" | "ignored": serve.py records its
        # checkpoint-restore decision here; /readyz reports it.
        self.checkpoint_state = "fresh"
        self.max_bind_retries = 3
        self._bind_retries: dict[str, int] = {}
        self._preempt_attempts: dict[str, int] = {}
        # Preemptors waiting for victim-deletion confirmation:
        # uid -> (pod, outstanding victim uids, deadline).  Requeued by
        # _on_pod_gone when the set drains, or by maintain() past the
        # deadline.  Mutated from both the loop thread and the watch
        # thread — every structural access holds _preempt_lock (the
        # encoder's own lock is always acquired inside it, never the
        # reverse).
        self._awaiting_preemption: dict[
            str, tuple[Pod, set, float]] = {}
        self._preempt_lock = threading.Lock()
        if mesh is not None:
            # Mesh-sharded serving: the same cycle, with score + assign
            # run as SPMD over the mesh's (dp, tp) ranks; the webhook's
            # batcher picks up sharded_score, and the burst path the
            # sharded replay.  The three share one state placement.
            from kubernetesnetawarescheduler_tpu_torch.parallel.sharding \
                import serving_fns

            (self._assign, self.sharded_score,
             self._sharded_burst) = serving_fns(cfg, mesh, method)
        else:
            self.sharded_score = None
            self._sharded_burst = None
            self._assign = {"greedy": assign_greedy,
                            "parallel": assign_parallel}[method]
        # The mesh serving fns keep their own placement and static
        # caches; only the single-device path threads an explicit
        # static.
        self._assign_takes_static = mesh is None
        # Batch-invariant static prep cache (explicit (state, version)
        # threading): the O(N^2) metric-vote/network normalization
        # depends only on metrics/network/validity — never on
        # placements — so serving cycles reuse it until the encoder's
        # static version moves.
        self._static_version: int | None = None
        self._static_val = None
        # Incremental static refresh (cfg.enable_delta_state /
        # cfg.enable_async_static): the running net extrema that make
        # delta rebuilds exact, the background refresh worker, and the
        # observability counters the bench/selfmetrics read.  The
        # worker NEVER blocks a serving batch: _static_for hands the
        # rebuild off and keeps scoring against the last static until
        # the staleness contract (static_max_staleness_s /
        # static_max_versions_behind) forces a synchronous build.
        self._static_ex = None
        self._static_lock = threading.Lock()
        self._static_cv = threading.Condition(self._static_lock)
        self._static_req: tuple | None = None
        self._static_stop = False
        self._static_thread: threading.Thread | None = None
        self._static_stale_since: float | None = None
        self.static_refresh_total = 0
        self.static_sync_builds = 0
        # Log-bucketed histograms (utils/timeseries.py): a drop-in
        # window surface (append /
        # list / clear / len / [-1]) for existing consumers, plus
        # exact never-evicting bucket counts exported as native
        # Prometheus histograms.  Bounds in the RECORDED unit
        # (milliseconds / seconds respectively).
        self._static_refresh_ms = LogHistogram(
            lo=1e-2, hi=1e6, window=2048)
        self._staleness_samples = LogHistogram(
            lo=1e-3, hi=1e5, window=8192)
        # Conflict-round samples from serving cycles (parallel method,
        # one per batch) — the same observable the bench reports
        # (rounds_p50/p99), exposed through /metrics so an operator
        # sees round-bound latency without a replay harness.
        import queue as queue_mod
        from collections import deque

        self._bind_q: queue_mod.Queue | None = None
        self._bind_worker: threading.Thread | None = None
        self._bind_worker_err: list[BaseException] = []
        # Uids assumed by THIS process (duplicate-delivery filter for
        # the assume path).  Deliberately not the encoder ledger: a
        # restored checkpoint could, after an unclean shutdown, carry
        # a committed-but-never-bound pod, and filtering on the ledger
        # would drop its re-delivery before the network forever — the
        # sync path heals exactly that case via bind + commit dedup,
        # and with a process-local set the assume path does too.
        # Mutated from the cycle thread (add) and the bind worker
        # (discard on rollback); both are GIL-atomic set ops.
        self._assumed_uids: set[str] = set()
        # Assumed placements by pod NAME: the scheduler's own cache
        # for peer resolution (kube-scheduler style).  In async mode
        # client.node_of lags the bind worker, so resolving peers from
        # the API-server view made encode-time peer resolution RACE
        # bind latency — nondeterministic scores for pods whose peers
        # were decided but not yet confirmed.  Written at assume time,
        # dropped on rollback and on pod deletion; reads fall back to
        # the API-server view.  Values are (namespace, node) so the
        # bare-name alias (annotation peers use bare names) can be
        # dropped owner-checked — popping it unconditionally on pod
        # deletion would evict a same-named pod from another
        # namespace.  _alias_lock guards the compound read-modify-
        # write sequences (refcounted bare-alias poisoning below);
        # single-key reads stay lock-free (GIL-atomic), same threading
        # contract as _assumed_uids.
        self._assumed_node: dict[str, tuple[str, str]] = {}
        # Namespaces with a LIVE assumption per bare pod name.  While
        # two or more namespaces hold the same bare name, the bare
        # alias is ambiguous and stays dropped ("poisoned") — the
        # refcount makes the poison sticky across re-assumes (a dict
        # probe alone cannot distinguish "never collided" from
        # "poisoned then popped") and restores the survivor's alias
        # when the collision clears.
        self._bare_ns: dict[str, set[str]] = {}
        self._alias_lock = threading.Lock()
        # Pods the kernel rejected while unconfirmed assumptions held
        # capacity: requeued when a rollback frees some (bounded; the
        # periodic resync re-delivers anything dropped).
        self._unsched_parked: "deque[Pod]" = deque(maxlen=1024)
        # O(1) membership alongside the deque (PodQueue._queued's
        # pattern) so the per-deletion purge check in _on_pod_gone is
        # a set probe, not a 1024-entry scan under the lock.  May
        # over-approximate (a maxlen-evicted pod's uid lingers until
        # its deletion) — harmless: the rebuild just finds nothing.
        self._parked_uids: set[str] = set()
        # Guards every _unsched_parked iteration/mutation: the cycle
        # thread appends, the bind worker and node-add callback drain,
        # and _on_pod_gone rebuilds — same mid-iteration RuntimeError
        # hazard _round_lock documents for round_samples.
        self._parked_lock = threading.Lock()
        # Bind batches parked under an OPEN breaker (degraded mode):
        # complete _bind_q items whose usage is already assumed.
        # Unbounded on purpose — backpressure comes from the queue and
        # _bind_q bounds upstream, and dropping an ASSUMED batch would
        # leak committed usage.  Guarded by _parked_lock.
        self._parked_binds: deque = deque()
        # In-flight pipelined burst: (pods, device out, with_stats,
        # node_table, n_real, dispatch t0, snapshot state, static).
        # Owned by the cycle thread
        # (run_once / flush_binds callers); retired before any state
        # read that must see its placements.
        self._pipe_inflight: tuple | None = None
        # The in-flight burst's span builder + static version, committed
        # at retire alongside the usage commit (crash-safety parity:
        # a span only exists for cycles whose placements landed).
        self._pipe_span: tuple | None = None
        # Multicycle retire queue: one record per LOGICAL cycle of the
        # in-flight window, sharing a single device output (fetched
        # once, at the first retire).  Owned by the cycle thread, like
        # _pipe_inflight; drained by _retire_multicycle before any
        # state read that must see its placements.
        self._mc_inflight: "deque" = deque()
        # Device wave ring (core/encode.DeviceWaveRing), built lazily
        # at first multicycle window so K=1 loops never touch it.
        self._wave_ring = None
        self.multicycle_windows = 0        # windows dispatched
        self.multicycle_overflow_total = 0  # waves past ring capacity
        # Last RETIRED logical cycle id: the restore point a mid-window
        # crash lands on (checkpoint meta provenance; -1 = none yet).
        self.multicycle_last_retired = -1
        # Retire lag in logical cycles (wave j of a window retires j
        # cycles after the window head) — small ints, so doubling
        # buckets from 1 keep them exact (round_samples pattern).
        self._retire_lag = LogHistogram(
            lo=1.0, hi=1024.0, growth=2.0, window=2048)
        # Coalesced async binds: items folded into an
        # earlier batch's fanout, and how many workers are inside a
        # bind fanout right now (gauge + high-water mark; bounded by
        # cfg.bind_max_inflight).
        self.bind_coalesced_total = 0
        self.bind_inflight = 0
        self.bind_inflight_peak = 0
        self._bind_inflight_lock = threading.Lock()
        self._encode_pool = None
        if self.pipelined:
            import concurrent.futures

            self._encode_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="encode-ahead")
        self._bind_workers: list[threading.Thread] = []
        if async_bind:
            # Bounded: a dead/slow API server must apply backpressure
            # to the cycle, not buffer unbounded assumed state.
            self._bind_q = queue_mod.Queue(maxsize=8)
            # Bounded-inflight worker pool (cfg.bind_max_inflight,
            # default 1 = the pre-r16 single worker).  Each worker may
            # additionally coalesce up to cfg.bind_coalesce_window
            # queued batches into one fanout — see _bind_worker_main.
            n_workers = max(1, int(getattr(cfg, "bind_max_inflight",
                                           1)))
            for wi in range(n_workers):
                w = threading.Thread(
                    target=self._bind_worker_main, daemon=True,
                    name=f"bind-worker-{wi}")
                self._bind_workers.append(w)
                w.start()
            self._bind_worker = self._bind_workers[0]

        # Gang scheduling (core/gang.py): annotated pods are diverted
        # into the registry's gate by run_once and scheduled as whole
        # groups through _schedule_gang once minMember have arrived.
        self.gangs = (GangRegistry(cfg)
                      if cfg.enable_gang_scheduling else None)
        self.gangs_bound = 0
        self.gangs_rolled_back = 0
        # Elastic reshaping: gangs committed at a DEGRADED declared
        # realization (fewer members than arrived) by the shape-aware
        # placement path, plus the per-span delta baseline for the
        # rebalancer's reshape counters.
        self.gangs_shaped_degraded = 0
        self._reshape_last = (0, 0)

        # Conflict-round window as a LogHistogram (rounds are small
        # ints; doubling buckets from 1 keep them exact): drop-in for
        # the old deque, with one-lock internal snapshots.
        self.round_samples = LogHistogram(
            lo=1.0, hi=1024.0, growth=2.0, window=256)
        # Appends happen on the serving thread while /metrics scrapes
        # from the UDS/gRPC threads; iterating a deque mid-append
        # raises RuntimeError, so both sides take this lock.
        self._round_lock = threading.Lock()
        # Fused-step accounting.  torch has no buffer donation, so
        # donated_total stays 0; jit_cache_miss_total is the JAX loop's
        # executable-cache growth, and torch keeps no executable cache,
        # so it stays 0 too (a CUDA kernel is built once per process, on
        # first use).
        self.donated_total = 0
        self.jit_cache_miss_total = 0
        # is_parked keeps resync/watch re-deliveries of a preemptor
        # that is waiting for victim confirmation out of the queue —
        # scoring it early would drop its reservation and burn its
        # attempt budget against usage the victims still hold.
        # is_parked also covers _parked_uids: gang members parked
        # after a rollback (and async-mode unschedulable pods) are
        # woken by _requeue_parked, not resync — a resync re-delivery
        # would duplicate them in the queue while parked.
        self.informer = Informer(
            client, self.queue, cfg.scheduler_name,
            on_node=self._on_node,
            is_parked=lambda p: (p.uid in self._awaiting_preemption
                                 or p.uid in self._parked_uids))
        # Usage release on pod termination/deletion: without this a
        # long-running daemon's committed usage grows monotonically
        # until every node looks full.  Clients deliver at most once
        # per pod (KubeClient dedups terminal-MODIFIED vs DELETED).
        client.on_pod_deleted(self._on_pod_gone)
        # Node scale-down: free the encoder slot (round 1 leaked slots
        # and kept binding to deleted nodes).
        client.on_node_deleted(self._on_node_gone)
        # Watch-gap detection -> relist audit: clients that can tell
        # us a stream lost events (410 Gone, reset resourceVersion)
        # arm a full relist on the next cycle.  getattr-guarded for
        # third-party ClusterClients predating the surface.
        gap_reg = getattr(client, "on_watch_gap", None)
        if callable(gap_reg):
            try:
                gap_reg(self._on_watch_gap)
            except Exception:  # noqa: BLE001 — optional surface
                pass
        # Real policy/v1 PodDisruptionBudgets: watch + initial sync
        # (events missed while down), feeding the preemption planner.
        # Optional per ClusterClient contract, and defensive: a
        # cluster (or test double) without policy/v1 access must not
        # fail serving — the annotation surface still protects.
        try:
            client.on_pdb_changed(self._on_pdb)
            initial_pdbs = client.list_pdbs()
        except Exception:  # noqa: BLE001 — no policy/v1: degrade
            initial_pdbs = None
        if initial_pdbs:
            for pdb in initial_pdbs:
                self.encoder.set_pdb(pdb)

    def _on_pdb(self, pdb, deleted: bool) -> None:
        if deleted:
            self.encoder.remove_pdb(pdb.uid or
                                    f"{pdb.namespace}/{pdb.name}")
        else:
            self.encoder.set_pdb(pdb)

    def _on_node(self, node: Node) -> None:
        try:
            self.encoder.node_index(node.name)
            is_new = False
        except KeyError:
            is_new = True
        self.encoder.upsert_node(node)
        if is_new:
            # New capacity: retry pods rejected while the cluster was
            # full (kube's unschedulable-queue flush on NodeAdd).
            # Only genuinely NEW nodes — requeueing on every node
            # UPDATE would churn the queue on routine status traffic.
            self._requeue_parked()

    def _on_node_gone(self, node: Node) -> None:
        self.encoder.remove_node(node.name)

    def _on_pod_gone(self, pod: Pod) -> None:
        self._preempt_attempts.pop(pod.uid, None)
        # A gated gang member deleted before its gang completed must
        # not count toward minMember forever.
        if self.gangs is not None:
            self.gangs.pod_gone(pod)
        # Keep the assume-dedup set bounded by live-pod lifetime.
        self._assumed_uids.discard(pod.uid)
        self._drop_assumed_node(pod)
        # A deleted pod must not be revived by _requeue_parked (the
        # spurious assume/bind would roll back via the bind failure,
        # but inflates counters and emits a bogus event first).
        with self._parked_lock:
            if pod.uid in self._parked_uids:
                from collections import deque

                self._parked_uids.discard(pod.uid)
                self._unsched_parked = deque(
                    (p for p in self._unsched_parked
                     if p.uid != pod.uid),
                    maxlen=self._unsched_parked.maxlen)
        # A deleted preemptor abandons its reservation and wait.
        with self._preempt_lock:
            if self._awaiting_preemption.pop(pod.uid, None) is not None:
                self.encoder._drop_nomination(pod.uid)
        # Release BEFORE the confirmation drain below: a requeued
        # preemptor must never be scored against usage its just-
        # terminated victim still held.
        # No scheduler_name filter: extender-path binds commit usage
        # for pods whose schedulerName is the stock scheduler's, and
        # their deletions must release it.  The uid-keyed ledger makes
        # release a no-op for pods we never committed, so foreign pods
        # cost at most an early-release marker (bounded set).
        if pod.node_name:
            self.encoder.release(pod, pod.node_name)
        # Victim-deletion confirmation: requeue preemptors whose last
        # outstanding victim just terminated.  A failed push is fine —
        # the entry is gone, so the pod is no longer parked and the
        # next resync re-delivers it.
        ready: list[Pod] = []
        with self._preempt_lock:
            for puid, (pp, vset, _dl) in list(
                    self._awaiting_preemption.items()):
                if pod.uid in vset:
                    vset.discard(pod.uid)
                    if not vset:
                        del self._awaiting_preemption[puid]
                        ready.append(pp)
        for pp in ready:
            self.queue.push(pp)

    # ------------------------------------------------------------------
    # Decision-level tracing (utils/flight.py)

    def _span_begin(self, path: str):
        """Start a cycle span, or the shared no-op when the recorder
        is disabled — call sites keep one code shape either way."""
        if self.flight is None:
            return NULL_SPAN
        return self.flight.begin(path)

    def _cycle(self, sb):
        """The span sink of cycle ``sb``: the loop's timer and the
        cycle's span; under a profiler, the range ``netaware.cycle
        <id>`` (:func:`~..utils.tracing.cycle`)."""
        return tracing.cycle(self.timer, sb)

    def _span_commit(self, sb, pods: Sequence[Pod],
                     static_version: int | None = None,
                     rounds: int = 0,
                     scan_window_k: int | None = None,
                     retire_lag_cycles: int | None = None) -> None:
        """Freeze and commit a cycle span.  Called where the cycle's
        effects commit: end of the serial/burst/gang cycle, or at
        RETIRE for the pipelined and multicycle paths — so a crash
        never leaves a span claiming a cycle whose placements were
        lost.

        Also THE outcome-observability seam: quality capture and the
        time-gated SLO evaluation ride here — before the recorder
        guard, so they run on all four paths even with the flight
        recorder off.  A host-side error of either is swallowed
        (observation never breaks serving); a device fault is not."""
        if self.quality is not None:
            try:
                self.quality.note_commit(self, pods,
                                         cycle_id=sb.cycle_id)
            except Exception as exc:  # noqa: BLE001 — observation only
                _observation_guard(exc)
        slo_burning = None
        if self.slo is not None:
            try:
                now = time.monotonic()
                if (now - self._slo_last_eval
                        >= self.cfg.slo_eval_interval_s):
                    self._slo_last_eval = now
                    self.slo.evaluate(self)
                b = self.slo.burning()
                slo_burning = b[0] if b else None
            except Exception as exc:  # noqa: BLE001 — observation only
                _observation_guard(exc)
                slo_burning = None
        if self.flight is None or sb is NULL_SPAN:
            return
        enc = self.encoder
        db = int(getattr(enc, "snapshot_delta_bytes_total", 0))
        fb = int(getattr(enc, "snapshot_full_bytes_total", 0))
        last_db, last_fb = self._flight_bytes
        self._flight_bytes = (db, fb)
        built = getattr(self, "_static_version", None)
        behind = 0
        if static_version is not None and built is not None:
            behind = max(0, int(static_version) - int(built))
        stale = 0.0
        if self.cfg.enable_async_static and self._staleness_samples:
            try:
                stale = float(self._staleness_samples[-1])
            except IndexError:
                stale = 0.0
        breaker = self.breaker
        bstate = (str(getattr(breaker, "state", "closed"))
                  if breaker is not None else "closed")
        degraded = self.degraded
        # Injected state faults outrank transport faults on the span:
        # corrupted state is the rarer, more actionable signal, and the
        # tag is one-shot (consumed by the first committed span).
        state_fault = self._state_fault_pending
        self._state_fault_pending = None
        fault = (f"state_{state_fault}" if state_fault
                 else "apiserver_brownout" if degraded
                 else "watch_gap" if self._relist_needed else None)
        # Rebalance accounting: cumulative counters turned into
        # per-span deltas (the descheduler runs on the maintain path,
        # so a span carries whatever moved since the previous span).
        rb_moves = rb_reverts = 0
        gang_reshapes = reshape_reverts = None
        if self.rebalance is not None:
            mt = int(self.rebalance.moves_total)
            rt = int(self.rebalance.moves_reverted)
            last_mt, last_rt = self._rebalance_last
            self._rebalance_last = (mt, rt)
            rb_moves = max(mt - last_mt, 0)
            rb_reverts = max(rt - last_rt, 0)
            # Reshape accounting is carried only when the feature is
            # live (None off-path, so spans serialize as before).
            if (self.cfg.enable_gang_reshaping
                    or self.rebalance.cfg.enable_gang_reshaping):
                rs = int(self.rebalance.reshapes_total)
                rr = int(self.rebalance.reshapes_reverted)
                last_rs, last_rr = self._reshape_last
                self._reshape_last = (rs, rr)
                gang_reshapes = max(rs - last_rs, 0)
                reshape_reverts = max(rr - last_rr, 0)
        # Policy accounting: the same cumulative -> per-span-delta shape
        # (shadow ranking runs on the maintain path).
        pol_disagree = pol_version = 0
        if self.policy is not None:
            sd = int(self.policy.shadow_disagreement_total)
            pol_disagree = max(sd - self._policy_shadow_last, 0)
            self._policy_shadow_last = sd
            pol_version = int(self.policy.version)
        # Cap the per-span uid list: a whole-workload bench drain can
        # retire tens of thousands of pods in one span, and the ring
        # holds `capacity` spans — n_pods still carries the true count.
        span = sb.finish(
            n_pods=len(pods),
            pod_uids=tuple(p.uid for p in pods[:64]),
            queue_depth=len(self.queue),
            static_staleness_s=stale,
            static_versions_behind=behind,
            breaker_state=bstate,
            degraded=degraded,
            fault_class=fault,
            delta_bytes=max(db - last_db, 0),
            full_bytes=max(fb - last_fb, 0),
            rounds=int(rounds),
            slo_burning=slo_burning,
            outcome_ring_depth=(self.quality.ring_depth()
                                if self.quality is not None else 0),
            rebalance_moves=rb_moves,
            rebalance_reverts=rb_reverts,
            gang_reshapes=gang_reshapes,
            reshape_reverts=reshape_reverts,
            scenario_phase=self.scenario_phase,
            trace_offset=int(self.trace_offset),
            policy_shadow_disagreements=pol_disagree,
            policy_version=pol_version,
            cluster_id=self.cluster_id,
            scan_window_k=scan_window_k,
            retire_lag_cycles=retire_lag_cycles,
        )
        self.flight.commit(span)

    def _capture_explains(self, pods: Sequence[Pod], batch,
                          assignment: np.ndarray, state, static,
                          node_table, cycle_id: int, path: str,
                          extra: dict | None = None) -> None:
        """Retain a per-pod placement-explain record (top-k candidates
        with the score decomposition and the gates that filtered the
        rest), gated by ``cfg.enable_explain``.  Runs AFTER the cycle's
        score/assign, at its retire/commit seam, so placements are the
        same with explain on or off.  Serial and gang cycles pass the
        exact cycle batch; burst, pipelined and multicycle pass
        per-chunk re-encodes (:meth:`_capture_explains_burst`).

        The decomposition (:func:`~.score.explain_scores`) is dense under
        both backends and its errors propagate: a device fault is not an
        observation failure.  An error in building the host-side records
        drops this capture and counts it in the flight recorder's
        ``explains_failed``."""
        if (self.flight is None or not self.cfg.enable_explain
                or not pods):
            return
        from kubernetesnetawarescheduler_tpu_torch.core.score import (
            explain_scores,
        )

        comps = explain_scores(state, batch, self.cfg, static)
        valid = state.node_valid.cpu().numpy().astype(bool)
        # Node class for the learned policy's per-class adjustment: the
        # encoder's interned zone index (-1 = no zone label).
        zones = state.node_zone.cpu().numpy().astype(np.int64)
        try:
            records = self._explain_records(pods, comps, assignment, valid,
                                            zones, node_table, cycle_id,
                                            path, extra)
        except Exception:  # noqa: BLE001 — observation never breaks serving
            self.flight.note_explain_failed()
            return
        for record in records:
            self.flight.put_explain(record)

    def _explain_records(self, pods: Sequence[Pod], comps: dict,
                         assignment: np.ndarray, valid: np.ndarray,
                         zones: np.ndarray, node_table, cycle_id: int,
                         path: str, extra: dict | None) -> list[dict]:
        """The explain records of one captured batch, built on the host
        from :func:`~.score.explain_scores`' arrays (the JAX loop's
        record layout, key for key)."""
        table_names, _gens = node_table
        gate_keys = ("static_ok", "fits", "affinity", "anti",
                     "sym_anti", "zone_ok", "spread_ok")
        netmodel = self.encoder.netmodel
        if netmodel is not None:
            prov = {"network": "netmodel_blend",
                    "pair_coverage": float(netmodel.coverage_fraction(
                        self.encoder.num_nodes))}
        else:
            prov = {"network": "direct_probe"}
        k = min(self.cfg.explain_top_k, len(table_names))
        total = comps["total"]
        now = time.time()
        records = []
        for i, pod in enumerate(pods):
            row = total[i]
            idx = int(assignment[i])
            order = np.argsort(row, kind="stable")[::-1][:k]
            candidates = []
            for j in order:
                j = int(j)
                name = (table_names[j]
                        if j < len(table_names) and table_names[j]
                        else f"slot-{j}")
                candidates.append({
                    "node": name,
                    "node_index": j,
                    "zone": int(zones[j]) if j < len(zones) else -1,
                    "total": float(row[j]),
                    "feasible": bool(comps["ok"][i, j]),
                    "components": {
                        "base": float(comps["base"][i, j]),
                        "net": float(comps["net"][i, j]),
                        "soft": float(comps["soft"][i, j]),
                        "balance": -float(comps["balance"][i, j]),
                        "spread": -float(comps["spread"][i, j]),
                    },
                    "gates": {g: bool(comps[g][i, j]) for g in gate_keys},
                })
            record = {
                "pod_uid": pod.uid,
                "pod": f"{pod.namespace}/{pod.name}",
                "cycle_id": cycle_id,
                "path": path,
                "t_wall": now,
                "decision": "bound" if idx >= 0 else "unschedulable",
                "node": (table_names[idx]
                         if 0 <= idx < len(table_names) else None),
                "node_index": idx,
                "score": float(row[idx]) if idx >= 0 else None,
                "candidates": candidates,
                "feasible_nodes": int(np.sum(valid & comps["ok"][i])),
                "gates_filtered": {
                    g: int(np.sum(valid & ~comps[g][i]))
                    for g in gate_keys},
                "provenance": prov,
            }
            if extra:
                record.update(extra)
            records.append(record)
        return records

    def _capture_explains_burst(self, pods: Sequence[Pod],
                                assignment: np.ndarray, state, static,
                                node_table, cycle_id: int,
                                path: str) -> None:
        """Explain capture for the burst, pipelined and multicycle
        paths, run at the retire/commit seam AFTER the assume/bind
        published this burst's placements.  The replay never keeps
        per-batch score planes, so each ``max_pods`` chunk is re-encoded
        here — in-stream peers then resolve against the placements the
        replay produced, and the totals are a post-hoc decomposition,
        not the in-replay score — and decomposed through
        :meth:`_capture_explains`.  An encode error drops the remaining
        chunks, each counted in ``explains_failed``; never the cycle."""
        if (self.flight is None or not self.cfg.enable_explain
                or not pods):
            return
        cap = self.cfg.max_pods
        for off in range(0, len(pods), cap):
            chunk = list(pods[off:off + cap])
            try:
                batch = self.encoder.encode_pods(
                    chunk, node_of=self._peer_node, lenient=True)
            except Exception:  # noqa: BLE001 — observation never breaks serving
                for _ in range(off, len(pods), cap):
                    self.flight.note_explain_failed()
                return
            self._capture_explains(chunk, batch,
                                   assignment[off:off + cap],
                                   state, static, node_table,
                                   cycle_id, path)

    # ------------------------------------------------------------------

    def run_once(self, timeout: float | None = 0.0) -> int:
        """One cycle: pop up to ``max_pods`` pods, schedule, bind.
        Returns the number of pods bound.

        Backlog burst: with at least two full batches queued (and
        ``burst_batches`` > 1), pops up to ``burst_batches`` batches
        and drains them through one device dispatch + one fetch
        (see __init__)."""
        budget = getattr(self.client, "retry_budget", None)
        if budget is not None:
            # Shared per-cycle retry allowance: whatever list-GET
            # retries this cycle spends, it spends from one pool.
            budget.begin_cycle()
        if self._relist_needed:
            self.relist_audit()
        if self._parked_binds:
            self._drain_parked_binds()
        batch = self.cfg.max_pods
        # Persistent multi-cycle window: with K>1 and a deep backlog,
        # pop up to K batches and serve them as ONE replay over the
        # window — run_once still counts/retires per logical cycle.
        # Single-device path only (a mesh serves deep backlogs through
        # its sharded burst); gang groups retire the window first (same
        # snapshot ordering as the pipelined path).
        if (self.multicycle > 1 and self._sharded_burst is None
                and len(self.queue) >= 2 * batch):
            pods = self.queue.pop_batch(self.multicycle * batch,
                                        timeout)
            pods, ready = self._gang_gate(pods)
            bound = 0
            if pods:
                bound = self.schedule_pods_multicycle(pods)
            if ready:
                bound += self._retire_multicycle()
            for key, members in ready:
                bound += self._schedule_gang(key, members)
            return bound
        if (self.burst_batches > 1
                and len(self.queue) >= 2 * batch):
            pods = self.queue.pop_batch(self.burst_batches * batch,
                                        timeout)
            pods, ready = self._gang_gate(pods)
            bound = 0
            if len(pods) > batch:
                if self.pipelined:
                    bound = self._pipeline_cycle(pods)
                    if ready:
                        # A gang's joint placement snapshots the
                        # encoder itself; retire the burst just
                        # dispatched so the gang never races its
                        # uncommitted placements.
                        bound += self._retire_inflight()
                else:
                    bound = self.schedule_pods_burst(pods)
            elif pods:  # raced down to a single batch: normal path
                bound = self._retire_inflight()
                bound += self.schedule_pods(pods)
            for key, members in ready:
                bound += self._schedule_gang(key, members)
            return bound
        # Shallow queue: a pipelined burst or multicycle window still
        # in flight is retired first — its placements must land before
        # (or instead of) any per-batch cycle.
        bound = self._retire_multicycle() if self._mc_inflight else 0
        bound += self._retire_inflight()
        pods = self.queue.pop_batch(batch, timeout)
        pods, ready = self._gang_gate(pods)
        if not pods and not ready:
            # Still drain degradation records: in extender-only
            # deployments the watch queue stays empty while the
            # webhook/bind paths keep encoding (and possibly
            # degrading) pods.
            self._emit_degraded_events()
            return bound
        if pods:
            bound += self.schedule_pods(pods)
        for key, members in ready:
            bound += self._schedule_gang(key, members)
        return bound

    def _gang_gate(self, pods: Sequence[Pod]
                   ) -> tuple[list[Pod], list[tuple[str, list[Pod]]]]:
        """The gang gate AHEAD of per-pod scheduling: pods carrying a
        pod-group annotation are absorbed into the registry instead of
        scheduled; a pod that completes its gang releases the whole
        group as a ``(key, members)`` unit for :meth:`_schedule_gang`.
        Annotation-free pods pass through untouched (and pay nothing —
        one ``gang_key_of`` string probe each)."""
        if self.gangs is None:
            return list(pods), []
        passthrough: list[Pod] = []
        ready: list[tuple[str, list[Pod]]] = []
        for pod in pods:
            key = gang_key_of(pod)
            if not key:
                passthrough.append(pod)
                continue
            members = self.gangs.admit(pod)
            if members is not None:
                ready.append((key, members))
        return passthrough, ready

    def schedule_pods_burst(self, pods: Sequence[Pod]) -> int:
        """Schedule several batches' worth of pods in ONE replay call
        and ONE assignment fetch, via the replay's per-batch step.
        Same score->assign->commit semantics as sequential
        :meth:`schedule_pods` cycles — in-stream peers resolve against
        earlier batches' placements through the replay's carry,
        exactly as they would across sequential cycles."""
        from kubernetesnetawarescheduler_tpu_torch.core.replay import (
            pad_stream,
            replay_stream_static,
        )

        # Timer samples are per-batch-NORMALIZED (wall / n_real per
        # phase): the percentile streams feed host-mode density and
        # /metrics as per-batch latency, and an un-normalized burst
        # sample would read as an 8x regression (the pipeline replay
        # normalizes its per-chunk samples the same way).  Each phase
        # records the normalized value with WEIGHT n_real so a burst
        # carries its full per-batch weight in the percentile streams
        # (one averaged sample per burst structurally under-reported
        # the tail), and the un-normalized cycle wall goes to
        # ``burst_wall`` — the latency the last batch in the burst
        # actually observed end-to-end.
        n_real = -(-len(pods) // self.cfg.max_pods)
        sb = self._span_begin("burst")
        cycle_t0 = time.perf_counter()
        with self._cycle(sb):
            with tracing.span("encode", n_real):
                stream = self.encoder.encode_stream(
                    pods, node_of=self._peer_node, lenient=True)
                # Padded to the FULL burst shape, as the JAX loop pads
                # it to keep one compiled program; here each padded
                # batch is a real (fully masked) replay step, and the
                # timer normalizes by the real batches only.
                stream = pad_stream(stream,
                                    self.burst_batches * self.cfg.max_pods)
                state, version = self.encoder.snapshot_versioned()
                node_table = self.encoder.node_table()
            self._emit_degraded_events()
            static = None
            with tracing.span("score_assign", n_real):
                if self._sharded_burst is not None:
                    # Mesh path: the sharded replay over the shared
                    # placement; its static prep is cached by leaf
                    # identity.
                    out, with_stats = self._sharded_burst(state, stream)
                else:
                    with_stats = self.method == "parallel"
                    # Same version-keyed static cache as the per-batch
                    # cycle.
                    static = self._static_for(state, version)
                    out = replay_stream_static(state, stream, static,
                                               self.cfg, self.method,
                                               with_stats=with_stats)
                cycle_rounds = 0
                if with_stats:
                    assignment_dev, _final_state, rounds_dev = out
                    assignment = _to_host(assignment_dev)
                    rounds = np.asarray(rounds_dev)
                    cycle_rounds = (int(rounds[:n_real].max())
                                    if n_real else 0)
                    with self._round_lock:
                        self.round_samples.extend(
                            int(r) for r in rounds[:n_real])
                else:
                    assignment_dev, _final_state = out
                    assignment = _to_host(assignment_dev)
            assignment = assignment[:len(pods)]
            with tracing.span("bind", n_real):
                if self.async_bind:
                    bound = self._assume_and_enqueue(pods, assignment,
                                                     node_table)
                else:
                    bound = self._bind_all(pods, assignment, node_table)
            self.timer.record("burst_wall",
                              time.perf_counter() - cycle_t0)
            self.burst_cycles += 1
            self._capture_explains_burst(pods, assignment, state, static,
                                         node_table, sb.cycle_id, "burst")
            self._span_commit(sb, pods, static_version=version,
                              rounds=cycle_rounds)
        return bound

    def _pipeline_cycle(self, pods: Sequence[Pod]) -> int:
        """One pipelined burst cycle: encode-prepare of THIS burst on
        the host thread overlaps the retire (fetch + assume + bind
        enqueue) of the PREVIOUS burst.  Returns pods assumed from the
        retired burst; this burst's own count is returned by the cycle
        that retires it.  The replay's conflict loop syncs with the
        host every round, so the dispatch below returns with the
        device step done but for its last queued operations: what the
        pipeline overlaps here is host encode against host retire.

        Ordering (the determinism contract, tests/test_pipeline.py):
        peers and the first-pod escape are finalized AFTER the
        previous burst's assume publishes its placements, and the
        snapshot is taken after the same point — exactly what a
        serial burst cycle would have seen."""
        from kubernetesnetawarescheduler_tpu_torch.core.replay import (
            pad_stream,
            replay_stream_static,
        )

        n_real = -(-len(pods) // self.cfg.max_pods)
        sb = self._span_begin("pipelined")

        def _timed_prepare():
            t = time.perf_counter()
            prep = self.encoder.encode_stream_prepare(pods,
                                                      lenient=True)
            return prep, time.perf_counter() - t

        fut = self._encode_pool.submit(_timed_prepare)
        # Stage overlap: previous burst's retire runs while the encode
        # worker prepares this burst's arrays.
        bound = self._retire_inflight()
        prepared, encode_s = fut.result()
        with self._cycle(sb):
            tracing.record("encode", time.perf_counter() - encode_s,
                           encode_s, n_real)
            # "dispatch" records finalize + snapshot + the replay call,
            # which (one host sync per conflict round) runs the device
            # step nearly to its end before it returns; the fetch in
            # _retire_inflight then waits only for its last operations.
            with tracing.span("dispatch", n_real):
                stream = self.encoder.finalize_stream(prepared,
                                                      self._peer_node)
                # Full burst shape, as schedule_pods_burst pads it.
                stream = pad_stream(stream,
                                    self.burst_batches * self.cfg.max_pods)
                state, version = self.encoder.snapshot_versioned()
                node_table = self.encoder.node_table()
                self._emit_degraded_events()
                static = None
                if self._sharded_burst is not None:
                    out, with_stats = self._sharded_burst(state, stream)
                else:
                    with_stats = self.method == "parallel"
                    static = self._static_for(state, version)
                    out = replay_stream_static(state, stream, static,
                                               self.cfg, self.method,
                                               with_stats=with_stats)
        self._pipe_inflight = (pods, out, with_stats, node_table,
                               n_real, time.perf_counter(),
                               state, static)
        self._pipe_span = (sb, version)
        self.burst_cycles += 1
        return bound

    def _retire_inflight(self) -> int:
        """Fetch the in-flight pipelined burst's assignments and run
        the assume/bind-enqueue tail.  No-op without one.  Usage is
        committed HERE — never at dispatch — so a crash between
        encode-ahead/dispatch and retire leaves no committed residue
        to double-commit after a checkpoint restore."""
        inflight = self._pipe_inflight
        if inflight is None:
            return 0
        self._pipe_inflight = None
        (pods, out, with_stats, node_table, n_real, t_dispatch,
         state, static) = inflight
        sb, span_version = (self._pipe_span
                            if self._pipe_span is not None
                            else (NULL_SPAN, None))
        self._pipe_span = None
        with self._cycle(sb):
            # The exposed device wait: whatever of the step did NOT
            # overlap host work since dispatch.  Feeds the same
            # score_assign percentile stream as the serial cycle.
            with tracing.span("score_assign", n_real):
                cycle_rounds = 0
                if with_stats:
                    assignment_dev, _final_state, rounds_dev = out
                    assignment = _to_host(assignment_dev)
                    rounds = np.asarray(rounds_dev)
                    cycle_rounds = (int(rounds[:n_real].max())
                                    if n_real else 0)
                    with self._round_lock:
                        self.round_samples.extend(
                            int(r) for r in rounds[:n_real])
                else:
                    assignment_dev, _final_state = out
                    assignment = _to_host(assignment_dev)
            assignment = assignment[:len(pods)]
            with tracing.span("bind", n_real):
                bound = self._assume_and_enqueue(pods, assignment,
                                                 node_table)
            self.timer.record("burst_wall",
                              time.perf_counter() - t_dispatch)
            self._capture_explains_burst(pods, assignment, state, static,
                                         node_table, sb.cycle_id,
                                         "pipelined")
            self._span_commit(sb, pods, static_version=span_version,
                              rounds=cycle_rounds)
        return bound

    def schedule_pods_multicycle(self, pods: Sequence[Pod]) -> int:
        """Serve up to ``multicycle`` batches as ONE replay call: encode
        the whole K-wave window once (global in-stream peer index
        space — waves must NOT be encoded separately, or cross-wave
        peers would miss earlier waves' placements), stage the waves
        through the device ring, and run one replay over all of them.  Waves retire asynchronously through
        :meth:`_retire_multicycle`; usage commits only at retire.

        Returns pods bound/assumed from the PREVIOUS window's retire
        plus any ring-overflow fallback; this window's own waves are
        counted by the cycles that retire them (the next window, the
        shallow-queue path, or flush_binds).  Placements are
        bit-identical to K sequential fused per-batch steps: the
        replay scan threads commits across waves exactly as
        sequential cycles would."""
        from kubernetesnetawarescheduler_tpu_torch.core.encode import (
            DeviceWaveRing,
            split_stream_waves,
        )
        from kubernetesnetawarescheduler_tpu_torch.core.replay import (
            pad_stream,
            replay_stream_static,
        )

        # Previous window first: its placements must be published
        # before this window's encode resolves peers (the sequential
        # snapshot-ordering contract, same as the pipelined path).
        bound = self._retire_multicycle()
        k = self.multicycle
        cap = self.cfg.max_pods
        t_enc = time.perf_counter()
        stream = self.encoder.encode_stream(
            pods, node_of=self._peer_node, lenient=True)
        # Fixed K*cap window shape, as the JAX loop pads it (one
        # compiled program per K there).  Here every pad wave is a
        # real, fully masked replay step; the padding is kept so the
        # ring and its overflow accounting see the JAX loop's waves.
        stream = pad_stream(stream, k * cap)
        state, version = self.encoder.snapshot_versioned()
        node_table = self.encoder.node_table()
        encode_s = time.perf_counter() - t_enc
        self._emit_degraded_events()

        depth = int(getattr(self.cfg, "multicycle_queue_depth", k))
        ring = self._wave_ring
        if ring is None or ring.capacity != depth:
            ring = self._wave_ring = DeviceWaveRing(
                depth, device=self.encoder.device)
        waves = split_stream_waves(stream, cap)
        staged = 0
        for wave in waves:
            if not ring.push(wave):
                break
            staged += 1
        if staged < len(waves):
            self.multicycle_overflow_total += len(waves) - staged
        window = ring.pop_window()
        real_in_window = min(len(pods), staged * cap)
        n_live = max(1, -(-real_in_window // cap))
        # One span builder PER logical cycle, opened at dispatch and
        # committed at the retire seam (spans stay one-per-logical-
        # cycle; phase costs are amortized shares of the window's).
        sbs = [self._span_begin("multicycle") for _ in range(n_live)]
        for sb in sbs:
            with self._cycle(sb):
                tracing.record("encode", t_enc, encode_s / n_live)
        t0 = time.perf_counter()
        with_stats = self.method == "parallel"
        static = self._static_for(state, version)
        # The window's replay spans land in its first logical cycle.
        with self._cycle(sbs[0]):
            out = replay_stream_static(state, window, static,
                                       self.cfg, self.method,
                                       with_stats=with_stats)
        dispatch_s = time.perf_counter() - t0
        for sb in sbs:
            sb.add_phase("dispatch", t0, dispatch_s / n_live)
        shared = {"out": out, "with_stats": with_stats,
                  "fetched": None, "rounds": None, "n_live": n_live,
                  "state": state, "static": static,
                  "t_dispatch": time.perf_counter()}
        for j in range(n_live):
            a = j * cap
            self._mc_inflight.append(
                (sbs[j], list(pods[a:min(a + cap, real_in_window)]),
                 j, staged, shared, node_table, version))
        self.multicycle_windows += 1
        if len(pods) > staged * cap:
            # Ring overflow: waves past the device-queue depth fall
            # back to the per-cycle/burst dispatch path AFTER the
            # window retires, so their re-encode sees the window's
            # published placements — a mis-tuned depth degrades
            # amortization, never placements (counter above is the
            # observability seam).
            bound += self._retire_multicycle()
            leftover = list(pods[staged * cap:])
            if len(leftover) > cap and self.burst_batches > 1:
                bound += self.schedule_pods_burst(leftover)
            else:
                for a in range(0, len(leftover), cap):
                    bound += self.schedule_pods(leftover[a:a + cap])
        return bound

    def _retire_multicycle(self, max_waves: int | None = None) -> int:
        """Retire pending multicycle waves: fetch the window's device
        output ONCE (at the first retire), then per wave run the
        assume/bind tail and commit its span.  Usage lands HERE —
        never at dispatch — so a crash mid-window restores to the
        last retired cycle with no half-committed wave (checkpoint
        contract).  ``max_waves`` bounds how
        many waves retire this call (the mid-window checkpoint seam);
        default drains all.  Returns pods bound/assumed."""
        bound = 0
        retired = 0
        cap = self.cfg.max_pods
        shared = None
        while self._mc_inflight:
            if max_waves is not None and retired >= max_waves:
                break
            (sb, wave_pods, j, k_eff, shared, node_table,
             version) = self._mc_inflight.popleft()
            with self._cycle(sb):
                t0 = time.perf_counter()
                if shared["fetched"] is None:
                    if shared["with_stats"]:
                        a_dev, _final, r_dev = shared["out"]
                        shared["fetched"] = _to_host(a_dev)
                        shared["rounds"] = np.asarray(r_dev)
                        with self._round_lock:
                            self.round_samples.extend(
                                int(r) for r in
                                shared["rounds"][:shared["n_live"]])
                    else:
                        a_dev, _final = shared["out"]
                        shared["fetched"] = _to_host(a_dev)
                    shared["out"] = None
                    # The exposed device wait, amortized over the
                    # window's logical cycles: the device-boundary score
                    # latency the bench compares to the in-kernel
                    # number.
                    tracing.record("score_assign", t0,
                                   time.perf_counter() - t0,
                                   shared["n_live"])
                else:
                    sb.add_phase("score_assign", t0,
                                 time.perf_counter() - t0)
                assignment = shared["fetched"][
                    j * cap:j * cap + len(wave_pods)]
                rounds_j = 0
                if (shared["rounds"] is not None
                        and j < len(shared["rounds"])):
                    rounds_j = int(shared["rounds"][j])
                with tracing.span("bind"):
                    if self.async_bind:
                        bound += self._assume_and_enqueue(
                            wave_pods, assignment, node_table)
                    else:
                        bound += self._bind_all(wave_pods, assignment,
                                                node_table)
                self._retire_lag.append(float(j))
                self._capture_explains_burst(
                    wave_pods, assignment, shared["state"],
                    shared["static"], node_table, sb.cycle_id,
                    "multicycle")
                self._span_commit(sb, wave_pods, static_version=version,
                                  rounds=rounds_j, scan_window_k=k_eff,
                                  retire_lag_cycles=j)
            self.multicycle_last_retired = sb.cycle_id
            retired += 1
        if retired and not self._mc_inflight and shared is not None:
            self.timer.record(
                "burst_wall",
                time.perf_counter() - shared["t_dispatch"])
        return bound

    def _cycle_inputs(self, sb, pods: Sequence[Pod]):
        """Encode half of a serial cycle: batch encode + atomic state
        snapshot + node table, degraded-constraint events emitted.

        Split out of :meth:`schedule_pods` so a multi-tenant server can
        run the SAME host-side semantics per tenant and hand each
        tenant back to :meth:`_cycle_outputs`."""
        with self._cycle(sb), tracing.span("encode"):
            # Lenient: pods arrive from the watch (untrusted
            # manifests), and one pod with un-internable constraints
            # must degrade ITSELF (conservative bit directions +
            # a ConstraintDegraded event), not raise and take the
            # whole batch's cycle down with it.
            batch = self.encoder.encode_pods(
                pods, node_of=self._peer_node, lenient=True)
            # Atomic (state, version) pair — a separate version read
            # on either side of snapshot() can mispair them when an
            # ingest thread dirties state in between (the same hazard
            # the extender batcher documents), and the assign static
            # cache would then serve stale normalizers against fresh
            # state.
            state, static_version = self.encoder.snapshot_versioned()
            # Name/generation table captured WITH the snapshot: the
            # bind path resolves indices against this table, so a slot
            # freed+reused mid-cycle binds to the old (gone) name —
            # rejected upstream — instead of silently landing on the
            # slot's new tenant.
            node_table = self.encoder.node_table()
        self._emit_degraded_events()
        return batch, state, static_version, node_table

    def _cycle_outputs(self, sb, pods: Sequence[Pod], batch, state,
                       static, node_table, assignment: np.ndarray,
                       rounds: int, static_version: int, *,
                       path: str = "serial") -> int:
        """Bind half of a serial cycle: bind/assume, explain capture,
        span commit."""
        with self._cycle(sb):
            with tracing.span("bind"):
                if self.async_bind:
                    bound = self._assume_and_enqueue(pods, assignment,
                                                     node_table)
                else:
                    bound = self._bind_all(pods, assignment, node_table)
            self._capture_explains(pods, batch, assignment, state, static,
                                   node_table, sb.cycle_id, path)
            self._span_commit(sb, pods, static_version=static_version,
                              rounds=rounds)
        return bound

    def schedule_pods(self, pods: Sequence[Pod]) -> int:
        sb = self._span_begin("serial")
        with self._cycle(sb):
            batch, state, static_version, node_table = \
                self._cycle_inputs(sb, pods)
            static = None
            with tracing.span("score_assign"):
                stats = self.method == "parallel"
                # assign_greedy has no with_stats parameter — pass the
                # kw only when asking for it (stats implies parallel).
                kw = {"with_stats": True} if stats else {}
                if self._assign_takes_static:
                    static = self._static_for(state, static_version)
                    out = self._assign(state, batch, self.cfg, static,
                                       **kw)
                else:
                    out = self._assign(state, batch, self.cfg, **kw)
                cycle_rounds = 0
                if stats:
                    assignment_dev, rounds = out
                    assignment = _to_host(assignment_dev)
                    cycle_rounds = int(rounds)
                    with self._round_lock:
                        self.round_samples.append(cycle_rounds)
                else:
                    assignment = _to_host(out)
            return self._cycle_outputs(sb, pods, batch, state, static,
                                       node_table, assignment,
                                       cycle_rounds, static_version)

    def _static_for(self, state, version: int):
        """Version-keyed cache of the batch-invariant assign static
        (see __init__); ``version`` must come from the SAME
        ``snapshot_versioned`` call that produced ``state``.

        Refresh policy (the tentpole of the 5 ms Score() p99 work):

        * Current version -> return the cached value, no device work.
        * ``cfg.enable_async_static`` off (default): rebuild HERE, but
          delta-aware — the encoder's dirty descriptor usually reduces
          the O(N²) re-normalization to an O(|dirty|) patch that is
          bit-identical to the full rebuild.
        * Async on: hand the rebuild to a background worker and keep
          serving the previous static, UNLESS the staleness contract
          is breached (no static yet, more than
          ``static_max_versions_behind`` versions or
          ``static_max_staleness_s`` seconds behind) — then build
          synchronously so staleness stays bounded even if the worker
          wedges."""
        if self._static_version == version:
            if self.cfg.enable_async_static:
                self._staleness_samples.append(0.0)
            return self._static_val
        if not self.cfg.enable_async_static:
            self._static_rebuild(state, version)
            return self._static_val
        now = time.monotonic()
        with self._static_cv:
            if self._static_stale_since is None:
                self._static_stale_since = now
            behind = (version - self._static_version
                      if self._static_version is not None else None)
            staleness = now - self._static_stale_since
        if (self._static_val is None or behind is None
                or behind > self.cfg.static_max_versions_behind
                or staleness > self.cfg.static_max_staleness_s):
            self.static_sync_builds += 1
            self._static_rebuild(state, version)
            self._staleness_samples.append(0.0)
            return self._static_val
        self._ensure_static_worker()
        with self._static_cv:
            # Latest-wins: a newer snapshot supersedes any rebuild
            # still queued (the worker always builds toward the
            # freshest version it has seen).
            self._static_req = (state, version)
            self._static_cv.notify()
        self._staleness_samples.append(staleness)
        return self._static_val

    def _static_rebuild(self, state, version: int) -> None:
        """Build (delta-aware when possible) and publish the static
        for ``version`` on the calling thread."""
        from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
            compute_assign_static_incremental,
        )

        t0 = time.perf_counter()
        dirty = None
        if self.cfg.enable_delta_state and self._static_version is not None:
            # The descriptor may span past ``version`` if the encoder
            # moved again already; the extra indices just re-patch
            # values ``state`` already holds — still bit-identical.
            dirty = self.encoder.static_delta_since(self._static_version)
        static, ex = compute_assign_static_incremental(
            state, self.cfg, self._static_val, self._static_ex, dirty)
        with self._static_cv:
            # Version monotonicity: never replace a fresher static
            # (the sync-fallback path can overtake a queued rebuild).
            if (self._static_version is None
                    or version > self._static_version):
                self._static_val = static
                self._static_ex = ex
                self._static_version = version
                self._static_stale_since = None
        self.static_refresh_total += 1
        self._static_refresh_ms.append(
            (time.perf_counter() - t0) * 1e3)

    def _ensure_static_worker(self) -> None:
        t = self._static_thread
        if t is None or not t.is_alive():
            self._static_stop = False
            self._static_thread = threading.Thread(
                target=self._static_worker_loop,
                name="static-refresh", daemon=True)
            self._static_thread.start()

    def _static_worker_loop(self) -> None:
        while True:
            with self._static_cv:
                while self._static_req is None and not self._static_stop:
                    self._static_cv.wait(0.5)
                if self._static_stop:
                    return
                state, version = self._static_req
                self._static_req = None
            try:
                self._static_rebuild(state, version)
            except Exception:  # noqa: BLE001 — a wedged worker must
                # not kill serving: the staleness contract routes
                # batches to the synchronous rebuild on the serving
                # thread, which raises the same error there.
                pass

    def stop_static_refresher(self, timeout: float | None = 10.0) -> None:
        """Stop the background static-refresh worker (shutdown path;
        idempotent, no-op when async refresh never ran)."""
        t = self._static_thread
        if t is None:
            return
        with self._static_cv:
            self._static_stop = True
            self._static_req = None
            self._static_cv.notify_all()
        t.join(timeout)
        self._static_thread = None

    def _schedule_gang(self, key: str, members: list[Pod]) -> int:
        """Jointly place and ATOMICALLY commit one complete gang.

        Score: two-pass joint placement (:func:`core.gang.place_gang`)
        — the normal batched assigner, then a re-score of every member
        row with the C[N, N]-derived co-placement bias, keeping the
        pass that wins the group objective.  Commit: assume-all (usage
        into the encoder up front, in-flight record for the
        checkpoint) then bind-all through the client's transactional
        ``bind_gang``; ANY member failure rolls back EVERY member.
        Returns members bound (the whole gang, or 0)."""
        comp = self.cfg.scheduler_name
        if len(members) > self.cfg.max_pods:
            # A gang wider than the batch shape cannot be scored
            # jointly in one dispatch: degrade LOUDLY to independent
            # placement rather than deadlock the job in the gate.
            from kubernetesnetawarescheduler_tpu_torch.k8s.types import Event

            self.client.create_event(Event(
                message=(f"pod group {key} has {len(members)} members "
                         f"> max_pods={self.cfg.max_pods}; placed "
                         "independently (no all-or-nothing guarantee)"),
                reason="GangDegraded", involved_pod=members[0].name,
                namespace=members[0].namespace, component=comp,
                type="Warning"))
            total = 0
            for i in range(0, len(members), self.cfg.max_pods):
                total += self.schedule_pods(
                    members[i:i + self.cfg.max_pods])
            return total
        sb = self._span_begin("gang")
        with self._cycle(sb):
            with tracing.span("encode"):
                batch = self.encoder.encode_pods(
                    members, node_of=self._peer_node, lenient=True)
                state, static_version = self.encoder.snapshot_versioned()
                node_table = self.encoder.node_table()
            self._emit_degraded_events()
            with tracing.span("score_assign"):
                if self._assign_takes_static:
                    static = self._static_for(state, static_version)
                    assign_fn = self._assign
                else:
                    # Mesh path: the sharded callables take no static, and
                    # gang re-scoring needs the {"raw", "ok"} seam, so the
                    # (rare, small) gang batches take the single-device
                    # assigners on the encoder's device.
                    static = None
                    assign_fn = {"greedy": assign_greedy,
                                 "parallel": assign_parallel}[self.method]
                # Elastic realizations: when the gang declares
                # alternative shapes AND the feature is on, score every
                # declared realization and commit the winner; otherwise
                # the rigid path runs.
                shapes = (gang_shapes_of(members)
                          if self.cfg.enable_gang_reshaping else ())
                shaped = len(shapes) > 1
                if shaped:
                    assignment, chosen, shape_info = place_gang_shaped(
                        state, batch, self.cfg, static, assign_fn,
                        len(members), shapes)
                else:
                    assignment = place_gang(state, batch, self.cfg,
                                            static, assign_fn,
                                            len(members))
                    chosen, shape_info = len(members), None
            commit_members = members
            surplus: list[Pod] = []
            if shaped and 0 < chosen < len(members):
                # A degraded realization commits the chosen PREFIX
                # all-or-nothing; the surplus members park (loudly) and
                # re-gate on the next wakeup/resync — the rebalancer's
                # regrow path restores the full shape when capacity
                # returns.
                commit_members = members[:chosen]
                surplus = members[chosen:]
            with tracing.span("bind"):
                bound = self._commit_gang(key, commit_members, assignment,
                                          node_table)
            if shaped and bound:
                self.encoder.note_gang_realization(key, len(commit_members),
                                                   len(members))
            if surplus:
                comp_events = []
                if bound:
                    self.gangs_shaped_degraded += 1
                    why = (f"gang {key} realized degraded shape "
                           f"{chosen}/{len(members)} "
                           f"(declared family: "
                           f"{','.join(str(c) for c, _ in shapes)}); "
                           "member parked awaiting regrow")
                else:
                    why = (f"gang {key}: no feasible placement at any "
                           "declared shape")
                for pod in surplus:
                    comp_events.append(failed_event(pod, comp, why))
                self.client.create_events(comp_events)
                self.unschedulable += len(surplus)
                self._park_gang(surplus)
            # Explain records note the joint C-matrix pass: the per-node
            # decomposition is the INDEPENDENT score surface; the gang's
            # co-placement bias may have moved the winner off the
            # independent argmax, which is exactly what the marker flags.
            self._capture_explains(
                members, batch, assignment, state, static, node_table,
                sb.cycle_id, "gang",
                extra={"gang": {"key": key, "members": len(members),
                                "joint_placement": True,
                                "bound": bool(bound),
                                **({"realization": chosen,
                                    "shape_info": shape_info}
                                   if shaped else {})}})
            self._span_commit(sb, members, static_version=static_version)
        return bound

    def _commit_gang(self, key: str, members: list[Pod],
                     assignment: np.ndarray, node_table) -> int:
        """Assume-all-then-bind-all with full rollback (see
        :meth:`_schedule_gang`)."""
        comp = self.cfg.scheduler_name
        table_names, table_gens = node_table
        events: list = []
        idxs = [int(assignment[i]) for i in range(len(members))]
        feasible = all(i >= 0 for i in idxs)
        if feasible:
            # Any member slot whose generation moved (node vanished
            # mid-cycle) aborts the WHOLE gang before anything binds.
            feasible = all(
                self.encoder.slot_generation(i) == table_gens[i]
                for i in idxs)
        if not feasible:
            if self.decision_log is not None:
                for pod in members:
                    self.decision_log.append(pod.name, "")
            self.unschedulable += len(members)
            for pod in members:
                events.append(failed_event(
                    pod, comp,
                    f"gang {key}: no feasible all-or-nothing "
                    "placement"))
            self.client.create_events(events)
            if self.gangs is not None:
                self.gangs.note_rolled_back(key)
            self._park_gang(members)
            return 0
        names = [table_names[i] for i in idxs]
        if self.decision_log is not None:
            for pod, name in zip(members, names):
                self.decision_log.append(pod.name, name)
        # ---- assume all -------------------------------------------------
        fresh = [(p, i) for p, i in zip(members, idxs)
                 if not self.encoder.is_committed(p.uid)]
        self.encoder.commit_many([p for p, _ in fresh],
                                 [i for _, i in fresh])
        assumed = {p.uid for p, _ in fresh}
        self._assumed_uids |= assumed
        for pod, name in zip(members, names):
            self._publish_assumed_node(pod, name)
        if self.gangs is not None:
            self.gangs.note_assumed(key)
        self.encoder.note_gang_inflight(
            key, [[p.uid, p.namespace, p.name, n]
                  for p, n in zip(members, names)])
        # ---- bind all (transactional) -----------------------------------
        outcomes = self.client.bind_gang([
            Binding(pod_name=p.name, namespace=p.namespace,
                    node_name=n)
            for p, n in zip(members, names)])
        self.encoder.clear_gang_inflight(key)
        if all(o is None for o in outcomes):
            for pod, name in zip(members, names):
                events.append(scheduled_event(pod, name, comp))
            self.client.create_events(events)
            self.scheduled += len(members)
            self.gangs_bound += 1
            if self.gangs is not None:
                self.gangs.note_bound(key)
            if self._bind_retries:
                for pod in members:
                    self._bind_retries.pop(
                        f"{pod.namespace}/{pod.name}", None)
            return len(members)
        # ---- rollback all ----------------------------------------------
        self.bind_failures += sum(1 for o in outcomes if o is not None)
        for pod, name in zip(members, names):
            if pod.uid in assumed:
                self.encoder.release(pod, name, rollback=True)
            self._assumed_uids.discard(pod.uid)
            self._drop_assumed_node(pod)
        self.gangs_rolled_back += 1
        if self.gangs is not None:
            self.gangs.note_rolled_back(key)
        first = next(o for o in outcomes if o is not None)
        for pod in members:
            events.append(failed_event(
                pod, comp, f"gang {key} rolled back: {first}"))
        self.client.create_events(events)
        # Park for the unblocked-gang wakeup (node add / rollback):
        # re-delivery re-gates the members, and the gang retries as a
        # whole.  Members the API server no longer knows stay parked
        # harmlessly (their deletion purges them via _on_pod_gone).
        self._park_gang(members)
        return 0

    def _park_gang(self, members: list[Pod]) -> None:
        evicted_events: list = []
        for pod in members:
            evicted = self._park_pod(pod)
            if evicted is not None:
                evicted_events.append(failed_event(
                    evicted, self.cfg.scheduler_name,
                    "dropped from the parked-pod backlog (capacity "
                    "1024 exceeded); recovered by the next resync"))
        if evicted_events:
            self.client.create_events(evicted_events)

    def _flush_gang_timeouts(self) -> None:
        """Expire incomplete gangs whose gate deadline passed: emit a
        FailedScheduling event per stranded member and return them to
        the queue (they re-gate with a fresh deadline on the next
        pop — kube co-scheduling's retry shape).

        Elastic gangs degrade instead: when reshaping is on and
        the arrived members cover some DECLARED smaller shape, the
        gate expiring means the missing members are not coming (a
        zonal outage deleted them, a controller is slow) — the gang
        schedules at the best viable realization now and the
        rebalancer's regrow path restores the full shape when the
        stragglers re-deliver."""
        if self.gangs is None:
            return
        comp = self.cfg.scheduler_name
        for key, members in self.gangs.flush_timeouts():
            declared = {int(c) for pod in members
                        for c, _ in (getattr(pod, "gang_shapes", ())
                                     or ())}
            if (self.cfg.enable_gang_reshaping and declared
                    and min(declared) <= len(members)):
                self.client.create_events([
                    failed_event(
                        pod, comp,
                        f"gang {key} timed out waiting for members "
                        f"({len(members)} arrived); degrading to the "
                        "declared elastic family")
                    for pod in members])
                self._schedule_gang(key, members)
                continue
            self.client.create_events([
                failed_event(
                    pod, comp,
                    f"gang {key} timed out waiting for members "
                    f"({len(members)} arrived)")
                for pod in members])
            for pod in members:
                self.queue.push(pod)  # full queue drops; resync heals

    def _emit_degraded_events(self) -> None:
        """Per-pod Warning events for constraint degradation on
        interner overflow (encode.Encoder._constraint_bits): the
        aggregate overflow counter says it happened; these say to WHOM
        — in particular a dropped anti-affinity group silently stops
        being enforced for that pod."""
        degraded = self.encoder.pop_degraded()
        if not degraded:
            return
        from kubernetesnetawarescheduler_tpu_torch.k8s.types import Event

        self.client.create_events([
            Event(
                message=(f"{count} constraint key(s) dropped "
                         "(interner capacity or unrepresentable "
                         "terms); affinity/anti-affinity may not be "
                         "fully enforced"
                         + (": " + "; ".join(detail) if detail else "")),
                reason="ConstraintDegraded", involved_pod=name,
                namespace=namespace,
                component=self.cfg.scheduler_name, type="Warning")
            for namespace, name, count, detail in degraded])

    def _publish_assumed_node(self, pod: Pod, node_name: str) -> None:
        """Record an assumed placement under the qualified name and —
        when unambiguous — the bare alias.  On a cross-namespace
        bare-name collision the bare alias is POISONED (dropped, and
        held dropped by _bare_ns' refcount) instead of last-writer-
        wins: an annotation peer's bare reference must never silently
        resolve to the other namespace's node; the inherently
        ambiguous lookup falls through to the client, whose own
        bare-name semantics then apply.  Qualified references always
        resolve exactly."""
        entry = (pod.namespace, node_name)
        with self._alias_lock:
            nss = self._bare_ns.setdefault(pod.name, set())
            nss.add(pod.namespace)
            if len(nss) == 1:
                self._assumed_node[pod.name] = entry
            else:
                self._assumed_node.pop(pod.name, None)
            self._assumed_node[f"{pod.namespace}/{pod.name}"] = entry

    def _drop_assumed_node(self, pod: Pod) -> None:
        """Remove a pod's assumed-placement entries.  The bare-name
        alias is dropped only when this pod's namespace owns it; when
        the drop resolves a cross-namespace collision down to one
        surviving namespace, the survivor's bare alias is restored
        (see _bare_ns in __init__)."""
        with self._alias_lock:
            self._assumed_node.pop(f"{pod.namespace}/{pod.name}", None)
            nss = self._bare_ns.get(pod.name)
            if nss is None:
                # Never assumed (or already fully dropped): nothing
                # beyond the owner-checked bare cleanup below.
                entry = self._assumed_node.get(pod.name)
                if entry is not None and entry[0] == pod.namespace:
                    self._assumed_node.pop(pod.name, None)
                return
            nss.discard(pod.namespace)
            if not nss:
                del self._bare_ns[pod.name]
                entry = self._assumed_node.get(pod.name)
                if entry is not None and entry[0] == pod.namespace:
                    self._assumed_node.pop(pod.name, None)
            elif len(nss) == 1:
                # Collision resolved: the survivor becomes bare-
                # addressable again (its qualified entry is live iff
                # its assumption still is).
                ns = next(iter(nss))
                surv = self._assumed_node.get(f"{ns}/{pod.name}")
                if surv is not None:
                    self._assumed_node[pod.name] = surv
                else:
                    self._assumed_node.pop(pod.name, None)

    def _peer_node(self, pod_name: str) -> str:
        # The scheduler's own assumed cache first (assume-then-bind:
        # a decided-but-unconfirmed peer is already placed from the
        # scorer's point of view — and consulting the API-server view
        # here made peer resolution race the bind worker).
        entry = self._assumed_node.get(pod_name)
        if entry is not None:
            return entry[1]
        try:
            return self.client.node_of(pod_name)
        except KeyError:
            return ""  # peer not known to the API server (yet)

    def _try_preempt(self, pod: Pod, events: list) -> bool:
        """Attempt to make room for an unschedulable pod by evicting
        strictly-lower-priority pods (core/preempt.py).  Returns True
        when victims were evicted and the pod was requeued; the caller
        then skips the FailedScheduling path for this cycle."""
        from kubernetesnetawarescheduler_tpu_torch.core.preempt import (
            execute_preemption,
            plan_preemption,
        )

        attempts = self._preempt_attempts.get(pod.uid, 0)
        if attempts >= self.cfg.max_preemption_attempts:
            # Budget exhausted: keep the counter (dropping it would let
            # the periodic resync re-arm eviction forever for a pod
            # preemption cannot help).  The entry is cleared when the
            # pod finally schedules or is deleted.
            return False
        plan = plan_preemption(self.encoder, pod)
        if plan is None or not plan.victims:
            return False
        self._preempt_attempts[pod.uid] = attempts + 1
        done = execute_preemption(self.client, self.encoder, plan,
                                  self.cfg.preemption_grace_s)
        if not done:
            return False
        self.preemptions += len(done)
        from kubernetesnetawarescheduler_tpu_torch.k8s.types import Event

        for v in done:
            events.append(Event(
                message=(f"Preempted by {pod.namespace}/{pod.name} "
                         f"(priority {pod.priority:g} > {v.priority:g})"),
                reason="Preempted", involved_pod=v.name,
                namespace=v.namespace,
                component=self.cfg.scheduler_name, type="Warning"))
        # Reserve the target (nominatedNodeName) and hold the
        # preemptor until every victim's deletion is confirmed through
        # the watch.  The wait entry is published BEFORE checking for
        # already-landed releases so a watch event racing this thread
        # can never slip between check and registration.
        self.encoder.nominate(pod.uid, plan.node_name, pod.requests)
        outstanding = {v.uid for v in done}
        with self._preempt_lock:
            self._awaiting_preemption[pod.uid] = (
                pod, outstanding,
                time.monotonic() + self.cfg.preemption_wait_s)
        with self._preempt_lock:
            for uid in list(outstanding):
                if not self.encoder.is_committed(uid):
                    # Release already landed (synchronous client
                    # fanout, or the watch beat us here).
                    outstanding.discard(uid)
            drained = (not outstanding
                       and pod.uid in self._awaiting_preemption)
            if drained:
                del self._awaiting_preemption[pod.uid]
        if drained and not self.queue.push(pod):
            # Queue full: refund the attempt (the freed space means
            # the next resync delivery likely schedules without
            # another eviction), drop the reservation, and fall
            # through to FailedScheduling so the state is visible.
            self._preempt_attempts[pod.uid] = attempts
            self.encoder._drop_nomination(pod.uid)
            return False
        return True

    def _requeue_transient(self, pod: Pod, exc: Exception,
                           events: list, comp: str) -> None:
        """Requeue a pod whose bind failed transiently, with a retry
        budget so it cannot cycle forever."""
        self.bind_failures += 1
        key = f"{pod.namespace}/{pod.name}"
        tries = self._bind_retries.get(key, 0) + 1
        self._bind_retries[key] = tries
        if tries <= self.max_bind_retries:
            self.queue.push(pod)
        else:
            self._bind_retries.pop(key, None)
            events.append(failed_event(
                pod, comp,
                f"bind failed after {tries - 1} retries: {exc}"))

    def _bound_where(self, pod: Pod) -> str:
        """Best-effort: which node (if any) the API server says the
        pod is bound to.  Used to heal 409s on the bind path."""
        try:
            return self.client.node_of(f"{pod.namespace}/{pod.name}")
        except KeyError:
            try:
                return self.client.node_of(pod.name)
            except KeyError:
                return ""

    def _bind_all(self, pods: Sequence[Pod],
                  assignment: np.ndarray,
                  node_table: tuple[list[str], list[int]] | None = None
                  ) -> int:
        """Bind a batch: one ``bind_many`` round-trip, batched events,
        batched usage commit — per-pod work only on the error paths.

        Semantically identical to binding pod-by-pod (the reference's
        shape, scheduler.go:196-233): per-pod outcomes, permanent
        rejections dropped with an event, transient errors requeued
        with a retry budget.  ``node_table`` is the (names, generations)
        snapshot taken with the cluster snapshot; commits are dropped
        for slots whose generation moved (node removed mid-cycle)."""
        comp = self.cfg.scheduler_name
        if node_table is None:
            node_table = self.encoder.node_table()
        table_names, table_gens = node_table
        events: list = []
        bindable, node_idxs, names = self._plan_bind(
            pods, assignment, table_names, events, comp)
        return self._finish_bind(bindable, node_idxs, names, table_gens,
                                 events, comp, assumed=None)

    def _plan_bind(self, pods: Sequence[Pod], assignment: np.ndarray,
                   table_names: list, events: list, comp: str):
        """Network-free half of a bind pass: per-pod decision-log
        entries, the preemption/unschedulable path for kernel
        rejections, and the (pod, node index, node name) triples worth
        sending to the API server."""
        bindable: list[Pod] = []
        node_idxs: list[int] = []
        names: list[str] = []
        for i, pod in enumerate(pods):
            idx = int(assignment[i])
            if idx < 0:
                if self.encoder.committed_node(pod.uid) is not None:
                    # Re-delivered pod whose usage is already in the
                    # ledger (watch replay, resync, relist audit): it
                    # is bound, not unschedulable — its OWN usage is
                    # what the re-score tripped over.  Logging "" /
                    # emitting FailedScheduling / parking it here
                    # would contradict the ledger and the apiserver.
                    continue
                if self.decision_log is not None:
                    self.decision_log.append(pod.name, "")
                if self.cfg.enable_preemption and \
                        self._try_preempt(pod, events):
                    continue
                self.unschedulable += 1
                events.append(failed_event(pod, comp, "no feasible node"))
                # Assume-then-bind: an "unschedulable" verdict may
                # rest on capacity an UNCONFIRMED assumption holds —
                # park the pod so a later rollback (which frees that
                # capacity) retries it instead of leaving it to the
                # slow periodic resync.  kube-scheduler's own
                # unschedulable-queue flush on cluster events.
                if self.async_bind:
                    evicted = self._park_pod(pod)
                    if evicted is not None:
                        events.append(failed_event(
                            evicted, comp,
                            "dropped from the parked-pod backlog "
                            "(capacity 1024 exceeded); recovered by "
                            "the next resync"))
                continue
            bindable.append(pod)
            node_idxs.append(idx)
            names.append(table_names[idx])
        self._redirect_committed(bindable, node_idxs, names)
        # Decision-log AFTER the redirect: for an already-committed pod
        # the ledger's node is the decision that actually binds — the
        # re-scored target would record a placement that never happens
        # (tools/state_audit.py cross-checks exactly this agreement).
        if self.decision_log is not None:
            for pod, name in zip(bindable, names):
                self.decision_log.append(pod.name, name)
        return bindable, node_idxs, names

    def _redirect_committed(self, bindable: list, node_idxs: list,
                            names: list) -> None:
        """Rewrite bind targets for pods whose usage is ALREADY in
        the ledger to the ledger's recorded node.  The assume for
        such a pod happened before (earlier cycle, or a previous
        process life via checkpoint restore) against a snapshot that
        did NOT contain its own usage; re-scoring it now sees that
        usage and can pick a different node — binding there would
        strand the recorded usage (ledger says node A, server says
        node B).  The ledger is authoritative for committed pods."""
        for j, pod in enumerate(bindable):
            where = self.encoder.committed_node(pod.uid)
            if where is None or where == names[j]:
                continue
            try:
                ridx = self.encoder.node_index(where)
            except KeyError:
                # Recorded node left the cluster; the scored target
                # stands and node-reconcile releases the stale record.
                continue
            names[j] = where
            node_idxs[j] = ridx
            self.binds_redirected += 1

    def _finish_bind(self, bindable: list, node_idxs: list, names: list,
                     table_gens: list, events: list, comp: str,
                     assumed: set | None) -> int:
        """Network half of a bind pass: ``bind_many`` plus per-pod
        outcome handling.  ``assumed is None`` is the synchronous
        cycle — successes are committed here (generation-guarded).
        Otherwise ``assumed`` holds the uids whose usage the cycle
        already committed at assume time: successes need no commit,
        and every failure of an assumed pod ROLLS BACK via the
        ledger-driven ``encoder.release`` before the usual
        event/requeue handling."""
        outcomes = self.client.bind_many([
            Binding(pod_name=pod.name, namespace=pod.namespace,
                    node_name=name)
            for pod, name in zip(bindable, names)])
        if self.flight is not None and self.flight.pods is not None:
            self.flight.pods.acked(
                [pod.uid for pod, exc in zip(bindable, outcomes)
                 if exc is None], time.perf_counter())

        ok_pods: list[Pod] = []
        ok_idxs: list[int] = []
        adopted = 0
        for pod, idx, name, exc in zip(bindable, node_idxs, names,
                                       outcomes):
            if exc is None:
                ok_pods.append(pod)
                ok_idxs.append(idx)
                events.append(scheduled_event(pod, name, comp))
            elif isinstance(exc, (KeyError, ValueError)):
                # "Already bound" conflicts can be OUR bind succeeding
                # without us seeing the response (connection dropped
                # mid-batch, duplicate queue delivery): if the pod
                # landed on the node we chose, it IS scheduled —
                # account it, don't report failure.
                where = (self._bound_where(pod)
                         if isinstance(exc, ValueError) else None)
                if where == name:
                    if self.encoder.is_committed(pod.uid) and \
                            (assumed is None or
                             pod.uid not in assumed):
                        # Duplicate delivery of a pod we already bound
                        # AND accounted: healing it again would inflate
                        # the scheduled counter and emit a second
                        # "Scheduled" event (commit_many dedups the
                        # ledger, but counters/events are not
                        # idempotent).  The assume path filters
                        # same-process duplicates before the network
                        # (_assumed_uids); cross-restart duplicates
                        # reach here NOT in `assumed` (already in the
                        # restored ledger, so excluded from the
                        # assume set) and are skipped the same way.
                        continue
                    ok_pods.append(pod)
                    ok_idxs.append(idx)
                    events.append(scheduled_event(pod, name, comp))
                    continue
                if where == "":
                    # Conflict but our view doesn't know where the pod
                    # sits yet (watch event still in flight): treat as
                    # transient so the retry re-checks once the cache
                    # catches up, instead of dropping a pod that may
                    # be running on the node we chose.
                    self._rollback_assumed(pod, name, assumed)
                    self._requeue_transient(pod, exc, events, comp)
                    continue
                # The pod IS bound, just not where this attempt chose
                # — often our own earlier bind whose acknowledgement
                # was lost (connection reset after the server applied
                # it), retried after intervening commits shifted the
                # placement.  Adopt the server's truth into the ledger
                # instead of dropping it: an unaccounted running pod
                # would overload its node forever (and the usage
                # ledger must reconverge to server truth after a
                # fault clears).
                self._rollback_assumed(pod, name, assumed)
                widx = None
                try:
                    widx = self.encoder.node_index(where)
                except KeyError:
                    pass
                if widx is not None and \
                        not self.encoder.is_committed(pod.uid):
                    self.encoder.commit_many([pod], [widx])
                    adopted += 1
                    self.binds_adopted += 1
                    events.append(scheduled_event(pod, where, comp))
                    self._bind_retries.pop(
                        f"{pod.namespace}/{pod.name}", None)
                    continue
                self.bind_failures += 1
                events.append(failed_event(
                    pod, comp, f"bind rejected: {exc}"))
            else:
                # Transient API error: requeue with a retry budget
                # instead of stranding the pod as Pending forever.
                self._rollback_assumed(pod, name, assumed)
                self._requeue_transient(pod, exc, events, comp)

        if self._bind_retries:
            for pod in ok_pods:
                self._bind_retries.pop(f"{pod.namespace}/{pod.name}", None)
        if self._preempt_attempts:
            for pod in ok_pods:
                self._preempt_attempts.pop(pod.uid, None)
        if assumed is None:
            # Drop commits whose slot was freed (and possibly reused)
            # since the snapshot: the node is gone, its pods are being
            # garbage-collected, and booking usage onto the slot's new
            # tenant would corrupt accounting.
            fresh = [(pod, idx) for pod, idx in zip(ok_pods, ok_idxs)
                     if self.encoder.slot_generation(idx) ==
                     table_gens[idx]]
            self.encoder.commit_many([p for p, _ in fresh],
                                     [i for _, i in fresh])
        self.client.create_events(events)
        self.scheduled += len(ok_pods) + adopted
        return len(ok_pods) + adopted

    def _rollback_assumed(self, pod: Pod, name: str,
                          assumed: set | None) -> None:
        """Reverse an assume-time commit for a pod whose bind failed
        (assume-then-bind cycle only; no-op for the sync path and for
        pods that were never assumed, e.g. stale-generation slots).
        ``rollback=True``: if the record is already gone (node removal
        raced the bind), do NOT plant an early-release marker — it
        would cancel the pod's next commit after the requeue."""
        if assumed is not None and pod.uid in assumed:
            # Release BEFORE discarding from _assumed_uids: the other
            # order opens a window where a concurrent duplicate
            # delivery in _assume_and_enqueue sees "not assumed" yet
            # "still committed" — it would skip its own assume-commit
            # while this release erases the usage underneath it.
            self.encoder.release(pod, name, rollback=True)
            self._assumed_uids.discard(pod.uid)
            self._drop_assumed_node(pod)
            # The rollback freed assumed capacity: retry pods the
            # kernel rejected while it was held.
            self._requeue_parked()

    def _requeue_parked(self) -> None:
        """Requeue every parked unschedulable pod (called when
        capacity appears: an assumed-bind rollback or a new node).

        Pushes happen UNDER the lock so a concurrent _on_pod_gone
        cannot miss a drained-but-unpushed pod and revive a deletion
        (queue.push is non-blocking — a full queue drops — and takes
        no lock that ever waits on _parked_lock, so the nesting cannot
        deadlock)."""
        with self._parked_lock:
            while self._unsched_parked:
                parked = self._unsched_parked.popleft()
                self._parked_uids.discard(parked.uid)
                self.queue.push(parked)  # full queue drops; resync heals

    def _park_pod(self, pod: Pod) -> Pod | None:
        """Park one unschedulable pod on the bounded backlog.  Returns
        the pod EVICTED to make room when the deque was full (callers
        emit its FailedScheduling event outside the lock) — the silent
        ``deque(maxlen=...)`` eviction used to lose the oldest parked
        pod with no trace (recovered only by a later resync, and never
        counted)."""
        evicted: Pod | None = None
        with self._parked_lock:
            if pod.uid in self._parked_uids:
                return None
            maxlen = self._unsched_parked.maxlen
            if maxlen is not None and \
                    len(self._unsched_parked) >= maxlen:
                evicted = self._unsched_parked.popleft()
                self._parked_uids.discard(evicted.uid)
                self.parked_dropped += 1
            self._unsched_parked.append(pod)
            self._parked_uids.add(pod.uid)
        return evicted

    # -- degraded mode (breaker-open bind parking) ---------------------

    def _dispatch_bind(self, item: tuple) -> None:
        """Hand one assumed bind batch to the bind worker — unless the
        breaker is OPEN (degraded mode) or older parked batches exist
        (FIFO: a fresh batch must never overtake the parked backlog),
        in which case the batch parks.  Usage is committed at assume
        time either way, so parking changes WHEN the API server sees
        the binds, never what later cycles score against — the
        no-re-ordering-vs-serial-oracle contract."""
        breaker = self.breaker
        if breaker is not None:
            with self._parked_lock:
                if breaker.state == "open" or self._parked_binds:
                    self._parked_binds.append(item)
                    self.binds_parked_total += len(item[0])
                    return
        self._bind_q.put(item)

    def _drain_parked_binds(self) -> int:
        """Release parked bind batches per breaker state: none while
        OPEN, ONE probe batch per call while HALF-OPEN (its outcome
        closes or re-opens the breaker), everything FIFO once CLOSED.
        Runs on the cycle thread; batches drain through the normal
        bind worker with unchanged retire/rollback semantics."""
        breaker = self.breaker
        released = 0
        while True:
            state = "closed" if breaker is None else breaker.state
            if state == "open":
                break
            with self._parked_lock:
                if not self._parked_binds:
                    break
                item = self._parked_binds.popleft()
            self._bind_q.put(item)
            released += 1
            if state == "half_open":
                break  # one probe; its outcome decides the rest
        return released

    @property
    def degraded(self) -> bool:
        """True while the control-plane breaker is open (binds parked,
        scoring still live) — the /healthz // readyz signal."""
        breaker = self.breaker
        return breaker is not None and breaker.state == "open"

    # -- watch-gap relist audit ---------------------------------------

    def _on_watch_gap(self, reason: str = "") -> None:
        """Watch-thread callback: a stream could not resume from its
        resourceVersion, so events may be lost.  Arms a relist audit
        for the CYCLE thread — relisting inline here would hang the
        watch thread on the same browned-out server that caused the
        gap."""
        self.watch_gaps += 1
        self._relist_needed = True

    def relist_audit(self) -> int:
        """Full relist after a watch gap: diff informer/encoder state
        against the server and repair the drift — nodes added or
        removed while the stream was dark, pending pods never
        delivered, ledger entries for pods that vanished.  Emits one
        summary repair event when anything moved.  A failing listing
        re-arms the audit (the gap is not healed until the server
        answers a full relist)."""
        self._relist_needed = False
        repairs = 0
        complete = True
        listed_at = time.monotonic()
        try:
            server_nodes = self.client.list_nodes()
        except Exception:  # noqa: BLE001 — server still dark: retry
            self._relist_needed = True
            return 0
        fresh_nodes = 0
        for node in server_nodes:
            try:
                self.encoder.node_index(node.name)
            except KeyError:
                fresh_nodes += 1
            # Upsert; genuinely new nodes also wake parked pods
            # (missed node-ADDED is exactly a gap symptom).
            self._on_node(node)
        repairs += fresh_nodes
        repairs += self.encoder.reconcile_nodes(
            [n.name for n in server_nodes], listed_at)
        # The informer's own node cache misses deletions too (it only
        # grows via watch events): prune ghosts against the same
        # authoritative listing.
        repairs += self.informer.reconcile_nodes(
            [n.name for n in server_nodes])
        try:
            repairs += self.informer.resync()
        except Exception:  # noqa: BLE001 — partial audit: re-arm
            self._relist_needed = True
            complete = False
        try:
            repairs += self.reconcile_usage()
        except Exception:  # noqa: BLE001 — partial audit: re-arm
            self._relist_needed = True
            complete = False
        self.relists += 1
        self.relist_repairs += repairs
        if repairs or not complete:
            from kubernetesnetawarescheduler_tpu_torch.k8s.types import Event

            self.client.create_event(Event(
                message=(f"watch gap: relist audit repaired {repairs} "
                         "drift item(s)"
                         + ("" if complete
                            else "; audit incomplete, re-armed")),
                reason="WatchGapRelist",
                involved_pod=self.cfg.scheduler_name,
                namespace="default",
                component=self.cfg.scheduler_name, type="Warning"))
        return repairs

    def _assume_and_enqueue(self, pods: Sequence[Pod],
                            assignment: np.ndarray,
                            node_table: tuple[list[str], list[int]]
                            ) -> int:
        """Assume-then-bind cycle tail (kube's cache pattern): commit
        fresh placements into the encoder NOW so the next cycle's
        snapshot sees them, then queue the network half for the bind
        worker.  Returns the number of pods assumed; bind
        confirmations update ``scheduled`` asynchronously
        (``flush_binds`` drains)."""
        if self._bind_worker_err:
            raise self._bind_worker_err[0]
        comp = self.cfg.scheduler_name
        table_names, table_gens = node_table
        events: list = []
        bindable, node_idxs, names = self._plan_bind(
            pods, assignment, table_names, events, comp)
        keep: list[tuple[Pod, int, str]] = []
        for pod, idx, name in zip(bindable, node_idxs, names):
            if pod.uid in self._assumed_uids:
                # Duplicate queue delivery of a pod THIS process
                # already assumed: the sync path heals this on the
                # 409; here it can be dropped before the network even
                # sees it.  (Process-local on purpose — see __init__.)
                continue
            keep.append((pod, idx, name))
        fresh = [(pod, idx) for pod, idx, _ in keep
                 if self.encoder.slot_generation(idx) == table_gens[idx]
                 # A pod already in the (possibly checkpoint-restored)
                 # ledger needs no assume-commit, and must NOT enter
                 # this cycle's `assumed` set: a cross-restart
                 # duplicate delivery then heals through the 409 path
                 # below without inflating counters/events (the
                 # process-local _assumed_uids filter cannot see it).
                 and not self.encoder.is_committed(pod.uid)]
        self.encoder.commit_many([p for p, _ in fresh],
                                 [i for _, i in fresh])
        assumed = {p.uid for p, _ in fresh}
        self._assumed_uids |= assumed
        for pod, idx, name in keep:
            if self.encoder.is_committed(pod.uid):
                # Under BOTH the bare and namespace-qualified names:
                # KubeClient peer references arrive qualified
                # ("ns/name", kubeclient pod_from_json), annotation
                # peers and the fake cluster use bare names — the
                # same dual indexing the stream encode uses.
                # Committed-but-not-assumed pods (checkpoint-restored
                # ledger entries, redirected to their recorded node by
                # _plan_bind) publish too: peers must resolve against
                # the ledger's placement, not race the bind worker
                # through the server-truth fallback.
                self._publish_assumed_node(pod, name)
        self._dispatch_bind(([p for p, _, _ in keep],
                             [i for _, i, _ in keep],
                             [n for _, _, n in keep],
                             table_gens, events, comp, assumed))
        return len(fresh)

    def _merge_bind_items(self, items: list[tuple]) -> tuple:
        """Coalesce several queued bind batches into ONE fanout item.
        Safe only in assume mode: every real queue item carries its
        ``assumed`` uid set (never None — only the shutdown sentinel
        is), and ``_finish_bind`` ignores ``table_gens`` entirely when
        ``assumed`` is a set, so concatenating the keep lists, merging
        the events, and unioning the assumed sets loses nothing.
        Merged bindings are re-grouped by (node, namespace) so
        adjacent binds to one node land together in the client
        fanout — the per-node/namespace batching window."""
        keep_p: list = []
        keep_i: list = []
        keep_n: list = []
        events: list = []
        assumed: set = set()
        for it in items:
            keep_p.extend(it[0])
            keep_i.extend(it[1])
            keep_n.extend(it[2])
            events.extend(it[4])
            assumed |= it[6]
        order = sorted(range(len(keep_p)),
                       key=lambda x: (keep_n[x],
                                      keep_p[x].namespace))
        self.bind_coalesced_total += len(items) - 1
        return ([keep_p[x] for x in order],
                [keep_i[x] for x in order],
                [keep_n[x] for x in order],
                items[0][3], events, items[0][5], assumed)

    def _bind_worker_main(self) -> None:
        import queue as queue_mod

        window = max(1, int(getattr(self.cfg, "bind_coalesce_window",
                                    1)))
        while True:
            item = self._bind_q.get()
            if item is None:
                self._bind_q.task_done()
                return
            # Coalesce: drain up to window-1 already-queued batches
            # into this fanout (window=1 = off, the pre-r16 shape).
            items = [item]
            while len(items) < window:
                try:
                    extra = self._bind_q.get_nowait()
                except queue_mod.Empty:
                    break
                if extra is None:
                    # A shutdown sentinel belongs to a BLOCKING get
                    # (each worker consumes exactly one) — recycle it
                    # to the back of the queue, accounting-exact.
                    self._bind_q.task_done()
                    self._bind_q.put(None)
                    break
                items.append(extra)
            try:
                merged = (items[0] if len(items) == 1
                          else self._merge_bind_items(items))
                keep_p, keep_i, keep_n, gens, events, comp, assumed = \
                    merged
                with self._bind_inflight_lock:
                    self.bind_inflight += 1
                    self.bind_inflight_peak = max(
                        self.bind_inflight_peak, self.bind_inflight)
                try:
                    with self.timer.phase("bind_net"):
                        self._finish_bind(keep_p, keep_i, keep_n,
                                          gens, events, comp, assumed)
                finally:
                    with self._bind_inflight_lock:
                        self.bind_inflight -= 1
            except BaseException as exc:  # noqa: BLE001 — surfaced on
                # the next cycle / flush; a dead worker must fail the
                # serving loop loudly, not strand assumed pods.
                self._bind_worker_err.append(exc)
            finally:
                # One task_done PER QUEUE ITEM — flush_binds polls
                # unfinished_tasks, which must reach zero exactly when
                # every enqueued batch (coalesced or not) completed.
                for _ in items:
                    self._bind_q.task_done()

    def flush_binds(self, timeout: float | None = None) -> None:
        """Block until every queued bind batch has been processed
        (assume-then-bind mode; no-op otherwise), then re-raise the
        first worker error if one occurred.  Call before reading
        bind-dependent state (checkpoints, tests, shutdown).

        Pipelined/multicycle mode: retires any in-flight burst or
        multicycle window first — their assumes must land before the
        queue can be considered drained.  (Same cycle-thread
        ownership contract as run_once.)"""
        if self._mc_inflight:
            self._retire_multicycle()
        if self._pipe_inflight is not None:
            self._retire_inflight()
        if self._bind_q is None:
            return
        if self._parked_binds:
            # A recovered breaker releases the parked backlog here too
            # (shutdown/checkpoint callers flush without cycling); an
            # OPEN breaker keeps it parked — degraded state is not
            # "drained", and the checkpoint carries the assumes.
            self._drain_parked_binds()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self._bind_q.unfinished_tasks:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"bind queue not drained within {timeout}s")
            time.sleep(0.002)
        if self._bind_worker_err:
            raise self._bind_worker_err[0]

    def multicycle_meta(self) -> dict:
        """Checkpoint provenance for the multi-cycle window (r16):
        stamped into checkpoint meta via ``extra_meta`` so a restore
        can name the cycle it lands on.  Usage commits only at retire,
        so ``waves_inflight`` waves are NOT in the ledger — a restore
        resumes from ``last_retired_cycle`` and the unretired waves'
        pods re-arrive Pending through the informer resync."""
        return {
            "k": int(self.multicycle),
            "waves_inflight": len(self._mc_inflight),
            "last_retired_cycle": int(self.multicycle_last_retired),
        }

    def stop_bind_worker(self, timeout: float | None = 30.0) -> None:
        """Drain outstanding binds and stop the worker (shutdown
        path; the loop cannot schedule in async mode afterwards)."""
        self.stop_static_refresher()
        if self._encode_pool is not None:
            self._encode_pool.shutdown(wait=True)
            self._encode_pool = None
        if self._bind_q is None:
            return
        self.flush_binds(timeout)
        # One sentinel per worker: each consumes exactly one from its
        # blocking get (a sentinel seen mid-coalesce is recycled).
        for _ in self._bind_workers:
            self._bind_q.put(None)
        for w in self._bind_workers:
            w.join(timeout)

    def run_until_drained(self, max_cycles: int = 10_000) -> int:
        """Drain the queue; returns total pods bound (assume-then-bind
        mode: total pods assumed, with all binds flushed)."""
        total = 0
        for _ in range(max_cycles):
            n = self.run_once(timeout=0.0)
            if n == 0 and len(self.queue) == 0:
                # The bind worker may still requeue transient failures
                # — only an empty queue AFTER a flush is drained.
                self.flush_binds()
                if len(self.queue) == 0:
                    break
            total += n
        return total

    def reconcile_nodes(self) -> int:
        """Remove encoder nodes the API server no longer lists (DELETED
        events missed while the daemon was down, or a watch gap).
        ``listed_at`` is taken before the listing so a node registered
        concurrently (watch ADDED racing the list response) is never
        wrongly removed.  Returns how many were removed."""
        listed_at = time.monotonic()
        try:
            listed = [n.name for n in self.client.list_nodes()]
        except Exception:  # noqa: BLE001 — transient; next tick retries
            return 0
        return self.encoder.reconcile_nodes(listed, listed_at)

    def reconcile_usage(self) -> int:
        """Release ledger entries for pods that no longer exist
        (deleted while the daemon was down, or whose watch event was
        lost).  No-op for clients that cannot list all pods."""
        listed_at = time.monotonic()
        pods = self.client.list_all_pods()
        if pods is None:
            return 0
        return self.encoder.reconcile_committed(
            (p.uid for p in pods), listed_at)

    def run_forever(self, poll_s: float = 0.05,
                    resync_every_s: float = 60.0) -> None:
        """The reference's ``wait.Until(s.Schedule, 0, quit)``
        (scheduler.go:140), batched, plus a periodic pending-pod
        resync so pods lost to drops/transient failures are recovered
        (the reference stranded them, scheduler.go:165-173) and a
        usage-ledger reconcile against the live pod listing."""
        last_resync = time.monotonic()
        while True:
            if self.run_once(timeout=poll_s) == 0:
                time.sleep(0.0)
            if time.monotonic() - last_resync >= resync_every_s:
                self.maintain()
                last_resync = time.monotonic()

    def maintain(self) -> None:
        """One maintenance tick: pending-pod resync + usage-ledger
        reconcile.  Transient API errors are swallowed — maintenance
        must never take the serving loop down (the watch path already
        catches-and-reconnects on exactly these errors)."""
        try:
            self.informer.resync()
        except Exception:  # noqa: BLE001 — retried next tick
            pass
        try:
            self.reconcile_usage()
        except Exception:  # noqa: BLE001 — retried next tick
            pass
        try:
            self.reconcile_nodes()
        except Exception:  # noqa: BLE001 — retried next tick
            pass
        self._flush_preemption_waits()
        self._flush_gang_timeouts()
        self.encoder.expire_nominations(self.cfg.preemption_wait_s)
        # Outcome observability: harvest pending quality joins against
        # the probes that arrived since the commits, and keep the SLO
        # engine sampling even when no cycles are committing.
        if self.quality is not None:
            try:
                now = time.monotonic()
                if (now - self._quality_last_harvest
                        >= self.cfg.quality_harvest_interval_s):
                    self._quality_last_harvest = now
                    self.quality.harvest(self.encoder)
            except Exception as exc:  # noqa: BLE001 — observation only
                _observation_guard(exc)
        if self.slo is not None:
            try:
                self._slo_last_eval = time.monotonic()
                self.slo.evaluate(self)
            except Exception as exc:  # noqa: BLE001 — observation only
                _observation_guard(exc)
        # Continuous rebalancing: settle in-flight moves, then scan for
        # improvement candidates and execute within budget.  The
        # rebalancer owns its interval gate.  A host-side failure (an
        # API error mid-tick) is retried next tick — moves are
        # crash-safe by the migration ledger — but a fault of the
        # device scan propagates.
        if self.rebalance is not None:
            try:
                self.rebalance.tick(self)
            except Exception as exc:  # noqa: BLE001 — retried next tick
                _observation_guard(exc)
        # Learned scoring policy: join the explain/outcome stores into
        # the example ring and run the bounded Adam steps (train tick),
        # then shadow-score the retained decisions and run the
        # promotion gate (eval tick).  Both off the scoring hot path.
        if self.policy is not None:
            try:
                now = time.monotonic()
                if (now - self._policy_last_train
                        >= self.cfg.policy_train_interval_s):
                    self._policy_last_train = now
                    self._policy_train_tick()
            except Exception as exc:  # noqa: BLE001 — observation only
                _observation_guard(exc)
            try:
                now = time.monotonic()
                if (now - self._policy_last_eval
                        >= self.cfg.policy_eval_interval_s):
                    self._policy_last_eval = now
                    self._policy_eval_tick()
            except Exception as exc:  # noqa: BLE001 — observation only
                _observation_guard(exc)

    def _policy_train_tick(self) -> None:
        """One train tick: join fresh quality outcomes with their
        explain records, feed the ring, run the Adam steps."""
        if self.policy_dataset is not None:
            batch = self.policy_dataset.collect(self.flight,
                                                self.quality)
            if batch is not None:
                self.policy.add_examples(batch.comps, batch.feas,
                                         batch.target, batch.cls)
        self.policy.train()

    def _policy_eval_tick(self) -> None:
        """One eval tick: shadow-rank the retained explain records
        (disagreement accounting), then run the counterfactual
        promotion gate; without a replay trace it refuses."""
        explains = (self.flight.explains()
                    if self.flight is not None else [])
        # Shadow-rank only records newer than the last tick — the
        # explain store retains records across ticks.
        newest = self._policy_shadow_twall
        for rec in explains:
            tw = float(rec.get("t_wall", 0.0))
            if tw <= self._policy_shadow_twall:
                continue
            newest = max(newest, tw)
            self.policy.shadow_rank(rec)
        self._policy_shadow_twall = newest
        self.policy.evals_total += 1
        from kubernetesnetawarescheduler_tpu_torch.policy.replay_eval import (
            evaluate_candidate,
        )

        candidate = self.policy.to_score_weights(self.cfg.weights)
        # The gate's replays run on the loop's own device.
        decision = evaluate_candidate(
            self.cfg, candidate, self.cfg.weights, explains,
            trace_path=self.policy_eval_trace,
            k_pad=self.policy.k_pad,
            replay_kwargs={"device": self.encoder.device})
        if not decision.promote:
            self.policy.rejections_total += 1
            return
        self._apply_promotion(decision)

    def _apply_promotion(self, decision) -> None:
        """Install gate-approved weights: replace cfg (the loop, not the
        shared object, owns its config) and drop the static cache so the
        next cycle re-derives the normalization under the promoted
        weights."""
        import dataclasses as _dc

        self.cfg = _dc.replace(self.cfg,
                               weights=decision.candidate_weights)
        self.policy.cfg = self.cfg
        if self.policy_dataset is not None:
            self.policy_dataset.cfg = self.cfg
        self._static_version = None
        self._static_val = None
        with self._static_lock:
            self._static_ex = None
        self.policy.note_promotion(decision.to_dict(),
                                   decision.candidate_weights)
        if self.flight is not None:
            self.flight.meta["policy_promotion"] = {
                "version": self.policy.promoted_version,
                "reason": decision.reason,
                "replay_delta": decision.replay_delta,
                "t_wall": decision.t_wall,
            }

    def _flush_preemption_waits(self) -> None:
        """Requeue preemptors whose confirmation deadline passed (a
        victim stuck terminating must not strand the preemptor forever
        — its reservation also expires) or whose victim set drained
        but whose requeue push failed earlier.  Entries are removed
        first; an unparked pod is re-delivered by resync if the push
        fails again."""
        now = time.monotonic()
        ready: list[Pod] = []
        with self._preempt_lock:
            for uid, (pod, vset, deadline) in list(
                    self._awaiting_preemption.items()):
                if vset and now < deadline:
                    continue
                del self._awaiting_preemption[uid]
                ready.append(pod)
        for pod in ready:
            self.queue.push(pod)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A device result on the host as numpy: ``.cpu()`` waits for the
    kernels that wrote it, so bind never races the device step (one
    host sync, at site ``fetch``)."""
    with host_sync("fetch"):
        return x.cpu().numpy()
