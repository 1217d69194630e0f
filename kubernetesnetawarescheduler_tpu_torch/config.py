"""Configuration layer.

The reference hardcodes everything: scheduler name (scheduler.go:119), queue
size (scheduler.go:129), node names (scheduler.go:252-256), node IPs
(scheduler.go:275-279), NIC/disk device names (scheduler.go:466-471,
:535-540), iperf file paths (scheduler.go:507-510) and the metric vote
weights 3/2/1/1/3/1 (scheduler.go:360-365).  Here all of that is a real
config surface: dataclasses, loadable from JSON/YAML
(:func:`load_config`), consumed by the scoring service, the benchmark
harness and the native extender shim alike.

This module is the PyTorch package's own copy of the JAX package's
``config.py``: the same fields, defaults and JSON layout, so one config
file drives both packages.  In this package ``score_backend="pallas"``
selects the hand-written CUDA tile kernels (core/kernels.py) and
``"xla"`` the dense torch path (core/score.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

# ---------------------------------------------------------------------------
# Metric channel layout of the NodeMetrics[N, M] matrix.
#
# The first six channels are exactly the per-node signals the reference
# scrapes and votes on (PrometheusNodeMetrics, scheduler.go:24-32):
#   cpu scaling frequency (getCurrentCPUUsage, scheduler.go:409-442),
#   occupied memory %     (getOccupiedMemoryPercentage, :444-461),
#   tx / rx packet totals (getNetworkPacketsSent/Received, :463-500),
#   iperf3 bandwidth      (getNetworkBandwith, :503-530),
#   disk io in flight     (getDiskIONow, :532-549).
# ---------------------------------------------------------------------------


class Metric:
    """Indices into the metric axis of ``NodeMetrics[N, M]``."""

    CPU_FREQ = 0
    MEM_PCT = 1
    NET_TX = 2
    NET_RX = 3
    BANDWIDTH = 4
    DISK_IO = 5

    COUNT = 6

    NAMES = ("cpu_freq", "mem_pct", "net_tx", "net_rx", "bandwidth", "disk_io")


# Goodness direction per metric: +1 means "higher raw value is better",
# -1 means "lower raw value is better".  Mirrors the reference's sweep
# directions (min for cpu/mem/tx/rx/disk, max for bandwidth;
# scheduler.go:334-359).
GOODNESS = (-1.0, -1.0, -1.0, -1.0, +1.0, -1.0)


class Resource:
    """Indices into the resource axis of capacity/usage/request vectors."""

    CPU = 0
    MEM = 1
    NET_BW = 2

    COUNT = 3

    NAMES = ("cpu", "mem", "net_bw")


@dataclasses.dataclass(frozen=True)
class ScoreWeights:
    """Weights of the scoring policy.

    ``cpu..disk`` reproduce the reference's vote weights (+3 best CPU,
    +2 best memory, +1 best tx, +1 best rx, +3 best bandwidth, +1 best
    disk; scheduler.go:360-365) but applied to *normalized continuous*
    metrics instead of a winner-takes-all vote, so that close seconds
    are not scored identically to the worst node.

    ``peer_bw`` / ``peer_lat`` weight the pod-aware network-cost term —
    the capability the reference's per-pair iperf3 files
    (scheduler.go:503-530) gesture at, generalized to full node x node
    bandwidth / latency matrices.

    ``balance`` is the soft bin-packing penalty (worst-fit resource
    fraction after placement); the reference never consults pod resource
    requests at all (``pod`` is an unused argument of ``prioritize``,
    scheduler.go:248).
    """

    cpu: float = 3.0
    mem: float = 2.0
    net_tx: float = 1.0
    net_rx: float = 1.0
    bandwidth: float = 3.0
    disk: float = 1.0

    peer_bw: float = 2.0
    peer_lat: float = 2.0
    balance: float = 1.0
    # Multiplier on the weighted preferred-affinity score term
    # (``preferredDuringSchedulingIgnoredDuringExecution`` semantics —
    # the mechanism the reference's own probe deployment relied on,
    # netperfScript/deployment.yaml:17-26).  Per-term weights live on
    # the pod (k8s weight scale, 1-100); this scales them into the
    # normalized-score units of the vote/net terms (100 -> 1.0).
    soft_affinity: float = 1.0
    # Penalty per unit of zone skew for soft topology spread
    # (``whenUnsatisfiable: ScheduleAnyway``): nodes in zones already
    # crowded with the pod's group score lower by
    # ``spread * (count[zone] + 1 - min_count)``.
    spread: float = 0.5

    def metric_vector(self) -> tuple[float, ...]:
        """Per-channel weights aligned with :class:`Metric` order."""
        return (self.cpu, self.mem, self.net_tx, self.net_rx,
                self.bandwidth, self.disk)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for sharded scoring.

    ``dp`` shards the pending-pod axis (batch data-parallelism), ``tp``
    shards the node axis (so the ``N x N`` latency/bandwidth matrices and
    the per-node capacity state split across devices).  ``dp * tp`` must
    equal the number of participating devices.
    """

    dp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static shapes + policy for one compiled scheduler instance.

    Shapes are compile-time constants (XLA requirement): real clusters
    are padded up to ``max_nodes`` / batches padded to ``max_pods`` with
    validity masks, so metric updates never trigger recompilation.
    """

    max_nodes: int = 128
    max_pods: int = 64
    max_peers: int = 8
    # Preferred (soft) affinity terms carried per pod, per bank (one
    # bank of node-label preference terms, one of pod-group preference
    # terms).  Terms beyond this are dropped in declaration order —
    # soft constraints degrade score-neutrally, unlike hard ones.
    max_soft_terms: int = 2
    # Hard ``requiredDuringSchedulingIgnoredDuringExecution``
    # nodeAffinity: up to ``max_ns_terms`` OR'd nodeSelectorTerms per
    # pod, each AND-ing up to ``max_ns_exprs`` matchExpressions
    # (In/NotIn/Exists/DoesNotExist).  Hard constraints degrade CLOSED
    # on overflow (an unrepresentable term/expr can only make the pod
    # harder to place, never easier) — see Encoder._ns_rows.
    max_ns_terms: int = 2
    max_ns_exprs: int = 4
    # Numeric nodeAffinity (Gt/Lt matchExpressions): node label values
    # for up to ``max_numeric_labels`` distinct KEYS are parsed into a
    # dense ``f32[N, L]`` table (NaN = label absent/non-numeric, which
    # fails every comparison — kube's direction), and each
    # nodeSelectorTerm carries up to ``max_ns_num`` (column, lo, hi)
    # comparisons AND'd with its other expressions.  Keys beyond the
    # budget degrade the TERM closed, like every other hard overflow.
    max_numeric_labels: int = 8
    max_ns_num: int = 2
    # Topology domains for topologySpreadConstraints (zone-level:
    # ``topology.kubernetes.io/zone``).  Zones intern on first sight;
    # nodes past the budget fall into an untracked -1 domain where
    # spread constraints cannot see them (degrades, never crashes).
    max_zones: int = 32

    num_metrics: int = Metric.COUNT
    num_resources: int = Resource.COUNT

    # Width (in uint32 words) of every constraint bitmask column
    # (labels / taints / affinity groups).  ``32 * mask_words - 1``
    # distinct keys are assignable per category (the top bit of the
    # last word is the reserved UNKNOWN sentinel), so the default of 4
    # supports 127 distinct selector-referenced labels, taints and pod
    # groups each.  Node labels are interned lazily — only label
    # strings some pod's selector actually references consume a slot —
    # so per-node-unique labels (kubernetes.io/hostname=...) never
    # count against this budget.
    mask_words: int = 4

    weights: ScoreWeights = dataclasses.field(default_factory=ScoreWeights)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    # Metric staleness: scores decay toward neutral with age
    # (exp(-age/tau)).  The reference instead re-scrapes every node
    # synchronously per pod (scheduler.go:275-279) and trusts whatever
    # iperf JSON was last dropped into /home (scheduler.go:512).
    staleness_tau_s: float = 60.0

    # Nodes whose staleness confidence exp(-age/tau) has fallen below
    # this floor are excluded from the min/max normalization span: a
    # long-silent node must not stretch the span (making every fresh
    # node look bad) while itself coasting on the neutral 0.5 blend.
    stale_conf_floor: float = 0.05

    # Pending-pod queue capacity; parity with the reference's
    # ``make(chan *v1.Pod, 300)`` (scheduler.go:129).
    queue_capacity: int = 300

    # Pods addressed to this scheduler name are ours (scheduler.go:119,
    # :170).
    scheduler_name: str = "netAwareScheduler"

    # bf16-rounded inputs (f32 accumulation) for the net-score
    # contraction.
    use_bfloat16: bool = True

    # Score kernel for the Score/Filter and assign paths (dispatched
    # via core.tiled_score): "xla" (dense torch, C[N,N] materialized)
    # or "pallas" (the hand-written CUDA tile kernels of
    # core/kernels.py; lat/bw streamed through shared memory, C never
    # materialized; plain torch versions on CPU tensors).  The names
    # are kept so one config file drives both packages.
    score_backend: str = "xla"

    # Extender webhook micro-batching: a fixed coalescing window in
    # seconds for /filter//prioritize scoring requests.  0 (default) =
    # natural batching only — requests queued while a dispatch is in
    # flight ride the next one, no added latency when idle.  A small
    # positive window (1-5 ms) trades per-request latency for larger
    # shared dispatches on latency-insensitive deployments.
    extender_batch_window_s: float = 0.0

    # Priority preemption: when a pod is unschedulable, evict the
    # cheapest set of strictly-lower-priority pods from the best node
    # and requeue it (core/preempt.py).  Off by default — eviction is
    # a destructive action a deployment must opt into.
    enable_preemption: bool = False

    # Preemption attempts per pod before it is left Pending with a
    # FailedScheduling event (guards against plan/evict/lose loops).
    max_preemption_attempts: int = 2

    # Graceful termination window passed with preemption deletes
    # (DeleteOptions.gracePeriodSeconds; the kubelet gets this long to
    # stop the victim cleanly).
    preemption_grace_s: int = 30

    # How long the preemptor waits for its victims' deletions to be
    # confirmed (watch DELETED -> ledger release) before it is requeued
    # anyway; also the TTL of its node reservation (nominatedNodeName
    # analog) so a wedged victim cannot hold capacity hostage.
    preemption_wait_s: float = 120.0

    # Gang scheduling (core/gang.py): pods annotated with a pod-group
    # are gated until minMember have arrived, scored jointly for
    # intra-gang pairwise bandwidth, and bound all-or-nothing.  On by
    # default because it only engages for pods that carry the
    # annotation — annotation-free workloads pay nothing.
    enable_gang_scheduling: bool = True

    # Default time an incomplete gang may sit gated before its members
    # are released with a FailedScheduling event; a pod-group's own
    # timeout annotation overrides this per gang.
    gang_timeout_s: float = 300.0

    # Strength of the group objective's co-placement bias: the joint
    # scoring pass adds ``gang_weight * mean_j C[n, m_j]`` (the mean
    # net-desirability column over the gang's tentative member nodes)
    # to every member's score row.  0 disables the second pass — gangs
    # still bind atomically but members place independently.
    gang_weight: float = 1.0

    # ---- learned network topology model (netmodel/) ----
    # Off by default: with the model disabled the score/gang path
    # consumes the raw probe matrices bit-identically to a build
    # without the subsystem.
    enable_netmodel: bool = False

    # Vivaldi coordinate dimensionality (latency embedding) and the
    # rank of the bandwidth factorization u[N,r] . v[N,r]^T.
    netmodel_dim: int = 4
    netmodel_rank: int = 8

    # Ring buffer of recent probe observations the Adam step samples
    # from (each probe inserts BOTH directed entries, so the ring holds
    # ring/2 probes), mini-batch size, steps per fit() call and PEAK
    # Adam learning rate (fit() applies an inverse-sqrt decay in total
    # steps, floored at lr/8 — see TopologyModel.fit).  ring >= batch
    # is enforced so a batch never aliases.  The ring must cover the
    # pair set the model is expected to generalize from: at 64
    # probes/cycle the default retains ~9 hours of probes (~1.5 MB
    # host memory); a too-small ring silently caps fit quality
    # (measured at N=1024: an 8192 ring left the log-residual at 0.38
    # where 65536 reaches 0.21).
    netmodel_ring: int = 65536
    netmodel_batch: int = 256
    netmodel_steps: int = 8
    netmodel_lr: float = 0.05

    # Confidence saturation: a node's confidence is
    # 1 - exp(-n_obs / conf_k) — after ~3*conf_k observations the
    # model's estimates for that node count (almost) fully.
    netmodel_conf_k: float = 4.0

    # Probe-freshness horizon for the blend: a pair measured within
    # ~tau seconds keeps its direct probe value; older pairs fade
    # toward the model estimate (weight exp(-age/tau)).
    netmodel_tau_s: float = 600.0

    # Residual monitor: a fresh measurement whose |log1p-bandwidth
    # residual| exceeds this threshold on a pair whose endpoint
    # confidence product is at least resid_conf raises a
    # link-degradation event.  0.7 in log1p space ~= a 2x bandwidth
    # divergence.
    netmodel_resid_threshold: float = 0.7
    netmodel_resid_conf: float = 0.5

    # Share of every probe budget the EIG planner still spends on
    # pure stalest-first exploration (guards against confidently-wrong
    # model regions never being re-measured).
    netmodel_explore_frac: float = 0.25

    # Probe bookkeeping forget horizon (seconds): per-pair last-probe
    # entries older than this are pruned from the orchestrator
    # (bounding its O(N^2) memory); <= 0 means never forget.
    probe_forget_s: float = 0.0

    # ---- control-plane brownout resilience (k8s/kubeclient.py) ----
    # Circuit breaker over API-server health: this many brownout
    # failures (5xx/429/connection errors) within breaker_window_s
    # trips the breaker OPEN; after breaker_cooldown_s it offers
    # HALF-OPEN (one probe).  Open flips the loop into degraded mode:
    # scoring/encode continue, binds park until the probe succeeds.
    breaker_failure_threshold: int = 5
    breaker_window_s: float = 30.0
    breaker_cooldown_s: float = 5.0

    # Shared per-cycle retry pool: ALL API retries in one scheduling
    # cycle draw from this one allowance, bounding the worst-case
    # latency a browned-out API server can inject into a cycle.
    api_retry_budget: int = 8

    # Jittered exponential backoff between retries:
    # min(max, base * 2^attempt) * uniform(0.5, 1.5).
    api_backoff_base_s: float = 0.05
    api_backoff_max_s: float = 2.0

    # ---- incremental device-resident state (core/encode.py,
    # core/score.py, core/loop.py) ----
    # Delta ingest + delta static refresh: the encoder tracks WHICH
    # rows/(i, j) pairs each mutation touched and snapshot() scatter-
    # updates just those indices into the previous device pytree;
    # the assign-static rebuild likewise patches only dirty entries of
    # the prepared N x N desirability pack, keeping the bw/lat
    # normalizers as running extrema (full re-scan only when an
    # extremum-holding entry retreats).  Both paths are bit-identical
    # to a from-scratch rebuild (property-tested); False restores the
    # full-group-transfer/full-rebuild behavior exactly.
    enable_delta_state: bool = True

    # Dirty-fraction escalation threshold: when more than this
    # fraction of a snapshot group's rows (or, for net, N*N pairs) is
    # dirty, upload the whole group instead of scattering — past that
    # point one contiguous transfer beats many scattered ones.
    delta_full_fraction: float = 0.25

    # Off-critical-path assign-static refresh: when True, the serving
    # loop's _static_for never blocks a batch on the O(N^2) static
    # rebuild — batches keep scoring against the last static while a
    # background thread builds the new one.  Off by default: serving
    # output becomes (boundedly) stale-tolerant, which changes
    # placement timing; benches and serve.py opt in explicitly.
    enable_async_static: bool = False

    # Staleness contract for the async refresh: a batch may score
    # against a stale static for at most this many seconds / encoder
    # static_versions, after which _static_for falls back to a
    # synchronous (blocking) rebuild on the serving thread.
    static_max_staleness_s: float = 0.25
    static_max_versions_behind: int = 8

    # Fused winner selection + single-dispatch scheduling step
    # (core/pallas_score.score_winner_tiled, core/score.score_winner,
    # core/assign.fused_schedule_step): the per-batch winner argmax is
    # fused into the score kernel (each pod tile carries a running
    # (best_score, best_node) pair across node tiles instead of
    # writing the P×N score plane to HBM) and the assign+commit pair
    # runs as ONE jitted dispatch with the ClusterState carry donated.
    # Placements are bit-identical to the two-stage path (the fused
    # winner preserves the documented lowest-index tie-break and falls
    # back to score→argmax whenever an out-of-kernel constraint join
    # is active); on by default because it only changes WHERE the
    # reduction runs, never what it computes.
    enable_winner_fusion: bool = True

    # Decision-level tracing (utils/flight.py): ring-buffer capacity of
    # the cycle-span flight recorder (0 disables recording entirely),
    # and the per-pod placement-explain capture.  Explain re-derives the
    # score decomposition host-side AFTER the jitted score/assign ran,
    # so the scoring path stays bit-identical whether it is on or off —
    # it costs extra host work per cycle, hence off by default.
    flight_recorder_size: int = 512
    enable_explain: bool = False
    explain_top_k: int = 5
    explain_retain: int = 512
    # Per-pod timelines the flight recorder keeps (enqueued, popped,
    # bind acknowledged; 0 keeps none): 16384 holds a minute of pods at
    # 250 pods/s, or eight bursts of 8 batches of 256.
    flight_pod_records: int = 16384

    # State integrity & self-healing (core/integrity.py): anti-entropy
    # audit period in seconds (0 disables the background auditor; the
    # digest kernel itself costs nothing extra on the hot path — it
    # rides the fused step's donated chain).  The watchdog fires a
    # flight-recorder crash dump after this many CONSECUTIVE audits
    # that detected drift the repair ladder could not clear.
    audit_interval_s: float = 0.0
    audit_watchdog_failures: int = 3

    # Ingest quarantine (ingest/probe.py): a probe result with a
    # non-finite value, negative latency, or non-positive bandwidth is
    # quarantined instead of written into staging; after this many
    # CONSECUTIVE quarantines on one link, a LinkQuarantined Event is
    # raised so operators see the sick path, not just a counter.
    quarantine_streak_events: int = 3

    # Outcome observability (obs/quality.py): join each bound pod's
    # score-time network prediction against subsequently observed
    # probe truth at the maintain cadence — realized bw/lat, regret
    # vs best alternative, calibration residuals.  Observation-only:
    # placements are bit-identical on or off (tests/test_quality.py).
    enable_quality_obs: bool = False
    quality_ring_size: int = 2048
    quality_harvest_interval_s: float = 5.0

    # SLO burn-rate engine (obs/slo.py): declarative objectives
    # evaluated over multi-window burn rates; <= 0 disables an
    # objective.  Targets default to the north-star bars (score p99
    # 5 ms; bind tail from BENCH_r05's measured envelope).  The error
    # budget is the tolerated breach fraction per window; an
    # objective burns when BOTH windows spend budget faster than
    # slo_burn_threshold.
    enable_slo: bool = False
    slo_score_p99_ms: float = 5.0
    slo_bind_p99_ms: float = 1000.0
    slo_regret_ceiling: float = 0.5
    slo_error_budget: float = 0.01
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_burn_threshold: float = 1.0
    slo_eval_interval_s: float = 5.0

    # Continuous rebalancing (core/rebalance.py): a budgeted
    # descheduler that revisits bound pods at maintain cadence,
    # scores current placement vs best feasible alternative on
    # device, and live-migrates the worst offenders through the
    # crash-safe migration ledger.  Hysteresis (minimum relative
    # gain, minimum placement age, per-pod move cooldown) keeps a
    # healthy cluster quiet; the eviction budget and per-group
    # disruption limits bound the blast radius of a storm.
    enable_rebalance: bool = False
    rebalance_interval_s: float = 15.0
    rebalance_min_gain: float = 0.05
    rebalance_min_age_s: float = 60.0
    rebalance_cooldown_s: float = 300.0
    rebalance_max_moves_per_cycle: int = 4
    rebalance_evictions_per_hour: float = 60.0
    rebalance_move_timeout_s: float = 120.0

    # ---- learned scoring policy (policy/) ----
    # Off by default: with the policy disabled, scoring consumes the
    # hand-tuned ScoreWeights constants bit-identically to a build
    # without the subsystem (same discipline as enable_netmodel).
    # When enabled the policy SHADOW-scores first — candidate weights
    # are never promoted into the live scorer without winning the
    # counterfactual-replay gate (policy/replay_eval.py) by at least
    # policy_promote_margin.
    enable_learned_score: bool = False

    # Bounded example ring the Adam step samples from (one example per
    # harvested scheduling decision), mini-batch size, steps per
    # train() call and PEAK learning rate (inverse-sqrt decay in total
    # steps, floored at lr/8 — same schedule as netmodel.fit).
    # ring >= batch so a batch never aliases.
    policy_ring: int = 4096
    policy_batch: int = 128
    policy_steps: int = 4
    policy_lr: float = 0.05

    # Minimum harvested examples before the first train step runs —
    # a near-empty ring would overfit a handful of decisions.
    policy_min_examples: int = 64

    # Maintain-cadence intervals: dataset-harvest + train tick, and
    # the (much rarer) counterfactual evaluation / promotion tick.
    policy_train_interval_s: float = 10.0
    policy_eval_interval_s: float = 120.0

    # Promotion margin: a candidate must beat the incumbent's
    # counterfactual replay outcome (realized-bandwidth-vs-oracle
    # ratio) by at least this much to be promoted.  Below the margin
    # the candidate keeps shadow-scoring and only the disagreement
    # rate is exported.
    policy_promote_margin: float = 0.02

    # Regret tolerance when labeling harvested decisions: an outcome
    # whose quality-observer regret is <= this is treated as "the
    # shipped choice was right"; above it the hindsight-best candidate
    # becomes the training target.
    policy_regret_margin: float = 0.05

    # ---- fleet-of-clusters serving (fleet/) ----
    # Smallest node-count padding bucket the FleetServer packs a
    # tenant into: tenant configs are rounded up to the next
    # power-of-two bucket >= this floor, so many small tenants share
    # ONE jit cache entry instead of each retracing at its exact
    # node count.  Must be a power of two.
    fleet_bucket_min: int = 64

    # ---- persistent multi-cycle serving + coalesced binds (r16) ----
    # Logical cycles per device dispatch: the serving loop encodes a
    # K-wave window once, stages the waves in a device ring, and runs
    # ONE donated scan over all of them — per-dispatch overhead
    # (Python dispatch, launch path, transport on a tunneled chip)
    # amortizes to 1/K of a cycle.  1 = today's per-cycle path,
    # bit-identical by construction.
    multicycle: int = 1
    # Device wave-ring capacity in waves (pre-encoded pod batches
    # staged device-side awaiting the scan).  A window larger than the
    # ring falls back to per-cycle dispatch for the overflow waves and
    # counts it — never drops pods.
    multicycle_queue_depth: int = 4
    # Bind coalescing: how many queued bind batches one worker drain
    # may merge into a single client fanout (1 = off — every batch
    # binds alone, the pre-r16 behavior, bit-identical).
    bind_coalesce_window: int = 1
    # Bound on concurrent bind workers draining the async bind queue
    # (1 = the single pre-r16 worker).  Inflight is capped, never
    # unbounded: the breaker + retry budget still gate every fanout.
    bind_max_inflight: int = 1

    # ---- elastic gang reshaping (r17) ----
    # Off by default: with reshaping disabled (or no gang declaring
    # alternative shapes) placement is bit-identical to the rigid
    # all-or-nothing path — same discipline as enable_rebalance.
    # When enabled, gangs carrying a ``netaware/pod-group-shapes``
    # annotation may commit a SMALLER declared realization when the
    # full shape is infeasible or strictly worse, and the rebalancer
    # may reshape a degraded gang (shrink / regrow / re-tile) through
    # the crash-safe reshape ledger under the same sliding-hour
    # eviction budget as ordinary moves.
    enable_gang_reshaping: bool = False
    # Minimum relative desirability gain (priority-weighted realized
    # intra-gang score under the frozen snapshot) a reshape must clear
    # before any member is evicted — the hysteresis bar that keeps a
    # healthy gang in its current shape.
    reshape_min_gain: float = 0.05
    # Bound on gangs reshaped per rebalancer tick; each member evicted
    # by a reshape is charged against rebalance_evictions_per_hour.
    reshape_max_per_cycle: int = 2

    def __post_init__(self) -> None:
        if self.max_nodes <= 0 or self.max_pods <= 0 or self.max_peers <= 0:
            raise ValueError("shape limits must be positive")
        if self.num_metrics < Metric.COUNT:
            raise ValueError(
                f"need at least {Metric.COUNT} metric channels for parity")
        if self.mask_words <= 0:
            raise ValueError("mask_words must be positive")
        if self.max_ns_terms <= 0 or self.max_ns_exprs <= 0:
            raise ValueError("nodeAffinity term/expr budgets must be "
                             "positive")
        if self.score_backend not in ("xla", "pallas"):
            raise ValueError(
                f"score_backend must be 'xla' or 'pallas', "
                f"got {self.score_backend!r}")
        if self.extender_batch_window_s < 0:
            raise ValueError("extender_batch_window_s must be >= 0")
        if self.gang_timeout_s <= 0:
            raise ValueError("gang_timeout_s must be > 0")
        if self.gang_weight < 0:
            raise ValueError("gang_weight must be >= 0")
        if self.breaker_failure_threshold < 1:
            raise ValueError("breaker_failure_threshold must be >= 1")
        if self.breaker_window_s <= 0 or self.breaker_cooldown_s <= 0:
            raise ValueError("breaker window/cooldown must be > 0")
        if self.api_retry_budget < 0:
            raise ValueError("api_retry_budget must be >= 0")
        if (self.api_backoff_base_s <= 0
                or self.api_backoff_max_s < self.api_backoff_base_s):
            raise ValueError("api backoff must satisfy "
                             "0 < base <= max")
        if self.netmodel_dim < 1 or self.netmodel_rank < 1:
            raise ValueError("netmodel dim/rank must be >= 1")
        if self.netmodel_batch < 1:
            raise ValueError("netmodel_batch must be >= 1")
        if self.netmodel_ring < self.netmodel_batch:
            raise ValueError("netmodel_ring must be >= netmodel_batch")
        if self.netmodel_steps < 0:
            raise ValueError("netmodel_steps must be >= 0")
        if self.netmodel_lr <= 0:
            raise ValueError("netmodel_lr must be > 0")
        if self.netmodel_conf_k <= 0 or self.netmodel_tau_s <= 0:
            raise ValueError("netmodel conf_k/tau_s must be > 0")
        if self.netmodel_resid_threshold <= 0:
            raise ValueError("netmodel_resid_threshold must be > 0")
        if not 0.0 <= self.netmodel_resid_conf <= 1.0:
            raise ValueError("netmodel_resid_conf must be in [0, 1]")
        if not 0.0 <= self.netmodel_explore_frac <= 1.0:
            raise ValueError("netmodel_explore_frac must be in [0, 1]")
        if self.probe_forget_s < 0:
            raise ValueError("probe_forget_s must be >= 0")
        if not 0.0 < self.delta_full_fraction <= 1.0:
            raise ValueError("delta_full_fraction must be in (0, 1]")
        if self.static_max_staleness_s <= 0:
            raise ValueError("static_max_staleness_s must be > 0")
        if self.static_max_versions_behind < 1:
            raise ValueError("static_max_versions_behind must be >= 1")
        if self.flight_recorder_size < 0:
            raise ValueError("flight_recorder_size must be >= 0")
        if self.flight_pod_records < 0:
            raise ValueError("flight_pod_records must be >= 0")
        if self.explain_top_k < 1:
            raise ValueError("explain_top_k must be >= 1")
        if self.explain_retain < 1:
            raise ValueError("explain_retain must be >= 1")
        if self.audit_interval_s < 0:
            raise ValueError("audit_interval_s must be >= 0")
        if self.audit_watchdog_failures < 1:
            raise ValueError("audit_watchdog_failures must be >= 1")
        if self.quarantine_streak_events < 1:
            raise ValueError("quarantine_streak_events must be >= 1")
        if self.quality_ring_size < 1:
            raise ValueError("quality_ring_size must be >= 1")
        if self.quality_harvest_interval_s <= 0:
            raise ValueError("quality_harvest_interval_s must be > 0")
        if self.slo_error_budget < 0:
            raise ValueError("slo_error_budget must be >= 0")
        if self.slo_fast_window_s <= 0 or self.slo_slow_window_s <= 0:
            raise ValueError("slo windows must be > 0")
        if self.slo_fast_window_s > self.slo_slow_window_s:
            raise ValueError("slo_fast_window_s must be <= "
                             "slo_slow_window_s")
        if self.slo_burn_threshold <= 0:
            raise ValueError("slo_burn_threshold must be > 0")
        if self.slo_eval_interval_s <= 0:
            raise ValueError("slo_eval_interval_s must be > 0")
        if self.rebalance_interval_s <= 0:
            raise ValueError("rebalance_interval_s must be > 0")
        if self.rebalance_min_gain < 0:
            raise ValueError("rebalance_min_gain must be >= 0")
        if self.rebalance_min_age_s < 0:
            raise ValueError("rebalance_min_age_s must be >= 0")
        if self.rebalance_cooldown_s < 0:
            raise ValueError("rebalance_cooldown_s must be >= 0")
        if self.rebalance_max_moves_per_cycle < 0:
            raise ValueError(
                "rebalance_max_moves_per_cycle must be >= 0")
        if self.rebalance_evictions_per_hour < 0:
            raise ValueError(
                "rebalance_evictions_per_hour must be >= 0")
        if self.rebalance_move_timeout_s <= 0:
            raise ValueError("rebalance_move_timeout_s must be > 0")
        if self.policy_batch < 1:
            raise ValueError("policy_batch must be >= 1")
        if self.policy_ring < self.policy_batch:
            raise ValueError("policy_ring must be >= policy_batch")
        if self.policy_steps < 0:
            raise ValueError("policy_steps must be >= 0")
        if self.policy_lr <= 0:
            raise ValueError("policy_lr must be > 0")
        if self.policy_min_examples < 1:
            raise ValueError("policy_min_examples must be >= 1")
        if self.policy_train_interval_s <= 0:
            raise ValueError("policy_train_interval_s must be > 0")
        if self.policy_eval_interval_s <= 0:
            raise ValueError("policy_eval_interval_s must be > 0")
        if self.policy_promote_margin < 0:
            raise ValueError("policy_promote_margin must be >= 0")
        if self.policy_regret_margin < 0:
            raise ValueError("policy_regret_margin must be >= 0")
        if (self.fleet_bucket_min < 1
                or self.fleet_bucket_min & (self.fleet_bucket_min - 1)):
            raise ValueError("fleet_bucket_min must be a power of two")
        if self.multicycle < 1:
            raise ValueError("multicycle must be >= 1")
        if self.multicycle_queue_depth < 1:
            raise ValueError("multicycle_queue_depth must be >= 1")
        if self.bind_coalesce_window < 1:
            raise ValueError("bind_coalesce_window must be >= 1")
        if self.bind_max_inflight < 1:
            raise ValueError("bind_max_inflight must be >= 1")
        if self.reshape_min_gain < 0:
            raise ValueError("reshape_min_gain must be >= 0")
        if self.reshape_max_per_cycle < 0:
            raise ValueError("reshape_max_per_cycle must be >= 0")

    def startup_warnings(
            self, policy_eval_trace: str | None = None) -> list[str]:
        """Config combinations that are VALID but silently weaker than
        they look — returned as explicit WARN lines for serve start
        (r15 satellite; the r14 behavior was a one-line banner aside
        that named no flag).  ``policy_eval_trace`` is the serve-level
        trace path (it lives on the loop, not the config).

        Unlike ``__post_init__`` these never raise: each is a legal
        configuration, just one an operator has regretted before."""
        warns: list[str] = []
        if self.enable_learned_score and not policy_eval_trace:
            warns.append(
                "enable_learned_score is on but no evaluation trace "
                "is configured: the policy trains and shadow-scores "
                "but can NEVER be promoted — the counterfactual-"
                "replay promotion gate needs a seeded scenario "
                "trace.  Pass --policy-eval-trace to enable "
                "promotion.")
        return warns


# ---------------------------------------------------------------------------
# (De)serialization — config files for the service / shim / benchmarks.
# ---------------------------------------------------------------------------


# Nested dataclass fields of SchedulerConfig, by field name.
_NESTED = {"weights": ScoreWeights, "mesh": MeshConfig}


def _from_mapping(cls: Any, data: Mapping[str, Any]) -> Any:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} config keys: {sorted(unknown)}; "
            f"valid keys: {sorted(known)}")
    kwargs: dict[str, Any] = {}
    for name, value in data.items():
        nested = _NESTED.get(name)
        if nested is not None and isinstance(value, Mapping):
            value = _from_mapping(nested, value)
        kwargs[name] = value
    return cls(**kwargs)


def config_from_dict(data: Mapping[str, Any]) -> SchedulerConfig:
    return _from_mapping(SchedulerConfig, data)


def config_to_dict(cfg: SchedulerConfig) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def load_config(path: str) -> SchedulerConfig:
    """Load a :class:`SchedulerConfig` from a JSON or YAML file."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    return config_from_dict(data or {})


def save_config(cfg: SchedulerConfig, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(config_to_dict(cfg), fh, indent=2)
        fh.write("\n")


__all__: Sequence[str] = (
    "Metric",
    "Resource",
    "GOODNESS",
    "ScoreWeights",
    "MeshConfig",
    "SchedulerConfig",
    "config_from_dict",
    "config_to_dict",
    "load_config",
    "save_config",
)
