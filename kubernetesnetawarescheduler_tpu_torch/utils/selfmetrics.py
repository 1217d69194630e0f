"""Self-metrics: Prometheus text exposition of the scheduler itself.

The PyTorch package's copy of the JAX package's ``utils/selfmetrics.py``.
The integrity auditor, state chaos, rebalancer, topology model,
placement quality, SLO and learned-policy families render when those
layers are attached, and a FleetServer's families through
:func:`render_fleet_metrics`, with the JAX names, labels, HELP and
TYPE.

The reference *consumes* Prometheus (node_exporter scrapes,
scheduler.go:275-279) but exposes nothing about itself — its only
introspection was ``println`` of scraped values (scheduler.go:517,
:525-526).  SURVEY.md §5's observability row requires self-metrics:
pods/sec, Score() latency percentiles, queue depth, metric staleness.
This module renders them in the same exposition format the ingest
parser consumes, so an operator points Prometheus at the scheduler the
same way the scheduler points at node_exporters (and our own parser
round-trips it — see tests/test_selfmetrics.py).
"""

from __future__ import annotations

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.utils.timeseries import (
    prom_histogram_lines,
)


_QUANTILES = (0.5, 0.9, 0.99)


class FamilyRegistry:
    """Duplicate-family guard for one exposition render: Prometheus
    silently keeps the FIRST HELP/TYPE it sees and some scrapers drop
    the whole body, so a name collision (two subsystems exporting the
    same family, or a summary vs histogram TYPE clash) must fail
    loudly at render time, not page someone with half-missing
    series."""

    def __init__(self) -> None:
        self._names: set[str] = set()

    def register(self, name: str) -> None:
        if name in self._names:
            raise ValueError(
                f"duplicate metric family {name!r} in /metrics render")
        self._names.add(name)


def _fmt(value: float) -> str:
    if value != value:  # NaN (empty percentile source)
        return "NaN"
    return repr(float(value))


def render_metrics(loop) -> str:
    """One exposition-format body for a
    :class:`~kubernetesnetawarescheduler_tpu_torch.core.loop.SchedulerLoop`."""
    enc = loop.encoder
    lines: list[str] = []
    _register = FamilyRegistry().register

    def counter(name: str, value: float, help_: str) -> None:
        _register(name)
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(value)}")

    def gauge(name: str, value: float, help_: str) -> None:
        _register(name)
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(value)}")

    def hist(name: str, help_: str, snaps) -> None:
        """Native-histogram family from (labels, snapshot) pairs —
        HELP/TYPE once, then every label set's buckets."""
        _register(name)
        first = True
        for labels, snap in snaps:
            lines.extend(prom_histogram_lines(
                name, help_, snap, labels=labels, header=first))
            first = False

    counter("netaware_pods_scheduled_total", loop.scheduled,
            "Pods successfully bound")
    counter("netaware_pods_unschedulable_total", loop.unschedulable,
            "Pods with no feasible node")
    counter("netaware_bind_failures_total", loop.bind_failures,
            "Bind attempts rejected or errored")
    counter("netaware_preemptions_total", loop.preemptions,
            "Pods evicted to make room for higher-priority pods")
    counter("netaware_burst_cycles_total",
            getattr(loop, "burst_cycles", 0),
            "Backlog bursts served (multi-batch single-dispatch "
            "cycles)")
    gauge("netaware_queue_depth", len(loop.queue),
          "Pending pods waiting in the scheduling queue")
    counter("netaware_queue_dropped_total",
            getattr(loop.queue, "dropped", 0),
            "Pods dropped on queue overflow (recovered by resync)")

    with enc._lock:
        valid = enc._node_valid.copy()
        ages = enc._metrics_age[valid]
        overflow = (enc.labels.overflow_drops + enc.taints.overflow_drops
                    + enc.groups.overflow_drops)
        ledger_size = len(enc._committed)
        early_releases = len(enc._early_releases)
    gauge("netaware_usage_ledger_entries", float(ledger_size),
          "Bound pods with committed usage (release/reconcile source)")
    gauge("netaware_early_release_markers", float(early_releases),
          "Terminations seen before their commit (in-flight races)")
    gauge("netaware_nodes_ready", float(valid.sum()),
          "Nodes currently schedulable")
    gauge("netaware_nodes_registered", float(enc.num_nodes),
          "Nodes known to the encoder")
    counter("netaware_intern_overflow_total", float(overflow),
            "Constraint keys dropped by lenient interning")
    counter("netaware_constraint_degraded_pods_total",
            float(getattr(enc, "degraded_total", 0)),
            "Pods that lost constraint keys to interner overflow "
            "(each also gets a ConstraintDegraded event)")
    counter("netaware_encode_shape_cache_hits_total",
            float(getattr(enc, "shape_cache_hits", 0)),
            "Pods encoded from the constraint-shape cache")
    counter("netaware_encode_shape_cache_misses_total",
            float(getattr(enc, "shape_cache_misses", 0)),
            "Constraint-shape computes (cache misses; the cache is "
            "bounded, so evictions recount shapes — a high and "
            "growing miss RATE means mostly-unique constraint sets)")

    # Control-plane brownout resilience (k8s/kubeclient.py,
    # the brownout work): breaker state, retry spend, watch-gap/relist audit
    # activity and the degraded-mode parking counters.
    breaker = getattr(loop, "breaker", None)
    if breaker is not None:
        gauge("netaware_apiserver_breaker_state",
              float(breaker.state_code),
              "Circuit breaker over API-server health "
              "(0=closed, 1=half_open, 2=open/degraded)")
        counter("netaware_apiserver_breaker_opens_total",
                float(breaker.opens_total),
                "Times the breaker tripped open (brownout onsets)")
        counter("netaware_apiserver_failures_total",
                float(breaker.failures_total),
                "Brownout-class API failures observed (5xx/429/"
                "connection errors)")
    budget = getattr(getattr(loop, "client", None), "retry_budget",
                     None)
    if budget is not None:
        counter("netaware_api_retries_total",
                float(budget.retries_total),
                "API request retries taken from the per-cycle budget")
        counter("netaware_api_retry_budget_exhausted_total",
                float(budget.exhausted_total),
                "Retries denied because the cycle's budget was spent")
    counter("netaware_watch_gaps_total",
            float(getattr(loop, "watch_gaps", 0)),
            "Watch-stream gaps detected (drops, 410 Gone)")
    counter("netaware_relists_total",
            float(getattr(loop, "relists", 0)),
            "Full relist reconciliation audits run after watch gaps")
    counter("netaware_relist_repairs_total",
            float(getattr(loop, "relist_repairs", 0)),
            "Drift items repaired by relist audits (missed nodes, "
            "re-enqueued pods, released ledger entries)")
    counter("netaware_parked_dropped_total",
            float(getattr(loop, "parked_dropped", 0)),
            "Parked pods evicted from the unschedulable backlog at "
            "capacity (each also gets a FailedScheduling event)")
    counter("netaware_binds_parked_total",
            float(getattr(loop, "binds_parked_total", 0)),
            "Pod binds parked by an open breaker (degraded mode)")
    counter("netaware_binds_adopted_total",
            float(getattr(loop, "binds_adopted", 0)),
            "Bound-elsewhere conflicts adopted into the ledger "
            "(our earlier bind applied but unacknowledged)")
    counter("netaware_binds_redirected_total",
            float(getattr(loop, "binds_redirected", 0)),
            "Binds re-routed to the ledger's recorded node (pod was "
            "already committed, e.g. restored from a checkpoint)")
    gauge("netaware_parked_binds_backlog",
          float(len(getattr(loop, "_parked_binds", ()))),
          "Bind batches currently parked awaiting breaker recovery")
    # Coalesced async binds + multi-cycle serving (r16): the bounded-
    # inflight proof and the coalescing win, scrapeable live (the
    # bench artifact's bind_split block is the offline counterpart).
    gauge("netaware_bind_inflight",
          float(getattr(loop, "bind_inflight", 0)),
          "Async bind batches inside their API fanout right now "
          "(bounded by cfg.bind_max_inflight)")
    counter("netaware_bind_coalesced_total",
            float(getattr(loop, "bind_coalesced_total", 0)),
            "Queued bind batches folded into an adjacent batch's "
            "fanout (sorted by node/namespace before POSTing)")

    # Learned topology model (netmodel/): direct-probe pair coverage,
    # prediction-residual quantiles, planner selection entropy and the
    # residual monitor's degradation count.
    netmodel = getattr(enc, "netmodel", None)
    if netmodel is not None:
        gauge("netaware_netmodel_pair_coverage_fraction",
              netmodel.coverage_fraction(enc.num_nodes),
              "Fraction of node pairs ever directly probed (the rest "
              "ride model estimates)")
        p50, p99 = netmodel.residual_quantiles()
        gauge("netaware_netmodel_residual_p50", p50,
              "Median |log-bandwidth residual| of fresh probes vs "
              "model prediction")
        gauge("netaware_netmodel_residual_p99", p99,
              "p99 |log-bandwidth residual| of fresh probes vs model "
              "prediction")
        counter("netaware_netmodel_sgd_steps_total",
                float(netmodel.steps_total),
                "Jitted mini-batch SGD steps dispatched")
        counter("netaware_netmodel_link_degradations_total",
                float(netmodel.degradations_total),
                "Fresh measurements diverging sharply from a confident "
                "prediction (each also gets a LinkDegraded event)")
    planner = getattr(loop, "probe_planner", None)
    if planner is not None:
        gauge("netaware_netmodel_probe_selection_entropy_bits",
              float(planner.last_entropy_bits),
              "Shannon entropy of the last probe cycle's EIG score "
              "distribution (collapse = planner fixation)")
    orch = getattr(loop, "probe_orchestrator", None)
    if orch is not None:
        stats = orch.staleness()
        gauge("netaware_probe_pair_coverage_fraction",
              float(stats["coverage_fraction"]),
              "Fraction of node pairs with a tracked recent probe")
        gauge("netaware_probe_mean_age_seconds",
              float(stats["mean_age_s"]),
              "Mean age of tracked pair probes")
        gauge("netaware_probe_max_age_seconds",
              float(stats["max_age_s"]),
              "Max age of tracked pair probes")
        counter("netaware_probe_pairs_pruned_total",
                float(getattr(orch, "pruned_total", 0)),
                "Per-pair probe bookkeeping entries pruned past the "
                "forget horizon")
        # Ingest quarantine: samples refused at the staging boundary,
        # per reason — growth here means a sick probe agent is
        # emitting garbage, not that links are bad.
        quarantined = getattr(orch, "quarantined", None)
        if quarantined:
            _register("netaware_ingest_quarantined_total")
            lines.append("# HELP netaware_ingest_quarantined_total "
                         "Probe samples refused at the staging "
                         "boundary (range validation)")
            lines.append("# TYPE netaware_ingest_quarantined_total "
                         "counter")
            for reason, n in sorted(quarantined.items()):
                lines.append(
                    "netaware_ingest_quarantined_total"
                    f'{{reason="{reason}"}} {_fmt(float(n))}')

    # Decision-level tracing (utils/flight.py): the cycle sequence and
    # drop counter make recorder overflow VISIBLE — if dropped grows
    # between scrapes, /debug/trace no longer covers the full window
    # and flight_recorder_size needs raising before the next incident.
    flight = getattr(loop, "flight", None)
    if flight is not None:
        gauge("netaware_cycle_seq", float(flight.cycle_seq),
              "Monotonic serving-cycle sequence number (flight "
              "recorder span ids)")
        counter("netaware_flight_dropped_total", float(flight.dropped),
                "Cycle spans evicted from the flight recorder's ring "
                "buffer (overflow)")
        gauge("netaware_flight_spans", float(len(flight)),
              "Cycle spans currently retained by the flight recorder")
        gauge("netaware_explain_records", float(flight.explains_len()),
              "Placement explain records currently retained "
              "(enable_explain)")

    # State integrity & self-healing (core/integrity.py): audit cadence
    # and the repair ladder's per-rung spend.  unrepaired_total > 0 is
    # a page — the ladder exhausted itself and placements may be
    # computed from corrupt state.
    auditor = getattr(loop, "integrity", None)
    if auditor is not None:
        counter("netaware_integrity_audits_total",
                float(auditor.audits_total),
                "Anti-entropy audit passes (digest compare of device "
                "planes vs shadow re-encode)")
        counter("netaware_integrity_drift_total",
                float(auditor.drift_detected_total),
                "Audits that detected device/staging digest drift")
        counter("netaware_integrity_drift_rows_total",
                float(auditor.drift_rows_total),
                "Total drifted rows localized across all audits")
        counter("netaware_integrity_unrepaired_total",
                float(auditor.unrepaired_total),
                "Audits whose drift survived the FULL repair ladder")
        counter("netaware_integrity_watchdog_dumps_total",
                float(auditor.watchdog_dumps),
                "Flight-recorder crash dumps fired by the stuck-audit "
                "watchdog")
        gauge("netaware_integrity_last_audit_ms",
              float(auditor.last_audit_ms),
              "Wall time of the most recent audit pass")
        _register("netaware_integrity_repairs_total")
        lines.append("# HELP netaware_integrity_repairs_total Repairs "
                     "applied, by escalation-ladder rung")
        lines.append("# TYPE netaware_integrity_repairs_total counter")
        for rung, n in sorted(auditor.repairs.items()):
            lines.append("netaware_integrity_repairs_total"
                         f'{{rung="{rung}"}} {_fmt(float(n))}')
    chaos = getattr(loop, "state_chaos", None)
    if chaos is not None:
        _register("netaware_state_faults_injected_total")
        lines.append("# HELP netaware_state_faults_injected_total "
                     "State-layer faults injected by the chaos "
                     "injector, by class")
        lines.append("# TYPE netaware_state_faults_injected_total "
                     "counter")
        for kind, n in sorted(chaos.injected.items()):
            lines.append("netaware_state_faults_injected_total"
                         f'{{fault="{kind}"}} {_fmt(float(n))}')

    # Extender webhook micro-batcher (api/extender._ScoreBatcher):
    # dispatch count exposes the coalescing rate (requests served /
    # dispatches = mean batch).
    batcher = getattr(loop, "_extender_batcher", None)
    if batcher is not None:
        counter("netaware_extender_dispatches_total",
                float(batcher.dispatches),
                "Score-kernel dispatches serving webhook requests")
        counter("netaware_extender_requests_total",
                float(batcher.requests),
                "Webhook score requests (filter+prioritize)")

    # Incremental device-resident state (core/loop._static_for +
    # core/encode delta ingest): refresh activity, sync-fallback count
    # (a growing share means the staleness contract keeps breaching —
    # tune static_max_staleness_s / static_max_versions_behind, see
    # OPERATIONS.md), delta-vs-full snapshot upload traffic, and the
    # staleness of the static each Score() actually served.
    counter("netaware_static_refresh_total",
            float(getattr(loop, "static_refresh_total", 0)),
            "Assign-static rebuilds (delta or full; async or sync)")
    counter("netaware_static_sync_builds_total",
            float(getattr(loop, "static_sync_builds", 0)),
            "Static rebuilds forced synchronous by the staleness "
            "contract (async mode's bounded fallback)")
    counter("netaware_snapshot_delta_bytes_total",
            float(getattr(enc, "snapshot_delta_bytes_total", 0)),
            "Host-to-device snapshot bytes moved as dirty-index "
            "scatter updates")
    counter("netaware_snapshot_full_bytes_total",
            float(getattr(enc, "snapshot_full_bytes_total", 0)),
            "Host-to-device snapshot bytes moved as full-array "
            "re-uploads")

    # Fused-step accounting (r9): recompile and donation observables.
    # jit_cache_miss_total must FLATLINE after warmup — steady-state
    # growth is a recompile the bucketed batch-size ladder should have
    # prevented (regression-tested in tests/test_winner_fusion.py).
    # torch has no buffer donation, so donated stays 0 on the port.
    counter("netaware_jit_cache_miss_total",
            float(getattr(loop, "jit_cache_miss_total", 0)),
            "Executable-cache growth across the tracked jitted "
            "entry points (recompiles; zero after warmup)")
    counter("netaware_donated_dispatches_total",
            float(getattr(loop, "donated_total", 0)),
            "Device dispatches that donated the cluster-state "
            "buffers (fused_schedule_step on owned state)")
    # The serving thread and the async refresh worker append to these
    # deques lock-free (appends are atomic; only iteration can see a
    # mutation and raise RuntimeError) — retry the snapshot instead of
    # intermittently 500ing the scrape.
    def _snap_deque(name: str) -> np.ndarray:
        dq = getattr(loop, name, ())
        for _ in range(3):
            try:
                return np.asarray(tuple(dq), dtype=float)
            except RuntimeError:
                continue
        return np.zeros((0,))

    refresh_ms = _snap_deque("_static_refresh_ms")
    stale_s = _snap_deque("_staleness_samples")
    if refresh_ms.size:
        _register("netaware_static_refresh_ms")
        lines.append("# HELP netaware_static_refresh_ms Wall time per "
                     "assign-static rebuild (delta or full)")
        lines.append("# TYPE netaware_static_refresh_ms summary")
        for q in _QUANTILES:
            lines.append(
                f'netaware_static_refresh_ms{{quantile="{q:g}"}} '
                f"{_fmt(float(np.quantile(refresh_ms, q)))}")
        lines.append(f"netaware_static_refresh_ms_sum "
                     f"{_fmt(float(refresh_ms.sum()))}")
        lines.append(
            f"netaware_static_refresh_ms_count {refresh_ms.size}")
    if stale_s.size:
        _register("netaware_static_staleness_s")
        lines.append("# HELP netaware_static_staleness_s Age of the "
                     "static each Score() call served (async refresh; "
                     "0 = current)")
        lines.append("# TYPE netaware_static_staleness_s summary")
        for q in _QUANTILES:
            lines.append(
                f'netaware_static_staleness_s{{quantile="{q:g}"}} '
                f"{_fmt(float(np.quantile(stale_s, q)))}")
        lines.append(f"netaware_static_staleness_s_sum "
                     f"{_fmt(float(stale_s.sum()))}")
        lines.append(
            f"netaware_static_staleness_s_count {stale_s.size}")

    # Conflict-round distribution over recent serving cycles (one
    # sample per batch, parallel assigner): whether score latency is
    # matmul-bound or round-bound — the bench's rounds_p50/p99, live.
    round_lock = getattr(loop, "_round_lock", None)
    if round_lock is not None:
        with round_lock:
            # Snapshot under the lock: the serving thread appends
            # while this scrape iterates, and a deque mutated during
            # iteration raises (intermittent 500s on /metrics).
            rounds = np.asarray(tuple(loop.round_samples), dtype=float)
    else:
        rounds = np.zeros((0,))
    if rounds.size:
        _register("netaware_conflict_rounds")
        lines.append("# HELP netaware_conflict_rounds Conflict-"
                     "resolution rounds per scheduled batch")
        lines.append("# TYPE netaware_conflict_rounds summary")
        for q in _QUANTILES:
            lines.append(
                f'netaware_conflict_rounds{{quantile="{q:g}"}} '
                f"{_fmt(float(np.quantile(rounds, q)))}")
        lines.append(
            f"netaware_conflict_rounds_sum {_fmt(float(rounds.sum()))}")
        lines.append(f"netaware_conflict_rounds_count {rounds.size}")

    # Metric staleness distribution over ready nodes — the quantity the
    # exp(-age/tau) decay consumes.
    _register("netaware_metric_staleness_seconds")
    lines.append("# HELP netaware_metric_staleness_seconds Age of each "
                 "ready node's last telemetry sample")
    lines.append("# TYPE netaware_metric_staleness_seconds summary")
    for q in _QUANTILES:
        v = float(np.quantile(ages, q)) if ages.size else float("nan")
        lines.append(
            f'netaware_metric_staleness_seconds{{quantile="{q:g}"}} '
            f"{_fmt(v)}")
    lines.append(f"netaware_metric_staleness_seconds_count {ages.size}")
    lines.append("netaware_metric_staleness_seconds_sum "
                 f"{_fmt(float(ages.sum()) if ages.size else 0.0)}")

    # Per-phase latency summaries (encode / score_assign / bind) — p99
    # Score() latency is a north-star metric (BASELINE.json).
    _register("netaware_phase_latency_seconds")
    lines.append("# HELP netaware_phase_latency_seconds Wall time per "
                 "scheduling phase")
    lines.append("# TYPE netaware_phase_latency_seconds summary")
    for phase, stats in sorted(loop.timer.summary().items()):
        for q in _QUANTILES:
            v = loop.timer.percentile(phase, q * 100)
            lines.append(
                f'netaware_phase_latency_seconds{{phase="{phase}",'
                f'quantile="{q:g}"}} {_fmt(v)}')
        lines.append(
            f'netaware_phase_latency_seconds_count{{phase="{phase}"}} '
            f"{stats['count']:g}")
        lines.append(
            f'netaware_phase_latency_seconds_sum{{phase="{phase}"}} '
            f"{_fmt(stats['total_s'])}")

    # Native-histogram ride-alongs (r11, utils/timeseries.py): the
    # summary families above keep their series names for existing
    # dashboards; these ``_hist`` families export the SAME
    # observations as cumulative le-buckets with exact never-evicting
    # counts, so "how many cycles ever crossed 5 ms" survives the
    # percentile window sliding and sums across replicas.
    hists = getattr(loop.timer, "hists", None)
    if hists:
        hist("netaware_phase_latency_seconds_hist",
             "Wall time per scheduling phase (log-bucketed native "
             "histogram; exact counts)",
             [(f'phase="{phase}"', h.snapshot())
              for phase, h in sorted(hists.items())])
    for attr, fam, help_ in (
            ("_static_refresh_ms", "netaware_static_refresh_ms_hist",
             "Wall time per assign-static rebuild, milliseconds "
             "(log-bucketed native histogram)"),
            ("_staleness_samples", "netaware_static_staleness_s_hist",
             "Age of the static each Score() call served, seconds "
             "(log-bucketed native histogram)"),
            ("round_samples", "netaware_conflict_rounds_hist",
             "Conflict-resolution rounds per scheduled batch "
             "(log-bucketed native histogram)"),
            ("_retire_lag", "netaware_multicycle_retire_lag",
             "Logical cycles between a multicycle wave's dispatch "
             "and its retire (log-bucketed native histogram)")):
        h = getattr(loop, attr, None)
        snap_fn = getattr(h, "snapshot", None)
        if snap_fn is not None:
            snap = snap_fn()
            if snap["count"]:
                hist(fam, help_, [("", snap)])

    # Pipeline stage budgets (pipelined serving datapath): the live
    # counterpart of the bench artifact's pipeline_budgets block —
    # encode / dispatch / device_wait / bind, so overlap health is
    # scrapeable, not just benchable.  Empty until a pipelined burst
    # has run.
    budgets = loop.timer.pipeline_budgets()
    if budgets:
        _register("netaware_pipeline_stage_ms")
        lines.append("# HELP netaware_pipeline_stage_ms Per-stage "
                     "serving-pipeline budget in milliseconds")
        lines.append("# TYPE netaware_pipeline_stage_ms gauge")
        for stage, b in sorted(budgets.items()):
            for stat in ("mean_ms", "p50_ms", "p99_ms"):
                lines.append(
                    f'netaware_pipeline_stage_ms{{stage="{stage}",'
                    f'stat="{stat[:-3]}"}} {_fmt(b[stat])}')

    # Outcome observability (obs/quality.py): did the placements
    # the scheduler committed turn out to be GOOD?  Regret is in the
    # same desirability units the score kernel optimized; calibration
    # residuals measure how honest the score-time network prediction
    # was against later probe truth.
    quality = getattr(loop, "quality", None)
    if quality is not None:
        qs = quality.summary()
        counter("netaware_quality_commits_noted_total",
                float(qs["noted_total"]),
                "Bound pods whose score-time prediction was captured "
                "for outcome joining")
        counter("netaware_quality_outcomes_total",
                float(qs["harvested_total"]),
                "Placement outcomes evaluated against observed probe "
                "state (regret + calibration)")
        counter("netaware_quality_no_peer_total",
                float(qs["no_peer_total"]),
                "Bound pods skipped by the quality observer (no "
                "resolvable peers at commit time)")
        counter("netaware_quality_calibration_samples_total",
                float(qs["calibration_samples"]),
                "Pod-peer samples contributing to netmodel "
                "calibration residuals")
        counter("netaware_quality_pending_dropped_total",
                float(qs["pending_dropped"]),
                "Pending observations evicted before harvest "
                "(capacity)")
        gauge("netaware_quality_ring_depth", float(qs["ring_depth"]),
              "Evaluated outcomes retained in the bounded ring")
        gauge("netaware_quality_pending_depth", float(qs["pending"]),
              "Commits awaiting their next harvest join")
        hist("netaware_quality_regret",
             "Per-pod placement regret vs the best feasible "
             "alternative, in net-desirability score units",
             [("", quality.regret_hist.snapshot())])
        hist("netaware_quality_bw_residual_log1p",
             "Per-pod |log1p(predicted bw) - log1p(observed bw)| "
             "calibration residual",
             [("", quality.bw_residual_hist.snapshot())])

    # SLO burn-rate engine (obs/slo.py): multi-window burn per
    # objective, plus a 0/1 burning flag alertmanager can gate on
    # without re-deriving the window math.
    slo = getattr(loop, "slo", None)
    if slo is not None:
        ss = slo.snapshot()
        counter("netaware_slo_evaluations_total",
                float(ss["evaluations_total"]),
                "SLO engine evaluation passes")
        counter("netaware_slo_burn_events_total",
                float(ss["burn_events_total"]),
                "Not-burning -> burning transitions (each also gets "
                "an SLOBurn event)")
        _register("netaware_slo_burn_rate")
        lines.append("# HELP netaware_slo_burn_rate Error-budget burn "
                     "rate per objective and window (1.0 = burning "
                     "exactly at budget)")
        lines.append("# TYPE netaware_slo_burn_rate gauge")
        for name, obj in sorted(ss["objectives"].items()):
            for window in ("fast", "slow"):
                lines.append(
                    f'netaware_slo_burn_rate{{objective="{name}",'
                    f'window="{window}"}} '
                    f"{_fmt(obj[f'burn_{window}'])}")
        _register("netaware_slo_burning")
        lines.append("# HELP netaware_slo_burning Whether the "
                     "objective is burning on BOTH windows (1 = page)")
        lines.append("# TYPE netaware_slo_burning gauge")
        for name, obj in sorted(ss["objectives"].items()):
            lines.append(
                f'netaware_slo_burning{{objective="{name}"}} '
                f"{1 if obj['burning'] else 0}")

    # Continuous rebalancing (core/rebalance.py): how often the
    # descheduler acted, what held it back (the skip breakdown is the
    # rebalance-storm runbook's first read), and the crash-safety
    # canary — half_moved_gangs must stay 0 forever.
    rb = getattr(loop, "rebalance", None)
    if rb is not None:
        rs = rb.summary()
        counter("netaware_rebalance_scans_total",
                float(rs["scans_total"]),
                "Descheduler improvement scans over the bound-pod "
                "ledger")
        counter("netaware_rebalance_moves_total",
                float(rs["moves_total"]),
                "Live migrations staged in the migration ledger")
        counter("netaware_rebalance_moves_completed_total",
                float(rs["moves_completed"]),
                "Migrations whose every member re-bound (ledger "
                "entry cleared)")
        counter("netaware_rebalance_moves_reverted_total",
                float(rs["moves_reverted"]),
                "Migrations reverted at their deadline (unbound "
                "members rolled back)")
        counter("netaware_rebalance_evictions_total",
                float(rs["pods_evicted_total"]),
                "Pods evicted by the rebalancer (the disruption the "
                "eviction budget bounds)")
        counter("netaware_rebalance_half_moved_gangs_total",
                float(rs["half_moved_gangs"]),
                "Gangs observed part-bound at a revert deadline — "
                "MUST stay 0 (the migration ledger's atomicity "
                "canary)")
        counter("netaware_rebalance_pins_skipped_total",
                float(rs["pins_skipped"]),
                "Single-pod moves whose target pin could not land "
                "(uid still committed when the pin was attempted) — "
                "the move degrades to a bare eviction")
        for key, help_txt in (
                ("skipped_gain", "below the relative-gain bar"),
                ("skipped_age", "younger than the placement-age "
                                "floor"),
                ("skipped_cooldown", "inside the per-pod move "
                                     "cooldown"),
                ("skipped_budget", "over the eviction budget"),
                ("skipped_disruption", "blocked by a PDB-style "
                                       "group floor")):
            counter(f"netaware_rebalance_{key}_total",
                    float(rs[key]),
                    f"Rebalance candidates skipped: {help_txt}")
        _register("netaware_rebalance_triggers_total")
        lines.append("# HELP netaware_rebalance_triggers_total "
                     "Executed moves by trigger source")
        lines.append("# TYPE netaware_rebalance_triggers_total "
                     "counter")
        for trig in ("link", "regret", "drain"):
            lines.append(
                f'netaware_rebalance_triggers_total{{trigger='
                f'"{trig}"}} {_fmt(float(rs["triggers_" + trig]))}')
        gauge("netaware_rebalance_moves_inflight",
              float(rs["moves_inflight"]),
              "Migrations currently staged in the ledger (crash-safe "
              "window)")
        gauge("netaware_rebalance_last_scan_candidates",
              float(rs["last_scan_candidates"]),
              "Improvement candidates surviving hysteresis at the "
              "last scan")
        # Elastic gang reshaping: one labeled counter family by
        # outcome, emitted only when the rebalancer's reshape block is
        # enabled.
        resh = rs.get("reshape")
        if isinstance(resh, dict) and resh.get("enabled"):
            _register("netaware_gang_reshape_total")
            lines.append("# HELP netaware_gang_reshape_total "
                         "Elastic gang reshapes by outcome "
                         "(committed = new realization bound; "
                         "reverted = settled back / degraded; "
                         "half_shaped MUST stay 0)")
            lines.append("# TYPE netaware_gang_reshape_total counter")
            for outcome, val in (
                    ("committed", resh["reshapes_completed"]),
                    ("reverted", resh["reshapes_reverted"]),
                    ("half_shaped", resh["half_shaped_gangs"])):
                lines.append(
                    f'netaware_gang_reshape_total{{outcome='
                    f'"{outcome}"}} {_fmt(float(val))}')
            gauge("netaware_gang_reshapes_inflight",
                  float(resh["reshapes_inflight"]),
                  "Reshapes currently staged in the reshape ledger "
                  "(crash-safe window)")

    # Learned scoring policy (policy/): training volume, shadow
    # disagreement (the promotion runbook's first read — a promotion
    # with near-zero disagreement changes nothing; one with high
    # disagreement is high-variance), and the gate's verdict history.
    policy = getattr(loop, "policy", None)
    if policy is not None:
        ps = policy.summary()
        counter("netaware_policy_train_steps_total",
                float(ps["steps_total"]),
                "Adam mini-batch steps dispatched over the example "
                "ring")
        counter("netaware_policy_examples_total",
                float(ps["examples_total"]),
                "Training examples harvested from the explain/"
                "outcome join")
        counter("netaware_policy_promotions_total",
                float(ps["promotions_total"]),
                "Candidate weight vectors promoted through the "
                "counterfactual replay gate")
        counter("netaware_policy_rejections_total",
                float(ps["rejections_total"]),
                "Gate runs that refused promotion (no trace, records "
                "regression, or below the replay margin)")
        counter("netaware_policy_shadow_disagreement_total",
                float(ps["shadow_disagreement_total"]),
                "Recorded decisions the shadow policy would have "
                "placed on a different node")
        counter("netaware_policy_shadow_agree_total",
                float(ps["shadow_agree_total"]),
                "Recorded decisions the shadow policy agrees with")
        gauge("netaware_policy_ring_depth",
              float(ps["ring_depth"]),
              "Training examples resident in the bounded ring")
        gauge("netaware_policy_version", float(ps["version"]),
              "Policy parameter version (increments per train tick)")
        gauge("netaware_policy_promoted_version",
              float(ps["promoted_version"]),
              "Parameter version live in the scorer (0 = hand-tuned "
              "weights, never promoted)")

    return "\n".join(lines) + "\n"


def render_fleet_metrics(fleet) -> str:
    """Exposition-format body for a
    :class:`~kubernetesnetawarescheduler_tpu_torch.fleet.server.FleetServer`
    — the consolidation-level view the per-tenant ``render_metrics``
    bodies cannot see: how many tenants share each padding bucket,
    batched-dispatch volume (lanes per dispatch is the consolidation
    ratio, live), per-tenant queue depth under a shared device
    program (the noisy-neighbor first read), and transfer-registry
    size."""
    s = fleet.summary()
    lines: list[str] = []
    _register = FamilyRegistry().register

    def counter(name: str, value: float, help_: str) -> None:
        _register(name)
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(value)}")

    counter("netaware_fleet_cycles_total", float(s["cycles_total"]),
            "Batched serving cycles across all buckets")
    counter("netaware_fleet_dispatches_total",
            float(s["dispatches_total"]),
            "Vmapped device dispatches (one per bucket cycle with "
            "work)")
    counter("netaware_fleet_dispatch_lanes_total",
            float(s["dispatch_lanes_total"]),
            "Tenant lanes carried by those dispatches (lanes/"
            "dispatch = live consolidation ratio)")
    counter("netaware_fleet_transfers_total",
            float(s["transfer"]["transfers_total"]),
            "Policies warm-started from the transfer registry")

    _register("netaware_fleet_tenants")
    lines.append("# HELP netaware_fleet_tenants Tenants packed into "
                 "each node-count padding bucket")
    lines.append("# TYPE netaware_fleet_tenants gauge")
    for nodes, blk in sorted(s["buckets"].items()):
        lines.append(f'netaware_fleet_tenants{{bucket_nodes='
                     f'"{nodes}"}} {_fmt(float(len(blk["tenants"])))}')

    _register("netaware_fleet_bucket_capacity")
    lines.append("# HELP netaware_fleet_bucket_capacity Padded lane "
                 "count of each bucket's batched dispatch")
    lines.append("# TYPE netaware_fleet_bucket_capacity gauge")
    for nodes, blk in sorted(s["buckets"].items()):
        lines.append(f'netaware_fleet_bucket_capacity{{bucket_nodes='
                     f'"{nodes}"}} {_fmt(float(blk["capacity"]))}')

    _register("netaware_fleet_tenant_queue_depth")
    lines.append("# HELP netaware_fleet_tenant_queue_depth Pending "
                 "pods per tenant (a deep queue behind a shared "
                 "dispatch is the noisy-neighbor signature)")
    lines.append("# TYPE netaware_fleet_tenant_queue_depth gauge")
    for name, blk in sorted(s["tenants"].items()):
        lines.append(f'netaware_fleet_tenant_queue_depth{{tenant='
                     f'"{name}"}} {_fmt(float(blk["queue_depth"]))}')

    _register("netaware_fleet_tenant_scheduled_total")
    lines.append("# HELP netaware_fleet_tenant_scheduled_total Pods "
                 "scheduled per tenant since onboarding")
    lines.append("# TYPE netaware_fleet_tenant_scheduled_total "
                 "counter")
    for name, blk in sorted(s["tenants"].items()):
        lines.append(
            f'netaware_fleet_tenant_scheduled_total{{tenant='
            f'"{name}"}} {_fmt(float(blk["scheduled"]))}')

    _register("netaware_fleet_registry_donors")
    lines.append("# HELP netaware_fleet_registry_donors Promoted "
                 "donor policies resident in the transfer registry")
    lines.append("# TYPE netaware_fleet_registry_donors gauge")
    lines.append(f"netaware_fleet_registry_donors "
                 f"{_fmt(float(len(s['transfer']['donors'])))}")

    return "\n".join(lines) + "\n"
