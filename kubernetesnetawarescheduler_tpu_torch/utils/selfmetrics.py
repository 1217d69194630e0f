"""Self-metrics: Prometheus text exposition of the scheduler itself.

The PyTorch package's copy of the JAX package's ``utils/selfmetrics.py``.
The families of layers the port does not have yet (placement quality,
SLOs, the learned policy, rebalancing, the integrity auditor, state
chaos, the topology model, the fleet) are absent, exactly as the JAX
package renders them with those layers off.

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

    # Fused-step accounting (r9, core/loop._note_dispatch): recompile
    # and donation observables.  jit_cache_miss_total must FLATLINE
    # after warmup — steady-state growth is a recompile the bucketed
    # batch-size ladder should have prevented (regression-tested in
    # tests/test_winner_fusion.py).  The serving loop's dispatches
    # never donate (its snapshot is encoder-owned, patched in place by
    # delta ingest), so donation_skipped grows one per dispatch while
    # donated moves only on owned-state paths (bench chain, replay
    # folds) — a nonzero donated here would mean the loop donated
    # buffers it does not own.
    counter("netaware_jit_cache_miss_total",
            float(getattr(loop, "jit_cache_miss_total", 0)),
            "Executable-cache growth across the tracked jitted "
            "entry points (recompiles; zero after warmup)")
    counter("netaware_donated_dispatches_total",
            float(getattr(loop, "donated_total", 0)),
            "Device dispatches that donated the cluster-state "
            "buffers (fused_schedule_step on owned state)")
    counter("netaware_donation_skipped_total",
            float(getattr(loop, "donation_skipped_total", 0)),
            "Device dispatches that could NOT donate (the serving "
            "snapshot is encoder-owned and patched in place)")
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

    return "\n".join(lines) + "\n"

