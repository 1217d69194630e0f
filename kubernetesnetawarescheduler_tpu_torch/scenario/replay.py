"""Streaming scenario replay: drive a generated trace through the
REAL serving stack.

The PyTorch package's copy of the JAX package's ``scenario/replay.py``.
What differs: the loop, its encoder and the oracle's loop are built on
``device`` (default ``"cuda"``); the bindings and events are consumed
and truncated under the cluster's lock, which the bind workers append
under; the rebalance tick swallows host errors as the JAX harness does
but re-raises a fault of the device; and every loop the replay builds
has its bind worker stopped when the replay returns or raises.

The harness materializes nothing trace-shaped: events stream off disk
(scenario/generate.read_trace), arriving pods buffer only up to one
scheduling wave, committed bindings and API events are consumed
incrementally and truncated (the watermark-compaction the bounded-RSS
acceptance bar measures), and every distribution lands in a bounded
LogHistogram or capped deque.  Millions of pods therefore stream
through a :class:`~...core.loop.SchedulerLoop` — any of the four loop
paths — at CPU-bench shapes.

Virtual time is the trace's ``t`` field.  ``time_compression`` C > 0
paces the replay at C virtual seconds per wall second (sleeping the
difference); C = 0 (default) replays as fast as the loop can serve,
which is what the bench suite wants.  The chaos proxy's virtual clock
is advanced in lockstep, so control-plane fault windows open and
close at trace-relative times regardless of pacing.

With every chaos/drift knob off, replay degenerates to exactly
``add_pods`` + ``run_once`` over :func:`pod_waves` boundaries — the
placement-bit-identity property tests/test_scenario.py pins against a
direct drive of the same pods.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Iterable, Iterator

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
    build_fake_cluster,
    feed_metrics,
    sample_metrics,
)
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig,
    ScoreWeights,
)
from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    is_device_error,
    round_up,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.client import FakeCluster
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node, Pod
from kubernetesnetawarescheduler_tpu_torch.scenario.generate import (
    pod_from_event,
    read_trace,
    spec_from_json,
)
from kubernetesnetawarescheduler_tpu_torch.utils.timeseries import LogHistogram

#: The suite's bandwidth+latency scoring mix (bench/suite.BW_LAT is
#: not imported to keep scenario -> suite import-free; suite imports
#: scenario for its leg).
REPLAY_WEIGHTS = ScoreWeights(cpu=0.5, mem=0.5, net_tx=0.0, net_rx=0.0,
                              bandwidth=1.0, disk=0.0,
                              peer_bw=3.0, peer_lat=2.0, balance=0.5)


def pod_waves(events: Iterable[dict[str, Any]], batch: int,
              tick_s: float,
              scheduler_name: str = "netAwareScheduler"
              ) -> Iterator[tuple[float, list[Pod]]]:
    """Yield ``(t, pods)`` waves at replay's EXACT flush boundaries
    (wave full, or the event stream crossed a tick bucket), ignoring
    every non-pod event.  This is the public contract the knobs-off
    bit-identity property is stated against: a direct drive feeding
    these waves through a fresh loop must place every pod on the same
    node the full replay harness does."""
    pending: list[Pod] = []
    bucket: int | None = None
    t = 0.0
    for ev in events:
        t = float(ev.get("t", t))
        b = math.floor(t / tick_s)
        if pending and bucket is not None and b != bucket:
            yield t, pending
            pending = []
        bucket = b
        if ev.get("kind") != "pod":
            continue
        pending.append(pod_from_event(ev, scheduler_name))
        if len(pending) >= batch:
            yield t, pending
            pending = []
    if pending:
        yield t, pending


@dataclasses.dataclass
class ReplayResult:
    """Raw outcome material of one replay; scenario/scorecard.py
    compresses it into the published scorecard."""

    pods_streamed: int = 0
    pods_bound: int = 0
    events_consumed: int = 0
    cycles: int = 0
    unschedulable: int = 0
    gangs_seen: int = 0
    gangs_completed: int = 0
    gang_wait_s: list[float] = dataclasses.field(default_factory=list)
    deletes_applied: int = 0
    deletes_failed: int = 0
    link_bursts_applied: int = 0
    link_repairs_applied: int = 0
    node_downs: int = 0
    node_ups: int = 0
    zone_downs: int = 0
    zone_ups: int = 0
    node_upgrades: int = 0
    state_faults: dict[str, int] = dataclasses.field(
        default_factory=dict)
    cycle_ms: LogHistogram = dataclasses.field(
        default_factory=lambda: LogHistogram(
            lo=1e-2, hi=1e5, window=8192))
    slo_samples: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=200_000))
    slo_budget_ms: float = 250.0
    duration_virtual_s: float = 0.0
    duration_wall_s: float = 0.0
    rss_samples: list[int] = dataclasses.field(default_factory=list)
    peak_rss_bytes: int = 0
    active_pods_max: int = 0
    queue_depth_max: int = 0
    rebalance_summary: dict | None = None
    evictions_total: int = 0
    quality_summary: dict | None = None
    invariants: dict | None = None
    sampled_bw: dict | None = None
    placements: dict[str, str] | None = None
    breaker_trips: int = 0
    queue_dropped: int = 0
    integrity: dict | None = None


_PAGE = 4096


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm", encoding="ascii") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def _build_loop(header: dict[str, Any], batch: int, method: str,
                chaos: bool, queue_capacity: int,
                score_weights: ScoreWeights | None = None,
                reshape: bool = False, device="cuda"
                ) -> tuple[SchedulerLoop, SchedulerConfig, FakeCluster,
                           list[Node], np.ndarray, np.ndarray]:
    """The serving stack for a trace header: cluster (optionally
    chaos-proxied), loop, ground-truth matrices, and the node list
    (node_up re-adds need the objects).

    ``score_weights`` substitutes the scoring weight vector for the
    whole replay — the policy promotion gate's counterfactual seam.
    ``None`` keeps :data:`REPLAY_WEIGHTS` exactly (golden-digest
    parity is pinned on this default).  The loop and its encoder live
    on ``device``."""
    spec = spec_from_json(header["spec"])
    cspec = spec.cluster
    chaos_seed = spec.chaos_seed if chaos else None
    cluster, lat, bw = build_fake_cluster(
        cspec, chaos=chaos_seed)
    inner = cluster.inner if hasattr(cluster, "inner") else cluster
    nodes = list(inner.list_nodes())
    cfg = SchedulerConfig(
        max_nodes=round_up(cspec.num_nodes, 128),
        max_pods=batch,
        max_peers=max(4, spec.max_peers),
        weights=(REPLAY_WEIGHTS if score_weights is None
                 else score_weights),
        queue_capacity=queue_capacity,
        # Built into the loop's cfg from construction, as the JAX
        # harness does.
        enable_gang_reshaping=reshape,
    )
    loop = SchedulerLoop(cluster, cfg, method=method, device=device)
    loop.encoder.set_network(lat, bw)
    feed_metrics(inner, loop.encoder,
                 np.random.default_rng(spec.seed + 1))
    return loop, cfg, cluster, nodes, lat, bw


def replay_trace(path: str, *,
                 batch: int = 64,
                 method: str = "parallel",
                 chaos: bool = True,
                 drift: bool = True,
                 state_faults: bool = True,
                 rebalance: bool = True,
                 reshape: bool = False,
                 quality: bool = True,
                 time_compression: float = 0.0,
                 compact: bool = True,
                 collect_placements: bool = False,
                 oracle_sample: int = 2048,
                 maintain_every: int = 16,
                 slo_budget_ms: float = 250.0,
                 queue_capacity: int = 4096,
                 score_weights: ScoreWeights | None = None,
                 progress: Any = None,
                 device="cuda") -> ReplayResult:
    """Stream the trace at ``path`` through a real SchedulerLoop.

    Knobs mirror the subsystems they gate: ``chaos`` (control-plane
    proxy), ``drift`` (link bursts applied to the encoder's network),
    ``state_faults`` (state_chaos injection), ``rebalance`` (budgeted
    descheduler at maintain cadence), ``reshape`` (elastic gang
    reshaping — requires ``rebalance``; shape-aware placement plus
    degrade-and-recover reshapes through the reshape ledger),
    ``quality`` (outcome observer + harvest).  All off = the
    bit-identity degenerate mode.

    ``collect_placements`` retains the full pod->node map (small
    traces / property tests only — it defeats the bounded-memory
    contract for million-pod runs).

    ``score_weights`` replays the SAME trace under a different
    scoring weight vector (policy/ promotion gate); ``None`` is the
    incumbent :data:`REPLAY_WEIGHTS`, bit-identical to a replay that
    never heard of the override.

    The loop and the oracle's loop run on ``device``.
    """
    header, events = read_trace(path)
    spec = spec_from_json(header["spec"])
    res = ReplayResult(slo_budget_ms=slo_budget_ms)
    t_wall0 = time.perf_counter()

    loop, cfg, client, nodes, lat0, bw0 = _build_loop(
        header, batch, method, chaos, queue_capacity, score_weights,
        reshape=reshape and rebalance, device=device)
    try:
        inner = client.inner if hasattr(client, "inner") else client
        node_by_name = {nd.name: nd for nd in nodes}
        node_idx = {nd.name: i for i, nd in enumerate(nodes)}
        metrics_rng = np.random.default_rng(spec.seed + 2)

        if quality:
            from kubernetesnetawarescheduler_tpu_torch.obs.quality import (
                QualityObserver,
            )
            loop.quality = QualityObserver(cfg)
        rb = None
        if rebalance:
            from kubernetesnetawarescheduler_tpu_torch.core.rebalance import (
                Rebalancer,
            )
            rb_cfg = dataclasses.replace(
                cfg,
                enable_rebalance=True,
                rebalance_interval_s=1e-4,
                rebalance_max_moves_per_cycle=32,
                rebalance_evictions_per_hour=512.0,
                rebalance_move_timeout_s=300.0,
                enable_gang_reshaping=bool(reshape),
            )
            rb = Rebalancer(rb_cfg, loop.encoder, loop.client)
            loop.rebalance = rb
        injector = auditor = None
        if state_faults:
            from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
                IntegrityAuditor,
            )
            from kubernetesnetawarescheduler_tpu_torch.core import (
                state_chaos,
            )
            injector = state_chaos.StateChaosInjector(
                loop.encoder, seed=spec.seed + 3, loop=loop)
            # Injection without the r10 auditor is not an experiment, it
            # is sabotage: one nan_poison leaves NaN staging that fails
            # every placement FOREVER (measured: a 1M-pod campaign froze
            # at 65k binds at its first fault).  Pair them exactly like
            # serve.py/the r10 soak do, audited at maintain cadence — the
            # window between fault and repair is the realistic blind spot
            # the scorecard's unschedulable spikes then show.
            auditor = IntegrityAuditor(loop.encoder, loop)
            loop.integrity = auditor
            loop.state_chaos = injector

        # Link-drift state: per-node multiplicative degradation factor
        # (bursts can overlap; repair divides its own factor back out).
        deg = np.ones(len(nodes), np.float64)
        degraded_now: set[str] = set()

        def _apply_network() -> None:
            f = np.maximum.outer(deg, deg)
            lat_eff = lat0.astype(np.float64) * f
            bw_eff = bw0.astype(np.float64) / f
            np.fill_diagonal(lat_eff, 0.0)
            np.fill_diagonal(bw_eff, bw_eff.max())
            loop.encoder.set_network(lat_eff, bw_eff)
            return None

        # Gang tracking (bounded by concurrently-active gangs).
        gang_first_t: dict[str, float] = {}
        gang_need: dict[str, int] = {}
        gang_member: dict[str, str] = {}

        # Oracle sampling: one contiguous window starting mid-trace.
        sample_start_t = 0.45 * spec.duration_s
        sampled_pods: list[Pod] = []
        want_placement: dict[str, str] = {}

        placements: dict[str, str] | None = (
            {} if collect_placements else None)

        mark = 0
        ev_mark = 0
        vt = 0.0
        waves = 0
        audit_pending = [False]  # fault injected, repair not yet run

        def _scan_bindings() -> None:
            """Consume newly-committed bindings (watermark), attribute
            gang completions and sampled placements to the current
            virtual time, then truncate the consumed prefix so the list
            never grows with total pod count.  The bind workers append
            under the cluster's lock, so the reads and the truncation
            hold it too."""
            nonlocal mark, ev_mark
            with inner._lock:
                blist = loop.client.bindings
                new = blist[mark:]
                mark = len(blist)
                elist = loop.client.events
                ev_new = elist[ev_mark:]
                ev_mark = len(elist)
                if compact:
                    if mark > 8192:
                        del blist[:mark]
                        mark = 0
                    if ev_mark > 8192:
                        del elist[:ev_mark]
                        ev_mark = 0
            for b in new:
                res.pods_bound += 1
                if placements is not None:
                    placements[b.pod_name] = b.node_name
                if b.pod_name in want_placement:
                    want_placement[b.pod_name] = b.node_name
                grp = gang_member.pop(b.pod_name, None)
                if grp is not None:
                    left = gang_need[grp] - 1
                    if left <= 0:
                        res.gangs_completed += 1
                        res.gang_wait_s.append(
                            max(0.0, vt - gang_first_t.pop(grp)))
                        del gang_need[grp]
                    else:
                        gang_need[grp] = left
            for e in ev_new:
                if e.reason == "FailedScheduling":
                    res.unschedulable += 1

        def _cycle() -> None:
            loop.trace_offset = res.events_consumed
            t0 = time.perf_counter()
            loop.run_once(timeout=0.0)
            ms = (time.perf_counter() - t0) * 1e3
            res.cycles += 1
            res.cycle_ms.record(ms)
            res.slo_samples.append((vt, ms > slo_budget_ms))
            _scan_bindings()

        def _flush(wave: list[Pod]) -> None:
            nonlocal waves
            for p in wave:
                if p.pod_group and p.gang_min_member > 1:
                    if p.pod_group not in gang_first_t and \
                            p.pod_group not in gang_need:
                        gang_first_t[p.pod_group] = vt
                        gang_need[p.pod_group] = p.gang_min_member
                        res.gangs_seen += 1
                    gang_member[p.name] = p.pod_group
                if (vt >= sample_start_t and p.peers
                        and len(sampled_pods) < oracle_sample):
                    sampled_pods.append(p)
                    want_placement.setdefault(p.name, "")
                    for peer in p.peers:
                        want_placement.setdefault(peer, "")
            loop.client.add_pods(wave)
            _cycle()
            # Keep the backlog bounded: the queue is capacity-capped and
            # DROPS on overflow, so a burst bucket must drain before the
            # next wave lands.  Stall guard: pods the loop keeps
            # requeueing (gang-gated under churn, breaker-open brownouts)
            # must not spin this into a busy loop.
            stall = 0
            while len(loop.queue) > 2 * batch and stall < 8:
                before = (loop.scheduled, len(loop.queue))
                _cycle()
                stall = stall + 1 if (loop.scheduled,
                                      len(loop.queue)) == before else 0
            waves += 1
            res.queue_depth_max = max(res.queue_depth_max,
                                      len(loop.queue))
            # A state fault blinds scheduling until repaired; audit on
            # the NEXT wave (≈ the ~1s-interval thread serve.py runs)
            # rather than waiting out the maintain cadence — 16 blind
            # waves is a whole queue-capacity of arrivals.
            if audit_pending[0] and auditor is not None:
                audit_pending[0] = False
                auditor.audit_once()
            if waves % maintain_every == 0:
                _maintain()
            if waves % 32 == 0:
                rss = _rss_bytes()
                res.rss_samples.append(rss)
                res.peak_rss_bytes = max(res.peak_rss_bytes, rss)
                res.active_pods_max = max(res.active_pods_max,
                                          len(inner._pods))
            if progress is not None and waves % 256 == 0:
                progress(res)

        def _maintain() -> None:
            loop.maintain()
            if auditor is not None:
                audit_pending[0] = False
                auditor.audit_once()
            if loop.quality is not None:
                loop.quality.harvest(loop.encoder)
            if rb is not None:
                for name in degraded_now:
                    rb.note_link_event(name, "", "degraded", streak=1)
                rb._last_tick = 0.0
                # Same contract as SchedulerLoop._maintain: a chaos
                # transport fault mid-tick is retried next tick, never
                # fatal (moves are crash-safe via the migration ledger);
                # a fault of the device propagates.
                try:
                    rb.tick(loop)
                except Exception as exc:  # noqa: BLE001 — retried next tick
                    if is_device_error(exc):
                        raise
            _scan_bindings()

        pending: list[Pod] = []
        bucket: int | None = None
        phase_steady_t = 0.1 * spec.duration_s
        loop.scenario_phase = "warmup"

        for ev in events:
            res.events_consumed += 1
            t = float(ev.get("t", vt))
            if time_compression > 0 and t > vt:
                time.sleep((t - vt) / time_compression)
            if chaos and hasattr(client, "advance") and t > vt:
                client.advance(t - vt)
            vt = max(vt, t)
            if loop.scenario_phase == "warmup" and vt >= phase_steady_t:
                loop.scenario_phase = "steady"
            b = math.floor(t / spec.tick_s)
            kind = ev.get("kind")
            # Bucket boundary: flush (the pod_waves contract).
            if pending and bucket is not None and b != bucket:
                _flush(pending)
                pending = []
            bucket = b

            if kind == "pod":
                pending.append(pod_from_event(ev, cfg.scheduler_name))
                res.pods_streamed += 1
                if len(pending) >= batch:
                    _flush(pending)
                    pending = []
                continue
            # Non-pod events act on the cluster mid-stream: flush first
            # so their effects land between waves, not inside one.
            if pending:
                _flush(pending)
                pending = []
            if kind == "delete":
                try:
                    inner.delete_pod(ev["pod"])
                    res.deletes_applied += 1
                except KeyError:
                    res.deletes_failed += 1
            elif kind == "link_degrade":
                if drift:
                    for name in ev["nodes"]:
                        i = node_idx.get(name)
                        if i is not None:
                            deg[i] *= float(ev["factor"])
                            degraded_now.add(name)
                    _apply_network()
                    res.link_bursts_applied += 1
            elif kind == "link_repair":
                if drift:
                    for name in ev["nodes"]:
                        i = node_idx.get(name)
                        if i is not None:
                            deg[i] /= float(ev["factor"])
                            if abs(deg[i] - 1.0) < 1e-9:
                                deg[i] = 1.0
                                degraded_now.discard(name)
                    _apply_network()
                    res.link_repairs_applied += 1
            elif kind in ("node_down", "node_upgrade"):
                nd = node_by_name.get(ev["node"])
                if nd is not None and ev["node"] in {
                        x.name for x in inner.list_nodes()}:
                    inner.delete_node(ev["node"])
                    if kind == "node_upgrade":
                        res.node_upgrades += 1
                    else:
                        res.node_downs += 1
            elif kind in ("zone_down", "zone_up"):
                alive = {x.name for x in inner.list_nodes()}
                for name in ev.get("nodes", ()):
                    nd = node_by_name.get(name)
                    if nd is None:
                        continue
                    if kind == "zone_down" and name in alive:
                        inner.delete_node(name)
                    elif kind == "zone_up" and name not in alive:
                        inner.add_node(nd)
                        loop.encoder.update_metrics(
                            nd.name, sample_metrics(metrics_rng),
                            age_s=0.0)
                if kind == "zone_down":
                    res.zone_downs += 1
                else:
                    res.zone_ups += 1
            elif kind == "node_up":
                nd = node_by_name.get(ev["node"])
                if nd is not None and ev["node"] not in {
                        x.name for x in inner.list_nodes()}:
                    inner.add_node(nd)
                    loop.encoder.update_metrics(
                        nd.name, sample_metrics(metrics_rng), age_s=0.0)
                    res.node_ups += 1
            elif kind == "state_fault":
                fault = ev.get("fault", "")
                if injector is not None and fault != "checkpoint_corrupt":
                    injector.inject(fault)
                    res.state_faults[fault] = (
                        res.state_faults.get(fault, 0) + 1)
                    audit_pending[0] = True

        if pending:
            _flush(pending)
        loop.scenario_phase = "drain"
        # Let any open chaos window close before the final drain.
        if chaos and hasattr(client, "advance"):
            client.advance(60.0)
        # Never drain blind: a trailing fault would spin the drain's full
        # cycle budget with every pod unschedulable.
        if audit_pending[0] and auditor is not None:
            audit_pending[0] = False
            auditor.audit_once()
        loop.run_until_drained()
        loop.flush_binds()
        _maintain()
        _scan_bindings()
        rss = _rss_bytes()
        res.rss_samples.append(rss)
        res.peak_rss_bytes = max(res.peak_rss_bytes, rss)

        res.duration_virtual_s = vt
        res.unschedulable = max(res.unschedulable, loop.unschedulable)
        res.queue_dropped = int(getattr(loop.queue, "dropped", 0))
        if loop.breaker is not None:
            res.breaker_trips = getattr(loop.breaker, "trips", 0) or 0
        if rb is not None:
            res.rebalance_summary = dict(rb.summary())
            res.evictions_total = int(
                res.rebalance_summary.get("pods_evicted_total", 0))
        if loop.quality is not None:
            res.quality_summary = dict(loop.quality.summary())
        if auditor is not None:
            res.integrity = {
                "audits": int(auditor.audits_total),
                "drift_detected": int(auditor.drift_detected_total),
                "repairs": dict(auditor.repairs),
                "unrepaired": int(auditor.unrepaired_total),
            }
        if chaos and hasattr(client, "advance"):
            from kubernetesnetawarescheduler_tpu_torch.k8s.chaos import (
                check_invariants,
            )
            res.invariants = check_invariants(loop, inner)

        if sampled_pods:
            res.sampled_bw = _sampled_oracle_bw(
                header, sampled_pods, want_placement, deg, lat0, bw0,
                node_idx, inner, batch, method, queue_capacity,
                device)
        res.placements = placements
    finally:
        loop.stop_bind_worker()
    res.duration_wall_s = time.perf_counter() - t_wall0
    return res


def _sampled_oracle_bw(header: dict[str, Any], sampled: list[Pod],
                       want_placement: dict[str, str],
                       deg: np.ndarray, lat0: np.ndarray,
                       bw0: np.ndarray, node_idx: dict[str, int],
                       inner: FakeCluster, batch: int, method: str,
                       queue_capacity: int,
                       device="cuda") -> dict[str, Any]:
    """Realized traffic-weighted peer bandwidth of the replayed
    placements vs an oracle that schedules the SAME sampled pods
    fresh with full knowledge of the final (drifted) network —
    bounded: the sample is one mid-trace window, edges restricted to
    pairs inside it.  The oracle's loop is built on ``device``; its
    bind worker is stopped and its tensors are let go before this
    returns."""
    f = np.maximum.outer(deg, deg)
    bw_eff = bw0.astype(np.float64) / f
    loopback = float(bw_eff.max())
    alive = {nd.name for nd in inner.list_nodes()}

    # Oracle: fresh loop over the currently-alive fleet, truth = the
    # final effective matrices.
    loop, cfg, client, nodes, _lat, _bw = _build_loop(
        header, batch, method, chaos=False,
        queue_capacity=queue_capacity, device=device)
    try:
        o_inner = client.inner if hasattr(client, "inner") else client
        # Final truth, restricted to the oracle's own (full) fleet; down
        # nodes score as absent via delete.
        lat_eff = lat0.astype(np.float64) * f
        bwm = bw_eff.copy()
        np.fill_diagonal(lat_eff, 0.0)
        np.fill_diagonal(bwm, bwm.max())
        loop.encoder.set_network(lat_eff, bwm)
        for nd in nodes:
            if nd.name not in alive:
                o_inner.delete_node(nd.name)
        sample_names = {p.name for p in sampled}
        clean = [dataclasses.replace(
            p, node_name="", uid=p.uid + "-oracle",
            peers={q: w for q, w in p.peers.items()
                   if q in sample_names})
            for p in sampled]
        for start in range(0, len(clean), batch):
            loop.client.add_pods(clean[start:start + batch])
            loop.run_once(timeout=0.0)
        loop.run_until_drained()
        loop.flush_binds()
        oracle_place = {b.pod_name: b.node_name
                        for b in loop.client.bindings}
    finally:
        loop.stop_bind_worker()
    # The oracle's encoder holds a second copy of the device planes.
    del loop, client, o_inner

    def _bw(place: dict[str, str]) -> tuple[float, int]:
        total = 0.0
        edges = 0
        for p in sampled:
            ni = place.get(p.name)
            ii = node_idx.get(ni) if ni else None
            if ii is None:
                continue
            for q, w in p.peers.items():
                if q not in sample_names:
                    continue
                nj = place.get(q)
                jj = node_idx.get(nj) if nj else None
                if jj is None:
                    continue
                total += w * (loopback if ii == jj
                              else float(bw_eff[ii, jj]))
                edges += 1
        return total, edges

    real_bw, real_edges = _bw(want_placement)
    oracle_bw, oracle_edges = _bw(oracle_place)
    ratio = (real_bw / oracle_bw) if oracle_bw > 0 else 1.0
    return {
        "sampled_pods": len(sampled),
        "sampled_edges": real_edges,
        "oracle_edges": oracle_edges,
        "realized_bw": float(real_bw),
        "oracle_bw": float(oracle_bw),
        "realized_bw_ratio_vs_oracle": float(ratio),
    }
