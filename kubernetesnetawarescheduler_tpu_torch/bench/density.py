"""Seeded density workload and its replay measurement.

:func:`synthetic_density` builds the density bench's cluster and backlog
straight from numpy — the shapes of the JAX package's
``bench/fakecluster.py`` defaults (``ClusterSpec`` nodes, ``WorkloadSpec``
pods) without the k8s objects and the encoder in between.  It writes
bits directly into the mask layout instead of interning labels:

- taint "dedicated" is bit 0 of ``taint_bits`` word 0, tolerated by the
  same bit of ``tol_bits``;
- pod group ``svc-g`` is bit ``g`` of word 0 of the group planes
  (``group_bit``, ``affinity_bits``, ``anti_bits``), ``group_idx = g``;
- node labels carry no bits: the encoder interns only selector-referenced
  labels, and this workload selects none.

:func:`measure_replay` runs the replay on the card and times it.

:func:`measure_device_latency` times the serving seam's per-batch
decision (``assign_parallel`` + ``commit_assignments``, and the fused
step beside it) on a cluster built the way the serving loop builds it:
``bench/fakecluster.py`` nodes through the :class:`~..core.encode.Encoder`.

:func:`run_density` is the JAX package's clusterloader2-style density
run in its ``mode="host"``: a generated fake cluster, a backlog of
generated pods, and the live :class:`~..core.loop.SchedulerLoop` draining
it, reporting pods/s and the loop's per-batch phase percentiles.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
    ClusterSpec,
    WorkloadSpec,
    build_fake_cluster,
    feed_metrics,
    generate_workload,
    sample_metrics,
)
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.assign import (
    assign_parallel,
    fused_schedule_step,
)
from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
from kubernetesnetawarescheduler_tpu_torch.core.replay import (
    PodStream,
    fold_stream,
    pad_stream,
    replay_folded,
    stream_from_numpy,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    commit_assignments,
    resolve_device,
    round_up,
    state_from_numpy,
)
from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
    compute_assign_static,
)

# bench/fakecluster.py ClusterSpec defaults.
ZONES, RACKS_PER_ZONE = 2, 4
LAT_TIERS = (0.1, 0.5, 2.0)       # same rack / same zone / cross zone (ms)
BW_TIERS = (25e9, 10e9, 1e9)      # bits per second
JITTER = 0.15
CPU_RANGE, MEM_RANGE, NETBW_RANGE = (8.0, 64.0), (16.0, 256.0), (10.0, 40.0)
TAINT_FRACTION = 0.05
# bench/fakecluster.py WorkloadSpec defaults.
SERVICES, PEER_FRACTION, MAX_PEERS = 20, 0.6, 4
AFFINITY_FRACTION, ANTI_FRACTION, TOLERATE_FRACTION = 0.1, 0.1, 0.05
POD_CPU, POD_MEM, POD_NETBW = (0.1, 4.0), (0.2, 8.0), (0.05, 2.0)
GROUP_SPACE = 28  # services map onto svc-(s % 28); anti draws from 28


def _nodes(rng: np.random.Generator, n: int, cfg: SchedulerConfig) -> dict:
    """Node-side numpy planes: tiered lat/bw with symmetric jitter,
    capacities, taints, zones and fresh node_exporter-shaped metrics."""
    nmax, w = cfg.max_nodes, cfg.mask_words
    idx = np.arange(n)
    zones = idx % ZONES
    racks = (idx // ZONES) % RACKS_PER_ZONE
    same_zone = zones[:, None] == zones[None, :]
    same_rack = same_zone & (racks[:, None] == racks[None, :])
    tier = np.where(same_rack, 0, np.where(same_zone, 1, 2))
    noise = 1.0 + JITTER * rng.standard_normal((n, n), dtype=np.float32)
    noise = np.clip((noise + noise.T) / 2, 0.5, 1.5)
    lat = np.zeros((nmax, nmax), np.float32)
    bw = np.zeros((nmax, nmax), np.float32)
    lat[:n, :n] = np.asarray(LAT_TIERS, np.float32)[tier] * noise
    bw[:n, :n] = np.asarray(BW_TIERS, np.float32)[tier] / noise
    np.fill_diagonal(lat[:n, :n], 0.0)
    np.fill_diagonal(bw[:n, :n], bw[:n, :n].max())

    cap = np.zeros((nmax, cfg.num_resources), np.float32)
    for r, rng_r in enumerate((CPU_RANGE, MEM_RANGE, NETBW_RANGE)):
        cap[:n, r] = rng.uniform(*rng_r, n)
    taint = np.zeros((nmax, w), np.int32)
    taint[:n, 0] = rng.random(n) < TAINT_FRACTION
    metrics = np.zeros((nmax, cfg.num_metrics), np.float32)
    for m, (lo, hi) in enumerate(((6e8, 2.4e9), (5.0, 95.0), (1e4, 1e7),
                                  (1e4, 1e7), (1e8, 1e10))):
        metrics[:n, m] = rng.uniform(lo, hi, n)
    metrics[:n, 5] = rng.integers(0, 16, n)
    valid = np.zeros(nmax, bool)
    valid[:n] = True
    zone = np.full(nmax, -1, np.int32)
    zone[:n] = zones
    return dict(metrics=metrics, lat=lat, bw=bw, cap=cap, node_valid=valid,
                taint_bits=taint, node_zone=zone)


def _pods(rng: np.random.Generator, s: int, cfg: SchedulerConfig) -> dict:
    """Pod-side numpy stream: services, in-stream peers (earlier pods of
    the same service, kept only when they sit in an EARLIER batch, as the
    encoder's peer-slot rule does), host-scoped (anti-)affinity with the
    first-pod escape, tolerations, requests and priorities."""
    k, w, batch = cfg.max_peers, cfg.mask_words, cfg.max_pods
    service = rng.integers(0, SERVICES, s)
    peer_pods = np.full((s, k), -1, np.int32)
    traffic = np.zeros((s, k), np.float32)
    aff = np.zeros((s, w), np.int32)
    anti = np.zeros((s, w), np.int32)
    gbit = np.zeros((s, w), np.int32)
    group_idx = np.zeros(s, np.int32)
    tol = np.zeros((s, w), np.int32)
    req = np.zeros((s, cfg.num_resources), np.float32)
    prio = np.zeros(s, np.float32)
    members: list[list[int]] = [[] for _ in range(SERVICES)]
    for i in range(s):
        earlier = members[service[i]]
        if earlier and rng.random() < PEER_FRACTION:
            count = int(rng.integers(1, MAX_PEERS + 1))
            chosen = rng.choice(len(earlier), size=min(count, len(earlier)),
                                replace=False)
            slot = 0
            for c in chosen:
                j = earlier[int(c)]
                vol = rng.uniform(0.5, 20.0)
                if slot < k and j // batch < i // batch:
                    peer_pods[i, slot] = j
                    traffic[i, slot] = vol
                    slot += 1
        g = int(service[i]) % GROUP_SPACE
        gbit[i, 0] = np.int32(1 << g)
        group_idx[i] = g
        # Required self-affinity; the first member of a group gets the
        # kube-scheduler waiver (no live member anywhere yet).
        if rng.random() < AFFINITY_FRACTION and earlier:
            aff[i, 0] = np.int32(1 << g)
        if rng.random() < ANTI_FRACTION:
            anti[i, 0] = np.int32(1 << int(rng.integers(0, GROUP_SPACE)))
        req[i, :3] = (rng.uniform(*POD_CPU), rng.uniform(*POD_MEM),
                      rng.uniform(*POD_NETBW))
        tol[i, 0] = rng.random() < TOLERATE_FRACTION
        prio[i] = rng.uniform(0.0, 10.0)
        earlier.append(i)
    t, t2, e, ne = (cfg.max_soft_terms, cfg.max_ns_terms, cfg.max_ns_exprs,
                    cfg.max_ns_num)
    z = np.zeros
    return dict(
        req=req, peer_pods=peer_pods, peer_nodes=np.full((s, k), -1, np.int32),
        peer_traffic=traffic, tol_bits=tol, sel_bits=z((s, w), np.int32),
        affinity_bits=aff, anti_bits=anti, group_bit=gbit, priority=prio,
        pod_valid=np.ones(s, bool),
        soft_sel_bits=z((s, t, w), np.int32), soft_sel_w=z((s, t), np.float32),
        soft_grp_bits=z((s, t, w), np.int32), soft_grp_w=z((s, t), np.float32),
        soft_zone_bits=z((s, t, w), np.int32),
        soft_zone_w=z((s, t), np.float32),
        group_idx=group_idx, spread_maxskew=z(s, np.int32),
        spread_hard=z(s, bool), ns_anyof=z((s, t2, e, w), np.int32),
        ns_forbid=z((s, t2, w), np.int32), ns_term_used=z((s, t2), bool),
        ns_num_col=np.full((s, t2, ne), -1, np.int32),
        ns_num_lo=np.full((s, t2, ne), -np.inf, np.float32),
        ns_num_hi=np.full((s, t2, ne), np.inf, np.float32),
        zaff_bits=z((s, w), np.int32), zanti_bits=z((s, w), np.int32))


def synthetic_density(num_nodes: int, num_pods: int, cfg: SchedulerConfig,
                      seed: int = 0, device="cuda"
                      ) -> tuple[ClusterState, PodStream]:
    """The density cluster (``num_nodes`` real nodes, padded to
    ``cfg.max_nodes``) and a backlog of ``num_pods`` pods (padded with
    invalid pods to a multiple of ``cfg.max_pods``), generated from
    ``seed`` and placed on ``device``.  Deterministic for a seed."""
    if num_nodes > cfg.max_nodes:
        raise ValueError(f"{num_nodes} nodes > max_nodes={cfg.max_nodes}")
    if cfg.num_resources < 3:
        raise ValueError("the density workload requests 3 resources")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    state = state_from_numpy(cfg, _nodes(rng, num_nodes, cfg), dev)
    stream = stream_from_numpy(cfg, _pods(rng, num_pods, cfg), dev)
    return state, pad_stream(stream, cfg.max_pods)


def measure_replay(state: ClusterState, stream: PodStream,
                   cfg: SchedulerConfig, method: str = "parallel") -> dict:
    """Replay ``stream`` on the card and time it: per-batch milliseconds
    from CUDA events around each batch, and end-to-end pods/s on the
    host clock from before the static prep to a final synchronize.
    Raises on a CPU state — a device measurement never falls back."""
    if state.device.type != "cuda":
        raise RuntimeError("measure_replay times the card; the state is on "
                           f"{state.device}")
    folded = fold_stream(stream, cfg)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in folded]

    def hook(i: int, phase: str) -> None:
        events[i][0 if phase == "start" else 1].record()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assignment, final_state, rounds = replay_folded(
        state, folded, cfg, method, with_stats=True, batch_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch_ms = np.asarray([a.elapsed_time(b) for a, b in events])
    valid = int(stream.pod_valid.sum())
    return dict(
        assignment=assignment, final_state=final_state, rounds=rounds,
        batch_ms=batch_ms, wall_s=wall, pods=valid,
        pods_per_s=valid / wall,
        p50_ms=float(np.percentile(batch_ms, 50)),
        p99_ms=float(np.percentile(batch_ms, 99)))


def _percentile(samples, q: float) -> float:
    ordered = sorted(samples)
    if not ordered:
        return 0.0
    rank = min(len(ordered) - 1,
               max(0, int(round(q / 100.0 * (len(ordered) - 1)))))
    return float(ordered[rank])


def _percentile_ms(samples, q: float) -> float:
    return _percentile(samples, q) * 1e3


def card(dev: torch.device) -> dict:
    """The device a measurement ran on: the torch name and, on a card,
    ``nvidia-smi``'s name and power limit line."""
    if dev.type != "cuda":
        return {"device_name": str(dev), "nvidia_smi": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return {"device_name": torch.cuda.get_device_name(dev),
            "nvidia_smi": out.stdout.strip().splitlines()[0]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _throwaway_encoder(num_nodes: int, seed: int, cfg: SchedulerConfig,
                       device="cuda") -> Encoder:
    """An encoder holding a generated cluster, built as the serving loop
    builds it: ``build_fake_cluster`` → ``upsert_node`` for each node →
    ``set_network`` → ``feed_metrics``."""
    cluster, lat, bw = build_fake_cluster(
        ClusterSpec(num_nodes=num_nodes, seed=seed + 999))
    encoder = Encoder(cfg, device=device)
    for node in cluster.list_nodes():
        encoder.upsert_node(node)
    encoder.set_network(lat, bw)
    feed_metrics(cluster, encoder, np.random.default_rng(seed + 2))
    return encoder


def measure_device_latency(num_nodes: int, batch_size: int,
                           score_backend: str = "pallas",
                           reps: int = 50, seed: int = 7,
                           warmup_reps: int = 3,
                           scan_k: int = 32,
                           fusion_ab: bool = True,
                           device="cuda") -> dict:
    """Chain-amortized per-batch latency of the scheduling decision
    (``assign_parallel`` with the precomputed static prep, then
    ``commit_assignments``): ``scan_k`` chained steps, each committing
    into the state the next one scores, then one synchronize; the wall
    time divided by ``scan_k`` is one sample, percentiles over ``reps``
    samples.  The JAX package runs the chain as one ``lax.scan``
    dispatch; here each step launches its own operations and the
    conflict loop syncs once per round, so the host's launch and sync
    costs are part of every sample.

    The batch is ``WorkloadSpec(num_pods=batch_size, seed=seed + 5,
    services=8, peer_fraction=0.5, affinity_fraction=0.1,
    anti_fraction=0.1)`` encoded with no placed peers, on a cluster from
    :func:`_throwaway_encoder`.  Returns the JAX function's fields
    (``p99_source`` names this methodology, ``backend`` the device type)
    plus the device name and power limit."""
    dev = resolve_device(device)
    cfg = SchedulerConfig(max_nodes=round_up(num_nodes, 128),
                          max_pods=batch_size, max_peers=4,
                          score_backend=score_backend)
    encoder = _throwaway_encoder(num_nodes, seed, cfg, dev)
    pods = generate_workload(
        WorkloadSpec(num_pods=batch_size, seed=seed + 5, services=8,
                     peer_fraction=0.5, affinity_fraction=0.1,
                     anti_fraction=0.1),
        scheduler_name=cfg.scheduler_name)
    batch = encoder.encode_pods(pods, node_of=lambda n: "", lenient=True)
    state = encoder.snapshot()
    compute_assign_static(state, cfg)  # warm-up (the first kernel build)
    _sync(dev)
    t0 = time.perf_counter()
    static = compute_assign_static(state, cfg)
    _sync(dev)
    static_prep_ms = (time.perf_counter() - t0) * 1e3

    scan_k = max(1, int(scan_k))

    def chain():
        # The same batch re-scored every step against the evolving
        # state: each commit moves used/group_bits, which the next
        # step's scoring reads.
        s = state
        for _ in range(scan_k):
            a = assign_parallel(s, batch, cfg, static)
            s = commit_assignments(s, batch, a)
        _sync(dev)

    for _ in range(max(1, warmup_reps)):
        chain()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chain()
        times.append((time.perf_counter() - t0) / scan_k)
    winner_fusion = (_fusion_ab_leg(state, batch, static, cfg, scan_k)
                     if fusion_ab else None)
    out = {
        "p50_ms": round(_percentile_ms(times, 50), 3),
        "p99_ms": round(_percentile_ms(times, 99), 3),
        "max_ms": round(max(times) * 1e3, 3),
        "reps": len(times),
        "scan_k": scan_k,
        "static_prep_ms": round(static_prep_ms, 3),
        "num_nodes": num_nodes,
        "batch_size": batch_size,
        "score_backend": score_backend,
        "backend": dev.type,
        # K chained steps, one synchronize at the end, wall / K per
        # sample.
        "p99_source": "device_chain_amortized",
        **card(dev),
    }
    if winner_fusion is not None:
        out["winner_fusion"] = winner_fusion
    return out


def _fusion_ab_leg(state, batch, static, cfg, scan_k: int) -> dict:
    """Fused-vs-unfused A/B at the per-call seam: ``scan_k`` steps of
    :func:`~..core.assign.fused_schedule_step` against ``scan_k`` steps
    of ``assign_parallel`` then ``commit_assignments``, each step timed
    on its own up to a synchronize (after two warm-up steps).  torch has
    no buffer donation, so no step donates and none can fail to:
    ``donated`` and ``donation_failures`` are 0.  The rounds histogram
    comes from the fused leg's round counts."""
    dev = state.device
    warm = 2

    def unfused_leg():
        s = state
        samples = []
        for i in range(scan_k + warm):
            t0 = time.perf_counter()
            a, _ = assign_parallel(s, batch, cfg, static, with_stats=True)
            s = commit_assignments(s, batch, a)
            _sync(dev)
            if i >= warm:
                samples.append(time.perf_counter() - t0)
        return samples

    def fused_leg():
        s = state
        samples, rounds = [], []
        for i in range(scan_k + warm):
            t0 = time.perf_counter()
            s, _, r = fused_schedule_step(s, batch, cfg, static)
            _sync(dev)
            if i >= warm:
                samples.append(time.perf_counter() - t0)
                rounds.append(int(r))
        return samples, rounds

    fu_samples, fu_rounds = fused_leg()
    un_samples = unfused_leg()
    return {
        "enabled": bool(getattr(cfg, "enable_winner_fusion", False)),
        "donated": 0,
        "donation_failures": 0,
        "rounds": {
            "p50": _percentile(fu_rounds, 50),
            "p99": _percentile(fu_rounds, 99),
            "max": int(max(fu_rounds, default=0)),
        },
        "fused_step_p50_ms": round(_percentile_ms(fu_samples, 50), 3),
        "fused_step_p99_ms": round(_percentile_ms(fu_samples, 99), 3),
        "unfused_step_p50_ms": round(_percentile_ms(un_samples, 50), 3),
        "unfused_step_p99_ms": round(_percentile_ms(un_samples, 99), 3),
        "steps_per_leg": int(scan_k),
        "ab_source": "per_dispatch_chain",
    }


# ---------------------------------------------------------------------------
# The live serving loop under a density backlog (the JAX package's
# run_density, mode="host").
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DensityResult:
    """The JAX package's density record, field for field, plus the p50s
    of the encode and bind phases.  ``rounds_*`` come from the loop's
    conflict-round samples (one per real batch)."""

    num_nodes: int
    pods_submitted: int
    pods_bound: int
    pods_unschedulable: int
    wall_s: float
    pods_per_sec: float
    score_p50_ms: float
    score_p99_ms: float
    encode_p99_ms: float
    bind_p99_ms: float
    score_samples: int = 0
    rounds_p50: float = 0.0
    rounds_p99: float = 0.0
    rounds_max: int = 0
    bind_tail_ms: float = 0.0
    pipeline_budgets: dict = dataclasses.field(default_factory=dict)
    static_refresh_count: int = 0
    static_refresh_p99_ms: float = 0.0
    static_sync_builds: int = 0
    staleness_at_score_p50_ms: float = 0.0
    staleness_at_score_p99_ms: float = 0.0
    staleness_bound_s: float = 0.0
    delta_bytes: int = 0
    full_bytes: int = 0
    trace_provenance: dict = dataclasses.field(default_factory=dict)
    bind_queue_wait_p99_ms: float = 0.0
    bind_rtt_p99_ms: float = 0.0
    bind_retry_count: int = 0
    multicycle_k: int = 0
    multicycle_queue_depth: int = 0
    multicycle_windows: int = 0
    multicycle_overflow: int = 0
    retire_lag_p99: float = 0.0
    bind_max_inflight: int = 0
    bind_coalesce_window: int = 0
    bind_coalesced_total: int = 0
    bind_inflight_peak: int = 0
    encode_p50_ms: float = 0.0
    bind_p50_ms: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _static_stats(loop: SchedulerLoop) -> dict:
    """Static-refresh and delta-ingest counters the serving loop and
    its encoder accumulated over the run (all zero when static never
    moved).  ``_static_refresh_ms`` samples are already milliseconds;
    ``_staleness_samples`` are seconds."""
    enc = loop.encoder
    return {
        "static_refresh_count": int(loop.static_refresh_total),
        "static_refresh_p99_ms": round(_percentile(
            list(loop._static_refresh_ms), 99), 3),
        "static_sync_builds": int(loop.static_sync_builds),
        "staleness_at_score_p50_ms": round(_percentile_ms(
            list(loop._staleness_samples), 50), 3),
        "staleness_at_score_p99_ms": round(_percentile_ms(
            list(loop._staleness_samples), 99), 3),
        "delta_bytes": int(enc.snapshot_delta_bytes_total),
        "full_bytes": int(enc.snapshot_full_bytes_total),
    }


def _flight_stats(loop: SchedulerLoop,
                  trace_out: str | None = None) -> dict:
    """Flight-recorder provenance: ring accounting plus the worst
    retained cycle span, and — when ``trace_out`` is set — the whole
    recorder dumped as a Perfetto-loadable trace."""
    flight = loop.flight
    if flight is None:
        return {}
    if trace_out:
        with open(trace_out, "w", encoding="utf-8") as fh:
            json.dump(flight.to_chrome_trace(), fh, indent=1,
                      sort_keys=True)
    worst = flight.worst_cycle()
    worst_doc: dict = {}
    if worst is not None:
        worst_doc = {
            "cycle_id": int(worst.cycle_id),
            "dur_ms": round(worst.dur_s * 1e3, 3),
            "path": worst.path,
            "phases": [[name, round(rel * 1e3, 3), round(dur * 1e3, 3)]
                       for name, rel, dur in worst.phases],
        }
    return {
        "trace_provenance": {
            "spans": len(flight),
            "capacity": int(flight.capacity),
            "dropped": int(flight.dropped),
            "worst_cycle": worst_doc,
            "trace_out": trace_out or "",
        },
    }


def _churn_fn(encoder: Encoder, node_names: list, rng: np.random.Generator,
              churn_links: int):
    """A zero-arg closure that perturbs ``churn_links`` random links
    (probe results, ``update_link``) plus one node's metrics sample — the
    steady measurement drizzle a live cluster sees, which keeps
    ``static_version`` moving so the run exercises the delta-ingest and
    incremental-refresh machinery."""
    n = len(node_names)

    def tick() -> None:
        for _ in range(churn_links):
            i, j = rng.choice(n, size=2, replace=False)
            encoder.update_link(
                node_names[int(i)], node_names[int(j)],
                lat_ms=float(rng.uniform(0.05, 2.0)),
                bw_bps=float(rng.uniform(1e8, 1e10)))
        encoder.update_metrics(node_names[int(rng.integers(n))],
                               sample_metrics(rng))

    return tick


def _warm_churn_path(loop: SchedulerLoop, churn_tick,
                     ticks: int = 3) -> None:
    """Run the delta-ingest / incremental-refresh path a few times
    outside the timed window, then zero the refresh counters so the
    result's static-refresh block covers the measured steady state."""
    for _ in range(ticks):
        churn_tick()
        st, ver = loop.encoder.snapshot_versioned()
        loop._static_for(st, ver)
    # Drain any queued async rebuild; the measured run restarts the
    # worker on first use (_ensure_static_worker clears the stop flag).
    loop.stop_static_refresher()
    loop.static_refresh_total = 0
    loop.static_sync_builds = 0
    loop._static_refresh_ms.clear()
    loop._staleness_samples.clear()
    loop.encoder.snapshot_delta_bytes_total = 0
    loop.encoder.snapshot_full_bytes_total = 0


def _drain_with_churn(loop: SchedulerLoop, churn_tick,
                      max_cycles: int = 10_000) -> int:
    """``run_until_drained`` with one churn tick before every serving
    cycle, so each ``snapshot_versioned`` sees a moved static version
    and ``_static_for`` runs its refresh path inside the timed window."""
    total = 0
    for _ in range(max_cycles):
        churn_tick()
        n = loop.run_once(timeout=0.0)
        if n == 0 and len(loop.queue) == 0:
            loop.flush_binds()
            if len(loop.queue) == 0:
                break
        total += n
    return total


def _throwaway_loop(num_nodes: int, seed: int, cfg: SchedulerConfig,
                    method: str, multicycle: int | None = None,
                    device="cuda") -> SchedulerLoop:
    """A scheduler loop on a throwaway cluster with the measured run's
    shapes, to pay one-time costs (the kernels' build, the allocator's
    first blocks) outside the timed window."""
    wcluster, wlat, wbw = build_fake_cluster(
        ClusterSpec(num_nodes=num_nodes, seed=seed + 999))
    wloop = SchedulerLoop(wcluster, cfg, method=method,
                          multicycle=multicycle, device=device)
    wloop.encoder.set_network(wlat, wbw)
    feed_metrics(wcluster, wloop.encoder, np.random.default_rng(seed + 2))
    return wloop


def _multicycle_stats(loop: SchedulerLoop, cfg: SchedulerConfig) -> dict:
    """Multi-cycle and coalesced-bind accounting the drain accumulated.
    ``retire_lag_p99`` comes from the loop's LogHistogram."""
    lag = loop._retire_lag
    return {
        "multicycle_k": int(loop.multicycle),
        "multicycle_queue_depth": int(cfg.multicycle_queue_depth),
        "multicycle_windows": int(loop.multicycle_windows),
        "multicycle_overflow": int(loop.multicycle_overflow_total),
        "retire_lag_p99": float(lag.percentile(99)) if len(lag) else 0.0,
        "bind_max_inflight": int(cfg.bind_max_inflight),
        "bind_coalesce_window": int(cfg.bind_coalesce_window),
        "bind_coalesced_total": int(loop.bind_coalesced_total),
        "bind_inflight_peak": int(loop.bind_inflight_peak),
    }


def run_density(num_nodes: int = 100, num_pods: int = 300,
                batch_size: int = 64, method: str = "parallel",
                seed: int = 0, cfg: SchedulerConfig | None = None,
                warmup: bool = True,
                metric_drop_fraction: float = 0.0,
                mode: str = "host",
                chunk_batches: int = 2,
                score_backend: str = "xla",
                sampler=None, mesh=None,
                pipelined: bool = False,
                churn_links: int = 0,
                multicycle: int = 1,
                bind_coalesce_window: int = 1,
                bind_max_inflight: int = 1,
                trace_out: str | None = None,
                device="cuda",
                after_drain: Callable[[SchedulerLoop], None] | None = None
                ) -> DensityResult:
    """Schedule ``num_pods`` generated pods onto a ``num_nodes`` fake
    cluster through the live :class:`~..core.loop.SchedulerLoop`;
    returns throughput and per-batch latency stats, one-time costs
    excluded by a warm-up loop.

    ``mode="host"`` is the JAX package's host mode: one device step per
    batch when the queue is shallow, bursts of up to ``burst_batches``
    batches (default 8) under a deep backlog, the pipelined cycle with
    ``pipelined=True`` and the K-wave window with ``multicycle=K``.  The
    device and pipeline modes drive the chunked replay feeds, which are
    not ported yet (ROADMAP Queue A item 5): they raise
    :class:`NotImplementedError`.

    ``churn_links`` > 0 injects seeded link-probe + metrics churn before
    every serving cycle (and then turns ``enable_async_static`` on in
    the default cfg).  ``sampler``, if given, is started after warm-up.
    ``after_drain(loop)``, if given, is called with the measured loop
    after its drain (its binds flushed, its refresher stopped), before
    the result is built.  The loop builds on ``device``."""
    if mode != "host":
        raise NotImplementedError(
            f"run_density mode={mode!r} drives the chunked replay feeds "
            "(ROADMAP Queue A item 5), which are not ported yet; "
            "mode='host' runs the serving loop")
    if cfg is None:
        cfg = SchedulerConfig(
            max_nodes=round_up(num_nodes, 128),
            max_pods=batch_size,
            max_peers=4,
            queue_capacity=max(300, num_pods + batch_size,
                               multicycle * batch_size),
            score_backend=score_backend,
            enable_async_static=(churn_links > 0),
            multicycle=max(1, multicycle),
            # Ring depth follows K: the run measures the window, not
            # the overflow fallback (a caller-passed cfg keeps its own
            # depth).
            multicycle_queue_depth=max(4, multicycle),
            bind_coalesce_window=max(1, bind_coalesce_window),
            bind_max_inflight=max(1, bind_max_inflight),
        )
    # Effective K: an explicitly-passed cfg keeps its own knob; the
    # param only overrides when the caller actually asked for K>1.
    eff_multicycle = multicycle if multicycle > 1 else int(cfg.multicycle)
    # Coalesced async binds only exist on the bind-worker path: turn
    # the worker on when the knobs ask for coalescing/inflight > 1
    # (pipelined mode already implies it inside SchedulerLoop).
    auto_async_bind = (eff_multicycle > 1 and (
        int(cfg.bind_coalesce_window) > 1
        or int(cfg.bind_max_inflight) > 1))
    cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=num_nodes,
                                                      seed=seed))
    loop = SchedulerLoop(cluster, cfg, method=method, mesh=mesh,
                         pipelined=pipelined, async_bind=auto_async_bind,
                         multicycle=eff_multicycle, device=device)
    loop.encoder.set_network(lat, bw)
    rng = np.random.default_rng(seed + 1)
    feed_metrics(cluster, loop.encoder, rng,
                 drop_fraction=metric_drop_fraction)
    pods = generate_workload(WorkloadSpec(num_pods=num_pods, seed=seed),
                             scheduler_name=cfg.scheduler_name)

    if warmup:
        wloop = _throwaway_loop(num_nodes, seed, cfg, method,
                                multicycle=eff_multicycle, device=device)
        # The waves the JAX run warms its compiled programs with, kept
        # so both packages drive the same paths: a K-batch multicycle
        # window, a 2-batch burst, then a lone small batch for the
        # per-batch cycle.
        waves = []
        if (eff_multicycle > 1
                and cfg.queue_capacity >= eff_multicycle * cfg.max_pods):
            waves.append(eff_multicycle * cfg.max_pods)
        if (wloop.burst_batches > 1
                and cfg.queue_capacity >= 2 * cfg.max_pods):
            waves.append(2 * cfg.max_pods)
        waves.append(min(cfg.max_pods, 8))
        for i, n_warm in enumerate(waves):
            warm = generate_workload(
                WorkloadSpec(num_pods=n_warm, seed=seed + 99 + i),
                scheduler_name=cfg.scheduler_name)
            wloop.client.add_pods(warm)
            wloop.run_until_drained()
        wloop.stop_bind_worker()

    churn_tick = None
    if churn_links > 0:
        churn_tick = _churn_fn(
            loop.encoder, [n.name for n in cluster.list_nodes()],
            np.random.default_rng(seed + 13), churn_links)
        if warmup:
            _warm_churn_path(loop, churn_tick)
    if sampler is not None:
        sampler.start()
    dev = loop.encoder.device
    _sync(dev)
    start = time.perf_counter()
    cluster.add_pods(pods)
    if churn_tick is not None:
        _drain_with_churn(loop, churn_tick)
    else:
        loop.run_until_drained()
    loop.flush_binds()
    _sync(dev)
    wall = time.perf_counter() - start
    # Quiesce the background workers (off the timed window) so the
    # counters below are final.
    loop.stop_bind_worker()
    if after_drain is not None:
        after_drain(loop)

    rounds = list(loop.round_samples)
    bound = loop.scheduled
    return DensityResult(
        num_nodes=num_nodes,
        pods_submitted=len(pods),
        pods_bound=bound,
        pods_unschedulable=loop.unschedulable,
        wall_s=wall,
        pods_per_sec=bound / wall if wall > 0 else 0.0,
        score_p50_ms=loop.timer.percentile("score_assign", 50) * 1e3,
        score_p99_ms=loop.timer.percentile("score_assign", 99) * 1e3,
        encode_p99_ms=loop.timer.percentile("encode", 99) * 1e3,
        bind_p99_ms=loop.timer.percentile("bind", 99) * 1e3,
        encode_p50_ms=loop.timer.percentile("encode", 50) * 1e3,
        bind_p50_ms=loop.timer.percentile("bind", 50) * 1e3,
        score_samples=loop.timer.count("score_assign"),
        rounds_p50=_percentile(rounds, 50),
        rounds_p99=_percentile(rounds, 99),
        rounds_max=int(max(rounds, default=0)),
        pipeline_budgets=loop.timer.pipeline_budgets(),
        bind_rtt_p99_ms=loop.timer.percentile("bind", 99) * 1e3,
        bind_retry_count=int(loop.bind_failures),
        staleness_bound_s=float(cfg.static_max_staleness_s),
        **_static_stats(loop),
        **_flight_stats(loop, trace_out),
        **_multicycle_stats(loop, cfg),
    )
