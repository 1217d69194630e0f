"""The benchmark suite's legs that the port runs.

The PyTorch package's copy of the JAX package's ``bench/suite.py``: its
frame (:class:`SuiteResult`, :class:`UsageSampler`, :data:`BW_LAT`,
:data:`SMALL`, :func:`run_suite`, :func:`main`) and two of its legs,
each taking ``device`` (default ``"cuda"``):

- ``scenario`` — :func:`run_scenario_config`, the trace-driven campaign:
  a diurnal workload trace generated from a seed and streamed through
  the real ``SchedulerLoop`` with the chaos proxy, link bursts, node
  churn, state faults under the auditor, the rebalancer and the quality
  observer, then the outcome scorecard;
- ``policy`` — :func:`run_policy_config`, the learned policy's shadow
  cost and the promotion gate: a seeded loser refused by the records
  leg, a seeded winner promoted by the scenario replay leg.

Every other leg of the JAX suite is refused by name before any leg
runs, with the ROADMAP item that ports it; ``--config all`` is refused
the same way rather than running a subset.

    python -m kubernetesnetawarescheduler_tpu_torch.bench.suite \\
        --config scenario|policy [--small] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.bench.artifact import (
    write_artifact,
)
from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
    ClusterSpec,
    NodeClassSpec,
    WorkloadSpec,
    build_fake_cluster,
    feed_metrics,
    generate_workload,
)
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig,
    ScoreWeights,
)
from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    round_up as _round_up,
)

#: Where ``main`` writes its artifacts unless ``--out`` names another
#: directory (listed in .gitignore; the JAX suite's committed
#: ``bench_artifacts/`` is never written).
DEFAULT_OUT = "bench_out"


@dataclasses.dataclass
class SuiteResult:
    config: str
    metrics: dict
    artifacts: list[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class UsageSampler(threading.Thread):
    """Samples this process's cpu (cores) and RSS (bytes) on a fixed
    period — the stand-in for clusterloader2's system-container
    resource sampling."""

    def __init__(self, period_s: float = 0.05) -> None:
        super().__init__(daemon=True)
        self.period_s = period_s
        self.cpu: list[float] = []
        self.mem: list[float] = []
        self._stop_evt = threading.Event()
        self._clk = os.sysconf("SC_CLK_TCK")
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _read(self) -> tuple[float, float]:
        with open("/proc/self/stat", encoding="ascii") as fh:
            parts = fh.read().rsplit(") ", 1)[1].split()
        # Fields 14/15 (utime/stime) are indices 11/12 after comm.
        cpu_s = (int(parts[11]) + int(parts[12])) / self._clk
        with open("/proc/self/statm", encoding="ascii") as fh:
            rss = int(fh.read().split()[1]) * self._page
        return cpu_s, rss

    def run(self) -> None:
        last_cpu, _ = self._read()
        last_t = time.monotonic()
        while not self._stop_evt.wait(self.period_s):
            cpu_s, rss = self._read()
            now = time.monotonic()
            dt = max(now - last_t, 1e-9)
            self.cpu.append(max(cpu_s - last_cpu, 0.0) / dt)
            self.mem.append(float(rss))
            last_cpu, last_t = cpu_s, now

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=2.0)


BW_LAT = ScoreWeights(cpu=0.5, mem=0.5, net_tx=0.0, net_rx=0.0,
                      bandwidth=1.0, disk=0.0,
                      peer_bw=3.0, peer_lat=2.0, balance=0.5)


def scenario_spec(num_nodes: int = 256, duration_s: float = 2900.0,
                  base_rate: float = 360.0, seed: int = 0,
                  gang_fraction: float = 0.0005):
    """The campaign's :class:`ScenarioSpec` (the JAX leg's own shape):
    three node classes, diurnal arrivals, gangs of 8, link bursts, node
    churn, state faults and a chaos seed."""
    from kubernetesnetawarescheduler_tpu_torch.scenario.generate import (
        ScenarioSpec,
    )

    return ScenarioSpec(
        seed=seed,
        duration_s=duration_s,
        base_rate=base_rate,
        diurnal_amplitude=0.3,
        day_s=max(duration_s / 4.0, 60.0),
        gang_fraction=gang_fraction,
        gang_sizes=(8,),
        longrun_fraction=0.003,
        serving_lifetime_s=12.0,
        batch_lifetime_s=6.0,
        gang_lifetime_s=10.0,
        lifetime_floor_s=2.0,
        link_burst_rate_per_s=0.01,
        link_burst_duration_s=15.0,
        node_churn_rate_per_s=0.002,
        node_down_duration_s=20.0,
        state_fault_rate_per_s=0.002,
        chaos_seed=seed + 17,
        cluster=ClusterSpec(
            num_nodes=num_nodes, seed=seed,
            node_classes=(
                NodeClassSpec("std", 0.5),
                NodeClassSpec("highmem", 0.25,
                              mem_range=(64.0, 256.0)),
                NodeClassSpec("edge", 0.25, cpu_range=(8.0, 32.0),
                              lat_scale=2.0, bw_scale=0.5),
            )),
    )


def run_scenario_config(out_dir: str | None = None,
                        num_nodes: int = 256,
                        duration_s: float = 2900.0,
                        base_rate: float = 360.0,
                        batch: int = 256, seed: int = 0,
                        gang_fraction: float = 0.0005,
                        oracle_sample: int = 2048,
                        slo_budget_ms: float = 250.0,
                        keep_trace: bool = False,
                        device="cuda") -> SuiteResult:
    """Trace-driven scenario campaign: generate a diurnal workload trace
    and stream it through the real SchedulerLoop on ``device`` — chaos
    proxy, link-degradation bursts, node churn, state faults, budgeted
    rebalancing and the quality observer all live — then publish the
    outcome scorecard.

    The headline is streaming throughput (pods per wall second); the
    scorecard, ``half_moved_gangs`` and the peak RSS ride in ``detail``
    (default shape: ≈1.04 M pods on 256 nodes).  The trace is written
    to a temporary directory (gzip) and deleted after the replay unless
    ``keep_trace``; it is reproducible from (seed, spec)."""
    import tempfile

    from kubernetesnetawarescheduler_tpu_torch.scenario.generate import (
        generate_trace,
    )
    from kubernetesnetawarescheduler_tpu_torch.scenario.replay import (
        replay_trace,
    )
    from kubernetesnetawarescheduler_tpu_torch.scenario.scorecard import (
        build_scorecard,
        check_scorecard,
    )

    spec = scenario_spec(num_nodes=num_nodes, duration_s=duration_s,
                         base_rate=base_rate, seed=seed,
                         gang_fraction=gang_fraction)
    tmp = tempfile.mkdtemp(prefix="scenario_trace_")
    trace_path = os.path.join(tmp, "trace.jsonl.gz")
    t0 = time.perf_counter()
    gen_stats = generate_trace(spec, trace_path)
    gen_wall = time.perf_counter() - t0
    trace_bytes = os.path.getsize(trace_path)

    sampler = UsageSampler(period_s=0.5)
    sampler.start()
    t0 = time.perf_counter()
    try:
        res = replay_trace(
            trace_path, batch=batch, oracle_sample=oracle_sample,
            slo_budget_ms=slo_budget_ms, device=device)
    finally:
        sampler.stop()
        if not keep_trace:
            try:
                os.remove(trace_path)
                os.rmdir(tmp)
            except OSError:
                pass
    replay_wall = time.perf_counter() - t0

    card = build_scorecard(res, evictions_per_hour_budget=512.0)
    problems = check_scorecard(card)
    peak_rss = int(max([res.peak_rss_bytes] + sampler.mem)
                   if sampler.mem else res.peak_rss_bytes)
    pods_per_sec = res.pods_streamed / max(replay_wall, 1e-9)
    half_moved = int(card["rebalance"]["half_moved_gangs"])
    inv = res.invariants or {}

    doc = {
        "metric": "scenario_campaign",
        "value": round(float(pods_per_sec), 3),
        "unit": "pods_per_wall_second",
        "seed": seed,
        "detail": {
            "num_nodes": num_nodes,
            "batch": batch,
            "device": str(device),
            "duration_virtual_s": float(res.duration_virtual_s),
            "replay_wall_s": float(replay_wall),
            "gen_wall_s": float(gen_wall),
            "trace_bytes_gz": int(trace_bytes),
            "gen_stats": {k: int(v) for k, v in gen_stats.items()},
            "pods_streamed": int(res.pods_streamed),
            "pods_bound": int(res.pods_bound),
            "events_consumed": int(res.events_consumed),
            "queue_dropped": int(res.queue_dropped),
            "unschedulable_events": int(res.unschedulable),
            "scorecard": card,
            "scorecard_problems": problems,
            "half_moved_gangs": half_moved,
            "peak_rss_bytes": peak_rss,
            "rss_first_bytes": int(res.rss_samples[0]
                                   if res.rss_samples else 0),
            "rss_last_bytes": int(res.rss_samples[-1]
                                  if res.rss_samples else 0),
            "pods_double_bound": int(inv.get("pods_double_bound", 0)),
            "invariants": {k: int(v) for k, v in inv.items()},
            "cycle_p50_ms": float(res.cycle_ms.percentile(50.0)),
            "cycle_p99_ms": float(res.cycle_ms.percentile(99.0)),
            "spec": {
                "base_rate": float(base_rate),
                "gang_fraction": float(gang_fraction),
                "oracle_sample": int(oracle_sample),
                "slo_budget_ms": float(slo_budget_ms),
                "node_classes": [c.name for c in
                                 spec.cluster.node_classes],
            },
        },
    }
    artifacts: list[str] = []
    write_artifact(out_dir, "scenario.json", doc, artifacts)
    return SuiteResult("scenario", doc, artifacts)


def policy_trace_spec(num_nodes: int = 128, duration_s: float = 60.0,
                      base_rate: float = 40.0, seed: int = 0):
    """The policy leg's seeded trace: a cluster whose edge half carries
    degraded links, plus link-drift bursts during the replay."""
    from kubernetesnetawarescheduler_tpu_torch.scenario.generate import (
        ScenarioSpec,
    )

    return ScenarioSpec(
        seed=seed, duration_s=duration_s, base_rate=base_rate,
        diurnal_amplitude=0.3, day_s=max(duration_s / 2.0, 30.0),
        gang_fraction=0.0, longrun_fraction=0.003,
        serving_lifetime_s=12.0, batch_lifetime_s=6.0,
        gang_lifetime_s=10.0, lifetime_floor_s=2.0,
        link_burst_rate_per_s=0.02, link_burst_duration_s=10.0,
        node_churn_rate_per_s=0.0, node_down_duration_s=20.0,
        state_fault_rate_per_s=0.0, chaos_seed=seed + 17,
        cluster=ClusterSpec(
            num_nodes=num_nodes, seed=seed,
            node_classes=(
                NodeClassSpec("std", 0.5),
                NodeClassSpec("edge", 0.5, lat_scale=4.0,
                              bw_scale=0.25),
            )))


def run_policy_config(out_dir: str | None = None,
                      num_nodes: int = 128,
                      num_pods: int = 256, batch: int = 32,
                      seed: int = 0,
                      duration_s: float = 60.0,
                      base_rate: float = 40.0,
                      oracle_sample: int = 256,
                      device="cuda") -> SuiteResult:
    """Learned-scoring-policy leg on ``device``: what does shadow
    scoring cost, and does the counterfactual promotion gate gate?

    - **disabled bit-identity + shadow overhead** — the same workload
      drains twice from identical seeds, bare vs with the policy
      attached and shadow-scoring every wave (explain capture on in both
      legs): placements must be identical; the shadow block's cost is
      reported against the cycle p50.
    - **the gate refuses a seeded loser** — a network-blind candidate
      (peer terms zeroed) is refused by the records leg before any
      replay.
    - **the gate promotes a seeded winner, quantified vs oracle** — one
      seeded scenario trace replays twice through the real loop,
      net-blind incumbent vs net-aware candidate; the headline is the
      fraction of the incumbent→oracle bandwidth gap the candidate
      recovers.
    """
    import tempfile

    from kubernetesnetawarescheduler_tpu_torch.bench.envinfo import (
        bench_env,
    )
    from kubernetesnetawarescheduler_tpu_torch.obs.quality import (
        QualityObserver,
    )
    from kubernetesnetawarescheduler_tpu_torch.policy import (
        PolicyDataset,
        ScoringPolicy,
        evaluate_candidate,
    )
    from kubernetesnetawarescheduler_tpu_torch.scenario.generate import (
        generate_trace,
    )
    from kubernetesnetawarescheduler_tpu_torch.scenario.replay import (
        REPLAY_WEIGHTS,
    )

    def _cfg():
        return SchedulerConfig(
            max_nodes=_round_up(num_nodes, 128), max_pods=batch,
            max_peers=4, weights=BW_LAT,
            queue_capacity=max(300, num_pods),
            enable_explain=True)

    def _build(cfg):
        cluster, lat, bw = build_fake_cluster(
            ClusterSpec(num_nodes=num_nodes, seed=seed))
        loop = SchedulerLoop(cluster, cfg, method="parallel",
                             device=device)
        loop.encoder.set_network(lat, bw)
        feed_metrics(cluster, loop.encoder,
                     np.random.default_rng(seed + 1))
        return loop

    def _workload(cfg, n, wseed):
        return generate_workload(
            WorkloadSpec(num_pods=n, seed=wseed, services=8,
                         peer_fraction=0.5),
            scheduler_name=cfg.scheduler_name)

    def _drain_timed(loop, pods, shadow=False, shadow_ms=None):
        cycle_ms = []

        def _tick():
            t0 = time.perf_counter()
            loop.run_once()
            cycle_ms.append((time.perf_counter() - t0) * 1e3)
            if shadow:
                # The shadow serving posture, run every wave so the cost
                # sampling is dense: harvest outcomes, join + train,
                # shadow-rank every fresh explain.  Timed apart from the
                # cycle: it is maintain-cadence work.
                t1 = time.perf_counter()
                loop.quality.harvest(loop.encoder)
                loop._policy_train_tick()
                fresh = [
                    r for r in loop.flight.explains()
                    if float(r.get("t_wall", 0.0))
                    > loop._policy_shadow_twall]
                for rec in fresh:
                    loop.policy.shadow_rank(rec)
                if fresh:
                    loop._policy_shadow_twall = max(
                        float(r.get("t_wall", 0.0)) for r in fresh)
                shadow_ms.append((time.perf_counter() - t1) * 1e3)

        try:
            for start in range(0, len(pods), batch):
                loop.client.add_pods(pods[start:start + batch])
                _tick()
            while len(loop.queue) or loop._pipe_inflight is not None:
                _tick()
            loop.flush_binds()
        finally:
            loop.stop_bind_worker()
        return cycle_ms

    def _placements(loop):
        return sorted((b.namespace, b.pod_name, b.node_name)
                      for b in loop.client.bindings)

    # A throwaway drain of the same config pays the one-time costs
    # (allocator, first launches) outside leg A.
    wloop = _build(_cfg())
    try:
        for n_warm in (2 * batch, min(batch, 8)):
            wloop.client.add_pods(_workload(wloop.cfg, n_warm,
                                            seed + 888))
            wloop.run_until_drained()
    finally:
        wloop.stop_bind_worker()

    # Leg A: policy off (the enable_learned_score=False posture).
    cfg_a = _cfg()
    loop_a = _build(cfg_a)
    cycles_a = _drain_timed(loop_a, _workload(cfg_a, num_pods,
                                              seed + 5))
    bindings_a = _placements(loop_a)

    # Leg B: identical seeds, policy + dataset + observer attached
    # directly (the same cfg).
    cfg_b = _cfg()
    loop_b = _build(cfg_b)
    loop_b.quality = QualityObserver(cfg_b)
    policy = ScoringPolicy(cfg_b, seed=seed, device=device)
    loop_b.policy = policy
    loop_b.policy_dataset = PolicyDataset(cfg_b, policy.k_pad)
    shadow_ms: list[float] = []
    cycles_b = _drain_timed(loop_b, _workload(cfg_b, num_pods,
                                              seed + 5), shadow=True,
                            shadow_ms=shadow_ms)
    bindings_b = _placements(loop_b)
    bit_identical = bindings_a == bindings_b

    p50_a = float(np.percentile(cycles_a, 50)) if cycles_a else 0.0
    p50_b = float(np.percentile(cycles_b, 50)) if cycles_b else 0.0
    # The shadow/train work is maintain-cadence and runs outside the
    # cycle timer: the per-cycle overhead is the shadow block amortized
    # over the cycle; the raw A/B p50 ratio is reported beside it.
    shadow_p50 = float(np.median(shadow_ms)) if shadow_ms else 0.0
    overhead = (shadow_p50 / p50_a) if p50_a else 0.0
    ab_inflation = max(0.0, p50_b / p50_a - 1.0) if p50_a else 0.0
    explains = loop_b.flight.explains()

    spec = policy_trace_spec(num_nodes=num_nodes, duration_s=duration_s,
                             base_rate=base_rate, seed=seed)
    tmp = tempfile.mkdtemp(prefix="policy_trace_")
    trace_path = os.path.join(tmp, "trace.jsonl.gz")
    generate_trace(spec, trace_path)
    rkw = dict(batch=batch, oracle_sample=oracle_sample,
               rebalance=False, state_faults=False, device=device)

    try:
        # Gate proof 1: the seeded LOSER (peer terms zeroed); the
        # records leg must refuse it on the recorded evidence alone.
        incumbent = cfg_b.weights
        loser = dataclasses.replace(incumbent, peer_bw=0.0,
                                    peer_lat=0.0)
        reject_decision = evaluate_candidate(
            cfg_b, loser, incumbent, explains,
            trace_path=trace_path, k_pad=policy.k_pad,
            replay_kwargs=rkw)

        # Gate proof 2: the seeded WINNER.  Net-blind incumbent vs the
        # net-aware candidate on the same trace; the replay scorecard is
        # the authority, so the records leg is given no evidence.
        inc_blind = dataclasses.replace(REPLAY_WEIGHTS, peer_bw=0.0,
                                        peer_lat=0.0)
        t0 = time.perf_counter()
        promote_decision = evaluate_candidate(
            cfg_b, REPLAY_WEIGHTS, inc_blind, [],
            trace_path=trace_path, margin=0.005,
            k_pad=policy.k_pad, replay_kwargs=rkw)
        gate_replay_s = time.perf_counter() - t0
    finally:
        try:
            os.remove(trace_path)
            os.rmdir(tmp)
        except OSError:
            pass

    if promote_decision.promote:
        policy.note_promotion(promote_decision.to_dict(),
                              promote_decision.candidate_weights)
    inc_ratio = promote_decision.incumbent_ratio
    cand_ratio = promote_decision.candidate_ratio
    recovered = ((cand_ratio - inc_ratio)
                 / max(1.0 - inc_ratio, 1e-9)
                 if inc_ratio >= 0.0 and cand_ratio >= 0.0 else 0.0)

    doc = {
        "metric": "policy_gate",
        "value": round(float(recovered), 6),
        "unit": "fraction_of_oracle_bw_gain_recovered",
        "seed": seed,
        "detail": {
            "num_nodes": num_nodes,
            "num_pods": num_pods,
            "batch": batch,
            "device": str(device),
            "cycle_ms_p50_off": p50_a,
            "cycle_ms_p50_on": p50_b,
            "ab_p50_inflation": float(ab_inflation),
            "shadow_ms_p50": shadow_p50,
            "shadow_ms_p99": (float(np.percentile(shadow_ms, 99))
                              if shadow_ms else 0.0),
            "shadow_samples": len(shadow_ms),
            "explains_recorded": len(explains),
            "gate_replay_wall_s": float(gate_replay_s),
            "trace": {"duration_s": float(duration_s),
                      "base_rate": float(base_rate),
                      "oracle_sample": int(oracle_sample)},
            "policy": {
                "shadow_overhead_fraction": float(overhead),
                "shadow_overhead_under_2pct": bool(overhead < 0.02),
                "disabled_bit_identical": bool(bit_identical),
                "gate_rejects_loser":
                    bool(not reject_decision.promote),
                "rejection": reject_decision.to_dict(),
                "promoted": bool(promote_decision.promote),
                "promotion": promote_decision.to_dict(),
                "incumbent_bw_ratio_vs_oracle": float(inc_ratio),
                "candidate_bw_ratio_vs_oracle": float(cand_ratio),
                "oracle_gain_recovered_fraction": float(recovered),
                "shadow_disagreement_rate":
                    float(policy.disagreement_rate()),
                "summary": policy.summary(),
            },
            "bench_env": bench_env(),
        },
    }
    artifacts: list[str] = []
    write_artifact(out_dir, "policy.json", doc, artifacts)
    return SuiteResult("policy", doc, artifacts)


CONFIGS: dict[str, Callable[..., SuiteResult]] = {
    "scenario": run_scenario_config,
    "policy": run_policy_config,
}

#: The JAX suite's other legs, each with the ROADMAP Queue A item that
#: ports it.
UNPORTED: dict[str, int] = {
    **{name: 14 for name in (
        "density", "custom_network", "affinity", "soft_affinity",
        "spread", "zone_affinity", "binpack", "sidecar", "gang",
        "topology", "integrity", "quality", "rebalance", "reshape")},
    "fleet": 13,
}

#: Every leg name, in the JAX suite's order (``--config all``).
ALL = ("density", "custom_network", "affinity", "soft_affinity", "spread",
       "zone_affinity", "binpack", "sidecar", "gang", "topology",
       "integrity", "quality", "rebalance", "reshape", "scenario",
       "policy", "fleet")

# Reduced shapes for smoke runs / CPU CI (the JAX suite's).
SMALL = {
    "scenario": dict(num_nodes=64, duration_s=30.0, base_rate=30.0,
                     batch=32, gang_fraction=0.01,
                     oracle_sample=64),
    "policy": dict(num_nodes=64, num_pods=96, batch=32,
                   duration_s=20.0, base_rate=20.0,
                   oracle_sample=64),
}


def _check_names(names: Sequence[str]) -> None:
    """Refuse the first leg the port does not run, before any runs."""
    for name in names:
        if name in UNPORTED:
            raise NotImplementedError(
                f"suite leg {name!r} is not ported yet (ROADMAP Queue A "
                f"item {UNPORTED[name]}); the port runs "
                f"{', '.join(CONFIGS)}")
        if name not in CONFIGS:
            raise ValueError(f"unknown suite leg {name!r}")


def run_suite(configs: Sequence[str] | None = None,
              out_dir: str | None = None,
              small: bool = False, device="cuda") -> list[SuiteResult]:
    names = list(configs) if configs else list(ALL)
    _check_names(names)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results = []
    for name in names:
        kwargs = dict(SMALL[name]) if small else {}
        results.append(CONFIGS[name](out_dir=out_dir, device=device,
                                     **kwargs))
    return results


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="all",
                    help=f"one of {', '.join(ALL)} or 'all' (the port "
                         f"runs {', '.join(CONFIGS)}; the others are "
                         "refused with their ROADMAP item)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--small", action="store_true",
                    help="reduced shapes for smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device the legs run on (default cuda)")
    args = ap.parse_args(argv)
    names = list(ALL) if args.config == "all" else [args.config]
    for res in run_suite(names, out_dir=args.out, small=args.small,
                         device=args.device):
        print(json.dumps(res.to_dict()))


if __name__ == "__main__":
    main()
