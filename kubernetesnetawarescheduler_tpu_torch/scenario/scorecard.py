"""Outcome scorecard for a scenario replay.

The PyTorch package's copy of the JAX package's ``scenario/scorecard.py``:
pure Python over the port's ``obs/slo.py``.

One compact, shape-checked dict answering "did the scheduler do a
good job under this scenario" — not "did it crash".  Reuses the
repo's existing outcome math instead of re-deriving it: SLO burn
windows come from :mod:`~kubernetesnetawarescheduler_tpu_torch.obs.slo`'s
pure functions over the replay's per-cycle breach samples, and
placement-quality regret is lifted straight from the attached
:class:`~kubernetesnetawarescheduler_tpu_torch.obs.quality.QualityObserver`
summary (the truth-join regret the quality leg publishes).

``check_scorecard`` is the shape lint; it is the same function as the
JAX package's, so a scorecard the port builds passes the repository's
``tools/scenario_check.py`` exactly when it passes here.
"""

from __future__ import annotations

import math
from typing import Any

from kubernetesnetawarescheduler_tpu_torch.obs.slo import (
    breach_fraction,
    burn_rate,
    is_burning,
)

# NOTE: scenario.replay (the ReplayResult producer) is deliberately
# NOT imported here — build_scorecard takes it duck-typed so this
# module stays free of the serving stack.


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    # Nearest-rank, matching LogHistogram.percentile's contract.
    idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
    return float(xs[idx])


def build_scorecard(res: "Any", *,
                    fast_window_s: float = 300.0,
                    slow_window_s: float = 3600.0,
                    error_budget: float = 0.01,
                    burn_threshold: float = 1.0,
                    evictions_per_hour_budget: float = 512.0
                    ) -> dict[str, Any]:
    """Compress a :class:`~.replay.ReplayResult` (duck-typed; see
    module note) into the published scorecard.

    SLO windows are VIRTUAL time (the trace's clock): a 10x-compressed
    replay burns budget at trace-relative rates, same as production
    would.  Budget adherence for the rebalancer is WALL time, because
    that is the clock its own token bucket enforces.
    """
    now = res.duration_virtual_s
    samples = list(res.slo_samples)
    frac, n_window = breach_fraction(samples, now, slow_window_s)
    fast = burn_rate(samples, now, fast_window_s, error_budget)
    slow = burn_rate(samples, now, slow_window_s, error_budget)

    rb = res.rebalance_summary or {}
    wall_h = max(res.duration_wall_s, 1e-9) / 3600.0
    evicted = int(rb.get("pods_evicted_total", res.evictions_total))
    evictions_per_wall_hour = evicted / wall_h
    qs = res.quality_summary or {}

    card: dict[str, Any] = {
        "pods": {
            "streamed": int(res.pods_streamed),
            "bound": int(res.pods_bound),
            "unschedulable": int(res.unschedulable),
            "deletes_applied": int(res.deletes_applied),
            "deletes_failed": int(res.deletes_failed),
            "queue_dropped": int(res.queue_dropped),
            "active_max": int(res.active_pods_max),
        },
        "bandwidth": dict(res.sampled_bw or {}),
        "gangs": {
            "seen": int(res.gangs_seen),
            "completed": int(res.gangs_completed),
            "wait_p50_s": _percentile(res.gang_wait_s, 50.0),
            "wait_p99_s": _percentile(res.gang_wait_s, 99.0),
        },
        "rebalance": {
            "summary": dict(rb),
            "half_moved_gangs": int(rb.get("half_moved_gangs", 0)),
            "pods_evicted_total": evicted,
            "evictions_per_wall_hour": float(evictions_per_wall_hour),
            "evictions_per_hour_budget": float(
                evictions_per_hour_budget),
            # 5% slack: the bucket refills continuously, so a run
            # ending just after a refill can sit a hair over rate.
            "within_budget": bool(
                evictions_per_wall_hour
                <= evictions_per_hour_budget * 1.05),
        },
        "repair_events": {
            "link_bursts": int(res.link_bursts_applied),
            "link_repairs": int(res.link_repairs_applied),
            "node_downs": int(res.node_downs),
            "node_ups": int(res.node_ups),
            "state_faults": dict(res.state_faults),
            # r10 auditor counters (audits/drift_detected/repairs/
            # unrepaired); {} when state-fault injection was off.
            "integrity": dict(getattr(res, "integrity", None) or {}),
            "breaker_trips": int(res.breaker_trips),
        },
        "slo": {
            "budget_ms": float(res.slo_budget_ms),
            "breach_fraction": float(frac),
            "window_samples": int(n_window),
            "fast_burn": float(fast) if math.isfinite(fast) else -1.0,
            "slow_burn": float(slow) if math.isfinite(slow) else -1.0,
            "burning": bool(is_burning(fast, slow, burn_threshold)),
            "fast_window_s": float(fast_window_s),
            "slow_window_s": float(slow_window_s),
            "error_budget": float(error_budget),
        },
        "quality": {
            "regret_p50": float(qs.get("regret_p50", 0.0)),
            "regret_p99": float(qs.get("regret_p99", 0.0)),
            "calibration_samples": int(
                qs.get("calibration_samples", 0)),
        },
        "cycles": {
            "count": int(res.cycles),
            "p50_ms": float(res.cycle_ms.percentile(50.0)),
            "p99_ms": float(res.cycle_ms.percentile(99.0)),
        },
        "memory": {
            "peak_rss_bytes": int(res.peak_rss_bytes),
            "rss_first_bytes": int(
                res.rss_samples[0] if res.rss_samples else 0),
            "rss_last_bytes": int(
                res.rss_samples[-1] if res.rss_samples else 0),
            "samples": int(len(res.rss_samples)),
        },
        "durations": {
            "virtual_s": float(res.duration_virtual_s),
            "wall_s": float(res.duration_wall_s),
        },
    }
    if res.invariants is not None:
        card["invariants"] = {k: int(v)
                              for k, v in res.invariants.items()}
    return card


#: section -> fields that must be present and numeric (bool counts as
#: numeric for the flags; json round-trip keeps these types).
_REQUIRED: dict[str, tuple[str, ...]] = {
    "pods": ("streamed", "bound", "unschedulable"),
    "gangs": ("seen", "completed", "wait_p50_s", "wait_p99_s"),
    "rebalance": ("half_moved_gangs", "pods_evicted_total",
                  "within_budget"),
    "repair_events": ("link_bursts", "link_repairs", "node_downs",
                      "node_ups"),
    "slo": ("budget_ms", "breach_fraction", "fast_burn", "slow_burn",
            "burning"),
    "cycles": ("count", "p50_ms", "p99_ms"),
    "memory": ("peak_rss_bytes",),
    "durations": ("virtual_s", "wall_s"),
}


def check_scorecard(card: Any) -> list[str]:
    """Shape-lint a scorecard dict; returns problems (empty = clean).

    Checks structure and internal consistency, NOT outcome quality —
    a scorecard reporting a terrible run still lints clean; bars live
    in the bench suite."""
    problems: list[str] = []
    if not isinstance(card, dict):
        return ["scorecard: not a dict"]
    for section, fields in _REQUIRED.items():
        sec = card.get(section)
        if not isinstance(sec, dict):
            problems.append(f"scorecard.{section}: missing or not a "
                            "dict")
            continue
        for fld in fields:
            v = sec.get(fld)
            if isinstance(v, bool):
                continue
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                problems.append(
                    f"scorecard.{section}.{fld}: missing or "
                    f"non-finite ({v!r})")
    if problems:
        return problems
    if not isinstance(card.get("bandwidth"), dict):
        problems.append("scorecard.bandwidth: missing or not a dict")
    pods = card["pods"]
    if pods["bound"] > pods["streamed"]:
        problems.append("scorecard.pods: bound exceeds streamed")
    gangs = card["gangs"]
    if gangs["completed"] > gangs["seen"]:
        problems.append("scorecard.gangs: completed exceeds seen")
    if gangs["wait_p99_s"] + 1e-9 < gangs["wait_p50_s"]:
        problems.append("scorecard.gangs: p99 below p50")
    frac = card["slo"]["breach_fraction"]
    if not 0.0 <= frac <= 1.0:
        problems.append("scorecard.slo.breach_fraction out of [0,1]")
    bw = card["bandwidth"]
    ratio = bw.get("realized_bw_ratio_vs_oracle")
    if ratio is not None and (not isinstance(ratio, (int, float))
                              or not math.isfinite(ratio)
                              or ratio < 0.0):
        problems.append(
            "scorecard.bandwidth.realized_bw_ratio_vs_oracle "
            f"invalid ({ratio!r})")
    cyc = card["cycles"]
    if cyc["p99_ms"] + 1e-9 < cyc["p50_ms"]:
        problems.append("scorecard.cycles: p99 below p50")
    return problems
