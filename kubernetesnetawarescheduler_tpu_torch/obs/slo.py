"""SLO burn-rate engine: declarative objectives over serving telemetry.

The PyTorch package's copy of the JAX package's ``obs/slo.py``: pure
Python, its burn events through the port's client and event types.

The north-star targets (BASELINE.json: score p99 < 5 ms; the bind
tail; r10's unrepaired-drift==0; r11's quality-regret ceiling) were
only ever checked by one-shot bench runs.  This engine makes them
standing objectives evaluated continuously in-process, using the
multi-window burn-rate methodology (Google SRE workbook): an
objective *burns* when BOTH a fast window (minutes — catches cliffs)
and a slow window (an hour — rejects blips) spend error budget faster
than the threshold.  On a not-burning -> burning transition the
engine emits one ``SLOBurn`` k8s Event; while burning, ``/readyz``
reports degraded (ready stays true — same alert-don't-evict
semantics as breaker degradation) and every flight span is tagged
with the burning objective (``CycleSpan.slo_burning``).

The burn-rate math (:func:`breach_fraction`, :func:`burn_rate`,
:func:`is_burning`) is pure and importable — tools/slo_report.py
reuses it offline over trace exports so the live engine and the
report can never disagree, and tests pin window edges without a loop.

Observation-only: the engine reads PhaseTimer percentiles, the
quality observer's regret distribution and the integrity auditor's
counters; it never feeds back into scoring.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterable

__all__ = [
    "Objective",
    "SLOEngine",
    "breach_fraction",
    "burn_rate",
    "is_burning",
]

#: Per-objective breach-sample retention: at the default 5 s eval
#: cadence this covers > 5 hours — comfortably past the slow window.
MAX_SAMPLES = 4096


@dataclass(frozen=True)
class Objective:
    """One declarative objective: ``value <= target`` must hold."""

    name: str
    target: float
    #: Tolerated breach fraction (the error budget): 0.0 means any
    #: breach spends infinite budget (used for invariants like
    #: unrepaired_drift == 0, where budget math degenerates to "any
    #: breach in both windows burns").
    error_budget: float
    unit: str = ""


def breach_fraction(samples: Iterable[tuple[float, bool]],
                    now: float, window_s: float
                    ) -> tuple[float, int]:
    """Fraction of samples inside ``(now - window_s, now]`` that were
    breaches, and the in-window sample count.  Pure; samples are
    ``(t_mono, breached)`` pairs in any order."""
    total = 0
    bad = 0
    lo = now - window_s
    for t, breached in samples:
        if lo < t <= now:
            total += 1
            if breached:
                bad += 1
    if total == 0:
        return 0.0, 0
    return bad / total, total


def burn_rate(samples: Iterable[tuple[float, bool]], now: float,
              window_s: float, error_budget: float) -> float:
    """Error-budget burn rate over one window: breach fraction divided
    by the budget.  1.0 = spending budget exactly as provisioned;
    >> 1 = on track to exhaust it early.  A zero budget makes ANY
    breach an infinite burn (invariant objectives)."""
    frac, n = breach_fraction(samples, now, window_s)
    if n == 0 or frac == 0.0:
        return 0.0
    if error_budget <= 0.0:
        return float("inf")
    return frac / error_budget


def is_burning(fast_burn: float, slow_burn: float,
               threshold: float) -> bool:
    """Multi-window AND: both the fast and slow windows must exceed
    the threshold — fast alone is a blip, slow alone is stale news."""
    return fast_burn >= threshold and slow_burn >= threshold


class SLOEngine:
    """Evaluates the configured objectives against live loop telemetry.

    Thread-safe: the serving thread calls :meth:`evaluate` (time-gated
    by the loop), scrape/debug threads call :meth:`snapshot` /
    :meth:`burning`."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.fast_window_s = float(cfg.slo_fast_window_s)
        self.slow_window_s = float(cfg.slo_slow_window_s)
        self.threshold = float(cfg.slo_burn_threshold)
        self.objectives: list[Objective] = []
        if cfg.slo_score_p99_ms > 0:
            self.objectives.append(Objective(
                "score_p99_ms", float(cfg.slo_score_p99_ms),
                float(cfg.slo_error_budget), unit="ms"))
        if cfg.slo_bind_p99_ms > 0:
            self.objectives.append(Objective(
                "bind_p99_ms", float(cfg.slo_bind_p99_ms),
                float(cfg.slo_error_budget), unit="ms"))
        if cfg.slo_regret_ceiling > 0:
            self.objectives.append(Objective(
                "quality_regret_p99", float(cfg.slo_regret_ceiling),
                float(cfg.slo_error_budget), unit="score"))
        # Invariant: never any unrepaired drift (error budget 0).
        self.objectives.append(Objective(
            "unrepaired_drift", 0.0, 0.0, unit="count"))
        self._samples: dict[str, deque[tuple[float, bool]]] = {
            o.name: deque(maxlen=MAX_SAMPLES) for o in self.objectives}
        self._values: dict[str, float] = {}
        self._burning: set[str] = set()
        self._lock = threading.Lock()
        self.evaluations_total = 0
        self.burn_events_total = 0

    # -- value sources -----------------------------------------------

    def _current_values(self, loop) -> dict[str, float]:
        """Pull each objective's current value from the loop; missing
        telemetry (no samples yet) yields no entry — no sample is
        recorded, so absence of data never reads as compliance OR
        breach."""
        vals: dict[str, float] = {}
        timer = getattr(loop, "timer", None)
        if timer is not None:
            if timer.count("score_assign") > 0:
                vals["score_p99_ms"] = (
                    timer.percentile("score_assign", 99) * 1e3)
            if timer.count("bind_net") > 0:
                vals["bind_p99_ms"] = (
                    timer.percentile("bind_net", 99) * 1e3)
        quality = getattr(loop, "quality", None)
        if quality is not None and quality.harvested_total > 0:
            vals["quality_regret_p99"] = (
                quality.regret_hist.percentile(99))
        integrity = getattr(loop, "integrity", None)
        if integrity is not None:
            vals["unrepaired_drift"] = float(
                getattr(integrity, "unrepaired_total", 0))
        return vals

    # -- evaluation --------------------------------------------------

    def evaluate(self, loop, now: float | None = None) -> set[str]:
        """Sample every objective, update burn rates, emit one
        ``SLOBurn`` Event per not-burning -> burning transition.
        Returns the currently-burning objective names."""
        if now is None:
            now = time.monotonic()
        vals = self._current_values(loop)
        newly: list[tuple[Objective, float, float, float]] = []
        with self._lock:
            self.evaluations_total += 1
            for obj in self.objectives:
                v = vals.get(obj.name)
                if v is None:
                    continue
                self._values[obj.name] = v
                buf = self._samples[obj.name]
                buf.append((now, v > obj.target))
                fast = burn_rate(buf, now, self.fast_window_s,
                                 obj.error_budget)
                slow = burn_rate(buf, now, self.slow_window_s,
                                 obj.error_budget)
                if is_burning(fast, slow, self.threshold):
                    if obj.name not in self._burning:
                        self._burning.add(obj.name)
                        self.burn_events_total += 1
                        newly.append((obj, v, fast, slow))
                else:
                    self._burning.discard(obj.name)
            burning = set(self._burning)
        for obj, v, fast, slow in newly:
            self._emit_burn_event(loop, obj, v, fast, slow)
        return burning

    def _emit_burn_event(self, loop, obj: Objective, value: float,
                         fast: float, slow: float) -> None:
        """Best-effort, like LinkDegraded: the burn is already visible
        in /metrics and /readyz whether or not the Event lands."""
        try:
            from kubernetesnetawarescheduler_tpu_torch.k8s.types import Event

            loop.client.create_event(Event(
                message=(
                    f"SLO {obj.name} burning: value "
                    f"{value:.4g}{obj.unit} vs target "
                    f"{obj.target:.4g}{obj.unit} "
                    f"(burn fast={fast:.3g} slow={slow:.3g} over "
                    f"{self.fast_window_s:.0f}s/"
                    f"{self.slow_window_s:.0f}s windows)"),
                reason="SLOBurn",
                involved_pod="",
                namespace="default",
                component=self.cfg.scheduler_name,
                type="Warning"))
        except Exception:
            pass

    # -- reads -------------------------------------------------------

    def burning(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._burning))

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        """Full engine state for /debug/slo: per-objective value,
        target, burn rates over both windows, burning flag, in-window
        sample counts."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            samples = {name: list(buf)
                       for name, buf in self._samples.items()}
            values = dict(self._values)
            burning = set(self._burning)
            evals = self.evaluations_total
            burns = self.burn_events_total
        objectives: dict[str, Any] = {}
        for obj in self.objectives:
            buf = samples[obj.name]
            fast = burn_rate(buf, now, self.fast_window_s,
                             obj.error_budget)
            slow = burn_rate(buf, now, self.slow_window_s,
                             obj.error_budget)
            frac_fast, n_fast = breach_fraction(
                buf, now, self.fast_window_s)
            frac_slow, n_slow = breach_fraction(
                buf, now, self.slow_window_s)
            objectives[obj.name] = {
                "target": obj.target,
                "unit": obj.unit,
                "error_budget": obj.error_budget,
                "value": values.get(obj.name),
                "breach_fraction_fast": frac_fast,
                "breach_fraction_slow": frac_slow,
                "samples_fast": n_fast,
                "samples_slow": n_slow,
                "burn_fast": fast,
                "burn_slow": slow,
                "burning": obj.name in burning,
            }
        return {
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.threshold,
            "evaluations_total": evals,
            "burn_events_total": burns,
            "burning": sorted(burning),
            "objectives": objectives,
        }
