"""Log-bucketed latency histograms: exact counts + windowed percentiles.

Before r11, every latency-shaped series the repo exported lived in one
of two shapes: the PhaseTimer's bounded ``(seconds, count)`` window
(percentiles only over the retained window, no distribution export) or
an ad-hoc ``deque`` on the loop (``_static_refresh_ms``,
``_staleness_samples``, ``round_samples``) that /metrics summarized
with ``np.quantile`` at scrape time.  Neither can answer "how many
cycles ever crossed 5 ms" after the window slides, and neither exports
a shape Prometheus can aggregate across replicas (quantiles don't sum;
histogram buckets do).

:class:`LogHistogram` is the replacement: HDR-style geometric buckets
(``growth``× per bucket, so relative error is bounded by the growth
factor) with EXACT running ``count``/``sum`` that never evict, plus a
bounded sample window for exact p50/p99 over recent observations —
the same split PhaseTimer made in r6.  One lock, snapshot-then-math
like ``PhaseTimer._snapshot``: a /metrics scrape never holds the lock
through sorting or string formatting.

It is also a drop-in for the ad-hoc deques it replaces: ``append`` /
``extend`` / ``clear`` / ``len()`` / iteration / ``[-1]`` all work on
the sample window, so existing consumers (bench/density's
``np.percentile(list(...))``, tests asserting ``len(...)``) keep
working while the bucket counts accrue underneath.

:func:`prom_histogram_lines` renders a snapshot as a native Prometheus
histogram (cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
Only buckets that received observations are emitted (plus ``+Inf``) —
cumulative ``le`` series stay valid under any subset of bounds, and
the scrape stays small.

:class:`HistogramPhaseTimer` subclasses PhaseTimer so every
``record()`` also lands in a per-phase LogHistogram: the existing
``netaware_phase_latency_seconds`` summary keeps its series while
``..._hist`` native histograms ride along (migrated without renaming).
"""

from __future__ import annotations

import bisect
import collections
import math
import threading
from typing import Any, Iterator

from kubernetesnetawarescheduler_tpu_torch.utils.tracing import (
    PhaseTimer,
    _weighted_percentile,
)

__all__ = [
    "HistogramPhaseTimer",
    "LogHistogram",
    "prom_histogram_lines",
]

#: Default percentile-window retention — matches PhaseTimer's bound.
DEFAULT_WINDOW = 8192


def _geometric_bounds(lo: float, hi: float, growth: float
                      ) -> tuple[float, ...]:
    """Bucket upper bounds ``lo, lo*growth, ...`` up to (and covering)
    ``hi``.  The last finite bound is >= hi; values above it land in
    the implicit +Inf bucket."""
    if not (lo > 0.0 and hi > lo and growth > 1.0):
        raise ValueError(
            f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
            f"growth={growth}")
    n = max(1, math.ceil(math.log(hi / lo) / math.log(growth)))
    return tuple(lo * growth ** i for i in range(n + 1))


class LogHistogram:
    """Geometric-bucket histogram + bounded exact-sample window.

    Thread-safe; every mutation and snapshot is one lock acquisition.
    Unit-agnostic: callers pick bounds in whatever unit they record
    (the loop's refresh histogram records milliseconds, the phase
    histograms seconds)."""

    __slots__ = ("_bounds", "_buckets", "_overflow", "_count", "_sum",
                 "_window", "_maxlen", "_lock")

    def __init__(self, lo: float = 1e-5, hi: float = 1e3,
                 growth: float = math.sqrt(2.0),
                 window: int = DEFAULT_WINDOW) -> None:
        self._bounds = _geometric_bounds(lo, hi, growth)
        self._buckets = [0] * len(self._bounds)
        self._overflow = 0          # observations above the last bound
        self._count = 0             # exact, never evicts
        self._sum = 0.0             # exact, never evicts
        # (value, count) pairs, newest last; bounded like PhaseTimer's
        # per-phase deque (an append past the bound evicts the oldest).
        self._maxlen = max(1, int(window))
        self._window: collections.deque[tuple[float, int]] = (
            collections.deque(maxlen=self._maxlen))
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------

    def record(self, value: float, count: int = 1) -> None:
        if count < 1:
            return
        value = float(value)
        # <= bound semantics (Prometheus ``le``): bisect_left on the
        # bounds finds the first bound >= value.
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            if idx >= len(self._bounds):
                self._overflow += count
            else:
                self._buckets[idx] += count
            self._count += count
            self._sum += value * count
            self._window.append((value, count))

    # Deque drop-in surface (the ad-hoc deques this class replaces
    # were appended/extended with bare floats, listed, len()'d,
    # cleared and indexed with [-1]).

    def append(self, value: float) -> None:
        self.record(value)

    def extend(self, values) -> None:
        for v in values:
            self.record(v)

    def clear(self) -> None:
        """Reset everything — window AND exact aggregates (bench warmup
        windows use this to exclude compile time, which must not leak
        into the exported distribution either)."""
        with self._lock:
            self._buckets = [0] * len(self._bounds)
            self._overflow = 0
            self._count = 0
            self._sum = 0.0
            self._window.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._window)

    def __iter__(self) -> Iterator[float]:
        with self._lock:
            window = list(self._window)
        for value, count in window:
            for _ in range(count):
                yield value

    def __getitem__(self, idx: int) -> float:
        with self._lock:
            return self._window[idx][0]

    # -- reading -----------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) over the retained
        window — exact over recent observations, same contract as
        ``PhaseTimer.percentile``.  Sort happens outside the lock."""
        with self._lock:
            window = list(self._window)
        return _weighted_percentile(window, q)

    def snapshot(self) -> dict[str, Any]:
        """One-lock consistent copy: exact aggregates, CUMULATIVE
        bucket counts (``le`` upper-bound keyed, Prometheus shape) and
        the percentile window.  All derivation (cumsum) runs on the
        copy, outside the lock."""
        with self._lock:
            buckets = list(self._buckets)
            overflow = self._overflow
            count = self._count
            total = self._sum
            window = list(self._window)
        cum = 0
        cumulative: list[tuple[float, int]] = []
        for bound, c in zip(self._bounds, buckets):
            cum += c
            cumulative.append((bound, cum))
        return {
            "count": count,
            "sum": total,
            "buckets": cumulative,          # [(le, cumulative_count)]
            "overflow": overflow,
            "window": window,
            "p50": _weighted_percentile(list(window), 50),
            "p99": _weighted_percentile(list(window), 99),
        }


def prom_histogram_lines(name: str, help_: str, snap: dict[str, Any],
                         labels: str = "",
                         header: bool = True) -> list[str]:
    """Render a :meth:`LogHistogram.snapshot` as native Prometheus
    histogram exposition lines.  ``labels`` (e.g. ``phase="encode"``)
    is spliced into every series; a family with several label sets
    emits the HELP/TYPE header with the first set only
    (``header=False`` for the rest — duplicate headers are invalid
    exposition).

    Sparse: only buckets whose cumulative count advanced are emitted,
    plus the mandatory ``+Inf`` — valid cumulative-``le`` output that
    keeps a 50-bucket family from dominating the scrape."""
    sep = "," if labels else ""
    out = ([f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
           if header else [])
    prev = 0
    for le, cum in snap["buckets"]:
        if cum != prev:
            out.append(
                f'{name}_bucket{{{labels}{sep}le="{le:.6g}"}} {cum}')
            prev = cum
    out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} '
               f'{snap["count"]}')
    lab = f"{{{labels}}}" if labels else ""
    out.append(f"{name}_sum{lab} {snap['sum']:.9g}")
    out.append(f"{name}_count{lab} {snap['count']}")
    return out


class HistogramPhaseTimer(PhaseTimer):
    """PhaseTimer whose every ``record()`` also lands in a per-phase
    :class:`LogHistogram` — the migration seam for the existing
    ``netaware_phase_latency_seconds`` summary family: the summary
    keeps rendering from the PhaseTimer window (series names
    unchanged) while ``/metrics`` gains native ``_hist`` buckets from
    the same observations.  Phase latencies span ~10 us (null phases)
    to tens of seconds (cold compiles): bounds 1e-5 s .. 1e3 s at
    sqrt(2) growth = 54 buckets, <=41% relative bucket error."""

    def __init__(self, max_samples: int | None = None) -> None:
        if max_samples is None:
            super().__init__()
        else:
            super().__init__(max_samples)
        self.hists: dict[str, LogHistogram] = {}
        self._hist_lock = threading.Lock()

    def record(self, name: str, seconds: float,
               count: int = 1) -> None:
        super().record(name, seconds, count)
        if count < 1:
            return
        h = self.hists.get(name)
        if h is None:
            with self._hist_lock:
                h = self.hists.setdefault(
                    name, LogHistogram(lo=1e-5, hi=1e3,
                                       growth=math.sqrt(2.0)))
        h.record(seconds, count)

    def reset(self) -> None:
        super().reset()
        with self._hist_lock:
            self.hists.clear()
