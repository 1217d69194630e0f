"""Self-metrics: per-phase latency histograms and throughput counters,
and the port's one span call.

The reference had no observability of itself at all — only ``println``
debugging of scraped values (scheduler.go:517, :525-526) and a node-name
log line (scheduler.go:182).  Here per-phase (encode / score / assign /
bind) timings and percentiles are first-class, because the north-star
target is expressed as one (p99 Score() < 5 ms, BASELINE.json).

:func:`span` times a stretch of a serving cycle by name.  Inside a cycle
(:func:`cycle`, which the loop enters with its ``PhaseTimer`` and the
cycle's flight-recorder span) it lands in both: the timer's exact count
and total, and the cycle's child spans, nested by time containment.
While a torch profiler is collecting, it is also a
``torch.profiler.record_function`` range named ``netaware.<name>``, so
the program's spans sit on the device trace's own timeline.  Free
functions of ``core/`` call it without a handle: the cycle's sink is
thread-local.  Outside a cycle and with no profiler running it returns
one shared null context.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Iterator, Mapping

from torch.autograd import profiler as _autograd_profiler

# Per-phase retention ceiling for the percentile window.  The 25-minute
# soak (soak.json r5) accumulated 208,210 timer entries — 28.5 MB of RSS
# growth — because the sample list was O(cycles).  Percentiles only need
# a recent window; counts and totals are kept as exact running
# aggregates that never evict.  8192 weighted pairs cover >2h of serving
# cycles at the soak's wave rate while bounding each phase to ~200 KB.
MAX_SAMPLES_PER_PHASE = 8192


def _weighted_percentile(samples: list[tuple[float, int]],
                         q: float) -> float:
    """Nearest-rank percentile over weight-expanded ``(seconds, count)``
    pairs — identical to materializing each pair ``count`` times.  Pure
    (no lock): callers pass an already-snapshotted list; the sort
    happens here, outside any lock."""
    if not samples:
        return 0.0
    samples = sorted(samples)
    n = sum(c for _, c in samples)
    rank = min(n - 1, max(0, int(round(q / 100.0 * (n - 1)))))
    cum = 0
    for value, c in samples:
        cum += c
        if rank < cum:
            return value
    return samples[-1][0]


class PhaseTimer:
    """Accumulates wall-clock samples per named phase.

    Thread-safe: the serving cycle, the async bind worker and the
    /metrics scrape thread all touch one timer — an unsynchronized
    first ``phase()`` from the worker would insert a dict key mid-
    ``summary()`` iteration on the scrape thread.

    Memory-bounded: each phase retains at most
    ``MAX_SAMPLES_PER_PHASE`` weighted ``(seconds, count)`` pairs for
    percentile queries (a sliding window over the most recent
    observations); ``count()`` and ``total()`` are exact running
    aggregates unaffected by eviction."""

    def __init__(self,
                 max_samples: int = MAX_SAMPLES_PER_PHASE) -> None:
        # (seconds, weight) pairs: a burst cycle records its
        # per-batch-normalized sample once with weight n_batches
        # instead of n_batches identical floats, so the window holds
        # cycles, not pods, while the percentile math still gives each
        # batch full weight.
        self.max_samples = int(max_samples)
        self._samples: dict[str, Deque[tuple[float, int]]] = {}
        self._counts: dict[str, int] = {}
        self._totals: dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - start)

    def record(self, name: str, seconds: float,
               count: int = 1) -> None:
        """Record ``count`` observations of ``seconds`` (weighted)."""
        if count < 1:
            return
        with self._lock:
            buf = self._samples.get(name)
            if buf is None:
                buf = collections.deque(maxlen=self.max_samples)
                self._samples[name] = buf
            buf.append((seconds, count))
            self._counts[name] = self._counts.get(name, 0) + count
            self._totals[name] = (self._totals.get(name, 0.0)
                                  + seconds * count)

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def total(self, name: str) -> float:
        with self._lock:
            return self._totals.get(name, 0.0)

    def samples_len(self, name: str) -> int:
        """Retained (seconds, count) pairs in the percentile window —
        bounded by ``max_samples`` regardless of record() volume."""
        with self._lock:
            return len(self._samples.get(name, ()))

    def percentile(self, name: str, q: float) -> float:
        """q in [0, 100]; nearest-rank on the weight-expanded sorted
        samples (identical to materializing each pair ``count``
        times).  Computed over the retained window — the most recent
        ``max_samples`` weighted pairs.  The lock only covers the
        snapshot copy; the O(n log n) sort runs outside it so a scrape
        never stalls the serving thread's ``record()``."""
        with self._lock:
            samples = list(self._samples.get(name, ()))
        return _weighted_percentile(samples, q)

    def _snapshot(self) -> tuple[dict[str, list[tuple[float, int]]],
                                 dict[str, int], dict[str, float]]:
        """One consistent copy of (samples, counts, totals) under a
        single lock acquisition — the scrape path's entire critical
        section."""
        with self._lock:
            samples = {name: list(buf)
                       for name, buf in self._samples.items()}
            counts = dict(self._counts)
            totals = dict(self._totals)
        return samples, counts, totals

    def summary(self) -> Mapping[str, Mapping[str, float]]:
        """One lock acquisition total (via :meth:`_snapshot`), then all
        sorting and percentile math on the copies — previously this
        re-took the lock 3×+ per phase and sorted inside it."""
        samples, counts, totals = self._snapshot()
        out: dict[str, dict[str, float]] = {}
        for name, buf in samples.items():
            out[name] = {
                "count": float(counts.get(name, 0)),
                "total_s": totals.get(name, 0.0),
                "p50_ms": _weighted_percentile(buf, 50) * 1e3,
                "p99_ms": _weighted_percentile(buf, 99) * 1e3,
            }
        return out

    def pipeline_budgets(self, phases: Mapping[str, str] | None = None,
                         ) -> dict[str, dict[str, float]]:
        """Per-stage budget block for bench artifacts: for each pipeline
        stage (encode / dispatch / bind by default) report mean, p50,
        p99 in ms plus the total seconds, so artifacts carry the
        overlap structure on their face."""
        if phases is None:
            # encode: host array prep (overlaps the device step in
            # pipelined mode); dispatch: host-side launch cost
            # (finalize+snapshot+trace, pipelined mode only);
            # device_wait: the blocking fetch — in pipelined mode only
            # the NON-overlapped residue of the device step; bind: the
            # network fanout on the async-bind worker.
            phases = {"encode": "encode", "dispatch": "dispatch",
                      "device_wait": "score_assign",
                      "bind": "bind_net"}
        samples, counts, totals = self._snapshot()
        out: dict[str, dict[str, float]] = {}
        for stage, name in phases.items():
            c = counts.get(name, 0)
            if not c:
                continue
            tot = totals.get(name, 0.0)
            buf = samples.get(name, [])
            out[stage] = {
                "count": float(c),
                "mean_ms": round(tot / c * 1e3, 3),
                "p50_ms": round(_weighted_percentile(buf, 50) * 1e3, 3),
                "p99_ms": round(_weighted_percentile(buf, 99) * 1e3, 3),
                "total_s": round(tot, 3),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counts.clear()
            self._totals.clear()


# ---------------------------------------------------------------------------
# The span call.
# ---------------------------------------------------------------------------

#: What :func:`span` returns outside a cycle with no profiler running.
NULL = contextlib.nullcontext()

#: Profiler range names carry this prefix (``netaware.assign.round``,
#: ``netaware.cycle 17``).
PREFIX = "netaware."


class _Sink:
    """Where the spans of the running cycle land: the loop's timer and
    the cycle's ``SpanBuilder`` (``NULL_SPAN`` when the flight recorder
    is off)."""

    __slots__ = ("timer", "builder")

    def __init__(self, timer, builder) -> None:
        self.timer = timer
        self.builder = builder


class _Local(threading.local):
    sink: _Sink | None = None


_LOCAL = _Local()


def _profiling() -> bool:
    """Whether a torch profiler is collecting: one module-attribute
    read, where an unconditional ``record_function`` costs microseconds
    even with no profiler running."""
    return _autograd_profiler._is_profiler_enabled


def _land(sink: _Sink, name: str, start: float, dur: float,
          weight: int) -> None:
    sink.timer.record(name, dur / weight, count=weight)
    sink.builder.add_phase(name, start, dur)


class _Span:
    __slots__ = ("_name", "_sink", "_weight", "_start", "_range")

    def __init__(self, name: str, sink: _Sink | None, weight: int) -> None:
        self._name = name
        self._sink = sink
        self._weight = weight
        self._range = None

    def __enter__(self) -> "_Span":
        if _profiling():
            self._range = _autograd_profiler.record_function(
                PREFIX + self._name)
            self._range.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._start
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._sink is not None:
            _land(self._sink, self._name, self._start, dur, self._weight)


def span(name: str, weight: int = 1):
    """Time the ``with`` block as span ``name`` (see the module doc).

    ``weight`` records the block into the timer as ``weight`` samples of
    ``duration / weight`` — a burst cycle's per-batch-normalised phase —
    so the timer's total stays the block's wall time; the cycle's child
    span is the block's own interval either way."""
    sink = _LOCAL.sink
    if sink is None and not _profiling():
        return NULL
    return _Span(name, sink, weight)


def record(name: str, start: float, dur: float, weight: int = 1) -> None:
    """Land an interval timed elsewhere (another thread's work, a share
    of a window) as span ``name`` of the running cycle, as :func:`span`
    would have; no profiler range.  No-op outside a cycle."""
    sink = _LOCAL.sink
    if sink is not None:
        _land(sink, name, start, dur, weight)


class _Cycle:
    __slots__ = ("_sink", "_prev", "_range")

    def __init__(self, sink: _Sink) -> None:
        self._sink = sink
        self._range = None

    def __enter__(self) -> "_Cycle":
        self._prev = _LOCAL.sink
        _LOCAL.sink = self._sink
        if _profiling():
            self._range = _autograd_profiler.record_function(
                f"{PREFIX}cycle {self._sink.builder.cycle_id}")
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        _LOCAL.sink = self._prev


def cycle(timer, builder):
    """Make ``(timer, builder)`` the sink of the spans this thread opens
    inside the ``with`` block; while a profiler collects, the block is
    the range ``netaware.cycle <builder.cycle_id>``, the id
    ``/debug/trace`` shows.  Re-entering the sink already in place is a
    no-op, so a cycle's halves may each enter it."""
    cur = _LOCAL.sink
    if cur is not None and cur.builder is builder and cur.timer is timer:
        return NULL
    return _Cycle(_Sink(timer, builder))
