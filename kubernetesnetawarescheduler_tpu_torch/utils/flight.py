"""Decision-level tracing: cycle spans, flight recorder, explainability.

Every aggregate the repo exposes today (PhaseTimer percentiles,
/metrics summaries, bench p99 blocks) answers "how are cycles doing
on average" — none answers "which cycle regressed" or "why did THIS
pod land on THAT node".  Kubernetes' own scheduler ships per-plugin
scoring traces and ``--v=10`` placement explanations for exactly this
gap.  This module is the repro's equivalent:

* :class:`CycleSpan` — one structured record per serving cycle (wall +
  monotonic timestamps, pod uids, per-phase child spans reusing the
  PhaseTimer phase names, queue depth, static-refresh staleness /
  version lag, breaker + degraded-mode state, delta-vs-full ingest
  bytes, fault class).
* :class:`FlightRecorder` — a bounded ring buffer of the most recent
  spans plus a bounded store of per-pod explain records and a bounded
  ring of per-pod timelines (:class:`PodRecords`: enqueued, popped,
  bind acknowledged).  Overflow evicts oldest and counts ``dropped``
  (scrapeable as ``netaware_flight_dropped_total``); RSS stays
  O(capacity) no matter how long the serve runs.
* :func:`FlightRecorder.to_chrome_trace` — Chrome trace-event JSON
  (Perfetto-loadable: ``ph:"X"`` complete events, phases nested under
  their cycle by time containment on one tid).
* :func:`FlightRecorder.crash_dump` — post-mortem file written on
  SIGTERM/fault from serve.py's shutdown path.

The recorder is observation-only: span capture happens host-side
around the existing timed blocks and never feeds back into scoring, so
placements are bit-identical with the recorder on or off (pinned by
tests/test_flight.py).
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator, Mapping

__all__ = [
    "CycleSpan",
    "FlightRecorder",
    "NULL_SPAN",
    "PodRecords",
    "SpanBuilder",
    "recent",
]

# The newest recorders of this process, kept past their loop (bounded):
# a reader in the same process — a post-mortem hook after a fault tore
# the loop down, an in-process benchmark after its run — reaches a
# loop's record through :func:`recent`.  Holding a recorder changes
# nothing it records.
_RECENT: collections.deque = collections.deque(maxlen=4)


@dataclass(frozen=True)
class CycleSpan:
    """One serving cycle, committed when the cycle's effects commit
    (serial: end of ``schedule_pods``; pipelined: at retire — the same
    point usage commits, so a crash never leaves a span for a cycle
    whose binds were lost)."""

    cycle_id: int
    path: str                  # serial | burst | pipelined | gang
    t_wall: float              # epoch seconds at cycle start
    t_mono: float              # perf_counter seconds at cycle start
    dur_s: float
    n_pods: int
    pod_uids: tuple[str, ...]
    queue_depth: int
    # (phase_name, start_rel_s, dur_s) — PhaseTimer names, offsets
    # relative to t_mono so children always nest inside the cycle.
    phases: tuple[tuple[str, float, float], ...]
    static_staleness_s: float = 0.0
    static_versions_behind: int = 0
    breaker_state: str = "closed"
    degraded: bool = False
    fault_class: str | None = None
    delta_bytes: int = 0
    full_bytes: int = 0
    # Conflict rounds the device executed for this cycle's batches
    # (max across a burst's batches — the round-bound share of the
    # cycle's device time).  Default-valued so spans recorded by older
    # code paths deserialize unchanged.
    rounds: int = 0
    # Outcome observability: the SLO objective burning when
    # this cycle committed (None = all objectives healthy or engine
    # off) and the quality observer's outcome-ring depth — so a trace
    # export shows WHICH cycles ran under a burning SLO and how much
    # realized-outcome evidence existed at the time.  Default-valued:
    # pre-r11 spans and crash dumps deserialize unchanged.
    slo_burning: str | None = None
    outcome_ring_depth: int = 0
    # Continuous rebalancing: live migrations executed /
    # reverted since the previous committed span (the descheduler
    # runs at maintain cadence, so this is a per-span delta, not a
    # cumulative count).  Default-valued: pre-r12 spans and crash
    # dumps deserialize unchanged.
    rebalance_moves: int = 0
    rebalance_reverts: int = 0
    # Scenario replay: which trace phase the replay
    # harness was in when this cycle committed (None = not a replay)
    # and how many trace events had been consumed — the join key
    # between a flight export and the scenario trace that drove it.
    # Default-valued: pre-r13 spans and crash dumps deserialize
    # unchanged.
    scenario_phase: str | None = None
    trace_offset: int = 0
    # Learned scoring policy: shadow decisions the policy
    # would have placed differently since the previous committed span
    # (per-span delta, rebalance_moves pattern — shadow ranking runs
    # at maintain cadence) and the policy-parameter version live when
    # this cycle committed (0 = hand-tuned weights, never promoted).
    # Default-valued: pre-r15 spans and crash dumps deserialize
    # unchanged.
    policy_shadow_disagreements: int = 0
    policy_version: int = 0
    # r15 fleet: which logical cluster (tenant) this cycle served.
    # None on solo loops — the pre-r15-compatible default, so old
    # traces and crash dumps deserialize unchanged and trace_check
    # validates it only-when-present.
    cluster_id: str | None = None
    # Persistent multi-cycle serving: the scan-window size
    # K this logical cycle was dispatched under, and how many cycles
    # after dispatch its retire landed (0 = first wave of its window).
    # None on pre-r16 paths (per-cycle dispatch) — spans are still
    # emitted one-per-logical-cycle from the retire seam, and
    # trace_check validates these only-when-present so old traces
    # lint clean.
    scan_window_k: int | None = None
    retire_lag_cycles: int | None = None
    # Elastic gang reshaping: gangs reshaped / reshape
    # reverts since the previous committed span (per-span delta,
    # rebalance_moves pattern — the reshape path runs at maintain
    # cadence).  None on off-path spans (reshaping disabled, or no
    # rebalancer attached) — pre-r17 spans and crash dumps deserialize
    # unchanged and trace_check validates these only-when-present.
    gang_reshapes: int | None = None
    reshape_reverts: int | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "cycle_id": self.cycle_id,
            "path": self.path,
            "t_wall": self.t_wall,
            "t_mono": self.t_mono,
            "dur_s": self.dur_s,
            "n_pods": self.n_pods,
            "pod_uids": list(self.pod_uids),
            "queue_depth": self.queue_depth,
            "phases": [list(p) for p in self.phases],
            "static_staleness_s": self.static_staleness_s,
            "static_versions_behind": self.static_versions_behind,
            "breaker_state": self.breaker_state,
            "degraded": self.degraded,
            "fault_class": self.fault_class,
            "delta_bytes": self.delta_bytes,
            "full_bytes": self.full_bytes,
            "rounds": self.rounds,
            "slo_burning": self.slo_burning,
            "outcome_ring_depth": self.outcome_ring_depth,
            "rebalance_moves": self.rebalance_moves,
            "rebalance_reverts": self.rebalance_reverts,
            "scenario_phase": self.scenario_phase,
            "trace_offset": self.trace_offset,
            "policy_shadow_disagreements":
                self.policy_shadow_disagreements,
            "policy_version": self.policy_version,
            "cluster_id": self.cluster_id,
            "scan_window_k": self.scan_window_k,
            "retire_lag_cycles": self.retire_lag_cycles,
            "gang_reshapes": self.gang_reshapes,
            "reshape_reverts": self.reshape_reverts,
        }


class SpanBuilder:
    """Accumulates one cycle's phase child spans, then freezes into a
    :class:`CycleSpan` at commit.  Created at cycle start (dispatch in
    the pipelined path), committed at retire — it may outlive the
    Python frame that started it, which is why it is an object and not
    a context manager."""

    __slots__ = ("cycle_id", "path", "t_wall", "t_mono", "_phases")

    def __init__(self, cycle_id: int, path: str) -> None:
        self.cycle_id = cycle_id
        self.path = path
        self.t_wall = time.time()
        self.t_mono = time.perf_counter()
        self._phases: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self._phases.append(
                (name, start - self.t_mono,
                 time.perf_counter() - start))

    def add_phase(self, name: str, start_mono: float,
                  dur_s: float) -> None:
        """Record a phase from explicit perf_counter timestamps (for
        stages timed outside a ``with`` block, e.g. the pipelined
        device wait measured between dispatch and retire)."""
        self._phases.append((name, start_mono - self.t_mono, dur_s))

    def finish(self, **fields: Any) -> CycleSpan:
        return CycleSpan(
            cycle_id=self.cycle_id,
            path=self.path,
            t_wall=self.t_wall,
            t_mono=self.t_mono,
            dur_s=time.perf_counter() - self.t_mono,
            phases=tuple(self._phases),
            **fields,
        )


class _NullSpan:
    """No-op stand-in when the recorder is disabled
    (``flight_recorder_size=0``): the serving loop keeps one code
    shape and pays only an attribute check."""

    __slots__ = ()
    cycle_id = 0
    path = "off"

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        yield

    def add_phase(self, name: str, start_mono: float,
                  dur_s: float) -> None:
        pass

    def finish(self, **fields: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class PodRecords:
    """Bounded ring of per-pod timelines, keyed by pod uid:
    ``[enqueued, popped, acked]`` in ``perf_counter`` seconds — when the
    queue took the pod, when a cycle popped it, and when the API server
    acknowledged its bind (None until then, or if it never does).  A
    record is made at the pop (a pod popped again starts a new one, at
    the newest end); past ``capacity`` the oldest is evicted and counted
    in ``dropped``.  Thread-safe: the cycle thread pops, the async bind
    worker acknowledges."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self._recs: collections.OrderedDict[str, list] = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self.dropped = 0

    def popped(self, stamps, t: float) -> None:
        """``stamps``: ``(uid, enqueued)`` of the pods one pop took at
        ``t``."""
        with self._lock:
            recs = self._recs
            for uid, enqueued in stamps:
                recs.pop(uid, None)
                recs[uid] = [enqueued, t, None]
            while len(recs) > self.capacity:
                recs.popitem(last=False)
                self.dropped += 1

    def acked(self, uids, t: float) -> None:
        with self._lock:
            recs = self._recs
            for uid in uids:
                rec = recs.get(uid)
                if rec is not None:
                    rec[2] = t

    def records(self) -> list[tuple[str, float, float, float | None]]:
        """``(uid, enqueued, popped, acked)``, oldest pop first."""
        with self._lock:
            return [(uid, *rec) for uid, rec in self._recs.items()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)


class FlightRecorder:
    """Bounded ring buffer of :class:`CycleSpan` + bounded per-pod
    explain store.  All methods are thread-safe (serving thread
    commits, scrape/debug threads read, the async bind worker never
    touches it)."""

    def __init__(self, capacity: int = 512,
                 explain_retain: int = 512,
                 pod_records: int = 0) -> None:
        self.capacity = int(capacity)
        self.explain_retain = int(explain_retain)
        # Per-pod timelines (0 keeps none); the loop hands the ring to
        # its queue, which stamps the pops.
        self.pods: PodRecords | None = (PodRecords(pod_records)
                                        if pod_records > 0 else None)
        self._spans: collections.deque[CycleSpan] = collections.deque(
            maxlen=max(1, self.capacity))
        self._explains: collections.OrderedDict[str, dict[str, Any]] = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self._cycle_seq = 0
        self.dropped = 0
        self.explains_dropped = 0
        # Explain captures dropped on a host-side error (the loop's
        # encode or record build); the JAX recorder has no such count.
        self.explains_failed = 0
        # Provenance over restarts: serve.py stamps the checkpoint
        # disposition here so a post-restore trace dump says "recorder
        # is empty because the process restarted (restored)", not
        # "nothing ever ran" (empty-but-versioned contract).
        self.meta: dict[str, Any] = {"checkpoint_state": "fresh"}
        _RECENT.append(self)

    # -- span side ---------------------------------------------------

    def begin(self, path: str) -> SpanBuilder:
        """Issue the next strictly-increasing cycle id and start a
        span.  Cheap: one lock bump + two clock reads."""
        with self._lock:
            self._cycle_seq += 1
            cid = self._cycle_seq
        return SpanBuilder(cid, path)

    @property
    def cycle_seq(self) -> int:
        with self._lock:
            return self._cycle_seq

    def commit(self, span: CycleSpan | None) -> None:
        if span is None:
            return
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def spans(self) -> list[CycleSpan]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- explain side ------------------------------------------------

    def put_explain(self, record: Mapping[str, Any]) -> None:
        uid = str(record["pod_uid"])
        with self._lock:
            self._explains.pop(uid, None)
            self._explains[uid] = dict(record)
            while len(self._explains) > max(1, self.explain_retain):
                self._explains.popitem(last=False)
                self.explains_dropped += 1

    def note_explain_failed(self) -> None:
        with self._lock:
            self.explains_failed += 1

    def get_explain(self, pod_uid: str) -> dict[str, Any] | None:
        with self._lock:
            rec = self._explains.get(pod_uid)
            return dict(rec) if rec is not None else None

    def explains(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._explains.values()]

    def explains_len(self) -> int:
        with self._lock:
            return len(self._explains)

    # -- export ------------------------------------------------------

    def to_chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}``
        object form Perfetto loads directly).  One pid/tid; cycles are
        ``ph:"X"`` complete events, phases are ``ph:"X"`` events whose
        [ts, ts+dur] interval is clamped inside their cycle's, so the
        viewer nests them and tools/trace_check.py can verify no span
        is orphaned.  ``pods`` holds the per-pod timelines as
        ``[uid, enqueued, popped, acked]`` on the events' clock (µs;
        ``acked`` null until the bind is acknowledged)."""
        # One lock acquisition for spans AND counters: a commit landing
        # between two separate snapshots would make the recorder block
        # disagree with the event list (tools/trace_check.py pins
        # spans == number of cycle events).
        pods = self.pods.records() if self.pods is not None else []
        with self._lock:
            spans = list(self._spans)
            recorder = {
                "capacity": self.capacity,
                "spans": len(spans),
                "dropped": self.dropped,
                "cycle_seq": self._cycle_seq,
                "explains": len(self._explains),
                "explain_retain": self.explain_retain,
                "explains_dropped": self.explains_dropped,
                "explains_failed": self.explains_failed,
                "pod_records": len(pods),
                "pod_records_capacity": (self.pods.capacity
                                         if self.pods is not None else 0),
                "pod_records_dropped": (self.pods.dropped
                                        if self.pods is not None else 0),
            }
            meta = dict(self.meta, explains_failed=self.explains_failed)
        events: list[dict[str, Any]] = [
            {"ph": "M", "pid": 1, "tid": 0, "ts": 0,
             "name": "process_name",
             "args": {"name": "netaware-scheduler"}},
            {"ph": "M", "pid": 1, "tid": 1, "ts": 0,
             "name": "thread_name",
             "args": {"name": "serving-cycle"}},
        ]
        for s in spans:
            ts = s.t_mono * 1e6
            dur = max(s.dur_s, 0.0) * 1e6
            events.append({
                "name": f"cycle {s.cycle_id} [{s.path}]",
                "cat": "cycle", "ph": "X", "pid": 1, "tid": 1,
                "ts": round(ts, 3), "dur": round(dur, 3),
                "args": s.to_dict(),
            })
            for name, rel, pdur in s.phases:
                pts = ts + max(rel, 0.0) * 1e6
                pend = min(pts + max(pdur, 0.0) * 1e6, ts + dur)
                pts = min(pts, ts + dur)
                events.append({
                    "name": name, "cat": "phase", "ph": "X",
                    "pid": 1, "tid": 1,
                    "ts": round(pts, 3),
                    "dur": round(max(pend - pts, 0.0), 3),
                    "args": {"cycle_id": s.cycle_id},
                })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": meta,
            "recorder": recorder,
            "pods": [[uid, round(enq * 1e6, 3), round(pop * 1e6, 3),
                      None if ack is None else round(ack * 1e6, 3)]
                     for uid, enq, pop, ack in pods],
        }

    def worst_cycle(self) -> CycleSpan | None:
        """The slowest retained cycle — the span a bench artifact must
        ship alongside any claimed p99 number (bench_check Rule 8)."""
        spans = self.spans()
        if not spans:
            return None
        return max(spans, key=lambda s: s.dur_s)

    def crash_dump(self, path: str, reason: str = "shutdown",
                   extra: dict | None = None) -> str:
        """Write the recorder + retained explain records to ``path``
        for post-mortem (SIGTERM / fault path in serve.py; the
        integrity watchdog's stuck-audit dump).  ``extra`` rides along
        verbatim — the watchdog attaches the drift localization so the
        post-mortem names the corrupt rows, not just the cycle.
        Returns the path written.  Best-effort caller-side: exceptions
        propagate so the caller can log-and-continue."""
        doc = {
            "reason": reason,
            "t_wall": time.time(),
            "trace": self.to_chrome_trace(),
            "explains": self.explains(),
        }
        if extra:
            doc["extra"] = extra
        import os

        # serve.py defaults the dump into --checkpoint-dir, which on a
        # first-run shutdown does not exist yet (save_checkpoint only
        # creates it AFTER this post-mortem is written).
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path


def recent() -> list[FlightRecorder]:
    """The newest flight recorders this process made, oldest first (at
    most four, each kept past its loop)."""
    return list(_RECENT)
