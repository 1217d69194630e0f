"""The metrics that read the program's own spans and per-pod records:
the reduction of program ranges in a device trace, each reader on a
record made by hand, and both cells' traced runs on the CPU."""

from __future__ import annotations

import collections
import math
import time
import types

import pytest

from benchmark import program_spans, run, trace
from benchmark.tests.conftest import cell
from kubernetesnetawarescheduler_tpu_torch.utils import flight
from kubernetesnetawarescheduler_tpu_torch.utils.flight import (
    FlightRecorder,
)

@pytest.fixture(autouse=True)
def _own_recorders(monkeypatch):
    """Each test sees only the recorders it makes."""
    monkeypatch.setattr(flight, "_RECENT",
                        collections.deque(maxlen=flight._RECENT.maxlen))


NEW_DRAIN = ("round_ms.drain", "sync_wait_ms.drain", "syncs_per_round.drain")
NEW_LATENCY = ("queue_wait_p99_ms.latency", "pop_to_bind_p99_ms.latency")

HARNESS = [
    {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
     "ts": 0.0, "dur": 100.0},
    {"ph": "X", "cat": "user_annotation", "name": "bench.score_assign",
     "ts": 0.0, "dur": 80.0},
    {"ph": "X", "cat": "kernel", "ts": 20.0, "dur": 10.0,
     "name": "void at::native::reduce_kernel<512, 1>(float)"},
    {"ph": "X", "cat": "kernel", "ts": 50.0, "dur": 10.0,
     "name": "(anonymous namespace)::static_scores_kernel(NetIn)"},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
     "ts": 62.0, "dur": 1.0},
]
# Idle gaps: [0, 20) mid 10, [30, 50) mid 40, [60, 100) mid 80.
PROGRAM = [
    {"ph": "X", "cat": "user_annotation", "name": "netaware.cycle 7",
     "ts": 0.0, "dur": 90.0},
    {"ph": "X", "cat": "user_annotation", "name": "netaware.assign.static",
     "ts": 1.0, "dur": 30.0},
    {"ph": "X", "cat": "user_annotation", "name": "netaware.assign.round",
     "ts": 31.0, "dur": 44.0},
    {"ph": "X", "cat": "user_annotation",
     "name": "netaware.sync.assign.continue", "ts": 35.0, "dur": 10.0},
]


def test_program_ranges_leave_the_trace_reduction_as_it_was():
    assert trace.reduce_events(HARNESS + PROGRAM) == \
        trace.reduce_events(HARNESS)


def test_idle_program_names_the_innermost_program_span():
    out = program_spans.idle_program(HARNESS + PROGRAM)
    assert out["idle_program"] == pytest.approx(
        {"assign.static": 20e-6, "sync.assign.continue": 20e-6,
         "cycle": 40e-6})
    assert out["program_s"] == pytest.approx(
        {"cycle": 90e-6, "assign.static": 30e-6, "assign.round": 44e-6,
         "sync.assign.continue": 10e-6})
    bare = program_spans.idle_program(HARNESS)
    assert bare["idle_program"] == pytest.approx({"host": 80e-6})
    assert bare["program_s"] == {}


# A window on a clock no run reaches (perf_counter is never negative):
# opened at -1000 s, its stretch 5 s in.
T_OPEN = -1000.0


def _ctx(trace_at_s: float = 5.0):
    return types.SimpleNamespace(t0=T_OPEN - 2.0, setup_s=2.0,
                                 traffic={"trace_at_s": trace_at_s})


def _cycle(rec: FlightRecorder, t: float, phases) -> None:
    sb = rec.begin("burst")
    sb.t_mono = t
    for name, dur in phases:
        sb.add_phase(name, t, dur)
    rec.commit(sb.finish(n_pods=1, pod_uids=("p",), queue_depth=0))


def test_drain_readers_read_the_window_before_the_stretch():
    rec = FlightRecorder(capacity=16)
    inner = [("assign.static", 0.004), ("assign.round", 0.010),
             ("sync.assign.continue", 0.002), ("assign.round", 0.014),
             ("sync.assign.continue", 0.003),
             ("sync.assign.second_chance", 0.001), ("sync.fetch", 0.005)]
    _cycle(rec, T_OPEN - 1.0, inner)          # set-up: not read
    _cycle(rec, T_OPEN + 1.0, inner)
    _cycle(rec, T_OPEN + 3.0, inner)
    _cycle(rec, T_OPEN + 6.0, [("assign.round", 1.0)])   # in the stretch
    ctx, line = _ctx(), {"window_s": 40.0}
    assert run.reader("round_ms.drain").read(line, ctx) == \
        pytest.approx(12.0)
    assert run.reader("sync_wait_ms.drain").read(line, ctx) == \
        pytest.approx(11.0)
    assert run.reader("syncs_per_round.drain").read(line, ctx) == \
        pytest.approx(2.0)
    # A window shorter than trace_at_s reads to its end.
    assert run.reader("round_ms.drain").read(
        {"window_s": 2.0}, ctx) == pytest.approx(12.0)


def test_drain_readers_give_none_without_their_spans():
    ctx = _ctx(trace_at_s=0.5)
    rec = FlightRecorder(capacity=4)
    for name in NEW_DRAIN:
        assert run.reader(name).read({"window_s": 40.0}, None) is None
        assert run.reader(name).read({"window_s": 40.0}, ctx) is None
    # Cycles of a program that records no inner spans.
    _cycle(rec, T_OPEN + 0.1, [("encode", 0.01), ("score_assign", 0.5)])
    for name in NEW_DRAIN:
        assert run.reader(name).read({"window_s": 40.0}, ctx) is None


def test_latency_readers_read_the_pods_popped_before_the_stretch():
    rec = FlightRecorder(capacity=4, pod_records=256)
    t = T_OPEN
    rec.pods.popped([("early", t - 0.5)], t - 0.1)      # before the window
    for k in range(100):                                # waits 1 .. 100 ms
        rec.pods.popped([(f"p{k}", t + 1.0)], t + 1.0 + 0.001 * (k + 1))
    rec.pods.acked([f"p{k}" for k in range(100)], t + 2.0)
    rec.pods.popped([("late", t + 4.0)], t + 4.5)       # in the stretch
    line = {"stretch_at_s": 4.2}
    ctx = _ctx()
    queue = run.reader("queue_wait_p99_ms.latency").read(line, ctx)
    assert queue == pytest.approx(99.0)
    bind = run.reader("pop_to_bind_p99_ms.latency").read(line, ctx)
    assert bind == pytest.approx(1000.0 - 2.0)
    # Pods never acknowledged count as the longest: two of 102 reach
    # the 99th percentile.
    rec.pods.popped([("never", t + 3.0), ("nor", t + 3.0)], t + 3.0)
    assert run.reader("pop_to_bind_p99_ms.latency").read(line, ctx) is None
    small = FlightRecorder(capacity=4, pod_records=64)
    small.pods.popped([(f"q{k}", t) for k in range(200)], t)
    assert len(small.pods) == 64 and small.pods.dropped == 136


def test_latency_readers_give_none_without_records():
    FlightRecorder(capacity=4, pod_records=0)
    for name in NEW_LATENCY:
        assert run.reader(name).read({}, None) is None
        assert run.reader(name).read({"stretch_at_s": 1.0}, _ctx()) is None


def test_traced_runs_report_the_program_span_metrics(tiny):
    root, bench = tiny
    for name, wanted in (("k8s5000-standalone.saturation", NEW_DRAIN),
                         ("k8s5000-standalone.latency-pods", NEW_LATENCY)):
        out = run.measure(bench, cell(bench, name), 11, 1.5, True, "cpu",
                          time.perf_counter(), root=root)
        got = out["metrics"]
        assert set(wanted) <= set(got), (name, sorted(got))
        for m in wanted:
            assert 0 < got[m]["value"] < math.inf, (m, got[m])
