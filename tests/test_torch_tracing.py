"""The port's span call (``utils/tracing.py``) and the records it feeds.

Inside a serving cycle a span lands in the loop's ``PhaseTimer`` and in
the cycle's flight-recorder span; under a torch profiler it is also a
``netaware.<name>`` range.  Checked here on the CPU with a small loop:
the shared null context outside a cycle, profiler ranges that match the
in-memory spans by name, count, nesting and duration on the burst and
serial paths, per-site host-sync counts that add up to
``host_flag.syncs``, placements unchanged by the profiler and the
recorder, the per-pod timelines (enqueued, popped, acknowledged) and
their ring's bound, and the burst path's per-batch-normalised timer.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
from kubernetesnetawarescheduler_tpu_torch.utils import tracing
from kubernetesnetawarescheduler_tpu_torch.utils.flight import NULL_SPAN

torch.set_num_threads(1)

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "trace_check.py")
_spec = importlib.util.spec_from_file_location("trace_check", _TOOL)
trace_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_check)

CFG = dict(max_nodes=64, max_pods=16, max_peers=4, queue_capacity=256)
# One cycle each: a burst of four batches, or one serial batch.
PATHS = {"burst": (4, 64), "serial": (1, 16)}


def _loop(burst_batches: int, num_pods: int, **cfg_over):
    cfg = SchedulerConfig(**{**CFG, **cfg_over})
    cluster, lat, bw = tfc.build_fake_cluster(
        tfc.ClusterSpec(num_nodes=48, seed=51))
    loop = SchedulerLoop(cluster, cfg, method="parallel",
                         burst_batches=burst_batches, device="cpu")
    loop.encoder.set_network(lat, bw)
    tfc.feed_metrics(cluster, loop.encoder, np.random.default_rng(52))
    pods = tfc.generate_workload(
        tfc.WorkloadSpec(num_pods=num_pods, seed=53, services=8,
                         peer_fraction=0.5, affinity_fraction=0.1,
                         anti_fraction=0.1),
        scheduler_name=cfg.scheduler_name)
    cluster.add_pods(pods)
    return loop, cluster, pods


def _profiled_cycle(loop, tmp_path):
    """One ``run_once`` under a CPU profiler: the bound count and the
    trace's ``netaware.`` ranges.  The collector is off meanwhile: a
    collection landing between a range's edge and the span's clock read
    would count in one and not the other."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            bound = loop.run_once(timeout=0.0)
    finally:
        gc.enable()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(tracing.PREFIX)]
    return bound, ranges


def _nested(intervals):
    """``(name, parent name, depth, duration)`` in start order, each
    interval's parent the innermost one containing it."""
    out, stack = [], []
    for start, end, name in sorted(intervals,
                                   key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][1] < end:
            stack.pop()
        parent = stack[-1][2] if stack else None
        out.append((name, parent, len(stack), end - start))
        stack.append((start, end, name))
    return out


def test_span_outside_a_cycle_is_the_shared_null():
    assert tracing.span("assign.round") is tracing.NULL
    assert tracing.span("encode", 4) is tracing.NULL
    tracing.record("encode", 0.0, 1.0)      # no sink: nothing to land in
    timer = tracing.PhaseTimer()
    with tracing.cycle(timer, NULL_SPAN):
        assert tracing.span("encode") is not tracing.NULL
        # Re-entering the sink in place is a no-op.
        assert tracing.cycle(timer, NULL_SPAN) is tracing.NULL
    assert tracing.span("encode") is tracing.NULL
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.span("encode") is not tracing.NULL


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiler_ranges_match_the_recorded_spans(path, tmp_path):
    """The same cycle, run three times on fresh loops: each run's ranges
    match its recorded spans by name, nesting and count, and each span's
    two durations agree within 5% + 50 µs in at least one of the runs
    (a shared host may deschedule this process between a range's edge
    and the span's clock read, widening one of the two)."""
    batches, n = PATHS[path]
    gaps = []
    for attempt in range(3):
        loop, _, _ = _loop(batches, n)
        try:
            bound, ranges = _profiled_cycle(loop, tmp_path)
        finally:
            loop.stop_bind_worker()
        assert bound > 0
        (span,) = loop.flight.spans()
        assert span.path == path
        cycles = [e for e in ranges
                  if e["name"].startswith("netaware.cycle ")]
        assert [e["name"] for e in cycles] == [
            f"netaware.cycle {span.cycle_id}"]
        prof = _nested([(float(e["ts"]) * 1e-6,
                         (float(e["ts"]) + float(e["dur"])) * 1e-6,
                         e["name"][len(tracing.PREFIX):])
                        for e in ranges if e not in cycles])
        mem = _nested([(rel, rel + dur, name)
                       for name, rel, dur in span.phases])
        assert [p[:3] for p in prof] == [m[:3] for m in mem]
        if attempt:
            assert [m[:3] for m in mem] == shape
        shape = [m[:3] for m in mem]
        gaps.append([abs(p[3] - m[3]) - (0.05 * m[3] + 50e-6)
                     for p, m in zip(prof, mem)])
        names = [m[0] for m in mem]
        assert names.count("assign.round") == sum(loop.round_samples) > 0
        assert names.count("assign.static") == batches
        if path == "burst":
            assert names.count("replay.batch") == batches
            assert names.count("replay.commit") == batches
        assert {"encode", "score_assign", "bind", "sync.fetch",
                "sync.assign.continue"} <= set(names)
        assert trace_check.check_trace(loop.flight.to_chrome_trace()) == []
    worst = max(min(g) for g in zip(*gaps))
    assert worst <= 0, (worst, shape)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_per_site_sync_counts_add_up_to_the_total(path):
    batches, n = PATHS[path]
    loop, _, _ = _loop(batches, n)
    try:
        before = tstate.host_flag.syncs
        loop.run_once(timeout=0.0)
        total = tstate.host_flag.syncs - before
    finally:
        loop.stop_bind_worker()
    sites = {k: v["count"] for k, v in loop.timer.summary().items()
             if k.startswith("sync.")}
    assert total > 0 and sum(sites.values()) == total
    (span,) = loop.flight.spans()
    assert sum(1 for name, _, _ in span.phases
               if name.startswith("sync.")) == total
    # Every round's continue test, and each batch's first.
    assert sites["sync.assign.continue"] == sum(loop.round_samples) + batches


def _bindings(burst_batches: int, profiled: bool, tmp_path, **cfg_over):
    loop, cluster, _ = _loop(burst_batches, 96, **cfg_over)
    try:
        if profiled:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                loop.run_until_drained()
        else:
            loop.run_until_drained()
    finally:
        loop.stop_bind_worker()
    return {b.pod_name: b.node_name for b in cluster.bindings}


@pytest.mark.parametrize("batches", [1, 4])
def test_placements_unchanged_by_profiler_and_recorder(batches, tmp_path):
    plain = _bindings(batches, False, tmp_path)
    assert plain
    assert _bindings(batches, True, tmp_path) == plain
    assert _bindings(batches, False, tmp_path,
                     flight_recorder_size=0) == plain
    assert _bindings(batches, True, tmp_path,
                     flight_recorder_size=0) == plain


@pytest.mark.parametrize("batches,async_bind", [(1, False), (4, False),
                                                (4, True)])
def test_pod_records_are_ordered_and_bounded(batches, async_bind):
    cfg = SchedulerConfig(**CFG)
    cluster, lat, bw = tfc.build_fake_cluster(
        tfc.ClusterSpec(num_nodes=48, seed=51))
    loop = SchedulerLoop(cluster, cfg, method="parallel",
                         burst_batches=batches, async_bind=async_bind,
                         device="cpu")
    try:
        loop.encoder.set_network(lat, bw)
        pods = tfc.generate_workload(
            tfc.WorkloadSpec(num_pods=96, seed=53, services=8),
            scheduler_name=cfg.scheduler_name)
        cluster.add_pods(pods)
        loop.run_until_drained()
        loop.flush_binds()
    finally:
        loop.stop_bind_worker()
    recs = {uid: (enq, pop, ack)
            for uid, enq, pop, ack in loop.flight.pods.records()}
    bound = {b.pod_name for b in cluster.bindings}
    assert bound
    for pod in pods:
        enq, pop, ack = recs[pod.uid]
        assert enq <= pop
        if pod.name in bound:
            assert ack is not None and pop <= ack
    doc = loop.flight.to_chrome_trace()
    assert len(doc["pods"]) == len(recs) == doc["recorder"]["pod_records"]
    assert trace_check.check_trace(doc) == []

    small, cluster, pods = _loop(batches, 96, flight_pod_records=40)
    try:
        small.run_until_drained()
    finally:
        small.stop_bind_worker()
    assert len(small.flight.pods) == 40
    assert small.flight.pods.dropped == 96 - 40
    assert small.flight.to_chrome_trace()["recorder"][
        "pod_records_dropped"] == 96 - 40
    off, _, _ = _loop(batches, 16, flight_pod_records=0)
    try:
        off.run_until_drained()
    finally:
        off.stop_bind_worker()
    assert off.flight.pods is None and off.queue.records is None


def test_burst_timer_keeps_its_per_batch_meaning():
    """Encode, score_assign and bind count one sample per real batch of
    the burst, and their totals are the phases' wall times."""
    loop, _, _ = _loop(4, 56)          # 3.5 batches: 4 real ones
    try:
        loop.run_once(timeout=0.0)
    finally:
        loop.stop_bind_worker()
    (span,) = loop.flight.spans()
    walls = {name: dur for name, _, dur in span.phases
             if name in ("encode", "score_assign", "bind")}
    assert len(walls) == 3
    for name, wall in walls.items():
        assert loop.timer.count(name) == 4
        assert loop.timer.total(name) == pytest.approx(wall, rel=1e-9)
    assert sum(walls.values()) <= loop.timer.total("burst_wall")
