"""The port's scenario generator, trace reader, pod waves and scorecard
against the JAX package's on the CPU.

For the same :class:`ScenarioSpec` both packages write the same trace
(decompressed bytes and generation stats), for specs that emit every
event kind; a trace written by either reads in the other; pods, waves
and scorecards are equal; and a scorecard the port builds from its own
replay passes the repository's ``tools/scenario_check.py``.
"""

from __future__ import annotations

import dataclasses
import gzip
import importlib.util
import json
import math
import os
import types
from collections import deque

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.scenario import generate as jgen
from kubernetesnetawarescheduler_tpu.scenario import replay as jrep
from kubernetesnetawarescheduler_tpu.scenario import scorecard as jsc
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.scenario import generate as tgen
from kubernetesnetawarescheduler_tpu_torch.scenario import replay as trep
from kubernetesnetawarescheduler_tpu_torch.scenario import scorecard as tsc
from kubernetesnetawarescheduler_tpu_torch.utils.timeseries import (
    LogHistogram,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "scenario_check.py")
_spec = importlib.util.spec_from_file_location("scenario_check", _TOOL)
scenario_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scenario_check)

JAX = types.SimpleNamespace(gen=jgen, rep=jrep, sc=jsc, fc=jfc)
TORCH = types.SimpleNamespace(gen=tgen, rep=trep, sc=tsc, fc=tfc)

_CLASSES = (dict(name="std", fraction=0.5),
            dict(name="edge", fraction=0.25, cpu_range=(2.0, 4.0),
                 lat_scale=4.0, bw_scale=0.25),
            dict(name="highmem", fraction=0.25, mem_range=(64.0, 256.0)))

# JAX tests/test_scenario.py's _small_spec, then the knobs that make the
# generator emit each event kind.
VARIANTS = {
    "small": {},
    "bursts_churn_faults": dict(link_burst_rate_per_s=0.2,
                                node_churn_rate_per_s=0.1,
                                state_fault_rate_per_s=0.2),
    "zone_outage": dict(zone_outage_at_s=5.0, zone_outage_zone=1,
                        zone_outage_duration_s=8.0),
    "rolling_upgrade": dict(duration_s=40.0, rolling_upgrade_at_s=2.0,
                            rolling_upgrade_batch=8,
                            rolling_upgrade_hold_s=3.0),
    "gang_shapes": dict(gang_fraction=0.3, gang_shapes_fraction=0.5,
                        gang_sizes=(2, 4, 8)),
    "everything": dict(link_burst_rate_per_s=0.2,
                       node_churn_rate_per_s=0.1,
                       state_fault_rate_per_s=0.2,
                       zone_outage_at_s=4.0, rolling_upgrade_at_s=9.0,
                       gang_shapes_fraction=0.5, chaos_seed=9,
                       node_classes=True),
}


def _small_spec(pkg, **overrides):
    classes = overrides.pop("node_classes", False)
    cluster = pkg.fc.ClusterSpec(
        num_nodes=32, seed=3,
        node_classes=tuple(pkg.fc.NodeClassSpec(**c) for c in _CLASSES)
        if classes else ())
    kw = dict(seed=5, duration_s=30.0, base_rate=8.0, tick_s=1.0,
              gang_fraction=0.1, gang_sizes=(4,),
              serving_lifetime_s=10.0, batch_lifetime_s=5.0,
              gang_lifetime_s=8.0, lifetime_floor_s=2.0, cluster=cluster)
    kw.update(overrides)
    return pkg.gen.ScenarioSpec(**kw)


def _text(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Every variant written by both packages, gzip and plain."""
    root = tmp_path_factory.mktemp("traces")
    out = {}
    for name, kw in VARIANTS.items():
        row = {}
        for tag, pkg in (("jax", JAX), ("torch", TORCH)):
            gz = str(root / f"{name}-{tag}.jsonl.gz")
            plain = str(root / f"{name}-{tag}.jsonl")
            stats = pkg.gen.generate_trace(_small_spec(pkg, **dict(kw)),
                                           gz)
            assert pkg.gen.generate_trace(_small_spec(pkg, **dict(kw)),
                                          plain) == stats
            row[tag] = (gz, plain, stats)
        out[name] = row
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_trace_is_byte_identical_to_jax(traces, variant):
    row = traces[variant]
    (jgz, jplain, jstats), (tgz, tplain, tstats) = row["jax"], row["torch"]
    assert tstats == jstats
    assert _text(tplain) == _text(jplain)
    assert _text(tgz) == _text(jgz) == _text(tplain)


def test_variants_emit_every_event_kind(traces):
    kinds: set[str] = set()
    for row in traces.values():
        _, events = tgen.read_trace(row["torch"][1])
        kinds |= {ev["kind"] for ev in events}
    assert kinds == set(tgen.EVENT_KINDS)
    assert tgen.EVENT_KINDS == jgen.EVENT_KINDS
    assert (tgen.TRACE_FORMAT, tgen.TRACE_VERSION) == (
        jgen.TRACE_FORMAT, jgen.TRACE_VERSION)


@pytest.mark.parametrize("writer,reader", [("jax", TORCH),
                                           ("torch", JAX)])
def test_trace_reads_in_the_other_package(traces, writer, reader):
    gz = traces["everything"][writer][0]
    own = traces["everything"]["torch" if writer == "jax" else "jax"][0]
    header, events = reader.gen.read_trace(gz)
    want_header, want_events = reader.gen.read_trace(own)
    assert header == want_header
    assert list(events) == list(want_events)
    spec = reader.gen.spec_from_json(header["spec"])
    assert spec == _small_spec(reader, **dict(VARIANTS["everything"]))
    assert scenario_check.check_trace_header(header) == []


def test_spec_json_matches_jax():
    for kw in VARIANTS.values():
        js = jgen.spec_to_json(_small_spec(JAX, **dict(kw)))
        ts = tgen.spec_to_json(_small_spec(TORCH, **dict(kw)))
        assert ts == js
        assert tgen.spec_from_json(json.loads(json.dumps(js))) == \
            _small_spec(TORCH, **dict(kw))


@pytest.mark.parametrize("header", [
    {"kind": "header", "format": "nope", "version": 1},
    {"kind": "header", "format": jgen.TRACE_FORMAT, "version": 99},
    {"kind": "event", "format": jgen.TRACE_FORMAT, "version": 1},
])
def test_read_trace_rejects_what_jax_rejects(tmp_path, header):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(header) + "\n")
    for pkg in (JAX, TORCH):
        with pytest.raises(ValueError):
            pkg.gen.read_trace(path)


def test_diurnal_and_round_t_match_jax():
    js, ts = _small_spec(JAX), _small_spec(TORCH)
    for t in np.linspace(0.0, 300.0, 97):
        assert tgen._diurnal(ts, float(t)) == jgen._diurnal(js, float(t))
        assert tgen._round_t(float(t) / 7.0) == jgen._round_t(
            float(t) / 7.0)


def _pod_fields(pod) -> dict:
    d = dataclasses.asdict(pod)
    d.pop("uid")
    return d


def test_pod_from_event_matches_jax(traces):
    path = traces["everything"]["torch"][1]
    _, events = tgen.read_trace(path)
    n = 0
    for ev in events:
        if ev["kind"] != "pod":
            continue
        got = _pod_fields(tgen.pod_from_event(ev, "sched-x"))
        want = _pod_fields(jgen.pod_from_event(ev, "sched-x"))
        assert got == want
        n += 1
    assert n > 100


@pytest.mark.parametrize("batch", [4, 16])
def test_pod_waves_match_jax(traces, batch):
    path = traces["everything"]["torch"][1]
    _, ev_t = tgen.read_trace(path)
    _, ev_j = jgen.read_trace(path)
    got = [(t, [_pod_fields(p) for p in w])
           for t, w in trep.pod_waves(ev_t, batch, 1.0)]
    want = [(t, [_pod_fields(p) for p in w])
            for t, w in jrep.pod_waves(ev_j, batch, 1.0)]
    assert got == want and len(got) > 10
    assert all(0 < len(w) <= batch for _, w in got)


def test_pod_waves_contract():
    """Waves split on batch-full and on tick-bucket boundaries, and
    non-pod events never land in a wave (JAX tests/test_scenario.py's
    contract, on the port)."""
    def pod_ev(t, name):
        return {"kind": "pod", "t": t,
                "pod": {"name": name, "cpu": 0.1, "mem": 0.2,
                        "net_bw": 0.05}}

    events = ([pod_ev(0.1, f"a{i}") for i in range(5)]
              + [{"kind": "link_degrade", "t": 0.5, "nodes": [],
                  "factor": 2.0}]
              + [pod_ev(1.2, f"b{i}") for i in range(3)]
              + [pod_ev(2.7, "c0")])
    waves = list(trep.pod_waves(iter(events), batch=4, tick_s=1.0))
    names = [[p.name for p in w] for _t, w in waves]
    assert names == [["a0", "a1", "a2", "a3"], ["a4"],
                     ["b0", "b1", "b2"], ["c0"]]


def _seeded_result(seed: int):
    """A port ReplayResult filled from a numpy seed, and the cycle times
    its histogram holds."""
    rng = np.random.default_rng(seed)
    res = trep.ReplayResult(slo_budget_ms=250.0)
    for name in ("pods_streamed", "events_consumed", "cycles",
                 "deletes_applied", "link_bursts_applied",
                 "link_repairs_applied", "node_downs", "node_ups",
                 "active_pods_max", "queue_depth_max"):
        setattr(res, name, int(rng.integers(100, 1000)))
    res.pods_bound = res.pods_streamed - int(rng.integers(0, 50))
    res.unschedulable = int(rng.integers(0, 40))
    res.deletes_failed = int(rng.integers(0, 3))
    res.gangs_seen = 12
    res.gangs_completed = 10
    res.gang_wait_s = list(rng.exponential(2.0, 10))
    res.state_faults = {"nan_poison": 1, "bit_flip": 2}
    cycle_ms = [float(ms) for ms in rng.lognormal(3.0, 1.0, 400)]
    for ms in cycle_ms:
        res.cycle_ms.record(ms)
    res.slo_samples = deque(
        (float(t), bool(b)) for t, b in zip(
            np.sort(rng.uniform(0, 900, 400)), rng.random(400) < 0.05))
    res.duration_virtual_s = 900.0
    res.duration_wall_s = float(rng.uniform(10, 60))
    res.rss_samples = [int(x) for x in rng.integers(1 << 28, 1 << 30, 5)]
    res.peak_rss_bytes = max(res.rss_samples)
    res.rebalance_summary = {"pods_evicted_total": 3,
                             "half_moved_gangs": 0, "moves_total": 3}
    res.quality_summary = {"regret_p50": 0.25, "regret_p99": 1.5,
                           "calibration_samples": 40}
    res.invariants = {"pods_double_bound": 0, "pods_lost": 0}
    res.sampled_bw = {"sampled_pods": 64, "realized_bw": 3.0,
                      "oracle_bw": 4.0,
                      "realized_bw_ratio_vs_oracle": 0.75}
    res.integrity = {"audits": 4, "drift_detected": 1,
                     "repairs": {"repatch_rows": 1}, "unrepaired": 0}
    return res, cycle_ms


def _as_jax(res: trep.ReplayResult, cycle_ms: list):
    """The same result as the JAX package's ReplayResult (its own
    LogHistogram holding the same samples)."""
    from kubernetesnetawarescheduler_tpu.utils.timeseries import (
        LogHistogram as JHist,
    )

    fields = {f.name: getattr(res, f.name)
              for f in dataclasses.fields(res)}
    hist = JHist(lo=1e-2, hi=1e5, window=8192)
    for ms in cycle_ms:
        hist.record(ms)
    fields["cycle_ms"] = hist
    return jrep.ReplayResult(**fields)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorecard_matches_jax(seed):
    res, cycle_ms = _seeded_result(seed)
    kw = dict(fast_window_s=120.0, evictions_per_hour_budget=64.0)
    got = tsc.build_scorecard(res, **kw)
    want = jsc.build_scorecard(_as_jax(res, cycle_ms), **kw)
    assert got == want
    # Duck-typed: each package's build_scorecard takes the other's result.
    assert jsc.build_scorecard(res, **kw) == got
    assert tsc.check_scorecard(got) == jsc.check_scorecard(want) == []
    bad = json.loads(json.dumps(got))
    bad["pods"]["bound"] = bad["pods"]["streamed"] + 1
    bad["cycles"]["p99_ms"] = -1.0
    del bad["memory"]
    assert tsc.check_scorecard(bad) == jsc.check_scorecard(bad) != []
    bad = json.loads(json.dumps(got))
    bad["bandwidth"]["realized_bw_ratio_vs_oracle"] = math.inf
    bad["gangs"]["completed"] = 99
    assert tsc.check_scorecard(bad) == jsc.check_scorecard(bad) != []


def test_port_scorecard_passes_scenario_check(traces):
    """A knobs-off port replay on the CPU, its scorecard and the suite
    leg's artifact envelope, linted by the repository's tool."""
    path = traces["small"]["torch"][1]
    res = trep.replay_trace(path, batch=16, chaos=False, drift=False,
                            state_faults=False, rebalance=False,
                            quality=False, oracle_sample=0,
                            queue_capacity=1024, device="cpu")
    assert res.pods_bound > 0
    assert isinstance(res.cycle_ms, LogHistogram)
    card = tsc.build_scorecard(res)
    assert tsc.check_scorecard(card) == []
    assert tsc.check_scorecard(json.loads(json.dumps(card))) == []
    doc = {"metric": "scenario_campaign", "value": 1.0,
           "detail": {"pods_streamed": res.pods_streamed,
                      "half_moved_gangs": 0, "scorecard": card}}
    assert scenario_check.check_artifact(doc) == []
    assert scenario_check.check_artifact(
        {"detail": {"pods_streamed": 0, "half_moved_gangs": 0,
                    "scorecard": card}}) != []
    assert scenario_check.check_artifact(
        {"detail": {"pods_streamed": 10, "half_moved_gangs": 1,
                    "scorecard": card}}) != []
