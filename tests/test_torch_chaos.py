"""The port's control-plane chaos proxy, its soak and the faulty
exporter fleet against the JAX package's, on the CPU.

``ChaosSchedule.generate`` gives the same timeline per seed.  A loop
driven synchronously (``pipelined=False``, binds inline, so the bind
order is fixed) through a fault window of each class gives the same
injected counts, bindings (in order) and events in both packages, and
``check_invariants`` the same counters.  The fast seeded soak
(``tests/test_chaos.py``'s: 16 nodes, 64 pods, seed 7, four classes)
gives the same schedule and recovers with every invariant 0; its bind
worker's timing moves its counts, which are not compared.  The exporter
fleet gives byte-identical bodies and the same failures per seed, and
``build_fake_cluster(chaos=...)`` returns the proxy.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.k8s import chaos as jchaos
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.k8s import chaos as tchaos
from kubernetesnetawarescheduler_tpu_torch.k8s.client import FakeCluster

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(cfg=JCfg, fc=jfc, chaos=jchaos,
                            loop=jloop.SchedulerLoop, kw={})
TORCH = types.SimpleNamespace(cfg=TCfg, fc=tfc, chaos=tchaos,
                              loop=tloop.SchedulerLoop,
                              kw={"device": "cpu"})
SOAK_CLASSES = ("http_5xx", "watch_410", "bind_partial", "bind_blackhole")


def _chaos_loop(pkg, fault, num_pods: int = 24, seed: int = 5):
    """``tests/test_chaos.py``'s ``_chaos_loop`` shape (24 nodes,
    ``max_pods=16``), driven synchronously."""
    cfg = pkg.cfg(max_nodes=32, max_pods=16, max_peers=4,
                  queue_capacity=num_pods + 32)
    schedule = pkg.chaos.ChaosSchedule(
        seed=0, faults=(pkg.chaos.ChaosFault(**fault),) if fault else ())
    proxy, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=24, seed=seed), chaos=schedule)
    loop = pkg.loop(proxy, cfg, method="parallel", burst_batches=1,
                    **pkg.kw)
    _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(proxy.inner, loop.encoder,
                        np.random.default_rng(seed + 1))
    pods = pkg.fc.generate_workload(
        pkg.fc.WorkloadSpec(num_pods=num_pods, seed=seed + 2, services=6,
                            peer_fraction=0.3),
        scheduler_name=cfg.scheduler_name)
    return loop, proxy, pods


def _drive(pkg, fault) -> dict:
    loop, proxy, pods = _chaos_loop(pkg, fault)
    proxy.advance(0.5)
    proxy.add_pods(pods)
    for _ in range(40):
        loop.run_once()
        proxy.advance(0.25)
        if len(loop.queue) == 0 and proxy.clock() > 4.0:
            break
    loop.maintain()
    loop.run_until_drained(max_cycles=30)
    loop.flush_binds()
    return {
        "injected": dict(proxy.injected),
        "latency_s": round(proxy.injected_latency_s, 6),
        "dropped_watch": proxy.dropped_watch_events,
        "dropped_events": proxy.dropped_event_posts,
        "blackholed": proxy.blackholed_binds,
        "bindings": [(b.pod_name, b.node_name)
                     for b in proxy.inner.bindings],
        "events": [(e.involved_pod, e.reason, e.type)
                   for e in proxy.inner.events],
        "counters": (loop.scheduled, loop.unschedulable, loop.watch_gaps,
                     loop.relists, loop.binds_parked_total,
                     loop.breaker.opens_total),
        "invariants": pkg.chaos.check_invariants(loop, proxy.inner),
    }


@pytest.mark.parametrize("seed,classes", [
    (0, None), (7, None), (11, None), (12, SOAK_CLASSES),
    (3, ("latency", "watch_drop", "conn_reset"))])
def test_schedule_matches_jax(seed, classes):
    kw = {} if classes is None else {"classes": classes}
    want = jchaos.ChaosSchedule.generate(seed, **kw)
    got = tchaos.ChaosSchedule.generate(seed, **kw)
    assert got.to_dicts() == want.to_dicts()
    assert got.classes == want.classes and got.end_s == want.end_s
    assert tchaos.FAULT_CLASSES == jchaos.FAULT_CLASSES
    with pytest.raises(ValueError):
        tchaos.ChaosSchedule.generate(seed, classes=("no_such_fault",))


@pytest.mark.parametrize("kind", tchaos.FAULT_CLASSES)
def test_sync_drive_under_fault_matches_jax(kind):
    fault = dict(kind=kind, start_s=0.0, duration_s=3.0,
                 probability=0.7, latency_s=0.1, fail_fraction=0.5)
    got, want = _drive(TORCH, fault), _drive(JAX, fault)
    assert got == want
    assert got["injected"][kind] > 0 or kind in ("watch_drop", "watch_410")
    assert got["invariants"] == {k: 0 for k in got["invariants"]}
    assert got["bindings"]


def test_check_invariants_matches_jax():
    """Drift the ledger against the server in both packages the same
    way: an orphaned record, a bound pod missing from the ledger, a
    pending pod with no trace."""
    got = {}
    for pkg in (JAX, TORCH):
        loop, proxy, pods = _chaos_loop(pkg, None)
        proxy.add_pods(pods[:16])
        loop.run_until_drained()
        loop.flush_binds()
        bound = [b.pod_name for b in proxy.inner.bindings]
        uid_of = {p.name: p.uid for p in pods}
        with loop.encoder._lock:
            loop.encoder._committed.pop(uid_of[bound[0]])
        with proxy.inner._lock:
            del proxy.inner._pods[bound[1]]
        with proxy.inner._lock:
            for p in pods[16:18]:
                proxy.inner._pods[p.name] = p
        got[pkg is TORCH] = pkg.chaos.check_invariants(loop, proxy.inner)
    assert got[True] == got[False]
    assert got[True]["ledger_orphans"] == 1
    assert got[True]["ledger_missing"] == 1
    assert got[True]["pods_lost"] == 2


def test_fast_soak_matches_jax():
    kw = dict(seed=7, num_nodes=16, num_pods=64, classes=SOAK_CLASSES,
              cycle_s=0.25, spacing_s=4.0, base_duration_s=1.5)
    want = jchaos.run_chaos_soak(**kw)
    got = tchaos.run_chaos_soak(**kw, device="cpu")
    for key in ("metric", "seed", "fault_classes", "schedule"):
        assert got[key] == want[key], key
    assert got["recovered"] and want["recovered"]
    assert got["time_to_recover_s"] is not None
    assert got["invariants"] == {k: 0 for k in want["invariants"]}
    assert set(got["detail"]) == set(want["detail"])
    detail = got["detail"]
    assert detail["brownout"]["assumed"] > 0
    assert detail["watch_gaps"] >= 1 and detail["relists"] >= 1
    assert detail["bound"] > 0


def test_fast_soak_with_state_faults_repairs_every_fault():
    doc = tchaos.run_chaos_soak(
        seed=7, num_nodes=16, num_pods=64, classes=SOAK_CLASSES,
        cycle_s=0.25, spacing_s=4.0, base_duration_s=1.5,
        state_faults=True, device="cpu")
    assert doc["recovered"]
    assert doc["invariants"] == {k: 0 for k in doc["invariants"]}
    integ = doc["detail"]["integrity"]
    injected = sum(integ["state_faults_injected"].values())
    assert injected > 0
    assert integ["drift_detected"] == injected
    assert integ["unrepaired"] == 0
    assert sum(integ["repairs"].values()) == injected


@pytest.mark.parametrize("nan", [False, True])
def test_synth_exporter_body_matches_jax(nan):
    rng = np.random.default_rng(9)
    for _ in range(4):
        vals = tfc.sample_metrics(rng)
        assert (tfc.synth_exporter_body(vals, num_cpus=3, nan=nan)
                == jfc.synth_exporter_body(vals, num_cpus=3, nan=nan))


def _fleet_outcomes(fc, spec_kw) -> list:
    names = [f"node-{i:04d}" for i in range(8)]
    fleet = fc.FaultyExporterFleet(names, fc.FaultSpec(**spec_kw))
    out = []
    for _ in range(5):
        for name, url in fleet.targets().items():
            try:
                out.append(fleet.fetch(url))
            except (ConnectionRefusedError, TimeoutError) as exc:
                out.append(type(exc).__name__)
    return out + [fleet.calls]


@pytest.mark.parametrize("spec_kw", [
    dict(seed=1),
    dict(drop_fraction=0.1, timeout_fraction=0.1, corrupt_fraction=0.1,
         nan_fraction=0.2, seed=4),
    dict(nan_fraction=0.5, dead_nodes=frozenset({"node-0003"}), seed=8),
])
def test_faulty_exporter_fleet_matches_jax(spec_kw):
    got = _fleet_outcomes(tfc, spec_kw)
    assert got == _fleet_outcomes(jfc, spec_kw)
    assert len(got) == 41


def test_build_fake_cluster_chaos_returns_a_proxy():
    bare, lat0, bw0 = tfc.build_fake_cluster(tfc.ClusterSpec(num_nodes=8,
                                                             seed=2))
    proxy, lat, bw = tfc.build_fake_cluster(
        tfc.ClusterSpec(num_nodes=8, seed=2), chaos=5)
    assert isinstance(proxy, tchaos.ChaosKubeProxy)
    assert isinstance(proxy.inner, FakeCluster)
    assert np.array_equal(lat, lat0) and np.array_equal(bw, bw0)
    assert ([n.name for n in proxy.list_nodes()]
            == [n.name for n in bare.list_nodes()])
    assert (proxy.schedule.to_dicts()
            == jchaos.ChaosSchedule.generate(5).to_dicts())
    sched = tchaos.ChaosSchedule.generate(3, classes=("latency",))
    proxy2, _, _ = tfc.build_fake_cluster(
        tfc.ClusterSpec(num_nodes=4, seed=1), chaos=sched)
    assert proxy2.schedule is sched
