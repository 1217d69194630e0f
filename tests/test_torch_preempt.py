"""The port's preemption planner against the JAX package's, on the CPU.

Each scenario builds the same encoder state through both packages' own
``SchedulerLoop`` (the cluster of ``tests/test_preempt.py``: 1-2 nodes,
``max_nodes=8``, ``max_pods=4``, filled with low-priority pods), then asks
``plan_preemption`` about the same preemptors: the target node and the
victims (by namespace, name, priority and node) must be identical.  The
end-to-end drives evict through the loops and must bind the same pods.
"""

from __future__ import annotations

import types

import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.core import preempt as jpreempt
from kubernetesnetawarescheduler_tpu.k8s import client as jclient
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.core import preempt as tpreempt
from kubernetesnetawarescheduler_tpu_torch.k8s import client as tclient
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

# Every loop a test builds is stopped at teardown (bind worker and static
# refresher), so no thread outlives its test.
_LOOPS: list = []


def _tracked(cls):
    def build(*args, **kwargs):
        loop = cls(*args, **kwargs)
        _LOOPS.append(loop)
        return loop
    return build


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(cfg=JCfg, loop=_tracked(jloop.SchedulerLoop),
                            preempt=jpreempt, client=jclient, t=jtypes,
                            kw={})
TORCH = types.SimpleNamespace(cfg=TCfg, loop=_tracked(tloop.SchedulerLoop),
                              preempt=tpreempt, client=tclient, t=ttypes,
                              kw={"device": "cpu"})


def _make(pkg, num_nodes=2, cap=4.0, burst_batches=8, **cfg_kw):
    cfg = pkg.cfg(max_nodes=8, max_pods=4, max_peers=2,
                  enable_preemption=True, **cfg_kw)
    cluster = pkg.client.FakeCluster()
    for i in range(num_nodes):
        cluster.add_node(pkg.t.Node(name=f"n{i}", capacity={"cpu": cap}))
    loop = pkg.loop(cluster, cfg, burst_batches=burst_batches, **pkg.kw)
    for i in range(num_nodes):
        loop.encoder.update_metrics(f"n{i}", {"cpu": 10.0})
    return cluster, loop


def _residents(pkg, scenario: str) -> list:
    P = pkg.t.Pod
    if scenario == "cheapest":
        return [P(name=f"f{i}", requests={"cpu": 2.0}, priority=1.0)
                for i in range(4)]
    if scenario == "mixed_priority":
        return [P(name="low0", requests={"cpu": 4.0}, priority=1.0),
                P(name="high0", requests={"cpu": 4.0}, priority=3.0)]
    if scenario == "ladder":
        return [P(name=f"l{i}", requests={"cpu": 1.0}, priority=float(i))
                for i in range(8)]
    if scenario == "pdb_annotation":
        return [P(name=f"g{i}", requests={"cpu": 2.0}, priority=1.0,
                  group="svc", pdb_min_available=1) for i in range(2)]
    if scenario == "pdb_object":
        return [P(name=f"db-{i}", requests={"cpu": 2.0}, priority=1.0,
                  labels=frozenset({"app=db"})) for i in range(2)]
    if scenario == "anti":
        return [P(name="a0", requests={"cpu": 1.0}, priority=1.0,
                  group="web"),
                P(name="a1", requests={"cpu": 1.0}, priority=2.0,
                  group="db")]
    if scenario == "gang":
        return [P(name=f"s-w{i}", requests={"cpu": 2.0}, priority=1.0,
                  pod_group="s", gang_min_member=3) for i in range(3)]
    raise KeyError(scenario)


def _preemptors(pkg, scenario: str) -> list:
    P = pkg.t.Pod
    out = [P(name="vip", requests={"cpu": 3.0}, priority=9.0),
           P(name="mid", requests={"cpu": 2.0}, priority=5.0),
           P(name="peer", requests={"cpu": 3.0}, priority=1.0),
           P(name="huge", requests={"cpu": 40.0}, priority=9.0)]
    if scenario == "anti":
        out.append(P(name="anti", requests={"cpu": 1.0}, priority=9.0,
                     group="api", anti_groups=frozenset({"web"})))
    if scenario == "ladder":
        out += [P(name=f"v{c}", requests={"cpu": float(c)}, priority=5.5)
                for c in (1, 3, 5)]
    return out


SCENARIOS = ("cheapest", "mixed_priority", "ladder", "pdb_annotation",
             "pdb_object", "anti", "gang")


def _plan_key(plan):
    if plan is None:
        return None
    return (plan.pod_name, plan.node_name,
            sorted((v.namespace, v.name, v.priority, v.node)
                   for v in plan.victims))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plan_preemption_matches_jax(scenario):
    plans = []
    for pkg in (JAX, TORCH):
        cluster, loop = _make(pkg, num_nodes=1 if scenario.startswith(
            "pdb") else 2)
        if scenario == "pdb_object":
            cluster.add_pdb(pkg.t.PodDisruptionBudget(
                name="pdb", uid="pdb", selector_key="app=db",
                selector_def=((("app", "db"),), ()), min_available=1))
        cluster.add_pods(_residents(pkg, scenario))
        loop.run_until_drained()
        plans.append([_plan_key(pkg.preempt.plan_preemption(loop.encoder,
                                                            pod))
                      for pod in _preemptors(pkg, scenario)])
    assert plans[1] == plans[0]
    assert any(p is not None for p in plans[0])


@pytest.mark.parametrize("burst", [1, 4])
def test_end_to_end_preemption_matches_jax(burst):
    """A high-priority pod arriving (alone, or inside a backlog burst)
    on a full cluster evicts the same victims and lands on the same node
    in both loops."""
    outs = []
    for pkg in (JAX, TORCH):
        cluster, loop = _make(pkg, burst_batches=burst)
        cluster.add_pods(_residents(pkg, "cheapest"))
        loop.run_until_drained()
        P = pkg.t.Pod
        cluster.add_pods(
            [P(name="vip", requests={"cpu": 3.0}, priority=9.0)]
            + [P(name=f"x{i}", requests={"cpu": 2.0}, priority=1.0)
               for i in range(7)])
        loop.run_until_drained()
        outs.append(({b.pod_name: b.node_name for b in cluster.bindings},
                     sorted((e.involved_pod, e.reason)
                            for e in cluster.events),
                     loop.preemptions, loop.unschedulable,
                     loop.burst_cycles > 0))
    assert outs[1] == outs[0]
    assert outs[0][2] == 2
