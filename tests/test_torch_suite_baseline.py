"""The bench suite's five BASELINE.json legs: the port against the JAX
package on the CPU.

Each leg (density, custom_network, affinity, binpack, sidecar) runs once
per package at the JAX suite's ``SMALL`` shape from the same seed.  Every
fake cluster a leg builds (warm-up loops included) records its bindings;
the two packages must make the same bindings, in the same order, in every
cluster.
Every metric that is not a clock must be equal, and the artifacts must
be byte-identical: the ``.data`` files as written, the audit JSONs once
the clock keys are dropped, the ``ResourceUsageSummary`` (all clocks) in
its schema.  A leg leaves no thread running.  The host oracle
``check_constraint_violations`` is also held against the JAX one on a
hand-built placement that breaks each of its rows.

The helpers here (:func:`run_leg`, :func:`mismatches`) are shared with
``test_torch_suite_audits.py``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import density as jdensity
from kubernetesnetawarescheduler_tpu.bench import suite as jsuite
from kubernetesnetawarescheduler_tpu.k8s import client as jclient
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu_torch.bench import density as tdensity
from kubernetesnetawarescheduler_tpu_torch.bench import suite as tsuite
from kubernetesnetawarescheduler_tpu_torch.k8s import client as tclient
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", suite=jsuite, density=jdensity,
                            client=jclient, types=jtypes, kw={})
TORCH = types.SimpleNamespace(name="torch", suite=tsuite,
                              density=tdensity, client=tclient,
                              types=ttypes, kw={"device": "cpu"})

#: Metrics read off a clock (or the host), excluded from parity.
CLOCKS = frozenset({
    "pods_per_sec", "baseline_pods_per_sec", "schedule_wall_s",
    "score_p99_ms", "scheduler_cpu_p99_cores", "scheduler_mem_p99_bytes",
    "gang_latency_p50_ms", "gang_latency_p99_ms",
    "gate_overhead_pods_per_sec", "gate_overhead_ratio", "bench_env"})

#: Rounded values that sit on ``used``'s 1e-6 parity: held at abs 1e-4.
USED_ROUNDED = frozenset({"util_p99", "util_std"})

LEGS = ("density", "custom_network", "affinity", "binpack", "sidecar")


@dataclasses.dataclass
class LegRun:
    result: object
    out_dir: Path
    bindings: list          # per cluster built, [(pod, node)] in order
    free0: list             # each free0 handed to _zone_attainable
    threads_left: list      # threads the leg started and left running


def run_leg(pkg, name: str, out_dir: Path, **overrides) -> LegRun:
    """Run ``pkg``'s leg ``name`` at the JAX ``SMALL`` shape (plus
    ``overrides``), recording every fake cluster it builds and every
    start-of-drain capacity it audits against."""
    clusters: list = []
    free0: list = []

    def recorder(real):
        def build(*a, **kw):
            out = real(*a, **kw)
            clusters.append(out[0])
            return out
        return build

    real_attainable = pkg.suite._zone_attainable

    def attainable(loop, pods, f0):
        free0.append(np.array(f0, copy=True))
        return real_attainable(loop, pods, f0)

    before = set(threading.enumerate())
    with pytest.MonkeyPatch.context() as mp:
        for mod in (pkg.suite, pkg.density):
            mp.setattr(mod, "build_fake_cluster",
                       recorder(mod.build_fake_cluster))
        mp.setattr(pkg.suite, "_zone_attainable", attainable)
        kwargs = {**pkg.suite.SMALL[name], **overrides, **pkg.kw}
        result = pkg.suite.CONFIGS[name](out_dir=str(out_dir), **kwargs)
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()]
    return LegRun(
        result=result, out_dir=out_dir,
        bindings=[[(b.pod_name, b.node_name) for b in c.bindings]
                  for c in clusters],
        free0=free0, threads_left=left)


def drop_clocks(x):
    if isinstance(x, dict):
        return {k: drop_clocks(v) for k, v in x.items() if k not in CLOCKS}
    if isinstance(x, list):
        return [drop_clocks(v) for v in x]
    return x


def mismatches(want, got, path: str = "", tol: dict | None = None
               ) -> list[str]:
    """Where ``got`` differs from ``want``: equal everywhere, except
    keys named in ``tol`` (key -> abs tolerance)."""
    tol = tol or {}
    if isinstance(want, dict) and isinstance(got, dict):
        if list(want) != list(got):
            return [f"{path}: keys {list(want)} != {list(got)}"]
        out = []
        for k in want:
            sub = f"{path}.{k}"
            if k in tol and not isinstance(want[k], (dict, list)):
                if abs(want[k] - got[k]) > tol[k]:
                    out.append(f"{sub}: {want[k]} != {got[k]} "
                               f"(abs {tol[k]})")
            else:
                out += mismatches(want[k], got[k], sub, tol)
        return out
    if isinstance(want, list) and isinstance(got, list):
        if len(want) != len(got):
            return [f"{path}: length {len(want)} != {len(got)}"]
        out = []
        for i, (a, b) in enumerate(zip(want, got)):
            out += mismatches(a, b, f"{path}[{i}]", tol)
        return out
    if type(want) is not type(got) or want != got:
        return [f"{path}: {want!r} != {got!r}"]
    return []


def check_bindings(j: LegRun, t: LegRun) -> None:
    assert len(j.bindings) == len(t.bindings) > 0
    for i, (a, b) in enumerate(zip(j.bindings, t.bindings)):
        assert a == b, (
            f"cluster {i}: {len(a)} / {len(b)} bindings, "
            f"{sum(x != y for x, y in zip(a, b))} differ")
    assert t.threads_left == []


def check_artifacts(j: LegRun, t: LegRun) -> None:
    jnames = [Path(p).name for p in j.result.artifacts]
    tnames = [Path(p).name for p in t.result.artifacts]
    assert jnames == tnames and tnames
    assert [str(t.out_dir / n) for n in tnames] == t.result.artifacts
    for name in tnames:
        a = (j.out_dir / name).read_text()
        b = (t.out_dir / name).read_text()
        if name.endswith(".data"):
            assert a == b, name
        elif name.startswith("ResourceUsageSummary_"):
            ja, tb = json.loads(a), json.loads(b)
            assert list(ja) == list(tb) == ["50", "90", "99", "100"]
            for pct in ja:
                [ra], [rb] = ja[pct], tb[pct]
                assert list(ra) == list(rb) == ["Name", "Cpu", "Mem"]
                assert ra["Name"] == rb["Name"]
                assert isinstance(rb["Cpu"], float)
                assert isinstance(rb["Mem"], int)
            assert a.endswith("}\n") and b.endswith("}\n")
        else:
            strip = [json.dumps(drop_clocks(json.loads(s)), indent=2)
                     for s in (a, b)]
            assert strip[0] == strip[1], name
            assert not b.endswith("\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache: dict = {}

    def get(pkg, name: str) -> LegRun:
        key = (pkg.name, name)
        if key not in cache:
            out = tmp_path_factory.mktemp(f"{pkg.name}_{name}")
            cache[key] = run_leg(pkg, name, out)
        return cache[key]

    return get


@pytest.mark.parametrize("name", LEGS)
def test_leg_binds_as_the_jax_leg(runs, name):
    check_bindings(runs(JAX, name), runs(TORCH, name))


@pytest.mark.parametrize("name", LEGS)
def test_leg_metrics_equal_the_jax_legs(runs, name):
    j, t = runs(JAX, name), runs(TORCH, name)
    assert t.result.config == j.result.config == name
    tol = {k: 1e-4 for k in USED_ROUNDED}
    assert mismatches(drop_clocks(j.result.metrics),
                      drop_clocks(t.result.metrics), name, tol) == []
    assert sorted(t.result.metrics) == sorted(j.result.metrics)


@pytest.mark.parametrize("name", LEGS)
def test_leg_artifacts_match_the_jax_legs(runs, name):
    check_artifacts(runs(JAX, name), runs(TORCH, name))


def test_baseline_bars_hold_at_small(runs):
    """The JAX suite tests' own bars, on the port's legs."""
    m = {n: runs(TORCH, n).result.metrics for n in LEGS}
    run = m["custom_network"]["runs"]["5"]
    assert 0 < run["custom_ms"] <= run["original_ms"]
    assert m["density"]["pods_bound"] > 0
    assert m["affinity"]["pods_bound"] > 0
    assert m["affinity"]["violations_total"] == 0
    for label in ("balanced", "unbalanced"):
        assert m["binpack"][label]["overcommit_nodes"] == 0
        assert m["binpack"][label]["capacity_violations"] == 0
    assert (m["binpack"]["balanced"]["util_std"]
            <= m["binpack"]["unbalanced"]["util_std"] + 0.05)
    assert m["sidecar"]["coplacement_rate"] >= 0.9
    assert m["sidecar"]["same_rack_rate"] >= m["sidecar"]["coplacement_rate"]
    assert m["sidecar"]["coplacement_vs_optimum"] >= 0.9


def _violating_cluster(pkg):
    """A hand-built placement that breaks each row of
    ``check_constraint_violations`` once, plus a second memberless
    self-affine pod (the first-pod waiver leaking)."""
    Node, Pod = pkg.types.Node, pkg.types.Pod
    cap = {"cpu": 8.0, "mem": 32.0, "net_bw": 10.0}
    cluster = pkg.client.FakeCluster()
    nodes = [
        Node(name="n0", capacity=cap, zone="zone-a", rack="r0"),
        Node(name="n1", capacity=cap, zone="zone-a", rack="r0"),
        Node(name="n2", capacity=cap, zone="zone-b", rack="r1",
             taints=frozenset({"dedicated=gpu:NoSchedule"})),
        Node(name="n3", capacity={**cap, "cpu": 1.0}, zone="zone-b",
             rack="r1"),
        Node(name="n4", capacity=cap, zone="zone-b", rack="r1",
             labels=frozenset({"disk=hdd"})),
        Node(name="n5", capacity=cap, zone="zone-c", rack="r2"),
        Node(name="n6", capacity=cap, zone="zone-c", rack="r2"),
    ]
    for n in nodes:
        cluster.add_node(n)
    req = {"cpu": 0.5, "mem": 1.0}
    placed = [
        # affinity: no co-resident of svc-x on n0.
        ("n0", Pod(name="aff", requests=req, group="svc-a",
                   affinity_groups=frozenset({"svc-x"}))),
        # anti: svc-b forbids svc-c, which shares n1.
        ("n1", Pod(name="anti", requests=req, group="svc-b",
                   anti_groups=frozenset({"svc-c"}))),
        ("n1", Pod(name="target", requests=req, group="svc-c")),
        # zone_anti: svc-c lives in zone-a (on n1).
        ("n0", Pod(name="zanti", requests=req, group="svc-d",
                   zone_anti_groups=frozenset({"svc-c"}))),
        # taint: n2's taint is not tolerated.
        ("n2", Pod(name="taint", requests=req, group="svc-e")),
        # capacity: 2 cpu on a 1-cpu node.
        ("n3", Pod(name="cap", requests={"cpu": 2.0, "mem": 1.0},
                   group="svc-f")),
        # zone_affinity: no svc-z member in zone-b.
        ("n4", Pod(name="zaff", requests=req, group="svc-g",
                   zone_affinity_groups=frozenset({"svc-z"}))),
        # node_affinity: n4 carries disk=hdd, not ssd.
        ("n4", Pod(name="nodeaff", requests=req, group="svc-h",
                   required_node_affinity=((("In", "disk", ("ssd",)),),))),
        # Two memberless self-affine pods of svc-s: one is waived, the
        # second is a violation.
        ("n5", Pod(name="self-1", requests=req, group="svc-s",
                   affinity_groups=frozenset({"svc-s"}))),
        ("n6", Pod(name="self-2", requests=req, group="svc-s",
                   affinity_groups=frozenset({"svc-s"}))),
    ]
    pods = [p for _, p in placed]
    cluster.add_pods(pods)
    for node, p in placed:
        cluster.bind(pkg.types.Binding(pod_name=p.name,
                                       namespace=p.namespace,
                                       node_name=node))
    return types.SimpleNamespace(client=cluster), pods


def test_check_constraint_violations_matches_jax_on_each_row():
    want = {"affinity": 2, "anti": 1, "taint": 1, "capacity": 1,
            "zone_affinity": 1, "zone_anti": 1, "node_affinity": 1}
    got = {}
    for pkg in (JAX, TORCH):
        loop, pods = _violating_cluster(pkg)
        got[pkg.name] = pkg.suite.check_constraint_violations(loop, pods)
    assert got["torch"] == got["jax"] == want
    # One self-affine pod alone is waived.
    loop, pods = _violating_cluster(TORCH)
    pods = [p for p in pods if p.name != "self-2"]
    assert TORCH.suite.check_constraint_violations(loop, pods) == {
        **want, "affinity": 1}
