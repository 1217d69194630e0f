"""The port's streaming scenario replay against the JAX package's on one
32-node trace on the CPU (f32 in both packages: the port's dense path
rounds to bf16 only on a CUDA device, as the JAX one only on a TPU).

- Knobs off: the same placement for every pod and every counter of
  ``ReplayResult`` identical.
- Drift and state faults on: the same placements, every fault repaired
  (``unrepaired`` 0) in both.
- Every knob on (chaos proxy, drift, state faults, rebalancer, quality
  observer, the sampled oracle): the same scorecard keys, the
  invariants and the auditor clean in both, and the realized-bandwidth
  ratio equal to 1e-12 relative wherever two JAX runs agree.

The JAX package's loop is built once per config and compiles once per
file; every replay stops its loops' bind workers before it returns.
"""

from __future__ import annotations

import dataclasses

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

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

BASE = dict(batch=16, chaos=False, drift=False, state_faults=False,
            rebalance=False, quality=False, oracle_sample=0,
            compact=False, collect_placements=True, queue_capacity=1024)
MODES = {
    "off": {},
    "drift_faults": dict(drift=True, state_faults=True),
    "all": dict(chaos=True, drift=True, state_faults=True,
                rebalance=True, quality=True, oracle_sample=64),
}
# Timing-dependent fields of ReplayResult, never compared.
_CLOCKED = {"cycle_ms", "slo_samples", "duration_wall_s", "rss_samples",
            "peak_rss_bytes", "slo_budget_ms"}


def _spec(gen, fc):
    return gen.ScenarioSpec(
        seed=5, duration_s=8.0, base_rate=12.0, tick_s=1.0,
        gang_fraction=0.1, gang_sizes=(4,), serving_lifetime_s=10.0,
        batch_lifetime_s=5.0, gang_lifetime_s=8.0, lifetime_floor_s=2.0,
        link_burst_rate_per_s=0.3, link_burst_duration_s=5.0,
        node_churn_rate_per_s=0.05, state_fault_rate_per_s=0.2,
        chaos_seed=22, cluster=fc.ClusterSpec(num_nodes=32, seed=3))


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("replay") / "t.jsonl")
    stats = tgen.generate_trace(_spec(tgen, tfc), path)
    assert jgen.generate_trace(_spec(jgen, jfc), path + ".jax") == stats
    assert open(path, "rb").read() == open(path + ".jax", "rb").read()
    assert stats["state_faults"] > 0 and stats["link_bursts"] > 0
    return path


@pytest.fixture(scope="module")
def runs(trace):
    """mode -> (JAX result, port result); the all-knob mode's JAX
    replay runs a second time only when the port's ratio differs."""
    out = {}
    for mode, kw in MODES.items():
        j = jrep.replay_trace(trace, **{**BASE, **kw})
        t = trep.replay_trace(trace, **{**BASE, **kw}, device="cpu")
        out[mode] = (j, t)
    return out


def _counters(res) -> dict:
    return {f.name: getattr(res, f.name)
            for f in dataclasses.fields(res) if f.name not in _CLOCKED}


def test_knobs_off_places_and_counts_identically(runs):
    j, t = runs["off"]
    assert t.placements and t.pods_bound == len(t.placements)
    assert t.placements == j.placements
    assert _counters(t) == _counters(j)
    assert t.cycles == j.cycles and t.cycle_ms.count == j.cycles


def test_drift_and_state_faults_place_identically(runs):
    j, t = runs["drift_faults"]
    assert t.link_bursts_applied == j.link_bursts_applied > 0
    assert sum(t.state_faults.values()) > 0
    assert t.state_faults == j.state_faults
    assert t.placements == j.placements
    assert j.integrity["unrepaired"] == t.integrity["unrepaired"] == 0
    assert t.integrity == j.integrity
    assert t.queue_dropped == j.queue_dropped == 0


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_every_knob_on_scorecards_agree(runs, trace):
    j, t = runs["all"]
    jc, tc = jsc.build_scorecard(j), tsc.build_scorecard(t)
    assert _keys(tc) == _keys(jc)
    assert t.invariants == j.invariants
    assert all(v == 0 for v in t.invariants.values()), t.invariants
    assert t.integrity["unrepaired"] == j.integrity["unrepaired"] == 0
    assert t.rebalance_summary["half_moved_gangs"] == 0
    assert t.quality_summary is not None
    got = t.sampled_bw["realized_bw_ratio_vs_oracle"]
    want = j.sampled_bw["realized_bw_ratio_vs_oracle"]
    if got != pytest.approx(want, rel=1e-12, abs=0.0):
        # The bar holds wherever the JAX package agrees with itself.
        again = jrep.replay_trace(trace, **{**BASE, **MODES["all"]})
        assert again.sampled_bw["realized_bw_ratio_vs_oracle"] != \
            pytest.approx(want, rel=1e-12, abs=0.0), (got, want)
    assert t.sampled_bw["sampled_pods"] == j.sampled_bw["sampled_pods"]


def test_build_loop_matches_jax(trace):
    """``_build_loop``'s config, node list and network are the JAX
    harness's, and the port's loop lives on the device asked for."""
    header, _ = tgen.read_trace(trace)
    tl, tcfg, _, tnodes, tlat, tbw = trep._build_loop(
        header, 16, "parallel", chaos=False, queue_capacity=1024,
        device="cpu")
    try:
        jl, jcfg, _, jnodes, jlat, jbw = jrep._build_loop(
            header, 16, "parallel", chaos=False, queue_capacity=1024)
        jl.stop_bind_worker()
        # The port's own flight_pod_records (per-pod timelines) aside.
        tdict = dataclasses.asdict(tcfg)
        assert tdict.pop("flight_pod_records") == 16384
        assert tdict == dataclasses.asdict(jcfg)
        assert [n.name for n in tnodes] == [n.name for n in jnodes]
        assert (tlat == jlat).all() and (tbw == jbw).all()
        assert tl.encoder.device.type == "cpu"
    finally:
        tl.stop_bind_worker()
    assert dataclasses.asdict(trep.REPLAY_WEIGHTS) == dataclasses.asdict(
        jrep.REPLAY_WEIGHTS)
