"""The bench suite's five layer legs: the port against the JAX package on
the CPU.

Each leg (topology, integrity, quality, rebalance, reshape) runs once per
package at the JAX suite's ``SMALL`` shape from the same seed, through
the helpers of ``test_torch_suite_baseline.py``: every fake cluster a leg
builds (warm-up loops included) makes the same bindings in the same
order, every metric that is not a clock is equal (the quality leg's
regret and residual percentiles within rtol 1e-5, the topology leg's
residuals within rtol 1e-4: the Adam trajectories sum in another order),
the artifact has the JAX file name and key set, the repository's
``tools/bench_check.py`` gives both artifacts the same failures, and no
thread outlives a leg.

The rebalancer's hysteresis reads ``time.monotonic`` (60 s minimum age):
each leg here runs in a few seconds, so its control ticks come well
inside that window in both packages.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from tests.test_torch_suite_baseline import (
    JAX,
    TORCH,
    check_bindings,
    mismatches,
    run_leg,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_TOOL = REPO / "tools" / "bench_check.py"
_spec = importlib.util.spec_from_file_location("bench_check", _TOOL)
bench_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_check)

LEGS = ("topology", "integrity", "quality", "rebalance", "reshape")

#: Each leg's values read off a clock (or the host), excluded from
#: parity.
CLOCKS = {
    "topology": {"bench_env"},
    "integrity": {"value", "audit_ms_p50", "audit_ms_p99",
                  "cycle_ms_p50_unaudited", "cycle_ms_p50",
                  "overhead_fraction", "audit_per_cycle_fraction",
                  "overhead_under_5pct", "bench_env"},
    "quality": {"value", "cycle_ms_p50_off", "cycle_ms_p50_on",
                "overhead_fraction", "overhead_under_2pct",
                "harvest_ms_p50", "harvest_ms_p99", "bench_env"},
    "rebalance": {"scan_ms_p50", "scan_ms_max", "bench_env"},
    "reshape": {"scan_ms_p50", "scan_ms_max", "bench_env"},
}

#: Relative tolerances of float32 sums taken in another order.
RTOL = {
    "topology": dict.fromkeys(("residual_p50", "residual_p99"), 1e-4),
    "quality": dict.fromkeys(
        ("regret_p50_clean", "regret_p99_clean", "bw_residual_p99_clean",
         "regret_p50", "regret_p99", "bw_residual_p50",
         "bw_residual_p99"), 1e-5),
}

ARTIFACT = {"topology": "topology.json", "integrity": "integrity.json",
            "quality": "quality.json", "rebalance": "rebalance.json",
            "reshape": "reshape.json"}


def drop(name: str, x):
    if isinstance(x, dict):
        return {k: drop(name, v) for k, v in x.items()
                if k not in CLOCKS[name]}
    return x


def tolerances(name: str, want: dict) -> dict:
    """Absolute tolerances from ``RTOL`` at ``want``'s values."""
    detail = want["detail"]
    return {k: r * abs(detail[k]) for k, r in RTOL.get(name, {}).items()}


def key_paths(x, path: str = "") -> set:
    if isinstance(x, dict):
        out = set()
        for k, v in x.items():
            out |= {f"{path}.{k}"} | key_paths(v, f"{path}.{k}")
        return out
    return set()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache: dict = {}

    def get(pkg, name: str):
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
    want, got = j.result.metrics, t.result.metrics
    assert mismatches(drop(name, want), drop(name, got), name,
                      tolerances(name, want)) == []
    assert key_paths(got) == key_paths(want)


@pytest.mark.parametrize("name", LEGS)
def test_leg_artifact_matches_the_jax_leg(runs, name):
    j, t = runs(JAX, name), runs(TORCH, name)
    assert [Path(p).name for p in j.result.artifacts] == [ARTIFACT[name]]
    assert t.result.artifacts == [str(t.out_dir / ARTIFACT[name])]
    docs = [json.loads((r.out_dir / ARTIFACT[name]).read_text())
            for r in (j, t)]
    assert key_paths(docs[1]) == key_paths(docs[0])
    assert mismatches(drop(name, docs[0]), drop(name, docs[1]), name,
                      tolerances(name, docs[0])) == []
    assert docs[1]["detail"]["bench_env"]["platform"] == "cpu"


@pytest.mark.parametrize("name", LEGS)
def test_bench_check_gives_both_artifacts_the_same_failures(runs, name):
    fails = [bench_check.check_doc(ARTIFACT[name], json.loads(
        (r.out_dir / ARTIFACT[name]).read_text()))
        for r in (runs(JAX, name), runs(TORCH, name))]
    assert fails[1] == fails[0]


def test_layer_bars_hold_at_small(runs):
    """The bars the card run checks, on the port's legs at ``SMALL``."""
    d = {n: runs(TORCH, n).result.metrics["detail"] for n in LEGS}
    integ = d["integrity"]
    assert integ["all_faults_detected"] and integ["unrepaired_drift"] == 0
    assert integ["clean_run_bit_identical"]
    assert d["quality"]["bit_identical"] and d["quality"]["drift_detected"]
    reb = d["rebalance"]
    assert reb["no_drift_bit_identical"] and reb["no_drift_moves"] == 0
    assert reb["half_moved_gangs"] == 0
    assert reb["evictions_per_pod_hour"] <= reb["budget_per_pod_hour"]
    resh = d["reshape"]["reshape"]
    assert resh["half_shaped_gangs"] == 0 and resh["no_outage_identical"]
    assert resh["no_outage_reshapes"] == 0
    topo = d["topology"]
    assert topo["pairs_probed"] > 0
    assert topo["sgd_steps_total"] == topo["cycles"] * 36
