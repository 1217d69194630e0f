"""The bench suite's constraint and gang audits: the port against the
JAX package on the CPU.

Each leg (soft_affinity, spread, zone_affinity, gang) runs once per
package at the JAX suite's ``SMALL`` shape from the same seed, through
the helpers of ``test_torch_suite_baseline.py``: the same bindings in
every fake cluster the leg builds (the gang leg's gang-aware, baseline
and gate-overhead clusters included), every metric that is not a clock
equal, the audit JSONs byte-identical once the clock keys are dropped,
and no thread left running.  soft_affinity also runs with ``deep=True``
at 32 nodes, 64 pods and batch 16: the trade analysis (the port calls
``score_pods`` and ``assign_greedy`` eagerly where JAX jits them), the
weight and batch sweeps and the derived conclusion equal JAX's, the
margins within the 2-decimal rounding of scores held at 1e-4.  The
start-of-drain free capacity each audit is measured against equals the
JAX value.  The gang leg runs at ``SMALL`` (≈27 s of JAX compiles on the
CPU, no less below it); the file passes in ≈100 s alone, ≈44 s of it the
JAX deep pass compiling its seven weight and batch configurations.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_suite_baseline import (
    JAX,
    TORCH,
    check_artifacts,
    check_bindings,
    drop_clocks,
    mismatches,
    run_leg,
)

torch.set_num_threads(1)

LEGS = ("soft_affinity", "spread", "zone_affinity", "gang")

#: Deep soft-affinity shape: small enough for the sequential pass.
DEEP = dict(num_nodes=32, num_pods=64, batch=16, deep=True)

#: Values rounded to 2 decimals from scores held at 1e-4.
MARGINS = {"sequential_margin_p50": 0.011, "sequential_margin_p90": 0.011,
           "sequential_zone_bonus_mean": 0.011}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache: dict = {}

    def get(pkg, name: str, **overrides):
        key = (pkg.name, name, tuple(sorted(overrides.items())))
        if key not in cache:
            out = tmp_path_factory.mktemp(f"{pkg.name}_{name}")
            cache[key] = run_leg(pkg, name, out, **overrides)
        return cache[key]

    return get


@pytest.mark.parametrize("name", LEGS)
def test_leg_binds_as_the_jax_leg(runs, name):
    check_bindings(runs(JAX, name), runs(TORCH, name))


@pytest.mark.parametrize("name", LEGS)
def test_leg_metrics_equal_the_jax_legs(runs, name):
    j, t = runs(JAX, name), runs(TORCH, name)
    assert t.result.config == j.result.config == name
    assert mismatches(drop_clocks(j.result.metrics),
                      drop_clocks(t.result.metrics), name) == []
    assert sorted(t.result.metrics) == sorted(j.result.metrics)


@pytest.mark.parametrize("name", LEGS)
def test_leg_artifacts_match_the_jax_legs(runs, name):
    check_artifacts(runs(JAX, name), runs(TORCH, name))


def test_audit_bars_hold_at_small(runs):
    """The JAX suite tests' bars and the gang docstring's, on the
    port's legs."""
    m = {n: runs(TORCH, n).result.metrics for n in LEGS}
    soft = m["soft_affinity"]
    assert soft["pods_bound"] > 0 and soft["violations_total"] == 0
    assert soft["zone_pref_rate"] > 0.6
    assert soft["spread_colocation"] <= soft["spread_colocation_control"]
    assert soft["zone_pref_vs_optimum"] >= 0.6
    assert m["spread"]["hard_spread_groups"] > 0
    assert m["spread"]["skew_violations"] == 0
    zone = m["zone_affinity"]
    assert min(zone["zone_aff_pods"], zone["zone_anti_pods"],
               zone["node_affinity_pods"]) > 0
    assert zone["violations_total"] == 0
    gang = m["gang"]
    assert gang["gangs_partially_bound"] == 0
    assert gang["gangs_fully_bound"] == gang["gangs_submitted"] > 0
    assert gang["gang_bw_strictly_higher"]
    assert gang["gate_overhead_ratio"] > 0
    assert gang["bench_env"]["platform"] == "cpu"


def test_deep_soft_affinity_trade_analysis_equals_jax(runs):
    j = runs(JAX, "soft_affinity", **DEEP)
    t = runs(TORCH, "soft_affinity", **DEEP)
    check_bindings(j, t)
    jm, tm = j.result.metrics, t.result.metrics
    trade = tm["zone_pref_trade"]
    assert trade["sequential_placed_prefer"] > 0
    assert mismatches(jm["zone_pref_trade"], trade, "trade",
                      MARGINS) == []
    assert tm["zone_pref_conclusion"] == jm["zone_pref_conclusion"]
    assert [e["batch"] for e in tm["zone_pref_batch_sweep"]] == [8, 32, 16]
    assert len(tm["zone_pref_weight_sweep"]) == 5
    assert all(e["violations_total"] == 0
               for e in tm["zone_pref_weight_sweep"])
    rest = {k: v for k, v in tm.items() if k != "zone_pref_trade"}
    jrest = {k: v for k, v in jm.items() if k != "zone_pref_trade"}
    assert mismatches(drop_clocks(jrest), drop_clocks(rest), "deep") == []
    check_artifacts(j, t)


def test_start_of_drain_free_capacity_equals_jax(runs):
    for overrides in ({}, DEEP):
        j = runs(JAX, "soft_affinity", **overrides)
        t = runs(TORCH, "soft_affinity", **overrides)
        # The default drain, then (deep) four weight points and three
        # batch sizes.
        assert len(t.free0) == len(j.free0) == (8 if overrides else 1)
        for a, b in zip(j.free0, t.free0):
            assert b.dtype == np.float32 and b.shape == a.shape
            assert np.array_equal(a, b)
            assert (b >= 0).all() and b.any()
