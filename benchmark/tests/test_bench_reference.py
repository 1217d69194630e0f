"""The reference against the port, and the control against the
reference, at a size the CPU holds."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, run
from benchmark.tests.conftest import cell, tiny_config

CELLS = ("k8s5000-standalone.saturation", "k8s5000-standalone.latency-pods")


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(tiny, name):
    root, bench = tiny
    out = run.measure(bench, cell(bench, name), 2**31 + 7, 1.5, False,
                      "cpu", time.perf_counter(), root=root)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["bind_faults"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    """The reference one precision below the configuration (float8
    network operands, a bfloat16 ledger) fails the cell's limits."""
    root, bench = tiny
    w = cell(bench, name)
    traffic = run.load_json(root / "benchmark" / "traffic"
                            / f"{w['traffic']}.json")
    limits = run.load_json(root / "benchmark" / "limits" / f"{name}.json")
    out = control.control(tiny_config(), traffic, limits, 11, 2048
                          if traffic["arrivals"] == "backlog" else 400,
                          "cpu")
    assert not out["correct"], out["checks"]


def test_reference_in_full_precision_is_exact(tiny):
    """The reference placing pods itself in float64 reads a gap of 0."""
    root, bench = tiny
    traffic = run.load_json(root / "benchmark" / "traffic"
                            / "saturation.json")
    out = control.control(tiny_config(), traffic,
                          {"score_gap": 0.0, "ledger_gap": 0.0,
                           "bind_faults": 0}, 3, 1024, "cpu",
                          net_dtype=torch.float64, dtype=torch.float64)
    assert out["correct"], out["checks"]
