"""The port's multicycle measurements in ``bench/density.py`` against the
JAX package's: ``multicycle_identity_check`` (the K-wave window with
coalesced async binds places every pod where the per-cycle path does)
is true in both packages with the same report, and
``measure_multicycle_latency`` reports the JAX function's keys.  The
shapes are ``tests/test_replay_feed.py``'s cluster (96 nodes,
``max_nodes=128``, ``max_pods=16``) with K=2.
"""

from __future__ import annotations

import torch

from kubernetesnetawarescheduler_tpu.bench import density as jdensity
from kubernetesnetawarescheduler_tpu_torch.bench import density as tdensity

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

NODES = 96


def test_multicycle_identity_check_in_both_packages():
    kw = dict(num_nodes=NODES, batch_size=16, k=2, num_pods=64)
    j = jdensity.multicycle_identity_check(**kw)
    t = tdensity.multicycle_identity_check(**kw, device="cpu")
    assert j["identical"] and t["identical"]
    assert {k: v for k, v in t.items()} == j


def test_measure_multicycle_latency_reports_the_jax_keys():
    out = tdensity.measure_multicycle_latency(NODES, 16, k=2, reps=2,
                                              score_backend="xla",
                                              device="cpu")
    jax_keys = {"p50_ms", "p99_ms", "max_ms", "reps", "multicycle_k",
                "num_nodes", "batch_size", "score_backend", "backend",
                "p99_source"}
    assert jax_keys <= set(out)
    assert out["p99_source"] == "device_boundary_multicycle"
    assert out["reps"] == 2 and out["multicycle_k"] == 2
    assert 0 < out["p50_ms"] <= out["p99_ms"] <= out["max_ms"]
    assert out["backend"] == "cpu"
