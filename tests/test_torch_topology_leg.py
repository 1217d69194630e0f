"""The suite's topology leg (``bench/suite.py:run_topology_config``) run
by both packages on the CPU, cut to 128 nodes, 12 probe cycles and 4
gangs: the port's topology model, EIG planner, orchestrator hooks, blend
and gang placement give the JAX package's coverage, gang bandwidths and
gain ratio exactly, and its residuals within the Adam tolerance.  Phase
``learn`` of ``chip_smoke.py`` runs the same leg's steps on the card at
5,120 nodes, and phase ``suite`` runs the leg itself at its 1,024 nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.bench.suite import (
    run_topology_config,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)


def test_topology_leg_matches_jax():
    """The JAX suite's topology leg, cut to 128 nodes, 12 cycles and 4
    gangs: the same coverage, the same gang placements on the sparse,
    blended and oracle planes (so the same gain ratio), and residuals
    within the Adam trajectories' tolerance."""
    from kubernetesnetawarescheduler_tpu.bench import suite as jsuite

    want = jsuite.run_topology_config(num_nodes=128, cycles=12,
                                      num_gangs=4).metrics["detail"]
    got = run_topology_config(num_nodes=128, cycles=12, num_gangs=4,
                              device="cpu").metrics["detail"]
    for key in ("coverage_fraction", "sparse_bw_gbps", "blended_bw_gbps",
                "oracle_bw_gbps", "gain_ratio", "sgd_steps_total"):
        assert got[key] == want[key], key
    for key in ("residual_p50", "residual_p99"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3)
