"""The JAX suite's topology leg (``bench/suite.py:run_topology_config``)
run by both packages on the CPU, cut to 128 nodes, 12 probe cycles and 4
gangs: the port's topology model, EIG planner, orchestrator hooks, blend
and gang placement give the JAX package's coverage, gang bandwidths and
gain ratio exactly, and its residuals within the Adam tolerance.  Phase
``learn`` of ``chip_smoke.py`` runs the same leg on the card at 5,120
nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import encode as tencode
from kubernetesnetawarescheduler_tpu_torch.ingest import probe as tprobe
from kubernetesnetawarescheduler_tpu_torch.netmodel import model as tmodel
from kubernetesnetawarescheduler_tpu_torch.netmodel import (
    planner as tplanner,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)


def _topology_leg(num_nodes: int, cycles: int, num_gangs: int) -> dict:
    """The port's run of the JAX suite's topology leg
    (``bench/suite.py:run_topology_config``): the model fit over
    ``cycles`` planner-picked probe cycles, then ``num_gangs`` gangs of 8
    placed on the sparse, blended and oracle planes and judged against
    truth."""
    from kubernetesnetawarescheduler_tpu_torch.config import ScoreWeights
    from kubernetesnetawarescheduler_tpu_torch.core.assign import (
        assign_parallel,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.gang import (
        gang_key_of,
        mean_intra_gang_bw,
        place_gang,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.score import (
        static_node_scores,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        commit_assignments,
    )

    cfg = TCfg(max_nodes=-(-num_nodes // 128) * 128, max_pods=16,
               max_peers=4, enable_netmodel=True, netmodel_steps=36,
               weights=ScoreWeights(cpu=0.5, mem=0.5, net_tx=0.0,
                                    net_rx=0.0, bandwidth=1.0, disk=0.0,
                                    peer_bw=3.0, peer_lat=2.0, balance=0.5))
    cluster, lat, bw = tfc.build_fake_cluster(
        tfc.ClusterSpec(num_nodes=num_nodes, seed=0))
    nodes = cluster.list_nodes()
    names = [n.name for n in nodes]
    enc = tencode.Encoder(cfg, device="cpu")
    for node in nodes:
        enc.upsert_node(node)
    tfc.feed_metrics(cluster, enc, np.random.default_rng(1))
    model = tmodel.TopologyModel(cfg, seed=0, device="cpu")
    enc.attach_netmodel(model)
    planner = tplanner.EIGProbePlanner(
        model, explore_frac=cfg.netmodel_explore_frac, seed=0)
    orch = tprobe.ProbeOrchestrator(
        enc, tprobe.FakeProber(names, lat, bw, noise=0.02, seed=0), names,
        planner=planner, model=model)
    for _ in range(cycles):
        orch.run_cycle(budget=64)
        orch.advance_clock(60.0)
    by_gang: dict = {}
    for p in tfc.generate_gang_workload(num_gangs=num_gangs, member_counts=(8,),
                                        filler_pods=0, seed=0):
        by_gang.setdefault(gang_key_of(p), []).append(p)

    def judge(state) -> float:
        static = static_node_scores(state, cfg)
        st, vals = state, []
        for key in sorted(by_gang):
            members = by_gang[key]
            batch = enc.encode_pods(members, lambda n: "")
            a = place_gang(st, batch, cfg, static, assign_parallel,
                           len(members))
            st = commit_assignments(st, batch, torch.from_numpy(a))
            vals.append(mean_intra_gang_bw(bw, a[:len(members)]))
        return float(np.mean(vals))

    blended = enc.snapshot()
    model.enabled = False
    enc.touch_net()
    sparse = enc.snapshot()
    model.enabled = True
    n_pad = cfg.max_nodes
    lat_pad = np.zeros((n_pad, n_pad), np.float32)
    bw_pad = np.zeros((n_pad, n_pad), np.float32)
    lat_pad[:num_nodes, :num_nodes] = lat
    bw_pad[:num_nodes, :num_nodes] = bw
    oracle = sparse.replace(lat=torch.from_numpy(lat_pad),
                            bw=torch.from_numpy(bw_pad))
    s, b, o = judge(sparse), judge(blended), judge(oracle)
    p50, p99 = model.residual_quantiles()
    return {"coverage_fraction": orch.staleness()["coverage_fraction"],
            "sparse_bw_gbps": s / 1e9, "blended_bw_gbps": b / 1e9,
            "oracle_bw_gbps": o / 1e9,
            "gain_ratio": (b - s) / (o - s) if o > s else 1.0,
            "residual_p50": p50, "residual_p99": p99,
            "sgd_steps_total": model.steps_total}


def test_topology_leg_matches_jax():
    """The JAX suite's topology leg, cut to 128 nodes, 12 cycles and 4
    gangs: the same coverage, the same gang placements on the sparse,
    blended and oracle planes (so the same gain ratio), and residuals
    within the Adam trajectories' tolerance."""
    from kubernetesnetawarescheduler_tpu.bench.suite import (
        run_topology_config,
    )

    want = run_topology_config(num_nodes=128, cycles=12,
                               num_gangs=4).metrics["detail"]
    got = _topology_leg(128, 12, 4)
    for key in ("coverage_fraction", "sparse_bw_gbps", "blended_bw_gbps",
                "oracle_bw_gbps", "gain_ratio", "sgd_steps_total"):
        assert got[key] == want[key], key
    for key in ("residual_p50", "residual_p99"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3)
