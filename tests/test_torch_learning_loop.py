"""The scheduling loop with all four learning layers on (placement
quality, SLOs, the learned policy in shadow, the topology model with its
EIG planner), against the JAX package's, on the CPU.

A serial and a burst drive on ``tests/test_torch_explain_loop.py``'s
shapes (24 nodes, ``max_nodes=32``, ``max_pods=16``, a 32-pod backlog in
arrival waves of 16 with a ``maintain()`` after each): the topology
model is fit on three probe cycles first and blends the net planes.
The port's ``"xla"`` and ``"pallas"`` drives are both held against the
JAX ``"xla"`` drive, because the JAX loop's explain records nothing
under ``"pallas"`` (ROADMAP Queue C item 3), so its policy would get no
examples there.  Bindings, quality outcomes (rtol 1e-5), the policy's
steps, version and examples, the model's steps, the ``/metrics`` family
names and the ``/debug/slo`` and ``/debug/policy`` keys agree.  The
daemon accepts the layers' flags and ``--policy-eval-trace``.  A
device fault in a learning tick or at the commit
seam propagates; a host error is swallowed as in the JAX loop.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.api import extender as jext
from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.ingest import probe as jprobe
from kubernetesnetawarescheduler_tpu.netmodel import (
    EIGProbePlanner as JPlanner,
)
from kubernetesnetawarescheduler_tpu.netmodel import (
    TopologyModel as JModel,
)
from kubernetesnetawarescheduler_tpu.utils import selfmetrics as jsm
from kubernetesnetawarescheduler_tpu_torch import serve
from kubernetesnetawarescheduler_tpu_torch.api import extender as text
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.ingest import probe as tprobe
from kubernetesnetawarescheduler_tpu_torch.netmodel import (
    EIGProbePlanner as TPlanner,
)
from kubernetesnetawarescheduler_tpu_torch.netmodel import (
    TopologyModel as TModel,
)
from kubernetesnetawarescheduler_tpu_torch.utils import selfmetrics as tsm

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(
    fc=jfc, cfg=JCfg, loop=jloop.SchedulerLoop, ext=jext, sm=jsm,
    probe=jprobe, planner=JPlanner, kw={},
    model=lambda cfg, enc: JModel(cfg, seed=3))
TORCH = types.SimpleNamespace(
    fc=tfc, cfg=TCfg, loop=tloop.SchedulerLoop, ext=text, sm=tsm,
    probe=tprobe, planner=TPlanner, kw={"device": "cpu"},
    model=lambda cfg, enc: TModel(cfg, seed=3, device=enc.device))

LEARN = dict(max_nodes=32, max_pods=16, max_peers=4, queue_capacity=4096,
             use_bfloat16=False, enable_explain=True,
             enable_quality_obs=True, enable_slo=True,
             enable_learned_score=True, enable_netmodel=True,
             quality_harvest_interval_s=1e-6, slo_eval_interval_s=1e-6,
             policy_train_interval_s=1e-6, policy_eval_interval_s=1e-6,
             policy_ring=256, policy_batch=32, policy_steps=2,
             policy_min_examples=8, netmodel_ring=4096,
             netmodel_batch=128)
WL = dict(num_pods=32, seed=7, services=8, peer_fraction=0.6,
          affinity_fraction=0.1, anti_fraction=0.1)
PATHS = {"serial": dict(burst_batches=1), "burst": dict(burst_batches=2)}
FLOAT_KEYS = ("realized_lat_ms", "realized_bw_bps", "net_score",
              "best_net_score", "regret", "bw_residual_log1p",
              "lat_residual_ms")


def _drive(pkg, path: str, backend: str = "xla"):
    cfg = pkg.cfg(**LEARN, score_backend=backend)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=24, seed=3))
    loop = pkg.loop(cluster, cfg, method="parallel", **PATHS[path],
                    **pkg.kw)
    _LOOPS.append(loop)
    enc = loop.encoder
    enc.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, enc, np.random.default_rng(4))
    names = [n.name for n in cluster.list_nodes()]
    model = pkg.model(cfg, enc)
    enc.attach_netmodel(model)
    planner = pkg.planner(model, explore_frac=cfg.netmodel_explore_frac,
                          seed=3)
    loop.probe_planner = planner
    orch = pkg.probe.ProbeOrchestrator(
        enc, pkg.probe.FakeProber(names, lat, bw, seed=3), names,
        planner=planner, model=model)
    loop.probe_orchestrator = orch
    for _ in range(3):
        orch.run_cycle(budget=24)
        orch.advance_clock(60.0)
    pods = pkg.fc.generate_workload(pkg.fc.WorkloadSpec(**WL),
                                    scheduler_name=cfg.scheduler_name)
    for start in range(0, len(pods), 16):
        cluster.add_pods(pods[start:start + 16])
        loop.run_once()
        loop.maintain()
    loop.run_until_drained()
    loop.flush_binds()
    loop.maintain()
    handlers = pkg.ext.ExtenderHandlers(loop)
    try:
        slo = json.loads(handlers.handle("/debug/slo", b""))
        policy = json.loads(handlers.handle("/debug/policy", b""))
    finally:
        handlers.close()
    names_of = {p.uid: f"{p.namespace}/{p.name}" for p in pods}
    body = pkg.sm.render_metrics(loop)
    pol = loop.policy
    return {
        "bindings": {b.pod_name: b.node_name for b in cluster.bindings},
        "outcomes": {names_of[o["pod_uid"]]: o
                     for o in loop.quality.outcomes()},
        "quality": {k: v for k, v in loop.quality.summary().items()
                    if not k.endswith(("_p50", "_p99"))},
        "policy": (pol.steps_total, pol.version, pol.examples_total,
                   pol.evals_total, pol.rejections_total,
                   pol.promotions_total,
                   pol.shadow_agree_total + pol.shadow_disagreement_total),
        "netmodel": (model.steps_total, model.fits_total,
                     model.pairs_observed),
        # The port has no donation-skip counter (torch donates no
        # buffers; tests/test_torch_api.py pins the difference).
        "families": sorted(ln.split()[2] for ln in body.splitlines()
                           if ln.startswith("# TYPE ")
                           and "netaware_donation_skipped_total" not in ln),
        "slo_keys": (sorted(slo), sorted(slo["slo"]),
                     sorted(slo["slo"]["objectives"]),
                     sorted(slo["quality"])),
        "policy_keys": sorted(policy),
        "slo_evals": loop.slo.evaluations_total,
        "explains": len(loop.flight.explains()),
        "provenance": {r["provenance"]["network"]
                       for r in loop.flight.explains()},
    }


def _assert_drives(got: dict, want: dict) -> None:
    assert got["bindings"] == want["bindings"] and got["bindings"]
    assert got["outcomes"].keys() == want["outcomes"].keys()
    assert got["outcomes"]
    for name, w in want["outcomes"].items():
        g = got["outcomes"][name]
        assert g["node"] == w["node"]
        assert g["peer_samples"] == w["peer_samples"]
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
        np.testing.assert_allclose(g["score_pred"], w["score_pred"],
                                   rtol=1e-4, atol=1e-4)
    for key in ("quality", "policy", "netmodel", "families", "slo_keys",
                "policy_keys", "slo_evals", "explains", "provenance"):
        assert got[key] == want[key], key
    assert got["policy"][0] > 0 and got["netmodel"][0] > 0
    assert got["provenance"] == {"netmodel_blend"}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_learning_layers_drive_matches_jax(path):
    want = _drive(JAX, path)
    for backend in ("xla", "pallas"):
        _assert_drives(_drive(TORCH, path, backend), want)


def test_daemon_accepts_the_learning_flags(tmp_path, capsys):
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps({"enable_netmodel": True,
                                "enable_explain": True}))
    argv = ["--cluster", "fake:16", "--uds", str(tmp_path / "s.sock"),
            "--device", "cpu", "--config", str(cfgp), "--quality-obs",
            "--slo", "--learned-score", "--once"]
    assert serve.main(argv) == 0
    err = capsys.readouterr().err
    assert "netmodel enabled" in err and "quality observer enabled" in err
    assert "slo engine enabled" in err and "learned scoring" in err


def test_daemon_refuses_the_policy_eval_trace(tmp_path, capsys):
    """The gate's replay leg is ported (ROADMAP item 14): the daemon
    starts with ``--policy-eval-trace`` and without the shadow-only
    WARN."""
    argv = ["--cluster", "fake:16", "--uds", str(tmp_path / "s.sock"),
            "--device", "cpu", "--learned-score", "--policy-eval-trace",
            "trace.jsonl", "--once"]
    assert serve.main(argv) == 0
    err = capsys.readouterr().err
    assert "ROADMAP Queue A item 14" not in err
    assert "learned scoring policy enabled" in err
    assert "NEVER be promoted" not in err


def _cuda_fault(*_a, **_k):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def _host_fault(*_a, **_k):
    raise ValueError("a host-side error")


@pytest.mark.parametrize("site", ["harvest", "train", "note_commit"])
def test_device_fault_in_a_learning_layer_propagates(site, monkeypatch):
    cfg = TCfg(**LEARN)
    cluster, lat, bw = tfc.build_fake_cluster(
        tfc.ClusterSpec(num_nodes=12, seed=2))
    loop = tloop.SchedulerLoop(cluster, cfg, device="cpu")
    _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pods = tfc.generate_workload(tfc.WorkloadSpec(
        num_pods=8, seed=1, services=2, peer_fraction=1.0))
    target = {"harvest": loop.quality, "train": loop.policy,
              "note_commit": loop.quality}[site]
    cluster.add_pods(pods[:4])
    loop.run_once()
    # A host error is swallowed, as the JAX loop swallows it ...
    monkeypatch.setattr(target, site, _host_fault)
    loop.maintain()
    cluster.add_pods(pods[4:6])
    loop.run_once()
    # ... a fault of the device is not.
    monkeypatch.setattr(target, site, _cuda_fault)
    with pytest.raises(RuntimeError, match="CUDA"):
        if site == "note_commit":
            cluster.add_pods(pods[6:])
            loop.run_once()
        else:
            loop.maintain()
