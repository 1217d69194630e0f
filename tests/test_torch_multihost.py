"""The port's multi-process meshes (``parallel/multihost.py``) and mesh
serving, against the JAX package's ``tests/test_multihost.py``.

In-process: ``global_mesh``'s defaults, its shape validation and its
host guard (the world size and ``LOCAL_WORLD_SIZE`` faked where a case
needs more ranks than the one-rank group this process makes),
``init_multihost``'s idempotence and propagated failures, and
``serve.main --multihost`` entering the follower loop on a rank that is
not 0.  Spawned (four gloo ranks, ``tests/test_torch_sharding.py``'s
harness, no JAX): the mesh serving loop on a 2x2 mesh binds what the JAX
package's single-device loop binds, its backlog burst binds as its
per-batch cycle, and the webhook's mesh scores equal the JAX package's
unsharded priorities.  One JAX config (the JAX test's).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_sharding import spawn_world

torch.set_num_threads(1)

CFG_KW = dict(max_nodes=64, max_pods=16, max_peers=4, queue_capacity=256,
              use_bfloat16=False)
LOOP_WORK = dict(num_pods=64, seed=7)
BURST_WORK = dict(num_pods=64, seed=7, services=8, peer_fraction=0.5)


def _args(n_cand: int) -> dict:
    return {"pod": {"metadata": {"name": "mx", "uid": "mx"},
                    "spec": {"schedulerName": "netAwareScheduler",
                             "containers": [{"resources": {"requests": {
                                 "cpu": "500m", "memory": "1Gi"}}}]}},
            "nodenames": [f"node-{j:04d}" for j in range(n_cand)]}


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_default_global_mesh_covers_all_ranks(one_rank):
    from kubernetesnetawarescheduler_tpu_torch.parallel.multihost import (
        global_mesh,
    )

    mesh = global_mesh(device="cpu")
    assert mesh.size == 1 and mesh.axis_names == ("dp", "tp")
    assert mesh.shape == {"dp": 1, "tp": 1}


def test_explicit_shape_validated(one_rank):
    from kubernetesnetawarescheduler_tpu_torch.parallel.multihost import (
        global_mesh,
    )

    with pytest.raises(ValueError, match="cover all"):
        global_mesh(dp=3, tp=3, device="cpu")


@pytest.mark.parametrize("world,local,ask,want", [
    (2, None, (None, None), (2, 1)),    # the JAX tests' bootstrap
    (4, 2, (None, None), (2, 2)),       # hosts x ranks per host
    (8, 4, (None, 2), (4, 2)),
    (8, 4, (2, None), (2, 4)),
])
def test_global_mesh_defaults_to_hosts_by_ranks_per_host(
        monkeypatch, world, local, ask, want):
    """``dp`` defaults to the hosts and ``tp`` to the ranks per host
    (``LOCAL_WORLD_SIZE``; a process without it is a host of its own)."""
    import torch.distributed as dist

    from kubernetesnetawarescheduler_tpu_torch.parallel import multihost

    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    made = []
    monkeypatch.setattr(multihost, "make_mesh",
                        lambda dp, tp, device: made.append((dp, tp)))
    multihost.global_mesh(*ask, device="cpu")
    assert made == [want]


def test_tp_cross_host_guard(monkeypatch):
    """A tp group spanning hosts is refused before any group is made."""
    import torch.distributed as dist

    from kubernetesnetawarescheduler_tpu_torch.parallel import multihost

    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(multihost, "make_mesh", lambda *a, **k: 1 / 0)
    with pytest.raises(ValueError, match="spans hosts"):
        multihost.global_mesh(dp=1, tp=2, device="cpu")


def test_init_multihost_is_idempotent_and_failures_propagate(monkeypatch):
    """A second init is a no-op (``dist.is_initialized()``); a genuine
    failure re-raises, even when its message says 'already', and a bad
    bootstrap raises before contacting anything."""
    import torch.distributed as dist

    from kubernetesnetawarescheduler_tpu_torch.parallel import multihost

    def boom(*a, **k):
        raise AssertionError("called")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", boom)
    multihost.init_multihost("127.0.0.1:1", 2, 0, backend="gloo")

    def in_use(*a, **k):
        raise RuntimeError("bind failed: Address already in use")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "TCPStore", lambda *a, **k: object())
    monkeypatch.setattr(dist, "init_process_group", in_use)
    with pytest.raises(RuntimeError, match="in use"):
        multihost.init_multihost("127.0.0.1:1", 2, 0, backend="gloo")
    for bad in (("127.0.0.1", 2, 0), ("127.0.0.1:1", None, 0),
                ("127.0.0.1:1", 2, 2)):
        with pytest.raises(ValueError):
            multihost.init_multihost(*bad, backend="gloo")


def test_backend_rule_needs_a_card_per_rank(monkeypatch):
    from kubernetesnetawarescheduler_tpu_torch.parallel import multihost

    assert multihost.default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert multihost.default_backend("cuda") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert multihost.default_backend("cuda") == "gloo"


def test_serving_dispatches_follower_on_non_zero_rank(monkeypatch,
                                                      tmp_path):
    """``--multihost`` on a rank other than 0 runs the follower loop (no
    control plane); the controller and the real two-process protocol are
    in ``tests/test_torch_serve_multihost.py``."""
    import types

    from kubernetesnetawarescheduler_tpu_torch import serve
    from kubernetesnetawarescheduler_tpu_torch.parallel import serve_multihost

    mesh = types.SimpleNamespace(rank=1, size=2)
    monkeypatch.setattr(serve, "_join_mesh", lambda args, dev: (mesh, False))
    calls = {}

    def fake_follower(cfg, m, method="parallel", max_steps=None):
        calls["mesh"] = m
        return 0

    monkeypatch.setattr(serve_multihost, "run_follower", fake_follower)
    rc = serve.main(["--cluster", "fake:16", "--once", "--multihost",
                     "--device", "cpu", "--uds", str(tmp_path / "f.sock")])
    assert rc == 0
    assert calls["mesh"] is mesh
    assert not (tmp_path / "f.sock").exists()


# ---------------------------------------------------------------------------
# Mesh serving on four ranks.
# ---------------------------------------------------------------------------


def _serving_rank(rank: int, world: int, data: dict) -> dict:
    from kubernetesnetawarescheduler_tpu_torch.api.extender import (
        ExtenderHandlers,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as fc
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.parallel.sharding import (
        make_mesh,
    )

    cfg = SchedulerConfig(**data["cfg"])
    mesh = make_mesh(2, 2, device="cpu")
    out = {}
    for label, bb, work in (("loop", 1, data["loop_work"]),
                            ("per_batch", 1, data["burst_work"]),
                            ("burst", 4, data["burst_work"])):
        cluster, lat, bw = fc.build_fake_cluster(
            fc.ClusterSpec(num_nodes=48, seed=5))
        loop = SchedulerLoop(cluster, cfg, mesh=mesh, burst_batches=bb,
                             device="cpu")
        try:
            loop.encoder.set_network(lat, bw)
            fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(6))
            cluster.add_pods(fc.generate_workload(
                fc.WorkloadSpec(**work), scheduler_name=cfg.scheduler_name))
            loop.run_until_drained()
            out[label] = ({b.pod_name: b.node_name
                           for b in cluster.bindings}, loop.burst_cycles,
                          len(loop.round_samples))
        finally:
            loop.stop_bind_worker()
    for n_cand in (48, 9):
        cluster, lat, bw = fc.build_fake_cluster(
            fc.ClusterSpec(num_nodes=48, seed=11))
        loop = SchedulerLoop(cluster, cfg, mesh=mesh, device="cpu")
        handlers = ExtenderHandlers(loop)
        try:
            loop.encoder.set_network(lat, bw)
            fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(12))
            out[f"prioritize_{n_cand}"] = handlers.prioritize(_args(n_cand))
        finally:
            handlers.close()
            loop.stop_bind_worker()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from kubernetesnetawarescheduler_tpu.api.extender import (
        ExtenderHandlers,
    )
    from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
    from kubernetesnetawarescheduler_tpu.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu.core.loop import SchedulerLoop

    cfg = SchedulerConfig(**CFG_KW)
    want = {}
    for label, work in (("loop", LOOP_WORK), ("burst", BURST_WORK)):
        cluster, lat, bw = jfc.build_fake_cluster(
            jfc.ClusterSpec(num_nodes=48, seed=5))
        loop = SchedulerLoop(cluster, cfg, burst_batches=1)
        loop.encoder.set_network(lat, bw)
        jfc.feed_metrics(cluster, loop.encoder, np.random.default_rng(6))
        cluster.add_pods(jfc.generate_workload(
            jfc.WorkloadSpec(**work), scheduler_name=cfg.scheduler_name))
        loop.run_until_drained()
        want[label] = {b.pod_name: b.node_name for b in cluster.bindings}
    for n_cand in (48, 9):
        cluster, lat, bw = jfc.build_fake_cluster(
            jfc.ClusterSpec(num_nodes=48, seed=11))
        loop = SchedulerLoop(cluster, cfg)
        loop.encoder.set_network(lat, bw)
        jfc.feed_metrics(cluster, loop.encoder, np.random.default_rng(12))
        want[f"prioritize_{n_cand}"] = ExtenderHandlers(loop).prioritize(
            _args(n_cand))
    got = spawn_world(tmp_path_factory.mktemp("serving"), 4,
                      "tests.test_torch_multihost", "_serving_rank",
                      {"cfg": CFG_KW, "loop_work": LOOP_WORK,
                       "burst_work": BURST_WORK})
    return want, got


def test_mesh_serving_loop_matches_unsharded_jax(served):
    want, got = served
    for res in got:
        assert res["loop"][0] == want["loop"] and want["loop"]


def test_mesh_burst_matches_mesh_per_batch(served):
    """The mesh loop's backlog burst (the sharded replay) binds as its
    per-batch cycle and as the JAX package's loop, the burst engaged,
    and its rounds reach the loop's samples."""
    want, got = served
    for res in got:
        assert res["burst"][1] > 0 and res["per_batch"][1] == 0
        assert res["burst"][0] == res["per_batch"][0] == want["burst"]
        assert res["burst"][2] >= 2


@pytest.mark.parametrize("n_cand", [48, 9])
def test_mesh_extender_scoring_matches_unsharded_jax(served, n_cand):
    """The webhook under a mesh (the sharded dense score: node axis over
    tp, the wave whole) gives the JAX package's unsharded priorities, on
    a full candidate list and on a narrow one (the candidate gather)."""
    want, got = served
    key = f"prioritize_{n_cand}"
    assert any(h["score"] for h in want[key])
    assert len(want[key]) == n_cand
    for res in got:
        assert res[key] == want[key]
