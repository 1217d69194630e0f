"""Two-process multi-rank serving of the port (``parallel/
serve_multihost.py``), against ``tests/test_serve_multihost.py``.

A controller and a follower (separate interpreters with no JAX, a gloo
group, the CPU): the follower joins every sharded step, the controller's
bindings equal the JAX package's unsharded loop's on the same cycles, a
metrics ingest between the cycles re-sends the topology leaves, and
``OP_STOP`` releases the follower.  Then ``serve.main --multihost`` on
two processes bootstrapped over a TCP store on 127.0.0.1: rank 0 serves
one cycle as the controller and stops the follower from its shutdown.
One JAX config (the JAX test's).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tests.test_torch_sharding import spawn_world

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG_KW = dict(max_nodes=32, max_pods=8, max_peers=2, use_bfloat16=False)
CYCLES = 2


def _cycles(loop, cluster, feed_metrics, work, gen, cfg) -> int:
    """The JAX test's drive: 12 pods, two cycles of a batch, a metrics
    ingest after each (a new static version, so the next cycle's
    snapshot holds fresh topology leaves)."""
    cluster.add_pods(work)
    total = 0
    for cycle in range(CYCLES):
        pods = loop.queue.pop_batch(cfg.max_pods, timeout=0.0)
        if not pods:
            break
        total += loop.schedule_pods(pods)
        feed_metrics(cluster, loop.encoder, gen(42 + cycle))
    return total


def _pair_rank(rank: int, world: int, data: dict) -> dict:
    from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as fc
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.parallel import serve_multihost
    from kubernetesnetawarescheduler_tpu_torch.parallel.multihost import (
        global_mesh,
    )

    cfg = SchedulerConfig(**data["cfg"])
    mesh = global_mesh(device="cpu")
    if rank != 0:
        return {"shape": mesh.shape,
                "steps": serve_multihost.run_follower(cfg, mesh)}
    cluster, lat, bw = fc.build_fake_cluster(fc.ClusterSpec(num_nodes=24,
                                                            seed=0))
    loop = SchedulerLoop(cluster, cfg, method="parallel", mesh=mesh,
                         device="cpu")
    try:
        loop.encoder.set_network(lat, bw)
        fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(1))
        ctl = serve_multihost.install_controller(loop, cfg, mesh)
        assert loop.sharded_score is None and loop.burst_batches == 1
        work = fc.generate_workload(fc.WorkloadSpec(num_pods=12, seed=2),
                                    scheduler_name=cfg.scheduler_name)
        bound = _cycles(loop, cluster, fc.feed_metrics, work,
                        np.random.default_rng, cfg)
        ctl.stop()
    finally:
        loop.stop_bind_worker()
    return {"shape": mesh.shape, "bound": bound, "big_syncs": ctl.big_syncs,
            "big_sent": ctl.big_sent,
            "binds": {b.pod_name: b.node_name for b in cluster.bindings}}


def test_two_process_controller_follower(tmp_path):
    from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
    from kubernetesnetawarescheduler_tpu.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu.core.loop import SchedulerLoop

    cfg = SchedulerConfig(**CFG_KW)
    cluster, lat, bw = jfc.build_fake_cluster(jfc.ClusterSpec(num_nodes=24,
                                                              seed=0))
    loop = SchedulerLoop(cluster, cfg, method="parallel")
    loop.encoder.set_network(lat, bw)
    jfc.feed_metrics(cluster, loop.encoder, np.random.default_rng(1))
    work = jfc.generate_workload(jfc.WorkloadSpec(num_pods=12, seed=2),
                                 scheduler_name=cfg.scheduler_name)
    want_bound = _cycles(loop, cluster, jfc.feed_metrics, work,
                         np.random.default_rng, cfg)
    want = {b.pod_name: b.node_name for b in cluster.bindings}

    ctl, fol = spawn_world(tmp_path, 2, "tests.test_torch_serve_multihost",
                           "_pair_rank", {"cfg": CFG_KW})
    # Each process is a host of its own (no torchrun): the mesh is 2x1.
    assert ctl["shape"] == fol["shape"] == {"dp": 2, "tp": 1}
    assert ctl["bound"] == want_bound == 12
    assert ctl["binds"] == want
    assert fol["steps"] == CYCLES
    # The first cycle sends every topology leaf; the metrics ingest
    # before the second re-sends the metric columns, not the N×N planes.
    assert ctl["big_syncs"] == CYCLES
    assert ctl["big_sent"]["lat"] == ctl["big_sent"]["bw"] == 1
    assert ctl["big_sent"]["metrics"] == CYCLES


_SERVE_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["kubernetesnetawarescheduler_tpu"] = None
import torch
torch.set_num_threads(1)
from kubernetesnetawarescheduler_tpu_torch import serve
pid, port, sock = sys.argv[1], sys.argv[2], sys.argv[3]
rc = serve.main([
    "--cluster", "fake:16", "--once", "--device", "cpu",
    "--uds", sock, "--probe-period-s", "0",
    "--multihost", "--coordinator", f"127.0.0.1:{port}",
    "--num-processes", "2", "--process-id", pid,
])
import torch.distributed as dist
print(f"SERVE_RC={rc or 0} GROUP_LEFT={dist.is_initialized()}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_main_two_process_wiring(tmp_path):
    """``serve.main --multihost`` on two processes: rank 0 builds the
    daemon, installs the controller, serves one cycle and broadcasts
    ``OP_STOP`` from its shutdown; rank 1 takes the follower branch and
    exits on that stop.  Each destroys the process group it made."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SERVE_RANK, str(i), str(port),
         str(tmp_path / f"s{i}.sock")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed: {err[-1500:]}"
        assert "SERVE_RC=0 GROUP_LEFT=False" in out
    assert "multihost controller driving 2 processes" in outs[0][2]
    assert "multihost follower 1/2 joining the mesh" in outs[1][2]
    assert "multihost follower exiting after" in outs[1][2]


def test_bool_leaves_travel_as_uint8_and_come_back_bool(tmp_path):
    """The wire form of a bool leaf is uint8; the receiver casts it back
    to the template's dtype (JAX restores dtypes after its psum)."""
    import torch.distributed as dist

    from kubernetesnetawarescheduler_tpu_torch.parallel import serve_multihost
    from kubernetesnetawarescheduler_tpu_torch.parallel.sharding import (
        make_mesh,
    )

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device="cpu")
        x = torch.rand(6) < 0.5
        assert mesh.wire(x).dtype == torch.uint8
        y = serve_multihost._bcast(mesh, x)
        assert y.dtype == torch.bool and torch.equal(y, x)
    finally:
        dist.destroy_process_group()
