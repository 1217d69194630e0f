"""The native extender shim under concurrent load in front of the port
(``bench/native_load.py``), on the CPU.

At the JAX harness test's shape (128 nodes, 24 clients x 3 requests,
the backend killed mid-flight) the port's harness meets that test's bars:
every request scored with the backend up, the shim's threads tracking the
fleet and draining afterwards, and a SIGKILLed backend failing OPEN.  The
backend daemon the harness kills is a process of the port that imports
neither JAX nor the JAX package.  The shim of the unchanged
``native/extender.cpp`` returns the same /prioritize bodies in front of
the JAX package's webhook and the port's, both at f32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu_torch.bench import native_load as tnl

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

#: The fixed payloads sent through both backends.
PAYLOADS = 32


def test_port_harness_meets_the_jax_bars_and_fails_open():
    """``tests/test_native_load.py``'s bars, on the port's harness."""
    doc = tnl.run_native_load(num_nodes=128, conc_clients=24,
                              requests_per_client=3,
                              kill_backend_midway=True, device="cpu")
    assert doc["errors"] == 0
    assert doc["scored_responses"] == 24 * 3
    assert doc["shim_peak"].get("threads", 0) <= 24 + 8
    kill = doc["backend_kill"]
    assert kill["fail_open"], kill
    assert kill["errors"] == 0
    assert kill["healthz_after"] == 200
    assert kill["shim_after"].get("threads", 99) <= 8
    assert 0 < kill["backend_up_s"] < tnl.BACKEND_UP_S


def test_backend_daemon_imports_neither_jax_nor_the_jax_package(tmp_path):
    """The harness's backend command, run once with ``jax`` and the JAX
    package made unimportable: it serves and exits cleanly."""
    cmd = tnl.backend_cmd(["--cluster", "fake:16", "--uds",
                           str(tmp_path / "s.sock"), "--device", "cpu",
                           "--once"])
    assert cmd[1] == "-c" and "jax" not in cmd[2]
    block = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['kubernetesnetawarescheduler_tpu'] = None; ")
    out = subprocess.run([cmd[0], "-c", block + cmd[2]], cwd=tnl._REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def _payloads(names: list, bound: list) -> list[bytes]:
    """``PAYLOADS`` seeded ExtenderArgs: varied requests and candidate
    sets, every other one naming placed pods as its traffic peers."""
    rng = np.random.default_rng(13)
    out = []
    for i in range(PAYLOADS):
        meta = {"name": f"fixed-{i}", "uid": f"fixed-{i}",
                "namespace": "default", "annotations": {}}
        if i % 2 == 0:
            peers = rng.choice(len(bound), size=3, replace=False)
            meta["annotations"]["netaware/peers"] = json.dumps(
                {bound[int(j)]: float(rng.uniform(0.5, 5.0))
                 for j in peers})
        cand = [names[int(j)] for j in np.sort(rng.choice(
            len(names), int(rng.integers(1, len(names) + 1)),
            replace=False))]
        out.append(json.dumps({"pod": {"metadata": meta, "spec": {
            "schedulerName": "netAwareScheduler",
            "containers": [{"resources": {"requests": {
                "cpu": f"{int(rng.integers(100, 2000))}m",
                "memory": f"{int(rng.integers(1, 8))}Gi"}}}]}},
            "nodenames": cand}).encode())
    return out


def test_shim_bodies_equal_in_front_of_either_package_at_f32(tmp_path):
    """The same seeded /prioritize requests through the shim, once in
    front of the JAX package's webhook and once in front of the port's,
    both at f32 over the same placed workload: byte-identical bodies."""
    from kubernetesnetawarescheduler_tpu.api.extender import (
        ExtenderHandlers as JHandlers,
    )
    from kubernetesnetawarescheduler_tpu.api.server import (
        ScorerServer as JServer,
    )
    from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
    from kubernetesnetawarescheduler_tpu.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.api.server import (
        ScorerServer as TServer,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench import (
        fakecluster as tfc,
    )

    shim = tnl.build_shim(str(tmp_path))
    cluster, lat, bw = jfc.build_fake_cluster(jfc.ClusterSpec(
        num_nodes=128, seed=0))
    jcfg = dataclasses.replace(
        SchedulerConfig(max_nodes=128, max_pods=32, max_peers=4),
        use_bfloat16=False)
    jloop = SchedulerLoop(cluster, jcfg, method="parallel")
    jloop.encoder.set_network(lat, bw)
    jfc.feed_metrics(cluster, jloop.encoder, np.random.default_rng(1))
    tloop, th = tnl.build_backend(128, 32, device="cpu",
                                  use_bfloat16=False)
    backends = {"jax": (jloop, JHandlers(jloop), JServer, jfc),
                "torch": (tloop, th, TServer, tfc)}
    bodies, procs, servers = {}, [], []
    try:
        for name, (loop, handlers, server_cls, fc) in backends.items():
            # The requests' peers: the same placed workload in both.
            loop.client.add_pods(fc.generate_workload(
                fc.WorkloadSpec(num_pods=64, seed=5, services=8,
                                peer_fraction=0.5),
                scheduler_name=loop.cfg.scheduler_name))
            loop.run_until_drained()
            bound = sorted(b.pod_name for b in loop.client.bindings)
            names = [n.name for n in loop.client.list_nodes()]
            server = server_cls(handlers, str(tmp_path / f"{name}.sock"))
            server.start()
            servers.append(server)
            port = tnl._free_port()
            procs.append(tnl.start_shim(shim, port, server.uds_path))
            assert tnl.wait_healthz(port, 10.0), name
            bodies[name] = tnl.post_all(port, _payloads(names, bound))
    finally:
        for server in servers:
            server.stop()
        for proc in procs:
            tnl.stop_proc(proc)
        for loop, handlers, _, _ in backends.values():
            handlers.close()
            loop.stop_bind_worker()
    assert bodies["torch"] == bodies["jax"]
    assert all(status == 200 and json.loads(body) != []
               for status, body in bodies["torch"])
    assert len({body for _, body in bodies["torch"]}) == PAYLOADS


def test_main_writes_the_doc_under_out(tmp_path, monkeypatch, capsys):
    """``main --write`` defaults under ``bench_out/`` (git-ignored), names
    the torch device it ran on and stamps the provenance block."""
    def fake(**kw):
        return {"num_nodes": kw["num_nodes"], "device": kw["device"]}

    monkeypatch.setattr(tnl, "run_native_load", fake)
    monkeypatch.chdir(tmp_path)
    tnl.main(["--device", "cpu", "--nodes", "64", "--write"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    doc = json.loads((tmp_path / "bench_out"
                      / "native_extender_load.json").read_text())
    assert doc == line
    assert doc["backend"] == "cpu" and doc["device"] == "cpu"
    assert doc["num_nodes"] == 64
    assert doc["bench_env"]["platform"] == "cpu"
    assert not os.path.exists(tmp_path / "bench_artifacts")
