"""The port's Score/Filter webhook against the JAX package's, on the CPU.

The same ``ExtenderArgs`` JSON goes into the JAX ``ExtenderHandlers`` and
the port's, each on a ``tests.test_loop.make_loop``-shaped loop (12 nodes,
``max_nodes=32``, ``max_pods=16``, ``max_peers=4``) holding the same
placed peer pods, under the dense backend and under the kernel backend
(the JAX Pallas kernel in interpret mode, the port's wrapper on its plain
version): identical filter lists and priorities, batcher rows allclose at
1e-4, identical ``/readyz``, ``/gangs``, ``/explain/<uid>`` and ``/debug/*``
answers, and the same ``# TYPE`` families on ``/metrics``.  Then the
shapes of ``tests/test_api.py`` on the port: the UDS frames, the bind
path, the batcher, gRPC and the native shim in front of the port's socket.
"""

from __future__ import annotations

import json
import shutil
import socket
import subprocess
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.api import extender as jext
from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu.utils import selfmetrics as jmetrics
from kubernetesnetawarescheduler_tpu_torch.api import extender as text
from kubernetesnetawarescheduler_tpu_torch.api.server import (
    ScorerServer,
    call_uds,
)
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig as TCfg
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes
from kubernetesnetawarescheduler_tpu_torch.utils import selfmetrics as tmetrics

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "native"

JAX = types.SimpleNamespace(fc=jfc, cfg=JCfg, loop=jloop.SchedulerLoop,
                            ext=jext, types=jtypes, kw={})
TORCH = types.SimpleNamespace(fc=tfc, cfg=TCfg, loop=tloop.SchedulerLoop,
                              ext=text, types=ttypes, kw={"device": "cpu"})


def make_loop(pkg, num_nodes=12, **cfg_kw):
    """``tests.test_loop.make_loop``'s shape in either package, with four
    pods of another scheduler bound and committed, so requests' peers
    resolve."""
    cfg = pkg.cfg(max_nodes=32, max_pods=16, max_peers=4, **cfg_kw)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=num_nodes, seed=3))
    loop = pkg.loop(cluster, cfg, method="parallel", **pkg.kw)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(0))
    names = [n.name for n in cluster.list_nodes()]
    for i in range(4):
        pod = pkg.types.Pod(name=f"peer-{i}", scheduler_name="other",
                            requests={"cpu": 0.5, "mem": 1.0})
        cluster.add_pod(pod)
        node = names[3 * i % len(names)]
        cluster.bind(pkg.types.Binding(pod_name=pod.name,
                                       namespace="default", node_name=node))
        loop.encoder.commit(pod, node)
    return cluster, loop


def extender_args(node_names, cpu="500m", peers=None, name="web-1"):
    pod = {
        "metadata": {"name": name, "uid": name, "namespace": "default",
                     "annotations": {}},
        "spec": {
            "schedulerName": "netAwareScheduler",
            "containers": [{"resources": {"requests": {
                "cpu": cpu, "memory": "1Gi"}}}],
        },
    }
    if peers:
        pod["metadata"]["annotations"]["netaware/peers"] = json.dumps(peers)
    return {"pod": pod, "nodenames": node_names}


def _requests(names) -> list[dict]:
    """Seeded requests: peers or none, all/some candidates, an unknown
    node, an oversized pod, no candidates."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(10):
        cand = [names[int(j)] for j in rng.choice(
            len(names), int(rng.integers(1, len(names) + 1)), replace=False)]
        if i == 3:
            cand.append("no-such-node")
        peers = ({f"peer-{int(k)}": float(rng.uniform(0.5, 9.0))
                  for k in rng.choice(4, int(rng.integers(1, 4)),
                                      replace=False)}
                 if i % 2 == 0 else None)
        cpu = "100000" if i == 7 else f"{int(rng.integers(100, 3000))}m"
        out.append(extender_args(cand, cpu=cpu, peers=peers,
                                 name=f"req-{i}"))
    out.append({"pod": {}, "nodenames": []})
    return out


def _answers(pkg, loop, names, reqs) -> dict:
    h = pkg.ext.ExtenderHandlers(loop)
    try:
        out = {"filter": [h.filter(a) for a in reqs],
               "prioritize": [h.prioritize(a) for a in reqs],
               "rows": [h._score_row(a)[2] for a in reqs],
               "full": h._batcher.score(pkg.ext._pod_from_k8s(
                   reqs[0]["pod"]))}
        for path in ("/readyz", "/gangs", "/explain/req-0", "/explain/",
                     "/debug/slo", "/debug/policy", "/debug/fleet",
                     "/debug/rebalance", "/debug/trace", "/health"):
            out[path] = json.loads(h.handle(path, b""))
        return out
    finally:
        h.close()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_webhook_answers_match_jax(backend):
    kw = dict(score_backend=backend, use_bfloat16=False)
    jc, jl = make_loop(JAX, **kw)
    tc, tl = make_loop(TORCH, **kw)
    try:
        names = [n.name for n in tc.list_nodes()]
        reqs = _requests(names)
        want = _answers(JAX, jl, names, reqs)
        got = _answers(TORCH, tl, names, reqs)
    finally:
        jl.stop_bind_worker()
        tl.stop_bind_worker()
    assert got["filter"] == want["filter"]
    assert got["prioritize"] == want["prioritize"]
    assert any(f["nodenames"] for f in got["filter"])
    assert any(f["failedNodes"] for f in got["filter"])
    for g, w in zip(got["rows"], want["rows"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["full"], np.asarray(want["full"]),
                               rtol=1e-4, atol=1e-4)
    for path in ("/readyz", "/gangs", "/explain/req-0", "/explain/",
                 "/debug/slo", "/debug/policy", "/debug/fleet",
                 "/debug/rebalance", "/health"):
        assert got[path] == want[path], path
    # No cycle ran: both recorders hold no span.
    assert got["/debug/trace"]["traceEvents"] == \
        want["/debug/trace"]["traceEvents"]


def _families(body: str) -> set[str]:
    return {ln.split()[2] for ln in body.splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_families_match_jax():
    """After the same webhook requests and the same drained backlog, the
    port's ``render_metrics`` exposes exactly the JAX package's ``# TYPE``
    families (its unported layers being off), none twice."""
    bodies = {}
    for pkg in (JAX, TORCH):
        cluster, loop = make_loop(pkg)
        h = pkg.ext.ExtenderHandlers(loop)
        try:
            names = [n.name for n in cluster.list_nodes()]
            h.prioritize(extender_args(names))
            cluster.add_pods(pkg.fc.generate_workload(
                pkg.fc.WorkloadSpec(num_pods=12, seed=4)))
            loop.run_until_drained()
            mod = jmetrics if pkg is JAX else tmetrics
            bodies[pkg is JAX] = mod.render_metrics(loop)
        finally:
            h.close()
            loop.stop_bind_worker()
    want, got = bodies[True], bodies[False]
    types_got = [ln.split()[2] for ln in got.splitlines()
                 if ln.startswith("# TYPE ")]
    assert len(types_got) == len(set(types_got))
    assert _families(got) == _families(want)
    assert "netaware_extender_dispatches_total" in _families(got)


# -- the shapes of tests/test_api.py on the port -------------------------


@pytest.fixture()
def scorer(tmp_path):
    cluster, loop = make_loop(TORCH)
    handlers = text.ExtenderHandlers(loop)
    server = ScorerServer(handlers, str(tmp_path / "scorer.sock"))
    server.start()
    yield cluster, loop, server
    server.stop()
    loop.stop_bind_worker()


def test_uds_filter_prioritize_and_overcommit(scorer):
    cluster, loop, server = scorer
    names = [n.name for n in cluster.list_nodes()]
    args = json.dumps(extender_args(names[:6])).encode()
    out = json.loads(call_uds(server.uds_path, "/filter", args))
    assert set(out) == {"nodenames", "failedNodes", "error"}
    assert len(out["nodenames"]) + len(out["failedNodes"]) == 6
    prio = json.loads(call_uds(server.uds_path, "/prioritize", args))
    assert [p["host"] for p in prio] == names[:6]
    assert max(p["score"] for p in prio) == 10
    big = json.dumps(extender_args(names, cpu="100000")).encode()
    out = json.loads(call_uds(server.uds_path, "/filter", big))
    assert out["nodenames"] == [] and len(out["failedNodes"]) == len(names)
    empty = json.dumps({"pod": {}, "nodenames": []}).encode()
    assert json.loads(call_uds(server.uds_path, "/prioritize", empty)) == []
    # A handler error is an empty frame (the shim fails open on it).
    assert call_uds(server.uds_path, "/filter", b"{not json") == b""


def test_uds_bind_roundtrip_commits_usage(scorer):
    cluster, loop, server = scorer
    cluster.add_pod(ttypes.Pod(name="bindme", scheduler_name="other",
                               requests={"cpu": 1.0, "mem": 1.0}))
    node = cluster.list_nodes()[0].name
    before = float(loop.encoder.snapshot().used.sum())
    body = json.dumps({"podName": "bindme", "podNamespace": "default",
                       "node": node}).encode()
    assert json.loads(call_uds(server.uds_path, "/bind", body)) == {
        "error": ""}
    assert cluster.node_of("bindme") == node
    assert float(loop.encoder.snapshot().used.sum()) > before
    out = json.loads(call_uds(server.uds_path, "/bind", body))
    assert "already bound" in out["error"]


def test_batcher_coalesces_concurrent_requests():
    cluster, loop = make_loop(TORCH)
    handlers = text.ExtenderHandlers(loop, batch_window_s=0.01)
    names = [n.name for n in cluster.list_nodes()]
    results: dict[int, list] = {}
    errors: list[BaseException] = []

    def client(i: int) -> None:
        try:
            args = extender_args(names, cpu=f"{100 + i * 10}m",
                                 name=f"conc-{i}")
            results[i] = handlers.prioritize(args)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(24)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        handlers.close()
        loop.stop_bind_worker()
    assert not errors, errors
    assert len(results) == 24
    assert all(len(out) == len(names) for out in results.values())
    assert handlers._batcher.dispatches <= 12
    assert handlers._batcher.requests == 24


def test_batcher_static_cache_tracks_metric_updates():
    cluster, loop = make_loop(TORCH, num_nodes=8)
    handlers = text.ExtenderHandlers(loop)
    try:
        names = [n.name for n in cluster.list_nodes()]
        out1 = {e["host"]: e["score"]
                for e in handlers.prioritize(extender_args(names))}
        rng = np.random.default_rng(5)
        best = names[3]
        for name in names:
            m = tfc.sample_metrics(rng)
            m["cpu_freq"] = 2.4e9 if name == best else 6e8
            m["mem_pct"] = 1.0 if name == best else 99.0
            m["bandwidth"] = 1e10 if name == best else 1e8
            m["net_tx"] = m["net_rx"] = 1e4 if name == best else 1e7
            m["disk_io"] = 0.0 if name == best else 15.0
            loop.encoder.update_metrics(name, m, age_s=0.0)
        out2 = {e["host"]: e["score"] for e in handlers.prioritize(
            extender_args(names, name="after-update"))}
    finally:
        handlers.close()
        loop.stop_bind_worker()
    assert out2[best] == max(out2.values()) == 10
    assert out1 != out2


def test_batcher_candidate_gather_matches_full_row():
    cluster, loop = make_loop(TORCH)
    handlers = text.ExtenderHandlers(loop)
    handlers2 = text.ExtenderHandlers(loop, batch_window_s=0.01)
    try:
        batcher = handlers._batcher
        names = [n.name for n in cluster.list_nodes()]
        args = extender_args(names, peers={"peer-0": 3.0})
        pod = text._pod_from_k8s(args["pod"])
        full = batcher.score(pod)
        idx = np.asarray([loop.encoder.node_index(n) for n in names] + [-1],
                         dtype=np.int32)
        got = batcher.score(pod, idx)
        assert got.shape == (len(names) + 1,)
        np.testing.assert_array_equal(got[:-1], full[idx[:-1]])
        out = handlers.filter({"pod": args["pod"],
                               "nodenames": names + ["no-such-node"]})
        assert "no-such-node" in out["failedNodes"]
        # A mixed wave: one full-row consumer and one gathered consumer.
        b2 = handlers2._batcher
        results = {}
        threads = [threading.Thread(target=lambda: results.__setitem__(
                       "full", b2.score(pod))),
                   threading.Thread(target=lambda: results.__setitem__(
                       "gathered", b2.score(pod, idx[:4])))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        handlers.close()
        handlers2.close()
        loop.stop_bind_worker()
    np.testing.assert_array_equal(results["full"], full)
    np.testing.assert_array_equal(results["gathered"], full[idx[:4]])


def test_grpc_transport(scorer):
    pytest.importorskip("grpc")
    from kubernetesnetawarescheduler_tpu_torch.api.grpc_server import (
        call_grpc,
        serve_grpc,
    )

    cluster, loop, server = scorer
    handlers = text.ExtenderHandlers(loop)
    gserver, port = serve_grpc(handlers)
    try:
        assert json.loads(call_grpc(f"127.0.0.1:{port}", "Health",
                                    b"{}")) == {"ok": True}
        names = [n.name for n in cluster.list_nodes()][:4]
        prio = json.loads(call_grpc(f"127.0.0.1:{port}", "Prioritize",
                                    json.dumps(extender_args(names))
                                    .encode()))
        assert [p["host"] for p in prio] == names
    finally:
        gserver.stop(0)
        handlers.close()


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """The shim built from ``native/extender.cpp`` with the Makefile's
    recipe, into a directory of this test's own: ``tests/test_api.py``
    runs ``make -C native`` in place, maybe at the same moment in another
    worker, and a binary being linked there cannot be executed."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    out = tmp_path_factory.mktemp("native")
    subprocess.run(["make", "-C", str(out), "-f", str(NATIVE / "Makefile"),
                    "--eval", f"vpath %.cpp {NATIVE}", "netaware_extender"],
                   check=True, capture_output=True)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, timeout=30.0):
    data = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def test_native_shim_serves_the_port_and_fails_open(native_build, scorer):
    """The shim of the unchanged ``native/extender.cpp`` in front of the
    port's socket: /filter and /prioritize answer; a handler error and a
    stopped backend fail open (prioritize → [], filter → 503)."""
    cluster, loop, server = scorer
    port = _free_port()
    proc = subprocess.Popen(
        [str(native_build / "netaware_extender"), str(port),
         server.uds_path], stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 5
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=0.5):
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.05)
        names = [n.name for n in cluster.list_nodes()][:5]
        status, out = _post(f"{base}/filter", extender_args(names))
        assert status == 200 and set(out["nodenames"]) <= set(names)
        status, prio = _post(f"{base}/prioritize",
                             extender_args(names, peers={"peer-1": 3.0}))
        assert status == 200 and [p["host"] for p in prio] == names
        assert _post(f"{base}/prioritize", b"{not json")[1] == []
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/filter", b"{not json")
        assert err.value.code == 503
        server.stop()  # the backend goes down, the shim stays
        status, prio = _post(f"{base}/prioritize", extender_args(names))
        assert status == 200 and prio == []
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/filter", extender_args(names))
        assert err.value.code == 503
    finally:
        proc.terminate()
        proc.wait(timeout=5)
