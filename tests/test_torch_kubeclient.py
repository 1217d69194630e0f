"""The port's HTTP kube client against the JAX package's, on the CPU.

The same manifests go through both packages' ``parse_quantity``,
``pod_from_json`` and ``node_from_json`` and must give the same objects;
the port's ``KubeClient`` lists, binds, posts events and watches against
the port's own ``bench/fakeapi.FakeApiServer``, whose captured requests
must satisfy the port's copy of the wire-contract schemas
(``k8s/conformance.py``) and the JAX package's alike.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.k8s import conformance as jconf
from kubernetesnetawarescheduler_tpu.k8s import kubeclient as jkc
from kubernetesnetawarescheduler_tpu_torch.bench import fakeapi
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.k8s import conformance as tconf
from kubernetesnetawarescheduler_tpu_torch.k8s import kubeclient as tkc
from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
    Binding,
    scheduled_event,
)

torch.set_num_threads(1)


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


@pytest.fixture()
def api():
    s = fakeapi.FakeApiServer()
    yield s
    s.stop()


@pytest.mark.parametrize("q", ["500m", "2", "1Gi", "1M", 3, "", "1.5Ki",
                               "100n", "7u", "2e3", "12Ti", "garbage", None])
def test_parse_quantity_matches_jax(q):
    def run(fn):
        try:
            return ("ok", fn(q))
        except Exception as exc:  # noqa: BLE001 — compare the failure too
            return ("raise", type(exc).__name__)
    assert run(tkc.parse_quantity) == run(jkc.parse_quantity)


def _manifests() -> list[dict]:
    rng = np.random.default_rng(7)
    out = [fakeapi.pod_json("p"), fakeapi.pod_json("q", node="n1",
                                                   peers={"x": 2.5})]
    for i in range(6):
        pod = fakeapi.pod_json(f"r{i}", peers={f"s{j}": float(rng.uniform(
            0.5, 9.0)) for j in range(int(rng.integers(0, 4)))})
        spec = pod["spec"]
        spec["nodeSelector"] = {"zone": f"z{i % 2}"}
        spec["tolerations"] = [{"key": "gpu", "operator": "Exists"}]
        spec["priority"] = int(rng.integers(0, 100))
        spec["initContainers"] = [{"resources": {"requests": {
            "cpu": f"{int(rng.integers(1, 4))}", "memory": "2Gi"}}}]
        spec["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {"matchLabels": {"app": f"a{i}"}},
                "topologyKey": "kubernetes.io/hostname"}]}}
        pod["metadata"]["labels"] = {"app": f"a{i}"}
        pod["metadata"]["annotations"]["netaware/pod-group"] = f"g{i % 3}"
        pod["metadata"]["annotations"][
            "netaware/pod-group-min-member"] = str(i)
        out.append(pod)
    return out


@pytest.mark.parametrize("i", range(8))
def test_pod_from_json_matches_jax(i):
    obj = _manifests()[i]
    assert _fields(tkc.pod_from_json(obj)) == _fields(jkc.pod_from_json(obj))


@pytest.mark.parametrize("rv", ["1", "42"])
def test_node_from_json_matches_jax(rv):
    obj = fakeapi.node_json("n7", rv=rv)
    obj["spec"]["taints"] = [{"key": "gpu", "effect": "NoSchedule"}]
    obj["metadata"]["labels"]["kubernetes.io/hostname"] = "n7"
    assert _fields(tkc.node_from_json(obj)) == _fields(jkc.node_from_json(obj))
    node = tkc.node_from_json(fakeapi.node_json("n0"))
    assert node.capacity["cpu"] == 8.0 and node.ready and node.zone == "z0"


def test_fakeapi_is_the_jax_tests_fake():
    """The port's copy serves the same manifests as the JAX tests'."""
    from tests.test_kubeclient import _node_json, _pod_json

    assert fakeapi.pod_json("a", node="n", peers={"b": 1.0}) == _pod_json(
        "a", node="n", peers={"b": 1.0})
    assert fakeapi.node_json("n", rv="3") == _node_json("n", rv="3")


def test_list_bind_event_roundtrip(api):
    c = tkc.KubeClient(base_url=api.url, token="t")
    try:
        assert [n.name for n in c.list_nodes()] == ["n0", "n1"]
        pending = c.list_pending_pods()
        assert [p.name for p in pending] == ["pending-1"]
        c.bind(Binding(pod_name="pending-1", namespace="default",
                       node_name="n0"))
        assert api.bindings[0]["body"]["target"]["name"] == "n0"
        assert c.node_of("pending-1") == "n0"
        c.create_event(scheduled_event(pending[0], "n0",
                                       "netAwareScheduler"))
        assert api.events[0]["reason"] == "Scheduled"
    finally:
        c.close()
    # Every request the client sent satisfies both packages' schemas.
    pytest.importorskip("jsonschema")
    assert len(api.requests) >= 4
    for method, path, body in api.requests:
        tconf.validate_request(method, path, body)
        jconf.validate_request(method, path, body)


def test_watch_delivers_pending_pods(api):
    c = tkc.KubeClient(base_url=api.url, token="t")
    got: list = []
    try:
        c.on_pod_added(got.append)
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        c.close()
    assert got and got[0].name == "pending-1"


def test_scheduler_loop_binds_through_the_fake_apiserver(api):
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop

    api.pods = [fakeapi.pod_json("pending-1", peers={"x": 1.0})]
    cfg = SchedulerConfig(max_nodes=8, max_pods=4, max_peers=2)
    c = tkc.KubeClient(base_url=api.url, token="t")
    loop = SchedulerLoop(c, cfg, device="cpu")
    try:
        for node in c.list_nodes():
            loop.encoder.upsert_node(node)
            loop.encoder.update_metrics(node.name, {"cpu": 10.0,
                                                    "mem": 20.0})
        deadline = time.monotonic() + 5.0
        while len(loop.queue) == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert loop.run_once() == 1
    finally:
        loop.stop_bind_worker()
        c.close()
    assert api.bindings[0]["body"]["target"]["kind"] == "Node"


def test_schemas_equal_the_jax_packages():
    """The port's conformance module is a copy: the same contracts."""
    assert [(m, p, json.dumps(s, sort_keys=True))
            for m, p, s in tconf._REQUEST_CONTRACTS] == [
        (m, p, json.dumps(s, sort_keys=True))
        for m, p, s in jconf._REQUEST_CONTRACTS]
