"""A stdlib fake of the Kubernetes v1 API server, for benches and tests.

The port's own copy of the fake API server, pod and node manifests that
the JAX package's tests define (``tests/test_kubeclient.py``): just
enough of the v1 API — list/watch nodes and pods, POST Binding, POST
Event, DELETE, policy/v1 PodDisruptionBudgets — for
:class:`~kubernetesnetawarescheduler_tpu_torch.k8s.kubeclient.KubeClient`
and the daemon (``serve.py --cluster kube:<url>``) to run against it.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def pod_json(name: str, node: str = "", sched: str = "netAwareScheduler",
              peers: dict | None = None, rv: str = "1") -> dict:
    ann = {}
    if peers:
        ann["netaware.io/peers"] = json.dumps(peers)
    return {
        "apiVersion": "v1",
        "kind": "Pod",  # real watch objects carry kind (conformance)
        "metadata": {"name": name, "namespace": "default", "uid": name,
                     "resourceVersion": rv, "annotations": ann},
        "spec": {
            "schedulerName": sched,
            "nodeName": node,
            "containers": [
                {"resources": {"requests": {"cpu": "500m",
                                            "memory": "1Gi"}}},
                {"resources": {"requests": {"cpu": "1",
                                            "memory": "512Mi"}}},
            ],
        },
    }


def node_json(name: str, rv: str = "1") -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "resourceVersion": rv,
                     "labels": {"topology.kubernetes.io/zone": "z0"}},
        "spec": {},
        "status": {
            "allocatable": {"cpu": "8", "memory": "16Gi"},
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


class FakeApiServer:
    """Just enough of the v1 API: list/watch nodes+pods, binding,
    events.  Watch streams emit whatever is in ``pod_events`` /
    ``node_events`` then idle."""

    def __init__(self):
        self.bindings: list[dict] = []
        self.events: list[dict] = []
        self.deletions: list[dict] = []
        self.pdbs: list[dict] = []
        # EVERY request the client sent, as (method, path, body), for
        # validation against the schemas in k8s/conformance.py.
        self.requests: list[tuple[str, str, dict | None]] = []
        # Per-bind handling delay (emulated API-server latency); the
        # ThreadingHTTPServer handles connections concurrently, so a
        # pooled client overlaps these.
        self.bind_delay_s = 0.0
        self.nodes = [node_json("n0"), node_json("n1")]
        self.pods = [pod_json("pending-1")]
        self.pod_events = [
            {"type": "ADDED", "object": pod_json("pending-1")}]
        # If set, replaces pod_events after the first watch connection
        # (lets tests model "stream errored, reconnect sees new data").
        self.pod_events_next: list | None = None
        self.node_events = [
            {"type": "ADDED", "object": n} for n in self.nodes]
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive: the client
            # reuses one connection for batched bind/event POSTs
            # TCP_NODELAY, as the real kube-apiserver's Go net/http
            # sets it: without this the handler's unbuffered
            # status/header/body writes hit the 40 ms Nagle/delayed-
            # ACK stall per response, capping ANY client at ~22
            # requests/s per connection.
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, status=200):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, events):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for e in events:
                        line = (json.dumps(e) + "\n").encode()
                        self.wfile.write(f"{len(line):x}\r\n".encode()
                                         + line + b"\r\n")
                        self.wfile.flush()
                    # idle until client drops (bounded for hygiene)
                    time.sleep(2.0)
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client hung up mid-stream (expected)

            def do_GET(self):
                outer.requests.append(("GET", self.path, None))
                if self.path.startswith("/api/v1/nodes"):
                    if "watch=true" in self.path:
                        self._stream(outer.node_events)
                    else:
                        self._json({"items": outer.nodes})
                elif self.path.startswith("/api/v1/pods"):
                    if "watch=true" in self.path:
                        events = outer.pod_events
                        if outer.pod_events_next is not None:
                            outer.pod_events = outer.pod_events_next
                            outer.pod_events_next = None
                        self._stream(events)
                    else:
                        self._json({"items": outer.pods})
                elif self.path.startswith(
                        "/apis/policy/v1/poddisruptionbudgets"):
                    if "watch=true" in self.path:
                        self._stream([])
                    else:
                        self._json({"items": outer.pdbs})
                else:
                    self._json({}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                outer.requests.append(("POST", self.path, body))
                if self.path.endswith("/binding"):
                    if outer.bind_delay_s:
                        time.sleep(outer.bind_delay_s)
                    outer.bindings.append({"path": self.path,
                                           "body": body})
                    self._json({}, 201)
                elif "/events" in self.path:
                    outer.events.append(body)
                    self._json({}, 201)
                else:
                    self._json({}, 404)

            def do_DELETE(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                body = json.loads(raw) if raw else None
                outer.requests.append(("DELETE", self.path, body))
                outer.deletions.append({"path": self.path,
                                        "body": body})
                self._json({}, 200)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        host, port = self.server.server_address
        return f"http://{host}:{port}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
