"""Per-node probe agent: the exec surface for honest pairwise probing.

The PyTorch package's own copy of the JAX package's
``ingest/probe_agent.py``, with the same HTTP contract, token,
allowlist and target check; it has no device code.

The reference measured bandwidth *from client pods on each node* via
``kubectl exec iperf3 -c iperf3-server`` (netperfScript/run.sh:12-14) —
client-side semantics, but only against ONE central server, with the
results dropped into the scheduler pod as files.  Round 1 of this build
replaced the file drop but regressed the vantage point: its prober ran
iperf3 *from the scorer pod* to per-node servers, so ``bw[a, b]`` was
really ``bw[scorer, b]``.

This agent restores the client-side vantage WITHOUT kubectl: a tiny
HTTP endpoint that runs in the probe DaemonSet next to the iperf3
server.  ``GET /probe?target=<host>`` makes *this node* run
``iperf3 -c <host> -J`` plus a TCP-connect latency estimate, and
returns both — so the orchestrator's ``AgentProber`` can ask node a's
agent to probe node b and record an honest a↔b measurement.

Stdlib-only (the DaemonSet container just runs
``python -m kubernetesnetawarescheduler_tpu_torch.ingest.probe_agent``);
subprocess args are passed as a list (no shell), and the target is
charset-validated anyway so the agent cannot be steered into running
anything but iperf3 against a host.
"""

from __future__ import annotations

import json
import re
import socket
import subprocess
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

DEFAULT_AGENT_PORT = 9798
DEFAULT_IPERF_PORT = 5201
MAX_DURATION_S = 30

_TARGET_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,253}$")


def run_iperf3(target: str, duration_s: int, port: int) -> bytes:
    """Run iperf3 client mode against ``target``; returns the raw -J
    output (the same flags the reference used at run.sh:12, minus the
    kubectl transport)."""
    out = subprocess.run(
        ["iperf3", "-c", target, "-p", str(port), "-J", "-Z",
         "-t", str(duration_s)],
        capture_output=True, timeout=duration_s + 10, check=True)
    return out.stdout


def tcp_latency_ms(target: str, port: int, tries: int = 3,
                   timeout_s: float = 2.0) -> float:
    """Median TCP connect time to ``target:port`` in milliseconds —
    the latency figure iperf3 itself does not produce."""
    samples = []
    for _ in range(tries):
        start = time.perf_counter()
        with socket.create_connection((target, port), timeout=timeout_s):
            samples.append((time.perf_counter() - start) * 1e3)
    samples.sort()
    return samples[len(samples) // 2]


def make_handler(runner: Callable[[str, int, int], bytes] = run_iperf3,
                 pinger: Callable[[str, int], float] = tcp_latency_ms,
                 token: str = "",
                 allowed_targets: frozenset[str] | None = None):
    """Handler class factory; ``runner``/``pinger`` are injectable so
    tests exercise the HTTP contract without a live iperf3 fleet.

    An exec surface on a hostPort must not be an open bandwidth-flood
    amplifier (the reference's equivalent, ``kubectl exec``, was
    RBAC-gated): ``token`` requires a matching ``X-Netaware-Token``
    header, and ``allowed_targets`` (when given) restricts probes to
    the known fleet — anything else is rejected before iperf3 runs.
    ``/healthz`` stays open (it reveals nothing and feeds the
    readinessProbe)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:  # quiet; agents are many
            pass

        def _send(self, code: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._send(200, {"ok": True})
                return
            if url.path != "/probe":
                self._send(404, {"error": f"unknown path {url.path}"})
                return
            if token and self.headers.get("X-Netaware-Token") != token:
                self._send(403, {"error": "bad or missing token"})
                return
            q = parse_qs(url.query)
            target = (q.get("target") or [""])[0]
            if not _TARGET_RE.match(target):
                self._send(400, {"error": "bad or missing target"})
                return
            if allowed_targets is not None \
                    and target not in allowed_targets:
                self._send(403, {"error": "target not in fleet"})
                return
            try:
                duration = min(int((q.get("duration") or ["2"])[0]),
                               MAX_DURATION_S)
                port = int((q.get("port") or [str(DEFAULT_IPERF_PORT)])[0])
            except ValueError:
                self._send(400, {"error": "bad duration/port"})
                return
            doc: dict = {}
            try:
                doc["latency_ms"] = pinger(target, port)
            except OSError as exc:
                doc["latency_ms"] = None
                doc["latency_error"] = str(exc)
            try:
                doc["iperf"] = json.loads(runner(target, duration, port))
            except (subprocess.SubprocessError, OSError,
                    ValueError) as exc:
                self._send(502, {**doc, "error": f"iperf3 failed: {exc}"})
                return
            self._send(200, doc)

    return Handler


def make_server(port: int = DEFAULT_AGENT_PORT,
                host: str = "0.0.0.0",
                runner: Callable[[str, int, int], bytes] = run_iperf3,
                pinger: Callable[[str, int], float] = tcp_latency_ms,
                token: str = "",
                allowed_targets: frozenset[str] | None = None
                ) -> ThreadingHTTPServer:
    return ThreadingHTTPServer(
        (host, port),
        make_handler(runner, pinger, token=token,
                     allowed_targets=allowed_targets))


def main(argv=None) -> None:
    import argparse
    import os

    ap = argparse.ArgumentParser(description="netaware probe agent")
    ap.add_argument("--port", type=int, default=DEFAULT_AGENT_PORT)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--token", default=os.environ.get(
        "NETAWARE_PROBE_TOKEN", ""),
        help="require X-Netaware-Token on /probe (default: "
             "$NETAWARE_PROBE_TOKEN)")
    ap.add_argument("--allow-targets", default="",
                    help="JSON file: list of hosts (or {name: host} "
                         "map) this agent may probe; unset = any "
                         "charset-valid host (use with --token)")
    args = ap.parse_args(argv)
    allowed = None
    if args.allow_targets:
        with open(args.allow_targets, encoding="utf-8") as fh:
            doc = json.load(fh)
        allowed = frozenset(doc.values() if isinstance(doc, dict)
                            else doc)
    server = make_server(port=args.port, host=args.host,
                         token=args.token, allowed_targets=allowed)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.server_close()


if __name__ == "__main__":
    main()
