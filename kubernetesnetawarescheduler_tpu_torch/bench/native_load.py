"""Load the native extender shim at 128 concurrent connections, then kill
its backend under load.

The PyTorch package's copy of the JAX package's
``bench/native_load.py``.  ``native/extender.cpp`` is
thread-per-connection; this harness drives the real binary in front of
the port's webhook:

- ``conc_clients`` (default 128) persistent keep-alive HTTP clients
  POSTing /prioritize through the shim -> UDS -> the port's batcher ->
  its scorer on ``device``;
- the shim process's thread and fd counts sampled from /proc at peak;
- a backend SIGKILL under full load: a separate daemon process
  (``serve.main`` of this package on ``device``) dies with the fleet
  live; every in-flight and later /prioritize must fail OPEN (HTTP 200,
  neutral ``[]``) and /healthz must still answer.

The shim is built from ``native/extender.cpp`` with ``native/Makefile``'s
recipe into a directory of its own (``native/`` itself is never written).
Every server, shim, backend and loop the harness starts is stopped before
it returns.

    python -m kubernetesnetawarescheduler_tpu_torch.bench.native_load \\
        [--device cpu] [--write [PATH]]

``--write`` alone writes ``bench_out/native_extender_load.json``
(git-ignored; the JAX package's ``bench_artifacts/`` is never written).
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")

#: Seconds the backend-kill daemon may take to answer /healthz through
#: the shim: its interpreter start, torch import, CUDA context and fake
#: cluster.
BACKEND_UP_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _proc_stats(pid: int) -> dict:
    out: dict = {}
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    out["threads"] = int(line.split()[1])
    except OSError:
        pass
    try:
        out["fds"] = len(os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        pass
    return out


def _args_payload(i: int) -> bytes:
    """The ExtenderArgs ``extender_qps`` drives in-process, serialized
    for the wire."""
    from kubernetesnetawarescheduler_tpu_torch.bench.extender_qps import (
        _prioritize_args,
    )

    return json.dumps(_prioritize_args(i)).encode()


def build_shim(out_dir: str) -> str:
    """Build ``netaware_extender`` from ``native/extender.cpp`` with the
    Makefile's recipe into ``out_dir``; returns the binary's path."""
    subprocess.run(
        ["make", "-C", out_dir, "-f", os.path.join(_NATIVE, "Makefile"),
         "--eval", f"vpath %.cpp {_NATIVE}", "netaware_extender"],
        check=True, capture_output=True)
    return os.path.join(out_dir, "netaware_extender")


def start_shim(shim: str, port: int, uds: str) -> subprocess.Popen:
    return subprocess.Popen([shim, str(port), uds],
                            stderr=subprocess.DEVNULL)


def wait_healthz(port: int, timeout_s: float) -> bool:
    """Poll the shim's /healthz until it answers 200 or ``timeout_s``
    passes."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=0.5)
            c.request("GET", "/healthz")
            ok = c.getresponse().status == 200
            c.close()
            if ok:
                return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


def stop_proc(proc: subprocess.Popen, kill: bool = False) -> None:
    """End ``proc`` (SIGTERM, or SIGKILL with ``kill``) and reap it."""
    if kill:
        proc.kill()
    else:
        proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)


def _connect(port: int) -> http.client.HTTPConnection:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    # TCP_NODELAY, as kube-scheduler's Go HTTP client sets it:
    # http.client writes headers and body as separate sends, and without
    # it each POST stalls ~40 ms on Nagle / delayed ACK.
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


def post_all(port: int, payloads: list[bytes]) -> list[tuple[int, bytes]]:
    """POST each payload to the shim's /prioritize in turn on one
    connection; ``(status, body)`` of each."""
    conn = _connect(port)
    out = []
    try:
        for body in payloads:
            conn.request("POST", "/prioritize", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
    finally:
        conn.close()
    return out


class _Client:
    """One persistent keep-alive connection; counts outcomes."""

    def __init__(self, port: int, n_requests: int, idx: int):
        self.port = port
        self.n = n_requests
        self.idx = idx
        self.ok = 0
        self.neutral = 0  # 200 with [] body (fail-open)
        self.errors = 0

    def _connect(self) -> http.client.HTTPConnection:
        return _connect(self.port)

    def run(self) -> None:
        conn = self._connect()
        for i in range(self.n):
            try:
                conn.request(
                    "POST", "/prioritize",
                    body=_args_payload(self.idx * 100000 + i),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    self.errors += 1
                    continue
                if json.loads(body) == []:
                    self.neutral += 1
                else:
                    self.ok += 1
            except Exception:  # noqa: BLE001 — counted, not raised
                self.errors += 1
                try:
                    conn.close()
                    conn = self._connect()
                except OSError:
                    return
        conn.close()


def run_fleet(port: int, conc_clients: int, requests_per_client: int,
              first_idx: int = 0) -> list[_Client]:
    """``conc_clients`` clients of ``requests_per_client`` requests each,
    all at once; returns them when every one has finished."""
    clients = [_Client(port, requests_per_client, first_idx + i)
               for i in range(conc_clients)]
    threads = [threading.Thread(target=c.run) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return clients


def timed_pass(port: int, shim_pid: int, conc_clients: int,
               requests_per_client: int) -> dict:
    """One timed fleet pass, with the shim's peak threads and fds
    sampled every 20 ms."""
    peak: dict = {}
    stop_sampling = threading.Event()

    def _sample_peak() -> None:
        while not stop_sampling.wait(0.02):
            for k, v in _proc_stats(shim_pid).items():
                peak[k] = max(peak.get(k, 0), v)

    sampler = threading.Thread(target=_sample_peak, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        clients = run_fleet(port, conc_clients, requests_per_client)
    finally:
        wall = time.perf_counter() - t0
        stop_sampling.set()
        sampler.join(timeout=2)
    total = sum(c.ok + c.neutral for c in clients)
    qps = total / wall if wall > 0 else 0.0
    return {
        "requests": conc_clients * requests_per_client,
        "scored_responses": sum(c.ok for c in clients),
        "errors": sum(c.errors for c in clients),
        # One timed pass, so best == mean; both keys keep the schema
        # aligned with extender_qps (whose headline is best-of-N).
        "conc_qps_best": round(qps, 1),
        "conc_qps_mean": round(qps, 1),
        "wall_s": round(wall, 2),
        "shim_peak": peak,
    }


def backend_cmd(serve_argv: list[str]) -> list[str]:
    """The command line of a daemon process of this package:
    ``serve.main(serve_argv)`` in a fresh interpreter."""
    return [sys.executable, "-c",
            "from kubernetesnetawarescheduler_tpu_torch import serve; "
            f"serve.main({serve_argv!r})"]


def _backend_kill_under_load(shim_bin: str, conc_clients: int,
                             requests_per_client: int,
                             device="cuda") -> dict:
    """SIGKILL a real backend process with the full client fleet live.

    A separate daemon process (``serve.main`` of this package, ``--cluster
    fake:128`` on ``device``) dies for real: the kernel closes every
    pooled socket, the shim's reconnect finds no listener, and every
    response from that instant must fail OPEN (200-neutral for
    /prioritize), with /healthz still live and the thread fleet drained.
    The node count is small: kill semantics do not depend on it."""
    tmp = tempfile.mkdtemp(prefix="native_kill_")
    uds = os.path.join(tmp, "kill.sock")
    backend = subprocess.Popen(
        backend_cmd(["--cluster", "fake:128", "--uds", uds,
                     "--device", str(device)]),
        cwd=_REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    port = _free_port()
    shim = start_shim(shim_bin, port, uds)
    try:
        t0 = time.perf_counter()
        deadline = time.time() + BACKEND_UP_S
        while not os.path.exists(uds) and time.time() < deadline:
            time.sleep(0.1)
        if not wait_healthz(port, max(0.0, deadline - time.time())):
            raise RuntimeError("kill-phase shim/backend did not come up")
        # Serve steadily before the kill: the first requests pay the
        # backend's first-use costs.
        warm = _Client(port, 2, 4000)
        warm.run()
        if warm.ok == 0:
            raise RuntimeError("kill-phase backend never scored")
        come_up_s = time.perf_counter() - t0

        clients = [_Client(port, requests_per_client, 1000 + i)
                   for i in range(conc_clients)]
        threads = [threading.Thread(target=c.run) for c in clients]
        total = conc_clients * requests_per_client
        for t in threads:
            t.start()
        # Kill once the run is observably mid-flight (some responses in,
        # most still outstanding).
        deadline = time.time() + 30
        while time.time() < deadline:
            if sum(cl.ok + cl.neutral for cl in clients) >= max(
                    1, total // 10):
                break
            time.sleep(0.005)
        backend.kill()  # SIGKILL mid-flight: sockets die with it
        for t in threads:
            t.join()
        neutral = sum(c.neutral for c in clients)
        errors = sum(c.errors for c in clients)
        # Settle-poll: the C++ per-connection threads exit on client
        # EOF, which lags the Python-side join.
        after = _proc_stats(shim.pid)
        settle = time.time() + 5
        while after.get("threads", 0) > 4 and time.time() < settle:
            time.sleep(0.05)
            after = _proc_stats(shim.pid)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        c.request("GET", "/healthz")
        healthz = c.getresponse().status
        c.close()
        return {
            "neutral_responses": neutral,
            # Scored before the SIGKILL landed.
            "scored_responses": sum(cl.ok for cl in clients),
            "errors": errors,
            "requests": total,
            "healthz_after": healthz,
            "shim_after": after,
            "backend_up_s": round(come_up_s, 2),
            "fail_open": (errors == 0 and healthz == 200
                          and neutral > 0),
        }
    finally:
        stop_proc(shim, kill=True)
        stop_proc(backend, kill=True)
        shutil.rmtree(tmp, ignore_errors=True)


def build_backend(num_nodes: int, max_pods: int, seed: int = 0,
                  device="cuda", **cfg_over):
    """``(loop, handlers)``: a ``num_nodes`` fake cluster with its network
    and metrics fed, behind the port's webhook handlers (``cfg_over``
    replaces fields of the harness's config)."""
    import dataclasses

    import numpy as np

    from kubernetesnetawarescheduler_tpu_torch.api.extender import (
        ExtenderHandlers,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        build_fake_cluster,
        feed_metrics,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.state import round_up

    cfg = dataclasses.replace(
        SchedulerConfig(max_nodes=round_up(num_nodes, 128),
                        max_pods=max_pods, max_peers=4), **cfg_over)
    cluster, lat, bw = build_fake_cluster(
        ClusterSpec(num_nodes=num_nodes, seed=seed))
    loop = SchedulerLoop(cluster, cfg, method="parallel", device=device)
    loop.encoder.set_network(lat, bw)
    feed_metrics(cluster, loop.encoder, np.random.default_rng(seed + 1))
    return loop, ExtenderHandlers(loop)


def run_native_load(num_nodes: int = 5120, max_pods: int = 256,
                    conc_clients: int = 128,
                    requests_per_client: int = 16,
                    kill_backend_midway: bool = True,
                    seed: int = 0, device="cuda") -> dict:
    from kubernetesnetawarescheduler_tpu_torch.api.server import ScorerServer

    tmp = tempfile.mkdtemp(prefix="native_load_")
    shim_bin = build_shim(tmp)
    loop, handlers = build_backend(num_nodes, max_pods, seed, device)
    uds = os.path.join(tmp, "scorer.sock")
    server = ScorerServer(handlers, uds)
    server.start()
    port = _free_port()
    shim = start_shim(shim_bin, port, uds)
    try:
        if not wait_healthz(port, 10.0):
            raise RuntimeError("shim did not come up")
        # Warm with the full concurrent fleet, twice (the JAX harness's
        # warm-up): the first waves pay the allocator's and the scorer's
        # first-use costs outside the timed pass.
        for _ in range(2):
            run_fleet(port, conc_clients, requests_per_client, 5000)
        result = {"num_nodes": num_nodes, "conc_clients": conc_clients,
                  **timed_pass(port, shim.pid, conc_clients,
                               requests_per_client)}
        if kill_backend_midway:
            result["backend_kill"] = _backend_kill_under_load(
                shim_bin, conc_clients, requests_per_client, device)
        return result
    finally:
        server.stop()
        stop_proc(shim)
        handlers.close()
        loop.stop_bind_worker()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", nargs="?", const=os.path.join(
        "bench_out", "native_extender_load.json"))
    ap.add_argument("--clients", type=int, default=128)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--device", default="cuda",
                    help="torch device the backends score on "
                         "(default cuda)")
    args = ap.parse_args(argv)

    import torch

    from kubernetesnetawarescheduler_tpu_torch.bench.envinfo import (
        bench_env,
    )

    doc = run_native_load(num_nodes=args.nodes,
                          conc_clients=args.clients,
                          requests_per_client=args.requests,
                          device=args.device)
    dev = torch.device(args.device)
    doc["backend"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else dev.type)
    doc["ts"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    doc["bench_env"] = bench_env()
    if doc["bench_env"].get("git_sha"):
        doc["git"] = doc["bench_env"]["git_sha"]  # legacy key
    print(json.dumps(doc))
    if args.write:
        os.makedirs(os.path.dirname(args.write) or ".", exist_ok=True)
        with open(args.write, "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    main()
