"""Full-daemon drain harness: serve.py against a fake API server.

The PyTorch counterpart of
``kubernetesnetawarescheduler_tpu/bench/daemon_smoke.py``: the port's
daemon (HTTP watch -> encode -> score -> bind POSTs) drains a backlog
from :class:`~.fakeapi.FakeApiServer`, the same wire contract the
reference's ``Schedule()`` + POST Binding loop (scheduler.go:189-237)
held against a live API server.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time


def drain_daemon(n_nodes: int = 512, n_pods: int = 2048,
                 deadline_s: float = 900.0,
                 collect_phases: bool = False,
                 device="cuda") -> dict:
    """Drain ``n_pods`` through the full daemon on ``device``; returns a
    dict with ``binds_per_sec`` / ``wall_s`` and, per pod, how many
    Binding POSTs the API server received (``max_binds_per_pod``).

    Two ``--once`` passes first pay the kernel build and the allocator's
    first blocks on both cycle shapes (a >=2-batch backlog burst and the
    per-batch tail).  ``n_nodes`` must size capacity above ``n_pods``:
    the default :func:`~.fakeapi.pod_json` pod fits ~5.3x per default
    :func:`~.fakeapi.node_json` node.

    ``collect_phases=True`` also scrapes the daemon's own /metrics for
    the per-phase latency sums and counts.
    """
    from kubernetesnetawarescheduler_tpu_torch import serve
    from kubernetesnetawarescheduler_tpu_torch.api.server import call_uds
    from kubernetesnetawarescheduler_tpu_torch.bench.fakeapi import (
        FakeApiServer,
        node_json,
        pod_json,
    )

    tmp = tempfile.mkdtemp()
    cfg_path = os.path.join(tmp, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"max_nodes": n_nodes, "max_pods": 256,
                   "max_peers": 4,
                   "queue_capacity": n_pods + 256}, f)

    def make_api(num_pods: int) -> FakeApiServer:
        api = FakeApiServer()
        api.nodes = [node_json(f"node-{i:04d}") for i in range(n_nodes)]
        api.node_events = [{"type": "ADDED", "object": nd}
                           for nd in api.nodes]
        api.pods = [pod_json(f"pod-{i:05d}") for i in range(num_pods)]
        api.pod_events = [{"type": "ADDED", "object": p}
                          for p in api.pods]
        return api

    def make_argv(api: FakeApiServer) -> list[str]:
        uds = os.path.join(tempfile.mkdtemp(), "scorer.sock")
        return ["--cluster", f"kube:{api.url}", "--kube-token", "t",
                "--uds", uds, "--config", cfg_path, "--async-bind",
                "--device", str(device)]

    for warm_pods in (2 * 256, 8):
        api = make_api(warm_pods)
        try:
            rc = serve.main(make_argv(api) + ["--once"])
            if rc != 0:
                raise SystemExit(f"warm serve rc={rc}")
        finally:
            api.stop()

    # Timed pass: the daemon proper (no --once), polled until the
    # backlog is drained, then stopped through its stop event.
    api = make_api(n_pods)
    argv = make_argv(api)
    stop = threading.Event()
    t0 = time.perf_counter()
    th = threading.Thread(target=serve.main, args=(argv, stop),
                          daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + deadline_s
        while len(api.bindings) < n_pods and time.monotonic() < deadline:
            if not th.is_alive():
                raise SystemExit(
                    f"serve daemon died after {len(api.bindings)} binds")
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        bound = len(api.bindings)
        if bound < n_pods:
            # A deadline exit must NOT report a rate that measures the
            # timeout rather than the drain.
            raise SystemExit(f"only {bound}/{n_pods} pods bound "
                             f"within {wall:.0f}s")
        per_pod: dict[str, int] = {}
        for b in list(api.bindings):
            name = b["body"]["metadata"]["name"]
            per_pod[name] = per_pod.get(name, 0) + 1
        out = {"nodes": n_nodes, "pods": n_pods, "bound": bound,
               "distinct_pods_bound": len(per_pod),
               "max_binds_per_pod": max(per_pod.values()),
               "wall_s": wall, "binds_per_sec": bound / wall}
        if collect_phases:
            phases: dict = {}
            body = call_uds(argv[argv.index("--uds") + 1], "/metrics",
                            b"", timeout_s=30).decode()
            for line in body.splitlines():
                if line.startswith("netaware_phase_latency_seconds") \
                        and not line.startswith("#"):
                    key = line.split(" ")[0]
                    phases[key] = float(line.rsplit(" ", 1)[1])
            out["phase_budget"] = phases
        return out
    finally:
        stop.set()
        th.join(timeout=60)
        api.stop()
