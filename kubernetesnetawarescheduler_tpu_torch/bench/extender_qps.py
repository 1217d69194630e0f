"""Extender webhook QPS bench: the micro-batched Score/Filter path.

The PyTorch counterpart of
``kubernetesnetawarescheduler_tpu/bench/extender_qps.py``: the same
legs on the port's :class:`~..api.extender._ScoreBatcher`.

- ``seq_qps``          one-at-a-time requests through the batcher
                       (demand-sized 8-pod batches);
- ``seq_maxpods_qps``  the round-1 shape, for comparison: one pod in a
                       ``max_pods``-padded batch per dispatch;
- ``conc_qps_best``    many client threads coalesced into shared
                       dispatches; best of the timed passes
                       (``conc_qps_mean`` is the mean,
                       ``conc_qps_passes`` the raw list);
- ``conc512_qps``      the same at 4x the clients.

torch compiles nothing per batch shape, so one warm-up pass (the kernel
library's build and the allocator's first blocks) precedes the timed
concurrent passes, where the JAX bench needs two to cover its compile
shapes.  ``seq_ms`` / ``conc_ms`` hold the per-request latency
percentiles each leg's callers saw.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.api.extender import (
    ExtenderHandlers,
)
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.state import round_up
from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
    score_pods_auto,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod
from kubernetesnetawarescheduler_tpu_torch.serve import build_fake


@dataclasses.dataclass
class QpsResult:
    num_nodes: int
    max_pods: int
    seq_qps: float
    seq_maxpods_qps: float
    # Best and mean over the timed passes, named as such: the mean is
    # the sustained rate, the best what a quiet machine reaches.
    conc_qps_best: float
    conc_clients: int
    mean_batch: float  # pods per kernel dispatch under concurrency
    conc_qps_mean: float = 0.0
    conc_dispatches: int = 0  # kernel dispatches in the best timed pass
    batch_occupancy: float = 0.0  # mean_batch / max_pods
    conc_qps_passes: list[float] = dataclasses.field(
        default_factory=list)
    # 4x the clients: each client has one request in flight, so a
    # coalescing batcher's ceiling is clients / dispatch interval.
    conc512_qps: float = 0.0
    conc512_clients: int = 0
    rtt_budget: dict = dataclasses.field(default_factory=dict)
    # Per-request latency percentiles in ms ({"p50", "p99"}): the
    # sequential leg and the best timed concurrent pass.
    seq_ms: dict = dataclasses.field(default_factory=dict)
    conc_ms: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _prioritize_args(i: int) -> dict:
    return {
        "pod": {
            "metadata": {"name": f"qps-pod-{i}", "uid": f"qps-{i}"},
            "spec": {
                "schedulerName": "netAwareScheduler",
                "containers": [{"resources": {"requests": {
                    "cpu": "500m", "memory": "1Gi"}}}],
            },
        },
        "nodenames": [f"node-{j:04d}" for j in range(0, 64)],
    }


def _pct_ms(samples_s: list[float]) -> dict:
    if not samples_s:
        return {"p50": 0.0, "p99": 0.0}
    ms = np.asarray(samples_s) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))}


def build_webhook(num_nodes: int, max_pods: int, max_peers: int = 4,
                  score_backend: str | None = None, seed: int = 0,
                  device="cuda"):
    """``(loop, handlers)``: the daemon's fake cluster of ``num_nodes``
    (``serve.build_fake``: network and metrics fed) behind a webhook."""
    cfg = SchedulerConfig(max_nodes=round_up(num_nodes, 128),
                          max_pods=max_pods, max_peers=max_peers)
    if score_backend is not None:
        cfg = dataclasses.replace(cfg, score_backend=score_backend)
    loop, _, _ = build_fake(num_nodes, seed, cfg, device=device)
    return loop, ExtenderHandlers(loop)


def run_qps(num_nodes: int = 5120, max_pods: int = 256,
            seq_requests: int = 32, conc_clients: int = 128,
            conc_requests: int = 2048, seed: int = 0,
            max_peers: int = 4, score_backend: str | None = None,
            device="cuda") -> QpsResult:
    loop, handlers = build_webhook(num_nodes, max_pods, max_peers,
                                   score_backend, seed, device)
    try:
        return _run(loop, handlers, num_nodes, max_pods, seq_requests,
                    conc_clients, conc_requests)
    finally:
        handlers.close()
        loop.stop_bind_worker()


def _run(loop, handlers, num_nodes, max_pods, seq_requests, conc_clients,
         conc_requests) -> QpsResult:
    cfg = loop.cfg

    def maxpods_once() -> None:
        b = loop.encoder.encode_pods([_pod_for_maxpods()],
                                     node_of=loop._peer_node, lenient=True)
        score_pods_auto(loop.encoder.snapshot(), b, cfg).cpu()

    # Warm both shapes (and the kernel build) outside the timed windows.
    handlers.prioritize(_prioritize_args(0))
    maxpods_once()

    seq_lat: list[float] = []
    start = time.perf_counter()
    for i in range(seq_requests):
        t0 = time.perf_counter()
        handlers.prioritize(_prioritize_args(i))
        seq_lat.append(time.perf_counter() - t0)
    seq_qps = seq_requests / (time.perf_counter() - start)

    # Round-1 shape: a max_pods-padded batch per request.
    start = time.perf_counter()
    for _ in range(seq_requests):
        maxpods_once()
    seq_maxpods_qps = seq_requests / (time.perf_counter() - start)

    lat: list[float] = []
    lock = threading.Lock()

    def client(base: int, per_client: int) -> None:
        for i in range(per_client):
            t0 = time.perf_counter()
            handlers.prioritize(_prioritize_args(base * 1000 + i))
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)

    def run_threads(n_clients: int = conc_clients,
                    per_client: int | None = None) -> float:
        per = (per_client if per_client is not None
               else conc_requests // conc_clients)
        threads = [threading.Thread(target=client, args=(c, per))
                   for c in range(n_clients)]
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - start

    run_threads()  # warm-up pass
    conc_qps = 0.0
    dispatches = 0
    mean_batch = 0.0
    best_wall = 0.0
    best_lat: list[float] = []
    passes: list[float] = []
    for _ in range(2):
        lat.clear()
        dispatches_before = handlers._batcher.dispatches
        conc_wall = run_threads()
        qps = len(lat) / conc_wall
        passes.append(qps)
        if qps > conc_qps:
            conc_qps = qps
            dispatches = handlers._batcher.dispatches - dispatches_before
            mean_batch = len(lat) / dispatches if dispatches else 0.0
            best_wall = conc_wall
            best_lat = list(lat)
    conc2 = 4 * conc_clients
    per2 = max(4, conc_requests // conc2 * 2)
    run_threads(conc2, per2)  # warm the larger coalesced waves
    lat.clear()
    d_before = handlers._batcher.dispatches
    wall2 = run_threads(conc2, per2)
    qps2 = len(lat) / wall2
    d2 = handlers._batcher.dispatches - d_before
    rtt_est_ms = wall2 / d2 * 1e3 if d2 else 0.0
    rtt_ms = best_wall / dispatches * 1e3 if dispatches else 0.0
    return QpsResult(
        num_nodes=num_nodes, max_pods=max_pods,
        seq_qps=seq_qps, seq_maxpods_qps=seq_maxpods_qps,
        conc_qps_best=conc_qps, conc_clients=conc_clients,
        mean_batch=mean_batch,
        conc_qps_mean=float(np.mean(passes)) if passes else 0.0,
        conc_dispatches=dispatches,
        batch_occupancy=mean_batch / max_pods,
        conc_qps_passes=passes,
        conc512_qps=qps2, conc512_clients=conc2,
        rtt_budget={
            "dispatch_interval_ms_conc": rtt_ms,
            "dispatch_interval_ms_conc512": rtt_est_ms,
            "dispatches_conc512": d2,
            "ceiling_conc_qps": (conc_clients / (rtt_ms / 1e3)
                                 if rtt_ms else 0.0),
            "ceiling_conc512_qps": (conc2 / (rtt_est_ms / 1e3)
                                    if rtt_est_ms else 0.0),
        },
        seq_ms=_pct_ms(seq_lat), conc_ms=_pct_ms(best_lat),
    )


def _pod_for_maxpods() -> Pod:
    return Pod(name="qps-ref", requests={"cpu": 0.5, "mem": 1.0})


def main(argv=None) -> None:
    """Print one JSON line: ``python -m
    kubernetesnetawarescheduler_tpu_torch.bench.extender_qps [--device
    cpu] [--nodes N] [--backend xla|pallas]``."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--backend", default=None, choices=("xla", "pallas"))
    args = ap.parse_args(argv)
    doc = run_qps(num_nodes=args.nodes, score_backend=args.backend,
                  device=args.device).to_dict()
    doc["device"] = args.device
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
