"""The one generator of the benchmark's inputs: a cluster and its pods.

Everything here is a function of a configuration's ``cluster`` block, a
traffic mix's parameters and ``--seed``, and nothing of the program: the
harness hands the arrays to the program (as nodes, metric samples, the
``lat``/``bw`` planes and pods) and the same arrays to the plain
reference.

The cluster follows the shapes of the port's fake cluster
(``bench/fakecluster.py``'s ``ClusterSpec`` defaults, which
``serve.build_fake`` uses): nodes in zones and racks, capacities drawn from
ranges, a share tainted ``dedicated``, node_exporter-shaped metrics, and
tiered latency/bandwidth planes with symmetric jitter.  The N×N jitter is
drawn on the run's device by a ``torch.Generator`` in one call, so a
5,000-node plane costs no host time; everything else is drawn by numpy.
Every seed gets the same node and pod values, dealt out in the seed's
own order (``SIZES``), so that a seed changes the inputs and not the
amount of work.

The pods follow ``bench/density.py``'s ``_pods``: services, requests,
priorities, tolerations, and traffic peers among earlier pods of the same
service.  A peer is drawn only among pods at least ``peer_lag`` places
earlier (or, with ``peers_bound_only``, among the pods bound at set-up),
so every peer is bound before the pod that names it is scored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# node_exporter-shaped metric channels and their ranges (the port's
# ``bench/fakecluster.sample_metrics``); the last one is an integer draw.
METRIC_NAMES = ("cpu_freq", "mem_pct", "net_tx", "net_rx", "bandwidth",
                "disk_io")
METRIC_RANGES = ((6e8, 2.4e9), (5.0, 95.0), (1e4, 1e7), (1e4, 1e7),
                 (1e8, 1e10))
DISK_IO_MAX = 16
RESOURCES = ("cpu", "mem", "net_bw")


@dataclasses.dataclass
class Cluster:
    names: list[str]
    zone: np.ndarray      # i32[n]
    rack: np.ndarray      # i32[n]
    cap: np.ndarray       # f32[n, 3] cpu cores, mem GiB, net Gbps
    tainted: np.ndarray   # bool[n]
    metrics: np.ndarray   # f32[n, 6] in METRIC_NAMES order
    lat: np.ndarray       # f32[n, n] ms
    bw: np.ndarray        # f32[n, n] bits per second

    @property
    def n(self) -> int:
        return len(self.names)


@dataclasses.dataclass
class Pods:
    names: list[str]
    req: np.ndarray        # f32[s, 3]
    priority: np.ndarray   # f32[s]
    tolerates: np.ndarray  # bool[s]
    peers: np.ndarray      # i64[s, k] pod indices, -1 = none
    volume: np.ndarray     # f32[s, k]
    bound_node: np.ndarray  # i64[s] node of a pod bound at set-up, else -1
    first_arrival: int     # pods before this index are bound at set-up

    @property
    def s(self) -> int:
        return len(self.names)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


# How much work a run does follows the sizes it is handed (how far the
# best nodes lead, how many pods want them), so every seed gets the same
# sizes: each node's and each pod's values come from one fixed stream,
# and the seed deals them out in its own order and draws the planes'
# jitter and the peers' picks.
SIZES = 0


def _deal(seed: int, stream: int, n: int) -> np.ndarray:
    """The seed's order of ``n`` values drawn from the fixed stream."""
    return _rng(seed, stream).permutation(n)


def make_cluster(spec: dict, seed: int, device) -> Cluster:
    """The cluster of a configuration's ``cluster`` block."""
    n = int(spec["nodes"])
    rng = _rng(SIZES, 1)
    idx = np.arange(n)
    zone = (idx % spec["zones"]).astype(np.int32)
    rack = ((idx // spec["zones"]) % spec["racks_per_zone"]).astype(np.int32)
    cap = np.stack([rng.uniform(*spec[k], n) for k in
                    ("cpu_range", "mem_range", "netbw_range")],
                   axis=1).astype(np.float32)
    tainted = rng.random(n) < spec["taint_fraction"]
    metrics = np.zeros((n, len(METRIC_NAMES)), np.float32)
    for m, (lo, hi) in enumerate(METRIC_RANGES):
        metrics[:, m] = rng.uniform(lo, hi, n)
    metrics[:, 5] = rng.integers(0, DISK_IO_MAX, n)
    order = _deal(seed, 3, n)
    cap, tainted, metrics = cap[order], tainted[order], metrics[order]

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & (2**63 - 1))
    zt = torch.as_tensor(zone, device=dev)
    rt = torch.as_tensor(rack, device=dev)
    same_zone = zt[:, None] == zt[None, :]
    same_rack = same_zone & (rt[:, None] == rt[None, :])
    tier = torch.where(same_rack, 0, torch.where(same_zone, 1, 2))
    noise = torch.randn((n, n), generator=gen, device=dev,
                        dtype=torch.float32)
    noise = 1.0 + spec["jitter"] * noise
    noise = ((noise + noise.T) / 2).clamp(0.5, 1.5)
    lat_t = torch.tensor(spec["lat_tiers_ms"], dtype=torch.float32,
                         device=dev)[tier] * noise
    bw_t = torch.tensor(spec["bw_tiers_bps"], dtype=torch.float32,
                        device=dev)[tier] / noise
    del noise, tier, same_zone, same_rack
    lat_t.fill_diagonal_(0.0)
    bw_t.fill_diagonal_(float(bw_t.max()))
    lat, bw = lat_t.cpu().numpy(), bw_t.cpu().numpy()
    del lat_t, bw_t
    names = [f"node-{i:04d}" for i in range(n)]
    return Cluster(names, zone, rack, cap, tainted, metrics, lat, bw)


def make_pods(traffic: dict, n_nodes: int, seed: int,
              arrivals: int) -> Pods:
    """``bound_per_node * n_nodes`` pods bound at set-up (each node holds
    exactly that many, in a seeded order), then ``arrivals`` pods to
    schedule, in the order they reach the scheduler."""
    rng = _rng(SIZES, 2)
    b = int(traffic.get("bound_per_node", 0)) * n_nodes
    s = b + int(arrivals)
    k = int(traffic["max_peers"])
    service = rng.integers(0, traffic["services"], s)
    req = np.stack([rng.uniform(*traffic[f], s) for f in
                    ("cpu_range", "mem_range", "netbw_range")],
                   axis=1).astype(np.float32)
    priority = rng.uniform(*traffic["priority_range"], s).astype(np.float32)
    tolerates = rng.random(s) < traffic["tolerate_fraction"]
    has = rng.random(s) < traffic["peer_fraction"]
    count = rng.integers(1, k + 1, s)
    vol = rng.uniform(*traffic["traffic_range"], (s, k)).astype(np.float32)
    # The seed's order: the pods bound at set-up among themselves, the
    # arrivals among themselves.
    order = np.concatenate([_deal(seed, 4, b), b + _deal(seed, 5, s - b)])
    service, req, priority = service[order], req[order], priority[order]
    tolerates, has, count = tolerates[order], has[order], count[order]
    vol = vol[order]
    rng = _rng(seed, 2)
    bound_node = np.full(s, -1, np.int64)
    if b:
        bound_node[:b] = np.tile(rng.permutation(n_nodes),
                                 b // n_nodes + 1)[:b]

    # Peers: up to k draws among the eligible earlier members of the
    # pod's service, duplicates dropped.
    u = rng.random((s, k))
    peers = np.full((s, k), -1, np.int64)
    lag = int(traffic.get("peer_lag", 1))
    bound_only = bool(traffic.get("peers_bound_only", False))
    for svc in range(int(traffic["services"])):
        members = np.flatnonzero(service == svc)
        pool = members[members < b] if bound_only else members
        mine = members[members >= b]
        if bound_only:
            eligible = np.full(len(mine), len(pool))
        else:
            eligible = np.searchsorted(pool, mine - lag, side="right")
        pick = np.minimum((u[mine] * eligible[:, None]).astype(np.int64),
                          np.maximum(eligible[:, None] - 1, 0))
        rows = pool[pick] if len(pool) else np.full_like(pick, -1)
        live = ((np.arange(k)[None, :] < count[mine, None])
                & has[mine, None] & (eligible[:, None] > 0))
        peers[mine] = np.where(live, rows, -1)
    peers.sort(axis=1)
    dup = np.zeros_like(peers, dtype=bool)
    dup[:, 1:] = (peers[:, 1:] == peers[:, :-1]) & (peers[:, 1:] >= 0)
    peers[dup] = -1
    vol = np.where(peers >= 0, vol, 0.0).astype(np.float32)
    names = [f"p{i:07d}" for i in range(s)]
    return Pods(names, req, priority, tolerates, peers, vol, bound_node, b)


def arrivals_of(traffic: dict, seconds: float) -> int:
    """How many pods a mix sends in a run of ``seconds``: the whole
    backlog, or the warm-up pods plus one per due time of the rate
    warm-up and the window."""
    if traffic["arrivals"] == "backlog":
        return int(traffic["pods"])
    return (int(traffic.get("warm_pods", 0))
            + int(np.ceil(traffic["rate_per_s"]
                          * (traffic.get("warm_s", 0.0) + seconds))))
