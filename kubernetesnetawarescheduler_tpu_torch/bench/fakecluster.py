"""Fake cluster generation: nodes, hierarchical network, workloads.

The PyTorch package's copy of the JAX package's ``bench/fakecluster.py``
generators (numpy only, so the same seed gives the same nodes, matrices
and pods in both packages):

- heterogeneous nodes across zones and racks;
- a hierarchical network model: same-rack links are fast/near,
  cross-rack slower, cross-zone slowest — producing the ``lat``/``bw``
  matrices the probe pipeline would measure;
- node_exporter-shaped metric samples;
- workloads of services whose pods exchange traffic (peers), with
  optional affinity/anti-affinity groups.

The fault-injecting exporter fleet, the gang workload and the ``chaos``
wrapper of :func:`build_fake_cluster` follow with the ingest, gang and
chaos modules they serve.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from kubernetesnetawarescheduler_tpu_torch.config import Metric
from kubernetesnetawarescheduler_tpu_torch.k8s.client import FakeCluster
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node, Pod


@dataclasses.dataclass(frozen=True)
class NodeClassSpec:
    """One heterogeneous node class (the VirtualFlow-style hardware
    decoupling, PAPERS.md): capacity ranges override the ClusterSpec
    defaults and the link scales shift every link touching a node of
    this class (a slow NIC bounds the link, so a pair's latency takes
    the WORSE class's scale and its bandwidth the SMALLER one).

    ``fraction`` is the class's share of the fleet; classes partition
    the node index range deterministically (largest-first by spec
    order), so the assignment never consumes generator randomness and
    the single-class default stays bit-identical."""

    name: str
    fraction: float
    cpu_range: tuple[float, float] | None = None
    mem_range: tuple[float, float] | None = None
    netbw_range: tuple[float, float] | None = None
    lat_scale: float = 1.0   # multiplies latencies on the node's links
    bw_scale: float = 1.0    # multiplies bandwidths on the node's links


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Shape of a generated cluster."""

    num_nodes: int = 100
    zones: int = 2
    racks_per_zone: int = 4
    seed: int = 0

    # Heterogeneous node classes; () = today's single-class fleet
    # (the default MUST stay bit-identical: the class path is gated,
    # pinned by tests/test_scenario.py::test_fakecluster_default_parity).
    node_classes: tuple[NodeClassSpec, ...] = ()

    # Link model (lat ms / bw bits-per-sec) by proximity tier.
    lat_same_rack: float = 0.1
    lat_same_zone: float = 0.5
    lat_cross_zone: float = 2.0
    bw_same_rack: float = 25e9
    bw_same_zone: float = 10e9
    bw_cross_zone: float = 1e9
    jitter: float = 0.15  # multiplicative noise on links

    # Node capacity ranges (cpu cores, mem GiB, net Gbps).
    cpu_range: tuple[float, float] = (8.0, 64.0)
    mem_range: tuple[float, float] = (16.0, 256.0)
    netbw_range: tuple[float, float] = (10.0, 40.0)

    taint_fraction: float = 0.05  # nodes tainted "dedicated"


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Shape of a generated pod workload."""

    num_pods: int = 300
    services: int = 20           # pods are grouped into services
    peer_fraction: float = 0.6   # fraction of pods with traffic peers
    max_peers: int = 4
    affinity_fraction: float = 0.1
    anti_fraction: float = 0.1
    tolerate_fraction: float = 0.05
    # Preferred (soft) affinity: fraction of pods carrying a weighted
    # zone preference (``soft_node_affinity`` toward a random zone
    # label) / a weighted spread preference away from their own
    # service's group (negative ``soft_group_affinity``).
    soft_zone_fraction: float = 0.0
    soft_spread_fraction: float = 0.0
    # Topology spread: fraction of pods carrying a zone-level
    # topologySpreadConstraint on their service's group (maxSkew 1-2;
    # hard_fraction of those are DoNotSchedule, rest ScheduleAnyway).
    spread_fraction: float = 0.0
    spread_hard_fraction: float = 0.5
    # Zone-scoped hard pod (anti-)affinity: fraction of pods requiring
    # co-residency with their OWN service's group at zone granularity
    # (followers joining an established service), and fraction
    # declaring zone-anti against a random OTHER service.
    zone_aff_fraction: float = 0.0
    zone_anti_fraction: float = 0.0
    # Hard nodeAffinity matchExpressions: fraction of pods requiring
    # ``disk In [ssd]`` (half) or ``disk NotIn [hdd]`` (half) — the
    # fake cluster labels nodes disk=ssd/hdd alternately.
    ns_fraction: float = 0.0
    zones: int = 2  # must match the ClusterSpec the workload runs on
    seed: int = 0
    cpu_range: tuple[float, float] = (0.1, 4.0)
    mem_range: tuple[float, float] = (0.2, 8.0)
    netbw_range: tuple[float, float] = (0.05, 2.0)


def _assign_node_classes(spec: ClusterSpec
                         ) -> list[NodeClassSpec] | None:
    """Deterministic node-index -> class map (None when the spec has
    no classes).  Largest-remainder apportionment over contiguous
    index blocks: no generator randomness is consumed, so adding
    classes never perturbs the capacity/taint/jitter draw stream."""
    if not spec.node_classes:
        return None
    total = sum(c.fraction for c in spec.node_classes)
    if total <= 0:
        raise ValueError("node_classes fractions must sum > 0")
    n = spec.num_nodes
    quotas = [c.fraction / total * n for c in spec.node_classes]
    counts = [int(q) for q in quotas]
    remainders = sorted(range(len(quotas)),
                        key=lambda k: (quotas[k] - counts[k], -k),
                        reverse=True)
    for k in remainders[:n - sum(counts)]:
        counts[k] += 1
    out: list[NodeClassSpec] = []
    for cls, cnt in zip(spec.node_classes, counts):
        out.extend([cls] * cnt)
    return out


def build_fake_cluster(spec: ClusterSpec, client_cls=FakeCluster,
                       chaos=None,
                       **client_kw) -> tuple[FakeCluster, np.ndarray,
                                             np.ndarray]:
    """Create a populated :class:`FakeCluster` plus its ground-truth
    ``(lat_ms, bw_bps)`` matrices (what a perfect probe pipeline would
    measure).  ``client_cls``/``client_kw`` let tests swap in a
    fault-injecting subclass or an emulated API RTT
    (``bind_latency_s``).

    ``chaos`` (a fault-injecting proxy in the JAX package) raises
    :class:`NotImplementedError` until the chaos module is ported."""
    rng = np.random.default_rng(spec.seed)
    cluster = client_cls(**client_kw)
    n = spec.num_nodes
    zones = np.arange(n) % spec.zones
    racks = (np.arange(n) // spec.zones) % spec.racks_per_zone
    classes = _assign_node_classes(spec)

    for i in range(n):
        cls = classes[i] if classes is not None else None
        cpu_range = spec.cpu_range
        mem_range = spec.mem_range
        netbw_range = spec.netbw_range
        extra: frozenset[str] = frozenset()
        if cls is not None:
            cpu_range = cls.cpu_range or cpu_range
            mem_range = cls.mem_range or mem_range
            netbw_range = cls.netbw_range or netbw_range
            extra = frozenset({f"nodeclass={cls.name}"})
        tainted = rng.random() < spec.taint_fraction
        cluster.add_node(Node(
            name=f"node-{i:04d}",
            capacity={
                "cpu": float(rng.uniform(*cpu_range)),
                "mem": float(rng.uniform(*mem_range)),
                "net_bw": float(rng.uniform(*netbw_range)),
            },
            labels=frozenset({f"zone={zones[i]}", f"rack={racks[i]}",
                              f"disk={'ssd' if i % 2 == 0 else 'hdd'}"})
            | extra,
            taints=frozenset({"dedicated"}) if tainted else frozenset(),
            zone=f"zone-{zones[i]}",
            rack=f"rack-{zones[i]}-{racks[i]}",
        ))

    same_zone = zones[:, None] == zones[None, :]
    same_rack = same_zone & (racks[:, None] == racks[None, :])
    lat = np.where(same_rack, spec.lat_same_rack,
                   np.where(same_zone, spec.lat_same_zone,
                            spec.lat_cross_zone)).astype(np.float32)
    bw = np.where(same_rack, spec.bw_same_rack,
                  np.where(same_zone, spec.bw_same_zone,
                           spec.bw_cross_zone)).astype(np.float32)
    noise = 1.0 + spec.jitter * rng.standard_normal((n, n)).astype(np.float32)
    noise = np.clip((noise + noise.T) / 2, 0.5, 1.5)
    lat = lat * noise
    bw = bw / noise
    if classes is not None:
        ls = np.array([classes[i].lat_scale for i in range(n)],
                      np.float32)
        bs = np.array([classes[i].bw_scale for i in range(n)],
                      np.float32)
        lat = lat * np.maximum.outer(ls, ls)
        bw = bw * np.minimum.outer(bs, bs)
    np.fill_diagonal(lat, 0.0)
    np.fill_diagonal(bw, bw.max())
    if chaos is not None:
        raise NotImplementedError(
            "build_fake_cluster(chaos=...) needs k8s/chaos.py, which this "
            "package does not have yet")
    return cluster, lat, bw


def sample_metrics(rng: np.random.Generator) -> dict[str, float]:
    """One node_exporter-shaped sample (channels of config.Metric)."""
    return {
        "cpu_freq": float(rng.uniform(6e8, 2.4e9)),
        "mem_pct": float(rng.uniform(5.0, 95.0)),
        "net_tx": float(rng.uniform(1e4, 1e7)),
        "net_rx": float(rng.uniform(1e4, 1e7)),
        "bandwidth": float(rng.uniform(1e8, 1e10)),
        "disk_io": float(rng.integers(0, 16)),
    }


assert set(sample_metrics(np.random.default_rng(0))) == set(Metric.NAMES)


def feed_metrics(cluster: FakeCluster, encoder, rng: np.random.Generator,
                 drop_fraction: float = 0.0) -> None:
    """Push a metrics sample for every node into an Encoder; with
    ``drop_fraction`` > 0, some nodes are skipped (scrape failure) —
    their staleness keeps growing instead of crashing the scorer the
    way the reference does on a failed scrape (it ``println``s the
    error then dereferences the nil body, scheduler.go:397-405)."""
    for node in cluster.list_nodes():
        if drop_fraction and rng.random() < drop_fraction:
            continue
        encoder.update_metrics(node.name, sample_metrics(rng), age_s=0.0)


def generate_workload(spec: WorkloadSpec,
                      scheduler_name: str = "netAwareScheduler"
                      ) -> list[Pod]:
    """Pods grouped into services; pods of a service exchange traffic
    with earlier pods of the same service (so peers resolve as the
    batch schedules — the batch-internal dependency the conflict
    resolver must handle)."""
    rng = np.random.default_rng(spec.seed)
    pods: list[Pod] = []
    service_of = rng.integers(0, spec.services, spec.num_pods)
    by_service: dict[int, list[str]] = {}
    # Spread constraints are per-SERVICE (a Deployment template carries
    # them uniformly), decided on first sight of each service.
    svc_spread: dict[str, tuple[int, bool]] = {}
    for i in range(spec.num_pods):
        svc = int(service_of[i])
        name = f"pod-{svc:03d}-{i:05d}"
        earlier = by_service.setdefault(svc, [])
        peers: dict[str, float] = {}
        if earlier and rng.random() < spec.peer_fraction:
            count = int(rng.integers(1, spec.max_peers + 1))
            chosen = rng.choice(len(earlier), size=min(count, len(earlier)),
                                replace=False)
            for c in chosen:
                peers[earlier[int(c)]] = float(rng.uniform(0.5, 20.0))
        group = f"svc-{svc % 28}"  # bounded distinct groups (32-bit intern)
        affinity = (frozenset({group})
                    if rng.random() < spec.affinity_fraction else frozenset())
        anti = (frozenset({f"svc-{int(rng.integers(0, 28))}"})
                if rng.random() < spec.anti_fraction else frozenset())
        soft_node = ()
        if rng.random() < spec.soft_zone_fraction:
            zone = int(rng.integers(0, spec.zones))
            soft_node = ((frozenset({f"zone={zone}"}),
                          float(rng.uniform(40.0, 100.0))),)
        soft_group = ()
        if rng.random() < spec.soft_spread_fraction:
            soft_group = ((group, -float(rng.uniform(40.0, 100.0))),)
        if group not in svc_spread:
            if rng.random() < spec.spread_fraction:
                svc_spread[group] = (
                    int(rng.integers(1, 3)),
                    bool(rng.random() < spec.spread_hard_fraction))
            else:
                svc_spread[group] = (0, True)
        spread_skew, spread_hard = svc_spread[group]
        zone_aff = frozenset()
        if earlier and rng.random() < spec.zone_aff_fraction:
            # Followers only (an established service has zone members
            # to join); a first pod with self-affinity would deadlock.
            zone_aff = frozenset({group})
        zone_anti = frozenset()
        if rng.random() < spec.zone_anti_fraction:
            other = int(rng.integers(0, 28))
            if f"svc-{other}" != group:
                zone_anti = frozenset({f"svc-{other}"})
        req_ns = ()
        if rng.random() < spec.ns_fraction:
            req_ns = (((("In", "disk", ("ssd",)),)
                       if rng.random() < 0.5
                       else (("NotIn", "disk", ("hdd",)),)),)
        pods.append(Pod(
            name=name,
            scheduler_name=scheduler_name,
            requests={
                "cpu": float(rng.uniform(*spec.cpu_range)),
                "mem": float(rng.uniform(*spec.mem_range)),
                "net_bw": float(rng.uniform(*spec.netbw_range)),
            },
            peers=peers,
            tolerations=(frozenset({"dedicated"})
                         if rng.random() < spec.tolerate_fraction
                         else frozenset()),
            group=group,
            affinity_groups=affinity,
            anti_groups=anti,
            zone_affinity_groups=zone_aff,
            zone_anti_groups=zone_anti,
            required_node_affinity=req_ns,
            soft_node_affinity=soft_node,
            soft_group_affinity=soft_group,
            spread_maxskew=spread_skew,
            spread_hard=spread_hard,
            priority=float(rng.uniform(0, 10)),
        ))
        earlier.append(name)
    return pods
