"""Seeded scenario-trace generator: a replayable cluster "day" as one
compact JSONL event stream.

The PyTorch package's copy of the JAX package's ``scenario/generate.py``
(numpy only): for the same :class:`ScenarioSpec` both packages write the
same bytes (decompressed), and a trace written by either reads and
replays in the other.

The trace is the contract between the generator and the replay
harness (scenario/replay.py): line 1 is a versioned header carrying
the full :class:`ScenarioSpec` (so a trace file alone reproduces its
cluster and its own regeneration), every following line is one event
in non-decreasing virtual time:

- ``pod`` — an arrival (serving / batch / gang / long-running class;
  gang members share a ``pod_group`` and arrive together);
- ``delete`` — a departure (the pod's lifetime expired — batch jobs
  finish, serving pods roll; long-running pods never depart, the
  slow-drift class whose outcome quality the scorecard exists for);
- ``link_degrade`` / ``link_repair`` — a CORRELATED burst: every
  link touching one rack's nodes degrades by ``factor`` for the
  burst duration (the k8s chaos proxy models control-plane faults;
  these model data-plane drift);
- ``node_down`` / ``node_up`` — node churn;
- ``zone_down`` / ``zone_up`` — a CORRELATED mass failure (v2): every
  node in one zone goes down at once and comes back together — the
  degrade-and-recover trigger elastic gang reshaping exists for;
- ``node_upgrade`` — one node drained for a rolling upgrade (v2);
  the replay treats it as a node_down whose ``node_up`` is scheduled
  a hold later, batch after batch marching across the fleet;
- ``state_fault`` — one scheduler-state fault class for the
  state_chaos injector (core/state_chaos.py).

Determinism is the whole point: same seed + spec -> byte-identical
file (sorted keys, fixed float formatting, a single rng drawn in a
fixed order; test-enforced).  Generation is STREAMING — a bounded
heap of scheduled future events (departures, repairs) is the only
state that grows with concurrency, never with total pod count.
"""

from __future__ import annotations

import dataclasses
import gzip
import heapq
import io
import json
import math
from typing import Any, Callable, Iterator

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
    ClusterSpec,
    NodeClassSpec,
)
from kubernetesnetawarescheduler_tpu_torch.core.state_chaos import (
    STATE_FAULT_CLASSES,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod

TRACE_FORMAT = "scenario-trace/v1"
# v2 (r17): zone_down/zone_up + node_upgrade event kinds, elastic
# gang-shape declarations on gang pods.  Readers accept 1..TRACE_VERSION
# — a v1 trace replays unchanged (none of the new kinds appear in it).
TRACE_VERSION = 2

EVENT_KINDS = ("pod", "delete", "link_degrade", "link_repair",
               "node_down", "node_up", "zone_down", "zone_up",
               "node_upgrade", "state_fault")

POD_CLASSES = ("serving", "batch", "gang", "longrun")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Everything the generator draws from — embedded verbatim in the
    trace header, so the trace is self-describing and regenerable."""

    seed: int = 0
    duration_s: float = 240.0        # virtual seconds of arrivals
    tick_s: float = 1.0              # arrival bucketing granularity
    base_rate: float = 50.0          # mean pod arrivals per virtual s
    day_s: float = 120.0             # diurnal period (compressed day)
    diurnal_amplitude: float = 0.6   # rate swing around the mean

    # Pod-class mix (fractions of arrivals; remainder = serving).
    batch_fraction: float = 0.3
    gang_fraction: float = 0.1
    longrun_fraction: float = 0.05
    gang_sizes: tuple[int, ...] = (4, 8, 16)

    # Mean lifetimes (virtual seconds, exponential; long-running pods
    # never depart).  A floor of a few ticks keeps departures from
    # racing the pod's own scheduling.
    serving_lifetime_s: float = 90.0
    batch_lifetime_s: float = 30.0
    gang_lifetime_s: float = 60.0
    lifetime_floor_s: float = 5.0

    # Workload shape (mirrors bench/fakecluster.WorkloadSpec).
    services: int = 16
    peer_fraction: float = 0.5
    max_peers: int = 3
    cpu_range: tuple[float, float] = (0.1, 2.0)
    mem_range: tuple[float, float] = (0.2, 4.0)
    netbw_range: tuple[float, float] = (0.05, 1.0)
    gang_cpu: float = 2.0
    gang_mem: float = 4.0
    gang_netbw: float = 0.5

    # Data-plane drift: correlated link-degradation bursts.
    link_burst_rate_per_s: float = 0.0
    link_burst_factor: float = 8.0
    link_burst_duration_s: float = 15.0

    # Node churn.
    node_churn_rate_per_s: float = 0.0
    node_down_duration_s: float = 20.0

    # Zonal outage (v2): at ``zone_outage_at_s`` every node of
    # ``zone_outage_zone`` goes down at once (one zone_down event),
    # returning together after the duration.  Negative = never.
    zone_outage_at_s: float = -1.0
    zone_outage_zone: int = 0
    zone_outage_duration_s: float = 45.0

    # Rolling node upgrade (v2): starting at ``rolling_upgrade_at_s``,
    # nodes drain in batches of ``rolling_upgrade_batch``, each held
    # down ``rolling_upgrade_hold_s`` before the next batch starts.
    # Negative = never.
    rolling_upgrade_at_s: float = -1.0
    rolling_upgrade_batch: int = 4
    rolling_upgrade_hold_s: float = 10.0

    # Fraction of gangs declaring an elastic shape family (v2):
    # "size,size//2:0.5" — full shape preferred, half shape at 0.5
    # priority (core/gang.parse_gang_shapes grammar).  0.0 = every
    # gang rigid, exactly the v1 stream.
    gang_shapes_fraction: float = 0.0

    # Scheduler-state faults (core/state_chaos.py classes).
    state_fault_rate_per_s: float = 0.0

    # Control-plane chaos: a seed for k8s/chaos.ChaosSchedule.generate
    # applied by the replay harness (None = bare cluster).
    chaos_seed: int | None = None

    # The fleet the trace runs on.
    cluster: ClusterSpec = dataclasses.field(
        default_factory=lambda: ClusterSpec(num_nodes=64, seed=0))


# ---------------------------------------------------------------------------
# Spec <-> JSON (tuples and the nested ClusterSpec/NodeClassSpec need
# explicit reconstruction; JSON has no tuple).
# ---------------------------------------------------------------------------


def spec_to_json(spec: ScenarioSpec) -> dict[str, Any]:
    doc = dataclasses.asdict(spec)

    def _tuples(obj: Any) -> Any:
        if isinstance(obj, tuple):
            return [_tuples(v) for v in obj]
        if isinstance(obj, dict):
            return {k: _tuples(v) for k, v in obj.items()}
        return obj

    return _tuples(doc)


def spec_from_json(doc: dict[str, Any]) -> ScenarioSpec:
    doc = dict(doc)
    cluster = dict(doc.pop("cluster"))
    classes = tuple(
        NodeClassSpec(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in c.items()})
        for c in cluster.pop("node_classes", ()))
    for key in ("cpu_range", "mem_range", "netbw_range"):
        cluster[key] = tuple(cluster[key])
    cluster_spec = ClusterSpec(node_classes=classes, **cluster)
    for key in ("gang_sizes", "cpu_range", "mem_range", "netbw_range"):
        doc[key] = tuple(doc[key])
    return ScenarioSpec(cluster=cluster_spec, **doc)


# ---------------------------------------------------------------------------
# Trace IO.
# ---------------------------------------------------------------------------


def _open_write(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "wb", compresslevel=5),
                                encoding="utf-8", newline="\n")
    return open(path, "w", encoding="utf-8", newline="\n")


def _open_read(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"),
                                encoding="utf-8")
    return open(path, encoding="utf-8")


def _dump(obj: dict[str, Any]) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def read_trace(path: str) -> tuple[dict[str, Any],
                                   Iterator[dict[str, Any]]]:
    """Open a trace: returns ``(header, events)`` where ``events`` is
    a STREAMING iterator over event dicts (the file is never
    materialized).  Raises ValueError on a bad header."""
    fh = _open_read(path)
    line = fh.readline()
    try:
        header = json.loads(line)
    except ValueError as exc:
        fh.close()
        raise ValueError(f"trace header unparseable: {exc}") from exc
    if (not isinstance(header, dict)
            or header.get("format") != TRACE_FORMAT
            or header.get("kind") != "header"):
        fh.close()
        raise ValueError(
            f"not a {TRACE_FORMAT} trace (header {header!r})")
    ver = header.get("version")
    if not isinstance(ver, int) or not 1 <= ver <= TRACE_VERSION:
        fh.close()
        raise ValueError(
            f"trace version {ver!r} outside the supported range "
            f"1..{TRACE_VERSION}")

    def _events() -> Iterator[dict[str, Any]]:
        try:
            for raw in fh:
                if raw.strip():
                    yield json.loads(raw)
        finally:
            fh.close()

    return header, _events()


def pod_from_event(ev: dict[str, Any],
                   scheduler_name: str = "netAwareScheduler") -> Pod:
    """Materialize one ``pod`` event as a schedulable Pod."""
    from kubernetesnetawarescheduler_tpu_torch.core.gang import (
        parse_gang_shapes,
    )

    p = ev["pod"]
    return Pod(
        name=p["name"],
        scheduler_name=scheduler_name,
        requests={"cpu": p["cpu"], "mem": p["mem"],
                  "net_bw": p["net_bw"]},
        peers=dict(p.get("peers", {})),
        group=p.get("group", ""),
        pod_group=p.get("pod_group", ""),
        gang_min_member=int(p.get("gang_min_member", 0)),
        priority=float(p.get("priority", 0.0)),
        gang_shapes=parse_gang_shapes(p.get("gang_shapes", "")),
    )


# ---------------------------------------------------------------------------
# Generation.
# ---------------------------------------------------------------------------


def _diurnal(spec: ScenarioSpec, t: float) -> float:
    """Arrival-rate multiplier at virtual time t (mean 1.0)."""
    return max(0.0, 1.0 + spec.diurnal_amplitude
               * math.sin(2.0 * math.pi * t / spec.day_s))


def _round_t(t: float) -> float:
    return round(t, 6)


def generate_trace(spec: ScenarioSpec, path: str,
                   progress: Callable[[int], None] | None = None
                   ) -> dict[str, Any]:
    """Write the trace for ``spec`` to ``path`` (gzip when the path
    ends ``.gz``); returns generation stats.  Streaming: memory is
    bounded by the concurrently-alive pod set (their scheduled
    departures sit in a heap), never by total pods."""
    rng = np.random.default_rng(spec.seed)
    n = spec.cluster.num_nodes
    racks_of: dict[tuple[int, int], list[str]] = {}
    for i in range(n):
        zone = i % spec.cluster.zones
        rack = (i // spec.cluster.zones) % spec.cluster.racks_per_zone
        racks_of.setdefault((zone, rack), []).append(f"node-{i:04d}")
    rack_keys = sorted(racks_of)

    # Scheduled future events: (t, seq, json-line).  seq breaks ties
    # deterministically in emission order.
    heap: list[tuple[float, int, str]] = []
    seq = 0

    def _push(t: float, obj: dict[str, Any]) -> None:
        nonlocal seq
        heapq.heappush(heap, (t, seq, _dump(obj)))
        seq += 1

    stats = {"pods": 0, "events": 0, "gangs": 0, "deletes": 0,
             "link_bursts": 0, "node_churn": 0, "state_faults": 0,
             "zone_outages": 0, "node_upgrades": 0,
             "shaped_gangs": 0}
    # Recent alive pods per service, for peer edges (bounded; peers
    # may outlive their partners — the join skips unresolved peers).
    recent: dict[int, list[str]] = {}
    down_until: dict[str, float] = {}
    pod_seq = 0
    gang_seq = 0

    class_probs = np.array([spec.batch_fraction, spec.gang_fraction,
                            spec.longrun_fraction])
    if class_probs.sum() > 1.0:
        raise ValueError("pod-class fractions sum past 1.0")

    def _requests() -> dict[str, float]:
        return {
            "cpu": round(float(rng.uniform(*spec.cpu_range)), 4),
            "mem": round(float(rng.uniform(*spec.mem_range)), 4),
            "net_bw": round(float(rng.uniform(*spec.netbw_range)), 4),
        }

    def _peers(svc: int) -> dict[str, float]:
        earlier = recent.get(svc, [])
        if not earlier or rng.random() >= spec.peer_fraction:
            return {}
        count = int(rng.integers(1, spec.max_peers + 1))
        chosen = rng.choice(len(earlier),
                            size=min(count, len(earlier)),
                            replace=False)
        return {earlier[int(c)]: round(float(rng.uniform(0.5, 20.0)), 3)
                for c in chosen}

    def _note_recent(svc: int, name: str) -> None:
        lst = recent.setdefault(svc, [])
        lst.append(name)
        if len(lst) > 32:
            del lst[:len(lst) - 32]

    def _lifetime(mean: float) -> float:
        return spec.lifetime_floor_s + float(rng.exponential(mean))

    with _open_write(path) as fh:
        header = {
            "kind": "header",
            "format": TRACE_FORMAT,
            "version": TRACE_VERSION,
            "seed": spec.seed,
            "spec": spec_to_json(spec),
        }
        fh.write(_dump(header) + "\n")

        def _emit(obj: dict[str, Any]) -> None:
            fh.write(_dump(obj) + "\n")
            stats["events"] += 1
            if progress is not None and stats["events"] % 65536 == 0:
                progress(stats["events"])

        def _drain_heap(upto: float) -> None:
            while heap and heap[0][0] <= upto:
                _, _, line = heapq.heappop(heap)
                fh.write(line + "\n")
                stats["events"] += 1

        zone_outage_fired = False
        upgrade_fired = False
        t = 0.0
        while t < spec.duration_s:
            _drain_heap(t)
            tv = _round_t(t)
            # --- scheduled mass events (v2, deterministic) ---------
            if (spec.zone_outage_at_s >= 0.0 and not zone_outage_fired
                    and t >= spec.zone_outage_at_s):
                zone_outage_fired = True
                z = spec.zone_outage_zone % max(1, spec.cluster.zones)
                znodes = sorted(
                    nm for (zz, _r), nms in racks_of.items()
                    if zz == z for nm in nms)
                up_t = _round_t(t + spec.zone_outage_duration_s)
                _emit({"t": tv, "kind": "zone_down", "zone": z,
                       "nodes": znodes})
                _push(up_t, {"t": up_t, "kind": "zone_up", "zone": z,
                             "nodes": znodes})
                for nm in znodes:
                    down_until[nm] = up_t
                stats["zone_outages"] += 1
            if (spec.rolling_upgrade_at_s >= 0.0 and not upgrade_fired
                    and t >= spec.rolling_upgrade_at_s):
                upgrade_fired = True
                bsz = max(1, int(spec.rolling_upgrade_batch))
                hold = max(spec.tick_s, spec.rolling_upgrade_hold_s)
                for b, start in enumerate(range(0, n, bsz)):
                    bt = _round_t(t + b * hold)
                    up_t = _round_t(t + (b + 1) * hold)
                    for i in range(start, min(start + bsz, n)):
                        name = f"node-{i:04d}"
                        obj = {"t": bt, "kind": "node_upgrade",
                               "node": name}
                        if bt <= tv:
                            _emit(obj)
                        else:
                            _push(bt, obj)
                        _push(up_t, {"t": up_t, "kind": "node_up",
                                     "node": name})
                        stats["node_upgrades"] += 1
            # --- fault/churn processes (Poisson per tick) ----------
            if spec.link_burst_rate_per_s > 0.0:
                for _ in range(int(rng.poisson(
                        spec.link_burst_rate_per_s * spec.tick_s))):
                    rk = rack_keys[int(rng.integers(len(rack_keys)))]
                    nodes = racks_of[rk]
                    factor = round(float(spec.link_burst_factor
                                         * rng.uniform(0.5, 1.5)), 3)
                    _emit({"t": tv, "kind": "link_degrade",
                           "nodes": nodes, "factor": factor})
                    _push(_round_t(t + spec.link_burst_duration_s),
                          {"t": _round_t(
                              t + spec.link_burst_duration_s),
                           "kind": "link_repair",
                           "nodes": nodes, "factor": factor})
                    stats["link_bursts"] += 1
            if spec.node_churn_rate_per_s > 0.0:
                for nm in [nm for nm, up in down_until.items()
                           if up <= t]:
                    del down_until[nm]
                for _ in range(int(rng.poisson(
                        spec.node_churn_rate_per_s * spec.tick_s))):
                    name = f"node-{int(rng.integers(n)):04d}"
                    if name in down_until:
                        continue
                    up_t = _round_t(t + spec.node_down_duration_s)
                    down_until[name] = up_t
                    _emit({"t": tv, "kind": "node_down", "node": name})
                    _push(up_t, {"t": up_t, "kind": "node_up",
                                 "node": name})
                    stats["node_churn"] += 1
            if spec.state_fault_rate_per_s > 0.0:
                for _ in range(int(rng.poisson(
                        spec.state_fault_rate_per_s * spec.tick_s))):
                    fault = STATE_FAULT_CLASSES[
                        int(rng.integers(len(STATE_FAULT_CLASSES)))]
                    _emit({"t": tv, "kind": "state_fault",
                           "fault": fault})
                    stats["state_faults"] += 1

            # --- arrivals (diurnal Poisson) ------------------------
            arrivals = int(rng.poisson(
                spec.base_rate * spec.tick_s * _diurnal(spec, t)))
            made = 0
            while made < arrivals:
                roll = rng.random()
                if roll < class_probs[0]:
                    cls, mean = "batch", spec.batch_lifetime_s
                elif roll < class_probs[0] + class_probs[1]:
                    cls, mean = "gang", spec.gang_lifetime_s
                elif roll < class_probs.sum():
                    cls, mean = "longrun", None
                else:
                    cls, mean = "serving", spec.serving_lifetime_s
                if cls == "gang":
                    size = int(spec.gang_sizes[
                        int(rng.integers(len(spec.gang_sizes)))])
                    group = f"gang-{gang_seq:06d}"
                    gang_seq += 1
                    # Elastic shape family (v2): declared on every
                    # member, identical string.  The 0-fraction guard
                    # short-circuits the rng draw, so v1-equivalent
                    # specs keep a byte-identical event stream.
                    shapes = ""
                    if (spec.gang_shapes_fraction > 0.0
                            and size >= 2
                            and rng.random()
                            < spec.gang_shapes_fraction):
                        shapes = f"{size},{max(1, size // 2)}:0.5"
                        stats["shaped_gangs"] += 1
                    life = _round_t(t + _lifetime(mean))
                    names = []
                    for m in range(size):
                        name = f"{group}-w{m:03d}"
                        names.append(name)
                        pod = {
                            "name": name,
                            "cpu": spec.gang_cpu,
                            "mem": spec.gang_mem,
                            "net_bw": spec.gang_netbw,
                            "pod_group": group,
                            "gang_min_member": size,
                            "priority": 5.0,
                        }
                        if shapes:
                            pod["gang_shapes"] = shapes
                        _emit({"t": tv, "kind": "pod",
                               "pod_class": cls, "pod": pod})
                        pod_seq += 1
                    for name in names:
                        _push(life, {"t": life, "kind": "delete",
                                     "pod": name})
                        stats["deletes"] += 1
                    stats["pods"] += size
                    stats["gangs"] += 1
                    made += size
                    continue
                svc = int(rng.integers(spec.services))
                name = f"pod-{cls[0]}{svc:03d}-{pod_seq:08d}"
                pod_seq += 1
                pod = {"name": name, "group": f"svc-{svc % 28}",
                       "priority": round(float(rng.uniform(0, 10)), 3),
                       **_requests()}
                peers = _peers(svc)
                if peers:
                    pod["peers"] = peers
                _emit({"t": tv, "kind": "pod", "pod_class": cls,
                       "pod": pod})
                _note_recent(svc, name)
                if mean is not None:
                    life = _round_t(t + _lifetime(mean))
                    _push(life, {"t": life, "kind": "delete",
                                 "pod": name})
                    stats["deletes"] += 1
                stats["pods"] += 1
                made += 1
            t += spec.tick_s

        # Flush every remaining scheduled event (departures/repairs
        # past the arrival horizon) so the trace closes consistent.
        _drain_heap(math.inf)

    return stats
