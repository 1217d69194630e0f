"""Lightweight Kubernetes API object mirrors.

Only the fields the scheduling path actually consumes, mirroring what
the reference touches on client-go objects: pod name/namespace/UID and
``spec.schedulerName`` / ``spec.nodeName`` (scheduler.go:170, :196-206,
:224-229), node names (scheduler.go:182), plus the request/affinity/
toleration surface the reference *should* have consulted but never did
(its ``prioritize`` ignores the pod, scheduler.go:248).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

_uid_counter = itertools.count(1)


def _next_uid(prefix: str) -> str:
    return f"{prefix}-{next(_uid_counter):08x}"


@dataclasses.dataclass(slots=True)
class Node:
    """A schedulable node.

    ``capacity`` maps resource name -> allocatable amount (cpu cores,
    mem GiB, net bandwidth Gbps — the :class:`~..config.Resource` axes).
    ``labels`` and ``taints`` are plain string sets; the encoder interns
    them into the bitmask columns of ``ClusterState``.
    """

    name: str
    capacity: Mapping[str, float] = dataclasses.field(default_factory=dict)
    labels: frozenset[str] = frozenset()
    taints: frozenset[str] = frozenset()
    ready: bool = True
    # Cordoned (kubectl cordon -> spec.unschedulable): running pods
    # stay, no new placements.
    unschedulable: bool = False
    # Optional topology hints used by the fake-cluster network model.
    zone: str = ""
    rack: str = ""


@dataclasses.dataclass(slots=True)
class Pod:
    """A pod to schedule.

    ``peers`` names already-known traffic partners (pod names) with
    relative traffic volumes; the encoder resolves placed peers to node
    indices.  ``group`` is the pod's (anti-)affinity group label —
    the hostname-topology reduction of k8s inter-pod affinity.
    """

    name: str
    namespace: str = "default"
    uid: str = dataclasses.field(default_factory=lambda: _next_uid("pod"))
    scheduler_name: str = "netAwareScheduler"
    node_name: str = ""  # empty = pending (scheduler.go:170)
    requests: Mapping[str, float] = dataclasses.field(default_factory=dict)
    peers: Mapping[str, float] = dataclasses.field(default_factory=dict)
    tolerations: frozenset[str] = frozenset()
    node_selector: frozenset[str] = frozenset()
    # The pod's own labels (``k=v`` strings) — the basis of
    # LABEL-driven group membership: a pod is a member of every
    # registered selector-group its labels satisfy (kube semantics),
    # in addition to its explicit ``group`` annotation below.
    labels: frozenset[str] = frozenset()
    group: str = ""
    affinity_groups: frozenset[str] = frozenset()
    anti_groups: frozenset[str] = frozenset()
    # Selector definitions for group keys referenced by this pod's
    # (anti-)affinity/spread terms: canonical group key -> selector
    # structure ``(matchLabels sorted ((k, v), ...), matchExpressions
    # sorted ((op, key, values), ...))``.  The encoder registers these
    # so OTHER pods' labels can be evaluated for membership — the
    # labelSelector-parity path (no annotation opt-in required).
    selector_defs: Mapping[str, tuple] = dataclasses.field(
        default_factory=dict)
    # Zone-scoped (topologyKey: topology.kubernetes.io/zone) required
    # pod (anti-)affinity: the pod must land in a zone hosting a
    # member of some ``zone_affinity_groups`` group / hosting no
    # member of any ``zone_anti_groups`` group.  The hostname-scoped
    # pair above stays the node-level machinery; kube's symmetric
    # anti-affinity holds at zone scope too (ClusterState.az_anti).
    zone_affinity_groups: frozenset[str] = frozenset()
    zone_anti_groups: frozenset[str] = frozenset()
    # Preferred (soft) affinity, the weighted score-term counterpart of
    # the hard masks above — ``preferredDuringSchedulingIgnoredDuring
    # Execution`` semantics (the reference's own probe server relied on
    # it, netperfScript/deployment.yaml:17-26).  Each term is
    # ``(labels-or-group, weight)``; weight follows the k8s 1-100
    # scale and may be negative for avoidance (soft anti-affinity).
    #
    # - ``soft_node_affinity``: ((frozenset{"k=v", ...}, weight), ...)
    #   — score bonus on nodes carrying ALL labels of the term.
    # - ``soft_group_affinity``: (("group", weight), ...) — score
    #   bonus on nodes already hosting a pod of that group (negative
    #   weight = preferred spreading).
    soft_node_affinity: tuple = ()
    soft_group_affinity: tuple = ()
    # - ``soft_zone_affinity``: (("group", weight), ...) — score bonus
    #   on nodes whose ZONE hosts a member of that group (preferred
    #   podAffinity with topologyKey topology.kubernetes.io/zone);
    #   negative weight = preferred zone-level spreading.
    soft_zone_affinity: tuple = ()
    # Zone-level topologySpreadConstraints: ``spread_maxskew`` 0
    # disables; ``spread_hard`` True = whenUnsatisfiable: DoNotSchedule
    # (mask), False = ScheduleAnyway (score penalty per unit of excess
    # skew).  ``spread_group`` names the COUNTED pod set (the
    # constraint's labelSelector reduced to a group key, with its
    # definition in ``selector_defs``); empty = the pod's own
    # ``group``.
    spread_maxskew: int = 0
    spread_hard: bool = True
    spread_group: str = ""
    # Hard ``requiredDuringSchedulingIgnoredDuringExecution``
    # nodeAffinity (the matchExpressions form the reference's probe
    # Deployment used only in its *preferred* stanza,
    # netperfScript/deployment.yaml:17-26): a tuple of
    # nodeSelectorTerms, OR'd; each term a tuple of expressions,
    # AND'd; each expression ``(op, key, values)`` with op one of
    # "In" / "NotIn" / "Exists" / "DoesNotExist" / "Gt" / "Lt"
    # (numeric operators compare the node label's parsed value via
    # the encoder's numeric label table).  ``node_selector`` (the map
    # form) ANDs with this, matching Kubernetes.
    required_node_affinity: tuple = ()
    priority: float = 0.0
    # Count of hard constraints lost/narrowed at PARSE time (e.g. a
    # required anti-affinity term with an unrepresentable selector
    # dropped open, or an affinity term degraded to the unsatisfiable
    # sentinel).  The encoder folds this into the same per-pod
    # ConstraintDegraded event stream as interner-overflow drops, so
    # parse-time degradation is operator-visible too.
    parse_degraded: int = 0
    # Human-readable descriptions of the parse-time drops above —
    # surfaced verbatim in the ConstraintDegraded event so operators
    # see WHICH term stopped being enforced (an anti-affinity term
    # dropped OPEN is otherwise invisible until a co-location
    # violation bites).
    parse_degraded_detail: tuple = ()
    # Annotation-level PodDisruptionBudget: at least this many members
    # of the pod's ``group`` must stay up — preemption may not disrupt
    # below it.  With no group, a nonzero value protects the pod
    # itself from preemption outright.
    pdb_min_available: int = 0
    # Gang scheduling (multi-host slice jobs): pods sharing a
    # ``pod_group`` are placed all-or-nothing.  ``gang_min_member`` is
    # the gang size the group gates on (the pod-group annotation's
    # minMember); 0 or 1 means the pod schedules independently.
    # ``gang_timeout_s`` bounds how long an incomplete gang may sit
    # gated before its members are released back with a
    # FailedScheduling event (0 = the scheduler config default).
    pod_group: str = ""
    gang_min_member: int = 0
    gang_timeout_s: float = 0.0
    # Elastic gang reshaping: the family of acceptable physical
    # realizations for the pod's gang, as ``((member_count, priority),
    # ...)`` sorted by declared preference.  Empty = the gang is rigid
    # (all-or-nothing at ``gang_min_member``).
    # A realization places exactly ``member_count`` of the gang's
    # members; ``priority`` in (0, 1] weights how desirable that shape
    # is relative to the full one (the placer commits the feasible
    # realization maximizing priority-weighted realized desirability).
    gang_shapes: tuple = ()


@dataclasses.dataclass(frozen=True, slots=True)
class PodDisruptionBudget:
    """A ``policy/v1`` PodDisruptionBudget, reduced to what the
    preemption planner consumes: the selector (canonicalized to a
    selector-group, so member counting rides the same label-driven
    machinery as affinity) and the disruption bound.

    Exactly one of the four bound fields is normally set (kube rejects
    specs with both minAvailable and maxUnavailable); percentages are
    resolved against the LIVE member count at planning time (kube
    resolves against the controller's expected scale — a documented
    delta; ceil for minAvailable, floor for maxUnavailable, both the
    conservative direction)."""

    name: str
    namespace: str = "default"
    uid: str = ""
    selector_key: str = ""     # canonical group key of the selector
    selector_def: tuple = ((), ())
    min_available: int | None = None
    min_available_pct: float | None = None
    max_unavailable: int | None = None
    max_unavailable_pct: float | None = None


@dataclasses.dataclass(frozen=True, slots=True)
class Binding:
    """The bind record POSTed on placement (scheduler.go:196-206)."""

    pod_name: str
    namespace: str
    node_name: str


@dataclasses.dataclass(frozen=True, slots=True)
class Event:
    """A ``Scheduled`` event (scheduler.go:214-233)."""

    message: str
    reason: str
    involved_pod: str
    namespace: str
    component: str
    count: int = 1
    type: str = "Normal"
    # Structured link identity for LinkDegraded/LinkQuarantined:
    # ``(src, dst, reason, streak)`` — a stable machine-consumable
    # field the rebalancer (core/rebalance.py) and operators' kubectl
    # filters can key on instead of parsing the human message.
    # Empty for every non-link event; defaulted so existing
    # constructors and wire serializations are unchanged.
    link: tuple = ()


def link_event(src: str, dst: str, reason: str, streak: int,
               message: str, component: str) -> Event:
    """A LinkDegraded/LinkQuarantined Warning carrying the structured
    ``(src, dst, reason, streak)`` payload, so a consumer can key on
    the link identity instead of parsing the human message."""
    return Event(
        message=message,
        reason=reason,
        involved_pod="",
        namespace="default",
        component=component,
        type="Warning",
        link=(src, dst, reason, int(streak)),
    )


def scheduled_event(pod: Pod, node_name: str, component: str) -> Event:
    """Parity with the reference's event payload: ``Assigned pod X to Y``
    (scheduler.go:211)."""
    return Event(
        message=f"Assigned pod {pod.name} to {node_name}",
        reason="Scheduled",
        involved_pod=pod.name,
        namespace=pod.namespace,
        component=component,
    )


def failed_event(pod: Pod, component: str, why: str) -> Event:
    """Emitted when no feasible node exists — the reference silently
    bound to the empty string in this case (findBestNode returns ""
    when all priorities are 0-valued or the map is empty,
    scheduler.go:384-394)."""
    return Event(
        message=f"Failed to schedule pod {pod.name}: {why}",
        reason="FailedScheduling",
        involved_pod=pod.name,
        namespace=pod.namespace,
        component=component,
        type="Warning",
    )


__all__: Sequence[str] = ("Node", "Pod", "PodDisruptionBudget",
                          "Binding", "Event",
                          "scheduled_event", "failed_event",
                          "link_event")
