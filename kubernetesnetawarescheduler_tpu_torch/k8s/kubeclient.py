"""A real API-server :class:`~.client.ClusterClient` over stdlib HTTP.

The reference reaches Kubernetes through client-go: in-cluster config
(scheduler.go:144), a shared-informer watch on pods/nodes
(scheduler.go:161-187), POST Binding (scheduler.go:196-206) and POST
Event (scheduler.go:214-233).  This module provides the same four
touchpoints as a standalone daemon WITHOUT a kubernetes client
library — just ``http.client`` + ``ssl`` — so the core stays
dependency-free and the daemon runs in any pod with a ServiceAccount.

Scope: exactly what the scheduling path consumes (the contract in
:class:`~.client.ClusterClient`), not a general k8s client.  Watches
are plain ``?watch=true`` chunked streams decoded line-by-line;
reconnect-with-resourceVersion handles the API server closing them.

Pod/Node JSON is mapped into the framework's lightweight types:

- resource requests: sum over containers of ``spec.containers[].
  resources.requests`` (cpu/memory parsed with k8s quantity suffixes);
  net bandwidth from the ``netaware.io/bandwidth-gbps`` annotation.
- network peers: the ``netaware.io/peers`` annotation, a JSON object
  ``{"other-pod": relative_traffic}`` — the declarative replacement
  for the reference's pod-blind scoring (its ``prioritize`` ignored
  the pod entirely, scheduler.go:248).
- affinity groups: ``netaware.io/group``, ``netaware.io/affinity``,
  ``netaware.io/anti-affinity`` annotations (comma-separated), the
  hostname-topology reduction of inter-pod affinity the score kernel
  masks on.
- labels/taints/selectors: flattened to ``key=value`` strings for the
  encoder's interners.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import ssl
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

from kubernetesnetawarescheduler_tpu_torch.k8s.client import (
    ClusterClient,
    NodeHandler,
    PodHandler,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
    Binding,
    Event,
    Node,
    Pod,
)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class _NodelayHTTPConnection(http.client.HTTPConnection):
    """``http.client`` leaves Nagle ON; with the request written as
    separate header/body sends and small JSON responses, a keep-alive
    POST round-trip stalls on the 40 ms delayed-ACK interaction —
    measured 22.7 binds/s per connection against an un-tuned Python
    server vs 4,800+ with TCP_NODELAY (tools/bind_budget.py).  Go's
    net/http (client-go AND kube-apiserver) sets TCP_NODELAY on every
    TCP connection, so this also matches the transport the reference
    actually ran on (scheduler.go:196-206 via client-go)."""

    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _NodelayHTTPSConnection(http.client.HTTPSConnection):
    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _StaleConnection(Exception):
    """A pooled keep-alive connection failed mid-request.  ``retryable``
    is False when the request may already have been applied server-side
    (sent non-GET) — the caller re-raises ``cause`` instead of blindly
    replaying."""

    def __init__(self, cause: Exception, retryable: bool) -> None:
        super().__init__(str(cause))
        self.cause = cause
        self.retryable = retryable


class _WatchExpired(Exception):
    """Internal: the server reported the watch resourceVersion stale
    (410 Gone) — reconnect from scratch."""


class ApiServerError(RuntimeError):
    """A non-2xx API-server response that is neither a 404 (KeyError)
    nor a 409 (ValueError).  Subclasses RuntimeError so every existing
    transient-error handler keeps working; ``status`` lets resilience
    code distinguish a browned-out control plane (5xx, 429) from a
    request the server understood and rejected (4xx)."""

    def __init__(self, message: str, status: int = 0) -> None:
        super().__init__(message)
        self.status = status


def _brownout_error(exc: BaseException) -> bool:
    """Does this exception say the control plane itself is unhealthy?
    5xx and 429 (server overloaded) count; connection-level failures
    count; 4xx semantic rejections do NOT — the server answered."""
    if isinstance(exc, ApiServerError):
        return exc.status >= 500 or exc.status == 429
    return isinstance(exc, (OSError, http.client.HTTPException))


class CircuitBreaker:
    """closed -> open -> half_open breaker over API-server health.

    ``record_failure`` within a sliding ``window_s`` trips the breaker
    at ``failure_threshold``; after ``cooldown_s`` the breaker offers
    HALF-OPEN (one probe's worth of traffic); a success there closes
    it, a failure re-opens it.  ``clock`` is injectable so chaos soaks
    can drive it on virtual time.  Thread-safe: the bind worker, watch
    threads and the cycle thread all record into it."""

    _CODES = {"closed": 0, "half_open": 1, "open": 2}

    def __init__(self, failure_threshold: int = 5,
                 window_s: float = 30.0, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures: list[float] = []
        self._opened_at = 0.0
        self.opens_total = 0
        self.failures_total = 0

    def _state_locked(self) -> str:
        if (self._state == "open"
                and self.clock() - self._opened_at >= self.cooldown_s):
            self._state = "half_open"
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    @property
    def state_code(self) -> int:
        """0=closed, 1=half_open, 2=open (the gauge encoding)."""
        return self._CODES[self.state]

    def allow(self) -> bool:
        """May a request be attempted right now?  half_open allows
        (that IS the probe); open refuses."""
        return self.state != "open"

    def _open_locked(self, now: float) -> None:
        self._state = "open"
        self._opened_at = now
        self._failures.clear()
        self.opens_total += 1

    def record_success(self) -> None:
        # Successes do NOT erase the failure window while closed: a
        # 50%-failing server is still browned out, and interleaved
        # successes must not keep the breaker from tripping.  Only the
        # half-open probe's success clears state (the server answered
        # after a full cooldown).
        with self._lock:
            if self._state_locked() == "half_open":
                self._state = "closed"
                self._failures.clear()

    def record_failure(self) -> None:
        now = self.clock()
        with self._lock:
            self.failures_total += 1
            state = self._state_locked()
            if state == "open":
                return
            if state == "half_open":
                # The probe failed: straight back to open, fresh
                # cooldown.
                self._open_locked(now)
                return
            self._failures.append(now)
            cutoff = now - self.window_s
            self._failures = [t for t in self._failures if t >= cutoff]
            if len(self._failures) >= self.failure_threshold:
                self._open_locked(now)


class RetryBudget:
    """A shared per-cycle retry allowance: every retry across every
    call path draws from ONE pool, reset by the scheduler cycle via
    :meth:`begin_cycle`.  Bounds the worst-case added latency a
    browned-out API server can inject into one cycle (N retries total,
    not N per request)."""

    def __init__(self, per_cycle: int = 8) -> None:
        self.per_cycle = max(0, int(per_cycle))
        self._left = self.per_cycle
        self._lock = threading.Lock()
        self.retries_total = 0
        self.exhausted_total = 0

    def begin_cycle(self) -> None:
        with self._lock:
            self._left = self.per_cycle

    def take(self) -> bool:
        with self._lock:
            if self._left > 0:
                self._left -= 1
                self.retries_total += 1
                return True
            self.exhausted_total += 1
            return False


def backoff_delay(attempt: int, base_s: float = 0.05,
                  max_s: float = 2.0,
                  rand: Callable[[], float] | None = None) -> float:
    """Jittered exponential backoff: ``base * 2^attempt`` capped at
    ``max_s``, scaled by a uniform [0.5, 1.5) jitter so a fleet of
    retrying clients cannot re-synchronize into thundering herds."""
    if rand is None:
        import random

        rand = random.random
    ceiling = min(max_s, base_s * (2.0 ** max(0, attempt)))
    return ceiling * (0.5 + rand())


ANN_PEERS = "netaware.io/peers"
ANN_GROUP = "netaware.io/group"
ANN_AFFINITY = "netaware.io/affinity"
ANN_ANTI = "netaware.io/anti-affinity"
ANN_BANDWIDTH = "netaware.io/bandwidth-gbps"
ANN_PDB = "netaware.io/pdb-min-available"
ANN_SOFT_AFFINITY = "netaware.io/soft-affinity"


# -- k8s quantity parsing ---------------------------------------------

_SUFFIX = {
    "n": 1e-9, "u": 1e-6, "k": 1e3,
    "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40,
    "Pi": 2 ** 50, "Ei": 2 ** 60,
}


def parse_quantity(q: str | int | float) -> float:
    """Parse a k8s resource quantity (``500m``, ``2``, ``1Gi``,
    ``100n``) to a float in base units (cores for cpu, bytes for
    memory).  Unparseable input yields 0.0 — the watch is
    cluster-wide, and one pod with an exotic quantity must degrade
    only itself, not crash event delivery."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    if not s:
        return 0.0
    try:
        if s.endswith("m"):
            return float(s[:-1]) / 1000.0
        for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei"):
            if s.endswith(suf):
                return float(s[: -len(suf)]) * _SUFFIX[suf]
        if s[-1] in _SUFFIX:
            return float(s[:-1]) * _SUFFIX[s[-1]]
        return float(s)
    except ValueError:
        return 0.0


def _flatten(m: Mapping[str, str] | None) -> frozenset[str]:
    if not m:
        return frozenset()
    return frozenset(f"{k}={v}" for k, v in m.items())


def _preferred_node_terms(spec: Mapping) -> tuple:
    """Extract ``preferredDuringSchedulingIgnoredDuringExecution``
    nodeAffinity terms as ``((frozenset{"k=v", ...}, weight), ...)`` —
    the stanza the reference's own probe deployment used
    (netperfScript/deployment.yaml:17-26).

    Representable shapes (soft semantics, so anything else degrades
    score-neutrally by skipping the term):

    - every matchExpression a single-value ``In`` → one term ANDing
      all ``key=value`` labels (k8s: expressions within a term AND);
    - exactly one multi-value ``In`` expression → one term per value,
      same weight (k8s: values within an expression OR).
    """
    na = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    out = []
    for term in na.get(
            "preferredDuringSchedulingIgnoredDuringExecution") or []:
        try:
            weight = float(term.get("weight", 0) or 0)
        except (TypeError, ValueError):
            continue
        exprs = (term.get("preference") or {}).get("matchExpressions") or []
        if not weight or not exprs:
            continue
        if all(e.get("operator") == "In" and e.get("key")
               and len(e.get("values") or []) == 1 for e in exprs):
            labels = frozenset(
                f"{e['key']}={e['values'][0]}" for e in exprs)
            out.append((labels, weight))
        elif (len(exprs) == 1 and exprs[0].get("operator") == "In"
              and exprs[0].get("key") and exprs[0].get("values")):
            key = exprs[0]["key"]
            out.extend((frozenset({f"{key}={v}"}), weight)
                       for v in exprs[0]["values"])
    return tuple(out)


_NS_OPS = frozenset({"In", "NotIn", "Exists", "DoesNotExist",
                     "Gt", "Lt"})


def _required_node_terms(spec: Mapping) -> tuple:
    """``requiredDuringSchedulingIgnoredDuringExecution`` nodeAffinity
    as ``((("In", key, (v, ...)), ...), ...)`` — OR'd nodeSelectorTerms
    of AND'd matchExpressions, the HARD sibling of
    :func:`_preferred_node_terms` (types.Pod.required_node_affinity).

    All six kube operators are representable: In/NotIn/Exists/
    DoesNotExist through the label-bit machinery, Gt/Lt through the
    encoder's numeric label table (single integer value, kube's
    contract).  Hard semantics, so MALFORMED input degrades CLOSED: a
    bad shape makes its TERM unsatisfiable (``("In", key, ())`` — the
    encoder maps empty-values In to the UNKNOWN sentinel) rather than
    being skipped, which would silently widen where the pod may land.
    ``matchFields`` (metadata.name matching) is unrepresentable."""
    na = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    req = (na.get("requiredDuringSchedulingIgnoredDuringExecution")
           or {})
    out = []
    for term in req.get("nodeSelectorTerms") or []:
        exprs = []
        bad = False
        if term.get("matchFields"):
            bad = True
        for e in term.get("matchExpressions") or []:
            op = e.get("operator")
            key = e.get("key")
            values = tuple(str(v) for v in e.get("values") or ())
            if (op not in _NS_OPS or not key
                    or (op in ("In", "NotIn") and not values)
                    or (op in ("Exists", "DoesNotExist") and values)
                    or (op in ("Gt", "Lt") and len(values) != 1)):
                bad = True
                continue
            exprs.append((op, key, values))
        if bad:
            out.append((("In", "", ()),))  # unsatisfiable term
        elif exprs:
            out.append(tuple(exprs))
        # A term with no expressions at all matches nothing in k8s
        # (empty nodeSelectorTerm selects no objects) — dropping it is
        # OR-equivalent ONLY while another term survives; the
        # all-terms-empty case is handled below.
    if not out and (req.get("nodeSelectorTerms") or []):
        # Every term was empty: k8s semantics are "matches nowhere"
        # (the pod stays Pending), not "no constraint" — returning ()
        # here would degrade a hard constraint OPEN.
        out.append((("In", "", ()),))
    return tuple(out)


def _preferred_group_terms(spec: Mapping, ann: Mapping,
                           namespace: str = "default") -> tuple:
    """Soft pod-(anti-)affinity as ``(host_terms, zone_terms, defs)``
    — term banks of ``(("group", weight), ...)`` plus the selector
    definitions their group keys need registered.

    Two surfaces merge into the host bank: the native annotation
    ``netaware.io/soft-affinity`` (JSON ``{"group": weight}``, negative
    = preferred spreading), and the k8s ``podAffinity``/
    ``podAntiAffinity`` preferred stanzas with ``topologyKey:
    kubernetes.io/hostname``.  Zone-topologyKey preferred stanzas land
    in the zone bank (scored against zone-resident membership,
    ``score.soft_zone_scores``) — a node-scoped term would actively
    misscore them (full spread bonus for a different node in the SAME
    zone).  Arbitrary labelSelectors canonicalize via
    :func:`_selector_key_def` (membership is label-driven); only
    malformed selectors and foreign topologyKeys degrade
    score-neutrally (soft semantics)."""
    out = []
    zone_out = []
    defs: dict[str, tuple] = {}
    if ANN_SOFT_AFFINITY in ann:
        try:
            raw = json.loads(ann[ANN_SOFT_AFFINITY])
            # Built fully before extending: a malformed entry rejects
            # the WHOLE annotation (score-neutral), never half of it.
            # Bare group names are namespace-qualified like every
            # other annotation group surface (pod_from_json _nsq;
            # NS_SEP keeps qualified keys collision-free).
            def _q(g: str) -> str:
                if "/" in g:
                    head, tail = g.split("/", 1)
                    return f"{head}{NS_SEP}{tail}"
                return f"{namespace}{NS_SEP}{g}"

            parsed = [(_q(str(g)), float(v))
                      for g, v in raw.items()
                      if float(v)]  # weight-0 entries are no-ops
            out.extend(parsed)
        except (ValueError, TypeError, AttributeError):
            pass  # malformed annotation degrades score-neutrally
    aff = spec.get("affinity") or {}
    for kind, sign in (("podAffinity", 1.0), ("podAntiAffinity", -1.0)):
        for term in (aff.get(kind) or {}).get(
                "preferredDuringSchedulingIgnoredDuringExecution") or []:
            try:
                weight = float(term.get("weight", 0) or 0)
            except (TypeError, ValueError):
                continue
            pat = term.get("podAffinityTerm") or {}
            tk = pat.get("topologyKey")
            if tk not in (_HOST_KEY, _ZONE_KEY):
                continue
            scope = _term_ns_scope(pat, namespace)
            kd = (None if scope == "unrepresentable" else
                  _selector_key_def(pat.get("labelSelector") or {},
                                    ns_scope=scope))
            if not weight or kd is None:
                # Malformed selector: degrade score-neutrally (soft
                # semantics) — scoring a DIFFERENT group than the k8s
                # selector selects would misdirect the bias.
                continue
            group, sel_def = kd
            defs[group] = sel_def
            (out if tk == _HOST_KEY else zone_out).append(
                (group, sign * weight))
    return tuple(out), tuple(zone_out), defs


_SEL_OPS = frozenset({"In", "NotIn", "Exists", "DoesNotExist"})

# Reserved pseudo-label key carrying the pod's namespace for selector
# evaluation.  Kubernetes label keys are validated server-side to
# ``[A-Za-z0-9._-]`` names (optionally ``dns.prefix/``-qualified), so a
# NUL byte can never collide with — or be spoofed by — a real workload
# label (same trick as :data:`UNSAT_GROUP`).  ``pod_from_json`` injects
# ``\x00ns=<namespace>`` into every parsed pod's label set, and
# namespace-scoped selector defs carry an ``("In", "\x00ns", (...))``
# expression, so namespace scoping rides the ordinary
# ``selector_matches`` path with no schema change.
_NS_KEY = "\x00ns"
# Separator between a namespace qualifier and the group body in
# canonical group keys: ``<ns>\x00/<body>``.  A bare "/" would be
# ambiguous — label KEYS may legally carry a "dns.prefix/" (so the
# cluster-wide key for ``{team/app: x}`` is the string "team/app=x",
# which a "/"-separated qualifier for namespace "team" + ``app=x``
# would collide with, silently merging two different selectors into
# one group bit); no legal label key, value, or namespace contains a
# NUL byte.
NS_SEP = "\x00/"


def _selector_key_def(sel: Mapping, ns_scope: tuple | None = None
                      ) -> tuple[str, tuple] | None:
    """Canonicalize an ARBITRARY labelSelector to ``(group_key,
    selector_def)``, or ``None`` when malformed (an operator outside
    In/NotIn/Exists/DoesNotExist, a missing key, or a value list that
    contradicts the operator's arity).

    ``selector_def`` is the structure :func:`~...core.encode.
    selector_matches` evaluates against pod labels — the
    labelSelector-parity path: membership is decided by LABELS, no
    annotation opt-in (kube semantics).

    ``ns_scope`` is the namespace scope of the term this selector came
    from: ``None`` means
    cluster-wide (all namespaces — kube's ``namespaceSelector: {}``),
    a tuple of names restricts membership to pods of those namespaces
    by injecting an ``In`` expression on :data:`_NS_KEY`.  Distinct
    scopes therefore canonicalize to DISTINCT group keys: a ``team-a``
    pod's term never shares a bit with the same labels in ``team-b``.

    Key convention: selectors reducible to an exact-label conjunction
    (``matchLabels`` plus single-value non-conflicting ``In``
    expressions) keep the sorted ``k=v[,k=v]`` key — cluster-wide
    scope keeps the legacy bare string (the SAME key the
    ``netaware.io/group`` annotation convention uses, so both
    membership surfaces share one bit); a single-namespace scope
    prefixes it as ``ns\\x00/k=v[,k=v]`` (:data:`NS_SEP` — a bare "/"
    would collide with cluster-wide keys whose label key carries a
    ``dns.prefix/``), matching how ``pod_from_json``
    namespace-qualifies annotation group names — so the bit sharing
    survives scoping.  Richer selectors and multi-namespace scopes get
    a canonical ``sel:`` key (the repr covers the ns expression).  An
    empty selector matches every pod (kube's empty-LabelSelector rule)
    under ``sel:any`` / ``ns\\x00/sel:any``."""
    match = dict(sel.get("matchLabels") or {})
    exprs = []
    for e in sel.get("matchExpressions") or []:
        op = e.get("operator")
        key = e.get("key")
        values = tuple(sorted(str(v) for v in e.get("values") or ()))
        if (op not in _SEL_OPS or not key
                or (op in ("In", "NotIn") and not values)
                or (op in ("Exists", "DoesNotExist") and values)):
            return None
        if (op == "In" and len(values) == 1
                and match.get(key, values[0]) == values[0]):
            match[key] = values[0]  # exact-match expression: fold
            continue
        exprs.append((str(op), str(key), values))
    ml = tuple(sorted((str(k), str(v)) for k, v in match.items()))
    exprs_t = tuple(sorted(exprs))
    ns_exprs = ()
    prefix = ""
    if ns_scope is not None:
        ns_t = tuple(sorted(str(n) for n in ns_scope))
        if not ns_t:
            return None  # empty scope selects nothing representable
        ns_exprs = (("In", _NS_KEY, ns_t),)
        if len(ns_t) == 1:
            prefix = f"{ns_t[0]}{NS_SEP}"
    if not exprs_t and (ns_scope is None or prefix):
        if not ml:
            return f"{prefix}sel:any", ((), ns_exprs)
        return (prefix + ",".join(f"{k}={v}" for k, v in ml),
                (ml, ns_exprs))
    full = (ml, tuple(sorted(exprs_t + ns_exprs)))
    return f"sel:{full!r}", full


def _term_ns_scope(term: Mapping, own_ns: str):
    """Resolve a ``podAffinityTerm``'s namespace scope, kube
    semantics (pkg/scheduler ``GetNamespaceLabelsSnapshot`` rules):

    - neither ``namespaces`` nor ``namespaceSelector`` → the pod's OWN
      namespace (the default the reference's probe placement leaned
      on, deployment.yaml:17-26, by delegating to stock kube);
    - ``namespaces: [...]`` → exactly those names;
    - ``namespaceSelector: {}`` (empty object) → ALL namespaces
      (returns ``None`` = cluster-wide, the pre-round-4 behavior);
    - a non-empty ``namespaceSelector`` needs Namespace-object labels
      this framework does not watch → ``"unrepresentable"`` (callers
      degrade per the affinity/anti contract).  A ``namespaces`` list
      alongside it would union with the selector's matches, which we
      cannot compute either.
    """
    nsel = term.get("namespaceSelector")
    if nsel is not None:
        if nsel.get("matchLabels") or nsel.get("matchExpressions"):
            return "unrepresentable"
        return None  # empty selector = all namespaces
    names = term.get("namespaces") or []
    if names:
        return tuple(sorted(str(n) for n in names))
    return (own_ns,)


_ZONE_KEY = "topology.kubernetes.io/zone"
_HOST_KEY = "kubernetes.io/hostname"
# Group name no real pod can carry (ANN_GROUP annotations are UTF-8
# text; a NUL byte never survives the API server): interning it yields
# a group bit that is present on no node/zone, so a required-affinity
# term we cannot represent makes the pod unschedulable (degrade
# CLOSED) instead of silently widening placement.
UNSAT_GROUP = "\x00unrepresentable"


def _required_group_terms(spec: Mapping, namespace: str = "default"
                          ) -> tuple:
    """``requiredDuringSchedulingIgnoredDuringExecution`` podAffinity /
    podAntiAffinity terms → ``(host_aff, host_anti, zone_aff,
    zone_anti)`` frozensets of group keys (the ``labelSelector
    .matchLabels`` reduction to the canonical sorted ``k=v[,k=v]``
    group string, matching ``netaware.io/group``).

    Scope/degradation contract:
    - Terms are NAMESPACE-scoped per kube semantics
      (:func:`_term_ns_scope`): default own-namespace, widened by
      ``namespaces:``/``namespaceSelector: {}``; a non-empty
      ``namespaceSelector`` is unrepresentable (no Namespace watch)
      and degrades like a malformed selector.
    - ``topologyKey: kubernetes.io/hostname`` terms land in the
      host-scoped sets, ``topology.kubernetes.io/zone`` in the
      zone-scoped ones.
    - ARBITRARY labelSelectors are representable: each canonicalizes
      to a selector-group (:func:`_selector_key_def`) whose membership
      the encoder evaluates against pod LABELS — no annotation opt-in
      (kube semantics).  Only malformed selectors and topologyKeys
      other than hostname/zone remain unrepresentable.
    - AFFINITY terms degrade CLOSED: an unrepresentable term
      contributes :data:`UNSAT_GROUP`, whose bit no resident carries —
      the pod stays unschedulable exactly where kube-scheduler could
      not have verified the constraint either.  Terms AND (the kernel
      subset-tests the union of term bits against resident groups),
      matching kube's all-terms join — so an UNSAT term keeps its
      CLOSED degradation even beside satisfiable terms.
    - ANTI-affinity terms are exact for any term count (every listed
      group is forbidden); an unrepresentable anti term drops OPEN,
      mirroring the interner-overflow direction for anti constraints
      (forbidding *everything* would be far harsher than kube).
    - Both degradations are counted in the returned ``degraded`` so
      the encoder emits the per-pod ConstraintDegraded event.
    - The first pod of a group with no live member gets kube's
      special-case waiver at ENCODE time (encoder
      ``_apply_first_pod_escape``) — required self-affinity no longer
      deadlocks the first replica.

    Returns ``(host_aff, host_anti, zone_aff, zone_anti, degraded,
    defs, detail)`` — ``defs`` maps each referenced group key to its
    selector definition for encoder registration; ``detail`` holds
    human-readable descriptions of each dropped term for the
    ConstraintDegraded event.
    """
    aff = spec.get("affinity") or {}
    host_aff, host_anti = set(), set()
    zone_aff, zone_anti = set(), set()
    degraded = 0
    detail: list[str] = []
    defs: dict[str, tuple] = {}
    for kind, is_anti in (("podAffinity", False), ("podAntiAffinity", True)):
        for term in (aff.get(kind) or {}).get(
                "requiredDuringSchedulingIgnoredDuringExecution") or []:
            tk = term.get("topologyKey")
            scope = _term_ns_scope(term, namespace)
            kd = (None if scope == "unrepresentable" else
                  _selector_key_def(term.get("labelSelector") or {},
                                    ns_scope=scope))
            if tk not in (_HOST_KEY, _ZONE_KEY) or kd is None:
                degraded += 1
                why = ("non-empty namespaceSelector (no Namespace "
                       "watch)" if scope == "unrepresentable"
                       else "malformed labelSelector" if kd is None
                       else f"unsupported topologyKey {tk!r}")
                detail.append(
                    f"required {kind} term dropped "
                    + ("OPEN (NOT enforced)" if is_anti
                       else "CLOSED (unsatisfiable)")
                    + f": {why}")
                if not is_anti:
                    (host_aff if tk != _ZONE_KEY else zone_aff).add(
                        UNSAT_GROUP)
                continue  # anti: degrade open (counted above)
            group, sel_def = kd
            defs[group] = sel_def
            target = {
                (False, _HOST_KEY): host_aff,
                (False, _ZONE_KEY): zone_aff,
                (True, _HOST_KEY): host_anti,
                (True, _ZONE_KEY): zone_anti,
            }[(is_anti, tk)]
            target.add(group)
    return (frozenset(host_aff), frozenset(host_anti),
            frozenset(zone_aff), frozenset(zone_anti), degraded, defs,
            tuple(detail))


def _spread_constraint(spec: Mapping, namespace: str = "default"
                       ) -> tuple[int, bool, str, dict]:
    """First zone-level ``topologySpreadConstraint`` as
    ``(maxSkew, hard, spread_group, defs)``; ``(0, True, "", {})`` =
    none.

    Scope notes: only ``topology.kubernetes.io/zone`` constraints are
    representable (hostname-level spreading is anti-affinity's job in
    this framework).  The counted pod set is the constraint's
    labelSelector, canonicalized to a selector-group
    (:func:`_selector_key_def`) scoped to the pod's OWN namespace —
    kube counts topology-spread members per namespace, always (no
    ``namespaces`` widening field exists on the constraint); a
    constraint WITHOUT a selector (or with a malformed one) falls
    back to the pod's own group (``spread_group == ""``).
    Unrepresentable constraints are skipped (degrade open)."""
    for c in spec.get("topologySpreadConstraints") or []:
        if c.get("topologyKey") != "topology.kubernetes.io/zone":
            continue
        try:
            skew = int(c.get("maxSkew", 0) or 0)
        except (TypeError, ValueError):
            continue
        if skew <= 0:
            continue
        hard = c.get("whenUnsatisfiable",
                     "DoNotSchedule") != "ScheduleAnyway"
        sel = c.get("labelSelector")
        if sel:
            kd = _selector_key_def(sel, ns_scope=(namespace,))
            if kd is not None:
                return skew, hard, kd[0], {kd[0]: kd[1]}
        return skew, hard, "", {}
    return 0, True, "", {}


def pod_from_json(obj: Mapping) -> Pod:
    """Map a v1.Pod JSON object to the framework :class:`Pod`."""
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    ann = meta.get("annotations") or {}

    # Effective pod request, kube-scheduler semantics:
    # max(sum(containers), max(initContainers)) + pod overhead.
    # Init containers run SEQUENTIALLY before the main ones, so the
    # node must fit whichever phase is larger, not their sum; sidecar
    # (restartable) init containers count like main containers.
    # spec.overhead is the RuntimeClass surcharge the scheduler must
    # reserve (kube adds it to the pod's effective request).
    cpu = mem = 0.0
    init_cpu = init_mem = 0.0
    sidecar_cpu = sidecar_mem = 0.0
    for c in spec.get("containers", []) or []:
        req = (c.get("resources") or {}).get("requests") or {}
        cpu += parse_quantity(req.get("cpu", 0))
        mem += parse_quantity(req.get("memory", 0))
    for c in spec.get("initContainers", []) or []:
        req = (c.get("resources") or {}).get("requests") or {}
        c_cpu = parse_quantity(req.get("cpu", 0))
        c_mem = parse_quantity(req.get("memory", 0))
        if c.get("restartPolicy") == "Always":  # sidecar: runs forever
            sidecar_cpu += c_cpu
            sidecar_mem += c_mem
        else:
            init_cpu = max(init_cpu, c_cpu + sidecar_cpu)
            init_mem = max(init_mem, c_mem + sidecar_mem)
    cpu = max(cpu + sidecar_cpu, init_cpu)
    mem = max(mem + sidecar_mem, init_mem)
    overhead = spec.get("overhead") or {}
    cpu += parse_quantity(overhead.get("cpu", 0))
    mem += parse_quantity(overhead.get("memory", 0))
    requests: dict[str, float] = {}
    if cpu:
        requests["cpu"] = cpu
    if mem:
        requests["mem"] = mem / 2 ** 30  # GiB, the Resource axis unit
    if ANN_BANDWIDTH in ann:
        try:
            requests["net"] = float(ann[ANN_BANDWIDTH])
        except ValueError:
            pass

    peers: dict[str, float] = {}
    if ANN_PEERS in ann:
        try:
            raw = json.loads(ann[ANN_PEERS])
            peers = {str(k): float(v) for k, v in raw.items()}
        except (ValueError, TypeError, AttributeError):
            peers = {}  # malformed annotation degrades to pod-blind

    tolerations = frozenset(
        f"{t.get('key', '')}={t.get('value', '')}"
        for t in spec.get("tolerations", []) or [] if t.get("key"))

    def _csv(key: str) -> frozenset[str]:
        v = ann.get(key, "")
        return frozenset(x.strip() for x in v.split(",") if x.strip())

    namespace = meta.get("namespace", "default")
    spread_skew, spread_hard, spread_group, spread_defs = \
        _spread_constraint(spec, namespace)
    (host_aff, host_anti, zone_aff, zone_anti, parse_degraded,
     req_defs, degraded_detail) = _required_group_terms(spec, namespace)
    soft_host_terms, soft_zone_terms, soft_defs = \
        _preferred_group_terms(spec, ann, namespace)
    selector_defs = {**req_defs, **soft_defs, **spread_defs}
    # Qualify peer references with the pod's own namespace (unless the
    # annotation already says "ns/name"): the pod cache and node_of()
    # are namespace-keyed, and a bare name would collide across
    # namespaces (same-named pods in staging/prod are routine).
    peers = {(k if "/" in k else f"{namespace}/{k}"): v
             for k, v in peers.items()}

    def _nsq(group: str) -> str:
        """Namespace-qualify a bare annotation group name (explicit
        ``ns/name`` opts into cross-namespace grouping, same
        convention as peers above; the canonical internal form uses
        :data:`NS_SEP` so the key can never collide with a
        cluster-wide key whose label carries a ``dns.prefix/``).
        Keeps the annotation surface and the namespace-scoped
        selector keys sharing one bit: selector ``app=db`` in team-a
        and annotation group ``app=db`` on a team-a pod both intern
        as ``team-a\\x00/app=db``."""
        if "/" in group:
            head, tail = group.split("/", 1)
            return f"{head}{NS_SEP}{tail}"
        return f"{namespace}{NS_SEP}{group}"

    return Pod(
        name=meta.get("name", ""),
        namespace=namespace,
        uid=meta.get("uid", "") or meta.get("name", ""),
        scheduler_name=spec.get("schedulerName", ""),
        node_name=spec.get("nodeName", "") or "",
        requests=requests,
        peers=peers,
        tolerations=tolerations,
        node_selector=_flatten(spec.get("nodeSelector")),
        # The \x00ns pseudo-label makes namespace scope visible to
        # selector_matches (see _NS_KEY) without a schema change.
        labels=(_flatten(meta.get("labels"))
                | frozenset({f"{_NS_KEY}={namespace}"})),
        required_node_affinity=_required_node_terms(spec),
        group=_nsq(ann.get(ANN_GROUP, "")) if ann.get(ANN_GROUP) else "",
        affinity_groups=frozenset(map(_nsq, _csv(ANN_AFFINITY)))
        | host_aff,
        anti_groups=frozenset(map(_nsq, _csv(ANN_ANTI))) | host_anti,
        zone_affinity_groups=zone_aff,
        zone_anti_groups=zone_anti,
        selector_defs=selector_defs,
        soft_node_affinity=_preferred_node_terms(spec),
        soft_group_affinity=soft_host_terms,
        soft_zone_affinity=soft_zone_terms,
        spread_maxskew=spread_skew,
        spread_hard=spread_hard,
        spread_group=spread_group,
        priority=float(spec.get("priority", 0) or 0),
        pdb_min_available=int(ann.get(ANN_PDB, 0) or 0),
        parse_degraded=parse_degraded,
        parse_degraded_detail=degraded_detail,
    )


def pdb_from_json(obj: Mapping):
    """Map a ``policy/v1`` PodDisruptionBudget JSON object to the
    framework type (``None`` for a malformed selector — an
    unenforceable PDB must not silently protect nothing; callers log
    it).  ``minAvailable``/``maxUnavailable`` accept ints and
    percentage strings, kube's two forms."""
    from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
        PodDisruptionBudget,
    )

    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    # A PDB protects pods of its OWN namespace only (policy/v1
    # semantics) — without the scope, same-labeled pods in other
    # namespaces would inflate the member count and let the preemption
    # planner evict below a real PDB's bound.
    kd = _selector_key_def(
        spec.get("selector") or {},
        ns_scope=(meta.get("namespace", "default"),))
    if kd is None:
        return None

    def _bound(value):
        """(absolute, percent) from an int or "N%" string."""
        if value is None:
            return None, None
        if isinstance(value, str) and value.endswith("%"):
            try:
                return None, float(value[:-1])
            except ValueError:
                return None, None
        try:
            return int(value), None
        except (TypeError, ValueError):
            return None, None

    min_abs, min_pct = _bound(spec.get("minAvailable"))
    max_abs, max_pct = _bound(spec.get("maxUnavailable"))
    return PodDisruptionBudget(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", "") or meta.get("name", ""),
        selector_key=kd[0],
        selector_def=kd[1],
        min_available=min_abs,
        min_available_pct=min_pct,
        max_unavailable=max_abs,
        max_unavailable_pct=max_pct,
    )


def node_from_json(obj: Mapping) -> Node:
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    status = obj.get("status", {})
    alloc = status.get("allocatable") or status.get("capacity") or {}
    labels = meta.get("labels") or {}
    capacity = {
        "cpu": parse_quantity(alloc.get("cpu", 0)),
        "mem": parse_quantity(alloc.get("memory", 0)) / 2 ** 30,
    }
    if ANN_BANDWIDTH in (meta.get("annotations") or {}):
        try:
            capacity["net"] = float(meta["annotations"][ANN_BANDWIDTH])
        except ValueError:
            pass
    ready = True
    for cond in status.get("conditions", []) or []:
        if cond.get("type") == "Ready":
            ready = cond.get("status") == "True"
    taints = frozenset(
        f"{t.get('key', '')}={t.get('value', '')}"
        for t in spec.get("taints", []) or [] if t.get("key"))
    return Node(
        name=meta.get("name", ""),
        capacity=capacity,
        labels=_flatten(labels),
        taints=taints,
        ready=ready,
        unschedulable=bool(spec.get("unschedulable", False)),
        zone=labels.get("topology.kubernetes.io/zone", ""),
        rack=labels.get("topology.kubernetes.io/rack", ""),
    )


# -- the client -------------------------------------------------------


class KubeClient(ClusterClient):
    """Standalone-daemon API-server client (stdlib HTTP only).

    ``base_url`` like ``https://10.0.0.1:443``; ``token``/``ca_file``
    default to the in-cluster ServiceAccount mount — the stdlib
    equivalent of ``rest.InClusterConfig()`` (scheduler.go:144).
    """

    def __init__(self, base_url: str | None = None,
                 token: str | None = None,
                 ca_file: str | None = None,
                 insecure: bool = False,
                 timeout: float = 30.0,
                 pool_size: int = 6) -> None:
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in-cluster (KUBERNETES_SERVICE_HOST unset) and "
                    "no base_url given")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        # Bound ServiceAccount tokens rotate (~1h expiry; the kubelet
        # rewrites the mounted file): when no explicit token is given,
        # remember the path and re-read periodically instead of
        # pinning the boot-time value (client-go re-reads per request).
        self._token_path = ""
        self._token_read_at = 0.0
        if token is None:
            self._token_path = os.path.join(SA_DIR, "token")
            token = (open(self._token_path).read().strip()
                     if os.path.exists(self._token_path) else "")
        self._token = token
        scheme, rest = self.base_url.split("://", 1)
        self._host = rest
        self._tls = scheme == "https"
        if self._tls:
            if insecure:
                self._ctx = ssl._create_unverified_context()
            else:
                ca = ca_file or os.path.join(SA_DIR, "ca.crt")
                self._ctx = ssl.create_default_context(
                    cafile=ca if os.path.exists(ca) else None)
        else:
            self._ctx = None
        self._timeout = timeout
        self._lock = threading.RLock()
        # Pods are cached under "namespace/name" — bare names collide
        # across namespaces (PodQueue._key namespaces for the same
        # reason), and pod_from_json qualifies peer references to
        # match.
        self._pods: dict[str, Pod] = {}
        self._pod_handlers: list[PodHandler] = []
        self._node_handlers: list[NodeHandler] = []
        self._deleted_handlers: list[PodHandler] = []
        self._node_deleted_handlers: list[NodeHandler] = []
        self._pdb_handlers: list = []
        # At-most-once pod-gone delivery: a pod that reached a terminal
        # phase (MODIFIED) is released then, and its later DELETED
        # event must not release again.  Entries are removed when the
        # DELETED event arrives, so the set is bounded by pods that
        # completed but are not yet deleted from etcd.
        self._released_uids: set[str] = set()
        self._watchers: list[threading.Thread] = []
        self._stop = threading.Event()
        # A small pool of persistent keep-alive connections for
        # request/response calls (watches stream on their own
        # connections): fresh TCP+TLS handshakes per bind would undo
        # the batched-bind amortization, and round 1's SINGLE shared
        # connection serialized the whole batch — bind_p99 was
        # host-side wire latency x batch size.  bind_many/create_events
        # fan out over the pool with a persistent executor.
        self._pool_size = max(1, pool_size)
        self._pool_lock = threading.Lock()
        self._idle_conns: list[http.client.HTTPConnection] = []
        self._conn_sem = threading.BoundedSemaphore(self._pool_size)
        self._executor: ThreadPoolExecutor | None = None
        # Control-plane brownout resilience: list GETs retry with
        # jittered exponential backoff under a shared per-cycle budget;
        # every call path records outcomes into the breaker, whose
        # state the SchedulerLoop reads to enter degraded mode (binds
        # parked, scoring continues).  serve.py re-tunes these from
        # SchedulerConfig via configure_resilience.
        self.breaker = CircuitBreaker()
        self.retry_budget = RetryBudget()
        self._backoff_base_s = 0.05
        self._backoff_max_s = 2.0
        self._sleep = time.sleep  # injectable for tests
        self._gap_handlers: list[Callable[[str], None]] = []
        self.watch_gaps = 0
        # Bind POST concurrency, measured at the wire (r16): the
        # loop's bind_max_inflight bounds worker threads, the pool
        # bounds connections — this gauge proves the bound held where
        # the POSTs actually leave (bench bind_split.max_inflight).
        self.bind_posts_inflight = 0
        self.bind_posts_peak = 0
        self._bind_gauge_lock = threading.Lock()

    def configure_resilience(self, failure_threshold: int = 5,
                             window_s: float = 30.0,
                             cooldown_s: float = 5.0,
                             retry_budget: int = 8,
                             backoff_base_s: float = 0.05,
                             backoff_max_s: float = 2.0) -> None:
        """Re-tune breaker/backoff knobs (SchedulerConfig's
        breaker_* / api_* fields); replaces the default objects, so
        call before serving starts."""
        self.breaker = CircuitBreaker(failure_threshold, window_s,
                                      cooldown_s)
        self.retry_budget = RetryBudget(retry_budget)
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s

    @staticmethod
    def pod_key(namespace: str, name: str) -> str:
        return f"{namespace}/{name}"

    # -- transport ----------------------------------------------------

    def _conn(self, timeout: float | None = None
              ) -> http.client.HTTPConnection:
        t = self._timeout if timeout is None else timeout
        if self._tls:
            return _NodelayHTTPSConnection(
                self._host, timeout=t, context=self._ctx)
        return _NodelayHTTPConnection(self._host, timeout=t)

    def _headers(self, extra: Mapping[str, str] | None = None) -> dict:
        if self._token_path:
            now = time.monotonic()
            if now - self._token_read_at > 60.0:
                self._token_read_at = now
                try:
                    self._token = open(self._token_path).read().strip()
                except OSError:
                    pass  # keep the last-known token
        h = {"Accept": "application/json"}
        if self._token:
            h["Authorization"] = f"Bearer {self._token}"
        if extra:
            h.update(extra)
        return h

    def _acquire_conn(self) -> http.client.HTTPConnection:
        self._conn_sem.acquire()
        with self._pool_lock:
            if self._idle_conns:
                return self._idle_conns.pop()
        return self._conn()

    def _release_conn(self,
                      conn: http.client.HTTPConnection | None) -> None:
        if conn is not None:
            with self._pool_lock:
                self._idle_conns.append(conn)
        self._conn_sem.release()

    def _ensure_executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._pool_size,
                    thread_name_prefix="kube-pool")
            return self._executor

    def _request(self, method: str, path: str, body: Mapping | None = None
                 ) -> Mapping:
        """One request over a pooled keep-alive connection.  Up to
        ``pool_size`` requests run concurrently; excess callers block
        on the semaphore."""
        conn = self._acquire_conn()
        try:
            try:
                return self._exchange(conn, method, path, body)
            except _StaleConnection as stale:
                # Keep-alive connection went stale (server closed it):
                # rebuild and retry.  Safe whenever the request never
                # left (send-phase failure) or the method is
                # idempotent; an already-SENT POST may have been
                # applied, and replaying it blind would dodge the
                # server's conflict detection — raise instead (the
                # bind path requeues and heals 409s against the watch
                # cache, core/loop.py _bind_all).
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None
                if not stale.retryable:
                    raise stale.cause
                conn = self._conn()
                try:
                    return self._exchange(conn, method, path, body)
                except _StaleConnection as again:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    conn = None
                    raise again.cause
        finally:
            self._release_conn(conn)

    def _exchange(self, conn: http.client.HTTPConnection, method: str,
                  path: str, body: Mapping | None) -> Mapping:
        payload = json.dumps(body) if body is not None else None
        headers = self._headers(
            {"Content-Type": "application/json"} if payload else None)
        sent = False
        try:
            conn.request(method, path, body=payload, headers=headers)
            sent = True
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, OSError) as exc:
            raise _StaleConnection(
                cause=exc,
                retryable=not (sent and method != "GET")) from exc
        if resp.status == 404:
            raise KeyError(f"{method} {path}: 404 {data[:200]!r}")
        if resp.status == 409:
            raise ValueError(f"{method} {path}: 409 {data[:200]!r}")
        if resp.status >= 300:
            raise ApiServerError(
                f"{method} {path}: {resp.status} {data[:200]!r}",
                status=resp.status)
        return json.loads(data) if data else {}

    def _get_with_retry(self, path: str) -> Mapping:
        """A list/read GET with brownout handling: outcomes feed the
        breaker; brownout-class failures (5xx/429/network) retry with
        jittered exponential backoff while the shared per-cycle budget
        and the breaker allow; semantic rejections propagate
        immediately.  GETs are idempotent, so replays are always
        safe."""
        attempt = 0
        while True:
            try:
                out = self._request("GET", path)
            except Exception as exc:  # noqa: BLE001 — classified below
                if not _brownout_error(exc):
                    # The server answered (404/409/other 4xx): healthy
                    # control plane, unhealthy request.
                    self.breaker.record_success()
                    raise
                self.breaker.record_failure()
                if not self.breaker.allow() \
                        or not self.retry_budget.take():
                    raise
                self._sleep(backoff_delay(attempt,
                                          self._backoff_base_s,
                                          self._backoff_max_s))
                attempt += 1
                continue
            self.breaker.record_success()
            return out

    def _record_write_outcome(self, exc: Exception | None) -> None:
        """Feed a write's outcome into the breaker.  Writes are never
        blindly replayed here (a sent POST may have been applied —
        the loop's requeue/409-heal machinery owns retries); the
        breaker only needs to LEARN from them."""
        if exc is None or not _brownout_error(exc):
            self.breaker.record_success()
        else:
            self.breaker.record_failure()

    # -- ClusterClient ------------------------------------------------

    def list_nodes(self) -> Sequence[Node]:
        obj = self._get_with_retry("/api/v1/nodes")
        return [node_from_json(it) for it in obj.get("items", [])]

    def list_pending_pods(self) -> Sequence[Pod]:
        obj = self._get_with_retry(
            "/api/v1/pods?fieldSelector=spec.nodeName%3D")
        pods = [pod_from_json(it) for it in obj.get("items", [])]
        with self._lock:
            for p in pods:
                self._pods[self.pod_key(p.namespace, p.name)] = p
        return pods

    def list_all_pods(self) -> Sequence[Pod]:
        obj = self._get_with_retry("/api/v1/pods")
        return [pod_from_json(it) for it in obj.get("items", [])]

    @staticmethod
    def _binding_body(binding: Binding) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": binding.pod_name},
            "target": {"apiVersion": "v1", "kind": "Node",
                       "name": binding.node_name},
        }

    def _record_bound(self, binding: Binding) -> None:
        with self._lock:
            pod = self._pods.get(
                self.pod_key(binding.namespace, binding.pod_name))
            if pod is not None:
                pod.node_name = binding.node_name

    def bind(self, binding: Binding) -> None:
        """POST the Binding subresource — the reference's exact call
        shape (scheduler.go:196-206)."""
        try:
            self._request(
                "POST",
                f"/api/v1/namespaces/{binding.namespace}/pods/"
                f"{binding.pod_name}/binding",
                body=self._binding_body(binding))
        except Exception as exc:
            self._record_write_outcome(exc)
            raise
        self._record_write_outcome(None)
        self._record_bound(binding)

    def _bind_one(self, binding: Binding) -> Exception | None:
        with self._bind_gauge_lock:
            self.bind_posts_inflight += 1
            if self.bind_posts_inflight > self.bind_posts_peak:
                self.bind_posts_peak = self.bind_posts_inflight
        try:
            self._request(
                "POST",
                f"/api/v1/namespaces/{binding.namespace}/pods/"
                f"{binding.pod_name}/binding",
                body=self._binding_body(binding))
            self._record_write_outcome(None)
            return None
        except Exception as exc:  # noqa: BLE001 — per-pod outcome
            self._record_write_outcome(exc)
            return exc
        finally:
            with self._bind_gauge_lock:
                self.bind_posts_inflight -= 1

    def bind_many(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        """Batched bind fanned out over the connection pool: up to
        ``pool_size`` POSTs in flight at once on persistent keep-alive
        connections, per-pod outcomes in input order.  Round 1
        serialized the batch on one connection — bind latency scaled
        with batch size and was the dominant host-side cost at
        batch=128 (BENCH_r01 bind_p99 ~191 ms)."""
        if not bindings:
            return []
        if len(bindings) == 1 or self._pool_size == 1:
            out = [self._bind_one(b) for b in bindings]
        else:
            ex = self._ensure_executor()
            out = list(ex.map(self._bind_one, bindings))
        for binding, exc in zip(bindings, out):
            if exc is None:
                self._record_bound(binding)
        return out

    @staticmethod
    def _event_body(event: Event) -> dict:
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        metadata: dict = {"generateName": f"{event.involved_pod}."}
        link = getattr(event, "link", ())
        if link:
            # Structured link identity (LinkDegraded/LinkQuarantined):
            # a stable annotation consumers filter on (jsonpath /
            # field selectors) instead of parsing the human message.
            src, dst, reason, streak = link
            metadata["annotations"] = {
                "netaware.dev/link-src": str(src),
                "netaware.dev/link-dst": str(dst),
                "netaware.dev/link-reason": str(reason),
                "netaware.dev/link-streak": str(int(streak)),
            }
        return {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": metadata,
            "involvedObject": {
                "apiVersion": "v1", "kind": "Pod",
                "name": event.involved_pod,
                "namespace": event.namespace},
            "reason": event.reason,
            "message": event.message,
            "type": event.type,
            "count": event.count,
            "firstTimestamp": now,
            "lastTimestamp": now,
            "source": {"component": event.component},
        }

    def create_event(self, event: Event) -> None:
        """POST a v1.Event (scheduler.go:214-233); failures are
        swallowed — events are best-effort, never worth failing a
        bind over."""
        try:
            self._request(
                "POST", f"/api/v1/namespaces/{event.namespace}/events",
                body=self._event_body(event))
            self._record_write_outcome(None)
        except Exception as exc:  # noqa: BLE001 — best-effort, but a
            # 5xx here is still brownout evidence the breaker wants.
            self._record_write_outcome(exc)

    def create_events(self, events: Sequence[Event]) -> None:
        """Batched events over the connection pool, best-effort."""
        if not events:
            return
        if len(events) == 1 or self._pool_size == 1:
            for event in events:
                self.create_event(event)
            return
        ex = self._ensure_executor()
        list(ex.map(self.create_event, events))

    def delete_pod(self, name: str, namespace: str = "default",
                   grace_seconds: int | None = None) -> None:
        """DELETE the pod — the preemption eviction primitive.
        ``grace_seconds`` becomes DeleteOptions.gracePeriodSeconds so
        the kubelet can stop the victim cleanly (the watch delivers
        DELETED once termination completes)."""
        body = None
        if grace_seconds is not None:
            body = {"apiVersion": "v1", "kind": "DeleteOptions",
                    "gracePeriodSeconds": int(grace_seconds)}
        self._request(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}",
            body=body)

    def node_of(self, pod_name: str) -> str:
        """``pod_name`` is a "namespace/name" key (pod_from_json
        qualifies peer references); a bare name falls back to the
        default namespace."""
        key = pod_name if "/" in pod_name else f"default/{pod_name}"
        with self._lock:
            pod = self._pods.get(key)
        if pod is None:
            raise KeyError(pod_name)
        return pod.node_name

    def get_pod(self, pod_name: str) -> Pod | None:
        key = pod_name if "/" in pod_name else f"default/{pod_name}"
        with self._lock:
            return self._pods.get(key)

    # -- watches (informer layer) -------------------------------------

    def on_watch_gap(self, handler: Callable[[str], None]) -> None:
        """Register ``handler(reason)`` for watch-gap detection: a
        stream whose resourceVersion had to be RESET (410 Gone /
        ERROR event, or a non-2xx watch response) may have lost
        events between the last delivery and the fresh watch — the
        SchedulerLoop answers with a full relist audit."""
        with self._lock:
            self._gap_handlers.append(handler)

    def _notify_watch_gap(self, reason: str) -> None:
        self.watch_gaps += 1
        with self._lock:
            handlers = list(self._gap_handlers)
        for h in handlers:
            try:
                h(reason)
            except Exception:  # noqa: BLE001 — a handler must not
                pass  # kill the watch thread

    def on_pod_added(self, handler: PodHandler) -> None:
        with self._lock:
            self._pod_handlers.append(handler)
        # Watch ALL pods (not just pending): completion/deletion of
        # bound pods must reach on_pod_deleted so usage accounting can
        # release — a pending-only field selector would hide those.
        self._ensure_watcher("/api/v1/pods?watch=true",
                             self._deliver_pod, name="pod-watch")

    def on_pod_deleted(self, handler: PodHandler) -> None:
        """Register for pod-gone events (DELETED, or MODIFIED into a
        terminal phase): the usage-release path the reference never
        had (it tracked no usage at all, scheduler.go:248)."""
        with self._lock:
            self._deleted_handlers.append(handler)
        self._ensure_watcher("/api/v1/pods?watch=true",
                             self._deliver_pod, name="pod-watch")

    def on_node_added(self, handler: NodeHandler) -> None:
        with self._lock:
            self._node_handlers.append(handler)
        self._ensure_watcher("/api/v1/nodes?watch=true",
                             self._deliver_node, name="node-watch")

    def on_node_deleted(self, handler: NodeHandler) -> None:
        """Node DELETED events (scale-down): round 1 dropped these,
        leaving deleted nodes node_valid=True forever — the scheduler
        kept binding pods to them (the API server accepts Bindings to
        nonexistent node names; the pods never run)."""
        with self._lock:
            self._node_deleted_handlers.append(handler)
        self._ensure_watcher("/api/v1/nodes?watch=true",
                             self._deliver_node, name="node-watch")

    def _deliver_pod(self, kind: str, obj: Mapping) -> None:
        if kind == "DELETED":
            pod = pod_from_json(obj)
            with self._lock:
                cached = self._pods.pop(
                    self.pod_key(pod.namespace, pod.name), None)
                gone = cached if cached is not None else pod
                already = gone.uid in self._released_uids
                self._released_uids.discard(gone.uid)
                handlers = list(self._deleted_handlers)
            # Prefer the cached view: a DELETED payload may already be
            # stripped, but release needs node_name + requests.
            if gone.node_name and not already:
                for h in handlers:
                    h(gone)
            return
        if kind not in ("ADDED", "MODIFIED"):
            return
        pod = pod_from_json(obj)
        phase = (obj.get("status") or {}).get("phase", "")
        terminal = phase in ("Succeeded", "Failed")
        with self._lock:
            self._pods[self.pod_key(pod.namespace, pod.name)] = pod
            pod_handlers = list(self._pod_handlers)
            deleted_handlers = list(self._deleted_handlers)
            if terminal and pod.node_name:
                if pod.uid in self._released_uids:
                    return  # already released on an earlier MODIFIED
                self._released_uids.add(pod.uid)
        if terminal and pod.node_name:
            # Terminal-but-not-yet-deleted: its usage is already free.
            for h in deleted_handlers:
                h(pod)
        elif not pod.node_name:
            for h in pod_handlers:
                h(pod)

    def on_pdb_changed(self, handler) -> None:
        """Watch ``policy/v1`` PodDisruptionBudgets:
        ``handler(pdb, deleted)`` per ADDED/MODIFIED/DELETED event —
        the real-PDB surface of the preemption planner (the
        annotation surface needs no watch)."""
        with self._lock:
            self._pdb_handlers.append(handler)
        self._ensure_watcher(
            "/apis/policy/v1/poddisruptionbudgets?watch=true",
            self._deliver_pdb, name="pdb-watch")

    def list_pdbs(self):
        doc = self._get_with_retry(
            "/apis/policy/v1/poddisruptionbudgets")
        out = []
        for item in doc.get("items", []) or []:
            pdb = pdb_from_json(item)
            if pdb is not None:
                out.append(pdb)
        return out

    def _deliver_pdb(self, kind: str, obj: Mapping) -> None:
        if kind not in ("ADDED", "MODIFIED", "DELETED"):
            return
        pdb = pdb_from_json(obj)
        if pdb is None:
            return  # malformed selector: unenforceable, skip
        with self._lock:
            handlers = list(self._pdb_handlers)
        for h in handlers:
            h(pdb, kind == "DELETED")

    def _deliver_node(self, kind: str, obj: Mapping) -> None:
        if kind == "DELETED":
            node = node_from_json(obj)
            with self._lock:
                handlers = list(self._node_deleted_handlers)
            for h in handlers:
                h(node)
            return
        if kind not in ("ADDED", "MODIFIED"):
            return
        node = node_from_json(obj)
        with self._lock:
            handlers = list(self._node_handlers)
        for h in handlers:
            h(node)

    def _ensure_watcher(self, path: str,
                        deliver: Callable[[str, Mapping], None],
                        name: str) -> None:
        with self._lock:
            if any(t.name == name and t.is_alive()
                   for t in self._watchers):
                return
            t = threading.Thread(target=self._watch_loop,
                                 args=(path, deliver), name=name,
                                 daemon=True)
            self._watchers.append(t)
            t.start()

    def _watch_loop(self, path: str,
                    deliver: Callable[[str, Mapping], None]) -> None:
        """One ``?watch=true`` chunked stream, reconnecting with the
        last seen resourceVersion — the client-go reflector's job
        (scheduler.go:161-187), minus the full re-list (the scheduler
        loop's periodic ``list_pending_pods`` resync covers missed
        events)."""
        rv = ""
        while not self._stop.is_set():
            conn = None
            try:
                # Watches idle legitimately between cluster events: a
                # request-sized read timeout would kill every quiet
                # stream.  ~5 min matches the API server's own watch
                # window; close() still interrupts via _stop checks.
                conn = self._conn(timeout=330.0)
                sep = "&" if "?" in path else "?"
                url = path + (f"{sep}resourceVersion={rv}" if rv else "")
                conn.request("GET", url, headers=self._headers())
                resp = conn.getresponse()
                if resp.status >= 300:
                    conn.close()
                    self._stop.wait(1.0)
                    if rv:
                        # Events between the tracked rv and the fresh
                        # watch may be lost — a gap, not a mere retry.
                        self._notify_watch_gap(
                            f"watch {path}: HTTP {resp.status}")
                    rv = ""  # stale resourceVersion: start fresh
                    continue
                buf = b""
                while not self._stop.is_set():
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if not line.strip():
                            continue
                        try:
                            evt = json.loads(line)
                        except ValueError:
                            continue
                        kind = evt.get("type", "")
                        obj = evt.get("object", {})
                        if kind == "ERROR":
                            # Usually a 410 Gone Status after etcd
                            # compaction: the rv is stale.  Reset it so
                            # the reconnect starts a fresh watch
                            # instead of hot-looping on the same
                            # stale version forever.  This IS a gap:
                            # everything between the compacted rv and
                            # the fresh list is unseen.
                            rv = ""
                            self._notify_watch_gap(
                                f"watch {path}: ERROR/410 "
                                f"{obj.get('code', '')}")
                            raise _WatchExpired()
                        rv = (obj.get("metadata", {})
                              .get("resourceVersion", rv))
                        try:
                            deliver(kind, obj)
                        except Exception:  # noqa: BLE001 — one poison
                            continue  # object must not drop the rest
                conn.close()
                # Clean EOF: brief pause so a server that instantly
                # closes idle watches cannot drive a hot reconnect
                # loop.
                self._stop.wait(0.2)
            except _WatchExpired:
                pass  # reconnect immediately with a fresh rv
            except Exception:  # noqa: BLE001 — reconnect
                self._stop.wait(1.0)
            finally:
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass

    def close(self) -> None:
        self._stop.set()
        with self._pool_lock:
            executor, self._executor = self._executor, None
            idle, self._idle_conns = self._idle_conns, []
        if executor is not None:
            executor.shutdown(wait=False)
        for conn in idle:
            try:
                conn.close()
            except OSError:
                pass
