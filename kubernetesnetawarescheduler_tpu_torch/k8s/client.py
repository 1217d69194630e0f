"""Cluster clients: the API-server boundary.

:class:`ClusterClient` is the contract the scheduler core needs from
Kubernetes — the same four touchpoints the reference uses through
client-go: watch pods (scheduler.go:164-174), list nodes (:240), bind
(:196-206), create event (:214-233).

:class:`FakeCluster` is the in-memory implementation used by tests and
the benchmark harness (SURVEY.md 4: "a fake cluster state generator …
this is how we test multi-node without a cluster").  A real-cluster
client would speak to the API server via the extender shim; the core
never imports kubernetes libraries.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Sequence

from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
    Binding,
    Event,
    Node,
    Pod,
)

PodHandler = Callable[[Pod], None]
NodeHandler = Callable[[Node], None]


class ClusterClient:
    """Abstract API-server boundary."""

    def list_nodes(self) -> Sequence[Node]:
        raise NotImplementedError

    def on_pod_added(self, handler: PodHandler) -> None:
        """Register a pod ADD handler (informer AddFunc,
        scheduler.go:165-173)."""
        raise NotImplementedError

    def on_node_added(self, handler: NodeHandler) -> None:
        raise NotImplementedError

    def on_pod_deleted(self, handler: PodHandler) -> None:
        """Register for pod-gone notifications (deletion or terminal
        phase) so committed usage can be released.  Optional: the
        default is no signal (callers must then rely on periodic
        reconciliation)."""

    def on_node_deleted(self, handler: NodeHandler) -> None:
        """Register for node DELETED events (scale-down, decommission)
        so the encoder can free the slot.  Optional, like
        :meth:`on_pod_deleted`; callers must also reconcile against
        :meth:`list_nodes` periodically for events missed while
        down."""

    def on_pdb_changed(self, handler) -> None:
        """Register for PodDisruptionBudget changes:
        ``handler(pdb, deleted: bool)``.  Optional — the default is no
        signal (clients without policy/v1 access simply never feed the
        planner real PDB objects; the annotation surface still
        works)."""

    def on_watch_gap(self, handler) -> None:
        """Register ``handler(reason: str)`` for watch-gap detection —
        a dropped stream, a 410 Gone resourceVersion expiry, or any
        reconnect that could not resume from the last seen rv.  The
        scheduler answers a gap with a full relist audit
        (SchedulerLoop.relist_audit).  Optional, like
        :meth:`on_pod_deleted`: the default is no signal, and callers
        then rely on periodic reconciliation alone."""

    def list_pdbs(self):
        """All policy/v1 PodDisruptionBudgets, or ``None`` when the
        client cannot provide them (initial sync for restarts — watch
        events missed while down)."""
        return None

    def bind(self, binding: Binding) -> None:
        raise NotImplementedError

    def create_event(self, event: Event) -> None:
        raise NotImplementedError

    def bind_many(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        """Batched bind: one outcome per binding (None = bound).

        Default delegates to :meth:`bind` per binding; implementations
        with per-call overhead (a lock, an HTTP round-trip) override to
        pay it once per batch.  A failure never aborts the batch."""
        out: list[Exception | None] = []
        for b in bindings:
            try:
                self.bind(b)
                out.append(None)
            except Exception as exc:  # noqa: BLE001 — per-pod outcome
                out.append(exc)
        return out

    def create_events(self, events: Sequence[Event]) -> None:
        """Batched event creation (best-effort, like the reference's
        fire-and-forget Events().Create, scheduler.go:214-233)."""
        for e in events:
            self.create_event(e)

    def bind_gang(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        """All-or-nothing bind of one gang's bindings: on success every
        outcome is None; on ANY failure NO binding is left applied and
        each failed slot carries its exception (succeeded-then-undone
        slots carry None — the caller treats any non-None as a whole-
        gang failure).

        Default implementation for transports without a transactional
        surface (the real API server has none): bind sequentially and,
        on first failure, COMPENSATE by deleting the already-bound
        members (best-effort — kube cannot unbind, so deletion +
        controller-recreate is the rollback primitive).  In-memory
        clients override with a true validate-all-then-apply-all
        transaction."""
        out: list[Exception | None] = [None] * len(bindings)
        done: list[int] = []
        failed = False
        for i, b in enumerate(bindings):
            if failed:
                out[i] = RuntimeError("gang aborted: earlier member "
                                      "failed to bind")
                continue
            try:
                self.bind(b)
                done.append(i)
            except Exception as exc:  # noqa: BLE001 — per-slot outcome
                out[i] = exc
                failed = True
        if failed:
            for i in done:
                try:
                    self.delete_pod(bindings[i].pod_name,
                                    bindings[i].namespace)
                except Exception:  # noqa: BLE001 — best-effort undo
                    pass
        return out

    def list_pending_pods(self) -> Sequence[Pod]:
        """Re-listable pending pods — the recovery path the reference
        lacks (queued pods are lost on restart; it only ever enqueues
        on ADD events, scheduler.go:165-173)."""
        raise NotImplementedError

    def list_all_pods(self) -> Sequence[Pod] | None:
        """Every pod the API server knows (any phase), or None when
        the client cannot provide it.  Drives usage-ledger
        reconciliation: pods deleted while the daemon was down emit no
        watch event, so their committed usage must be detected by
        comparison against this listing."""
        return None

    def node_of(self, pod_name: str) -> str:
        """Node a pod is bound to ("" if pending).  Part of the core
        contract: peer-traffic scoring resolves placed peers through
        this (raises ``KeyError`` for unknown pods)."""
        raise NotImplementedError

    def get_pod(self, pod_name: str) -> Pod | None:
        """Full pod object (None if unknown) — the /bind path needs the
        real resource requests to account usage."""
        raise NotImplementedError

    def delete_pod(self, name: str, namespace: str = "default",
                   grace_seconds: int | None = None) -> None:
        """Delete a pod (the preemption eviction primitive).
        ``grace_seconds`` maps to DeleteOptions.gracePeriodSeconds
        where the transport supports it.  Raises ``KeyError`` when the
        pod is unknown."""
        raise NotImplementedError


class FakeCluster(ClusterClient):
    """In-memory cluster: nodes, pods, bindings, events.

    Thread-safe; pod/node additions fan out synchronously to registered
    handlers, mimicking informer delivery.
    """

    def __init__(self, bind_latency_s: float = 0.0,
                 api_concurrency: int = 8) -> None:
        # bind_latency_s emulates the API server round-trip per bind
        # POST; api_concurrency caps how many such calls proceed at
        # once (an API server handles concurrent requests — this is
        # what makes a pooled/concurrent client measurably faster than
        # a serial one in benchmarks).
        self.bind_latency_s = bind_latency_s
        self._api_sem = threading.BoundedSemaphore(max(1, api_concurrency))
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._pods: dict[str, Pod] = {}
        self.bindings: list[Binding] = []
        self.events: list[Event] = []
        self._pod_handlers: list[PodHandler] = []
        self._node_handlers: list[NodeHandler] = []
        self._deleted_handlers: list[PodHandler] = []
        self._node_deleted_handlers: list[NodeHandler] = []
        self._pdbs: dict[str, object] = {}
        self._pdb_handlers: list = []

    # -- population ---------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
            handlers = list(self._node_handlers)
        for h in handlers:
            h(node)

    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            self._pods[pod.name] = pod
            handlers = list(self._pod_handlers)
        for h in handlers:
            h(pod)

    def add_pods(self, pods: Iterable[Pod]) -> None:
        for pod in pods:
            self.add_pod(pod)

    def delete_pod(self, name: str, namespace: str = "default",
                   grace_seconds: int | None = None) -> None:
        """Remove a pod and fan out to on_pod_deleted handlers.
        Real watches deliver DELETED for PENDING pods too (kubeclient
        does), and the loop's lifecycle cleanup — parked-queue purge,
        assume-cache eviction — depends on seeing them; round 5
        aligned this fake with that semantic (bound-only delivery let
        deleted-but-parked pods linger).  For never-bound pods the
        usage-release half is a no-op (uid-keyed ledger).
        ``grace_seconds`` is accepted for interface parity (deletion
        is immediate here)."""
        with self._lock:
            pod = self._pods.pop(name, None)
            handlers = list(self._deleted_handlers)
        if pod is None:
            raise KeyError(name)
        for h in handlers:
            h(pod)

    def add_pdb(self, pdb) -> None:
        """Upsert a PodDisruptionBudget (keyed by uid or name); fans
        out to on_pdb_changed handlers like a watch ADDED/MODIFIED."""
        with self._lock:
            self._pdbs[pdb.uid or pdb.name] = pdb
            handlers = list(self._pdb_handlers)
        for h in handlers:
            h(pdb, False)

    def remove_pdb(self, uid: str) -> None:
        with self._lock:
            pdb = self._pdbs.pop(uid, None)
            handlers = list(self._pdb_handlers)
        if pdb is not None:
            for h in handlers:
                h(pdb, True)

    def on_pdb_changed(self, handler) -> None:
        with self._lock:
            self._pdb_handlers.append(handler)

    def list_pdbs(self):
        with self._lock:
            return list(self._pdbs.values())

    def delete_node(self, name: str) -> None:
        """Remove a node (scale-down); fans out to on_node_deleted
        handlers.  Pods bound there are deleted too (the kubelet is
        gone; mirrors the API server's garbage collection)."""
        with self._lock:
            node = self._nodes.pop(name, None)
            node_handlers = list(self._node_deleted_handlers)
            doomed = [p.name for p in self._pods.values()
                      if p.node_name == name]
        if node is None:
            raise KeyError(name)
        for pod_name in doomed:
            try:
                self.delete_pod(pod_name)
            except KeyError:
                pass
        for h in node_handlers:
            h(node)

    # -- ClusterClient ------------------------------------------------

    def list_nodes(self) -> Sequence[Node]:
        with self._lock:
            return list(self._nodes.values())

    def on_pod_added(self, handler: PodHandler) -> None:
        with self._lock:
            self._pod_handlers.append(handler)

    def on_node_added(self, handler: NodeHandler) -> None:
        with self._lock:
            self._node_handlers.append(handler)

    def on_pod_deleted(self, handler: PodHandler) -> None:
        with self._lock:
            self._deleted_handlers.append(handler)

    def on_node_deleted(self, handler: NodeHandler) -> None:
        with self._lock:
            self._node_deleted_handlers.append(handler)

    def _bind_locked(self, binding: Binding) -> None:
        """Single-binding validation + apply; caller holds the lock.
        Shared by :meth:`bind` and :meth:`bind_many` so the two paths
        cannot drift."""
        pod = self._pods.get(binding.pod_name)
        if pod is None:
            raise KeyError(f"unknown pod {binding.pod_name}")
        if binding.node_name not in self._nodes:
            raise KeyError(f"unknown node {binding.node_name}")
        if pod.node_name:
            raise ValueError(
                f"pod {pod.name} already bound to {pod.node_name}")
        pod.node_name = binding.node_name
        self.bindings.append(binding)

    def _simulate_latency(self) -> None:
        if self.bind_latency_s > 0:
            import time

            with self._api_sem:
                time.sleep(self.bind_latency_s)

    def bind(self, binding: Binding) -> None:
        self._simulate_latency()
        with self._lock:
            self._bind_locked(binding)

    def create_event(self, event: Event) -> None:
        with self._lock:
            self.events.append(event)

    def bind_many(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        if self.bind_latency_s > 0 and len(bindings) > 1:
            # Emulated-latency mode: per-binding round-trips proceed
            # concurrently up to api_concurrency, like a real API
            # server in front of a pooled client.
            from concurrent.futures import ThreadPoolExecutor

            def one(binding: Binding) -> Exception | None:
                self._simulate_latency()
                try:
                    with self._lock:
                        self._bind_locked(binding)
                    return None
                except (KeyError, ValueError) as exc:
                    return exc

            with ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(one, bindings))
        out: list[Exception | None] = []
        with self._lock:
            for binding in bindings:
                try:
                    self._bind_locked(binding)
                    out.append(None)
                except (KeyError, ValueError) as exc:
                    out.append(exc)
        return out

    def create_events(self, events: Sequence[Event]) -> None:
        with self._lock:
            self.events.extend(events)

    def bind_gang(self, bindings: Sequence[Binding]
                  ) -> list[Exception | None]:
        """True all-or-nothing transaction: validate EVERY binding
        under the lock, apply only when all pass.  On any failure
        nothing is mutated — no compensating deletes, no pod ever
        observable bound to a strict subset of its gang (the atomicity
        invariant the gang tests pin).  Duplicate pod names within one
        gang are rejected as a conflict (the second apply would
        double-bind)."""
        self._simulate_latency()
        with self._lock:
            out: list[Exception | None] = [None] * len(bindings)
            seen: set[str] = set()
            failed = False
            for i, b in enumerate(bindings):
                try:
                    pod = self._pods.get(b.pod_name)
                    if pod is None:
                        raise KeyError(f"unknown pod {b.pod_name}")
                    if b.node_name not in self._nodes:
                        raise KeyError(f"unknown node {b.node_name}")
                    if pod.node_name:
                        raise ValueError(
                            f"pod {pod.name} already bound to "
                            f"{pod.node_name}")
                    if b.pod_name in seen:
                        raise ValueError(
                            f"duplicate pod {b.pod_name} in gang")
                    seen.add(b.pod_name)
                except (KeyError, ValueError) as exc:
                    out[i] = exc
                    failed = True
            if failed:
                return out
            for b in bindings:
                self._bind_locked(b)
            return out

    def list_pending_pods(self) -> Sequence[Pod]:
        with self._lock:
            return [p for p in self._pods.values() if not p.node_name]

    def list_all_pods(self) -> Sequence[Pod]:
        with self._lock:
            return list(self._pods.values())

    # -- introspection ------------------------------------------------

    def pod(self, name: str) -> Pod:
        with self._lock:
            return self._pods[name]

    def get_pod(self, pod_name: str) -> Pod | None:
        with self._lock:
            return self._pods.get(pod_name)

    def node_of(self, pod_name: str) -> str:
        with self._lock:
            return self._pods[pod_name].node_name
