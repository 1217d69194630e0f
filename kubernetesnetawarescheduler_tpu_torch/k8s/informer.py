"""Informer/watch layer: pending-pod queue fed by ADD events.

Mirrors the reference's informer wiring (scheduler.go:161-187): a pod
ADD handler that enqueues pods with no node assignment and a matching
``spec.schedulerName`` (filter at scheduler.go:170), and a node ADD
handler.  Differences by design:

- bounded queue with an explicit overflow policy (the reference's
  ``chan *v1.Pod, 300`` silently *blocks the informer goroutine* when
  full, scheduler.go:129, :171);
- a resync path (:meth:`Informer.resync`) re-lists pending pods, so a
  restart does not strand pods the way the reference does (ADD-only,
  no UpdateFunc, no re-list; scheduler.go:165-173).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Sequence

from kubernetesnetawarescheduler_tpu_torch.k8s.client import ClusterClient
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node, Pod


class PodQueue:
    """Bounded FIFO of pending pods with batch pop.

    ``pop_batch`` drains up to ``max_batch`` pods — the batching the
    device path needs (the reference popped exactly one pod per cycle,
    scheduler.go:191).

    ``push`` stamps when each pod entered; with ``records`` (the flight
    recorder's :class:`~..utils.flight.PodRecords`) each pop hands the
    popped pods' uids, their stamps and the pop's time to it.
    """

    def __init__(self, capacity: int = 300, records=None) -> None:
        self._capacity = capacity
        self._dq: collections.deque[Pod] = collections.deque()
        # Queued pods' keys -> perf_counter seconds at their push.
        self._queued: dict[str, float] = {}
        self.records = records
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.dropped = 0
        self.duplicates = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    @staticmethod
    def _key(pod: Pod) -> str:
        # Namespaced: same-named pods in different namespaces are
        # distinct (Binding is namespaced too).
        return f"{pod.namespace}/{pod.name}"

    def push(self, pod: Pod) -> bool:
        """Enqueue; returns False when full (counted as a drop) or when
        the pod is already queued (duplicate ADD delivery / resync
        overlap — counted separately)."""
        with self._not_empty:
            if self._key(pod) in self._queued:
                self.duplicates += 1
                return False
            if len(self._dq) >= self._capacity:
                self.dropped += 1
                return False
            self._dq.append(pod)
            self._queued[self._key(pod)] = time.perf_counter()
            self._not_empty.notify()
            return True

    def pop_batch(self, max_batch: int, timeout: float | None = None
                  ) -> list[Pod]:
        """Take up to ``max_batch`` pods; blocks up to ``timeout`` for
        the first one (None = non-blocking)."""
        stamps = []
        with self._not_empty:
            if not self._dq and timeout:
                self._not_empty.wait(timeout)
            t = time.perf_counter()
            batch: list[Pod] = []
            while self._dq and len(batch) < max_batch:
                pod = self._dq.popleft()
                stamps.append((pod.uid, self._queued.pop(self._key(pod))))
                batch.append(pod)
        if self.records is not None and stamps:
            self.records.popped(stamps, t)
        return batch


class Informer:
    """Subscribes to a :class:`ClusterClient` and maintains the node
    list + pending-pod queue."""

    def __init__(self, client: ClusterClient, queue: PodQueue,
                 scheduler_name: str,
                 on_node: Callable[[Node], None] | None = None,
                 is_parked: Callable[[Pod], bool] | None = None) -> None:
        self._client = client
        self._queue = queue
        self._scheduler_name = scheduler_name
        self._on_node = on_node
        # Pods the scheduler is deliberately holding out of the queue
        # (e.g. preemptors awaiting victim confirmation): resync and
        # watch re-deliveries must not enqueue them early.
        self._is_parked = is_parked
        self._nodes: dict[str, Node] = {}
        self.resyncs = 0  # full pod re-lists (restart + relist audit)
        self._lock = threading.Lock()
        client.on_pod_added(self._handle_pod)
        client.on_node_added(self._handle_node)
        for node in client.list_nodes():
            self._handle_node(node)

    def _wants(self, pod: Pod) -> bool:
        # The reference's filter: unbound + addressed to us
        # (scheduler.go:170).
        if self._is_parked is not None and self._is_parked(pod):
            return False
        return (not pod.node_name
                and pod.scheduler_name == self._scheduler_name)

    def _handle_pod(self, pod: Pod) -> None:
        if self._wants(pod):
            self._queue.push(pod)

    def _handle_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
        if self._on_node is not None:
            self._on_node(node)

    def nodes(self) -> Sequence[Node]:
        with self._lock:
            return list(self._nodes.values())

    def resync(self) -> int:
        """Re-list pending pods into the queue (restart recovery);
        returns how many were enqueued."""
        count = 0
        for pod in self._client.list_pending_pods():
            if self._wants(pod) and self._queue.push(pod):
                count += 1
        self.resyncs += 1
        return count

    def reconcile_nodes(self, live_names) -> int:
        """Drop cached nodes absent from a full server listing.

        The node cache only ever GROWS through watch events; a
        node-DELETED missed during a watch gap leaves a ghost entry
        that ``nodes()`` keeps serving forever.  The relist audit
        passes the authoritative listing here; returns how many
        ghosts were pruned."""
        live = set(live_names)
        with self._lock:
            ghosts = [n for n in self._nodes if n not in live]
            for name in ghosts:
                del self._nodes[name]
        return len(ghosts)
