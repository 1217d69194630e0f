"""Kubernetes scheduler-extender semantics: /filter and /prioritize.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/api/extender.py``:
the stock extender webhook contract against the port's scoring core.

- ``/filter``: ExtenderArgs {pod, nodenames} -> ExtenderFilterResult
  {nodenames, failedNodes} from the masked score row (``-inf`` =
  infeasible).
- ``/prioritize``: ExtenderArgs -> HostPriorityList [{host, score}]
  with scores scaled to k8s's 0..10 extender convention.
- ``/bind``: ExtenderBindingArgs -> bookkeeping + Binding via the
  cluster client (optional; stock kube-scheduler can also bind itself).

Concurrent requests coalesce in :class:`_ScoreBatcher` into one
``score_pods_auto`` call per wave: with ``score_backend="pallas"`` that
is one launch of the masked tile kernel (``masked_scores_kernel``) over
the wave's pods, padded to a power of two.  What differs from the JAX
module:

- The candidate gather is ``torch.take_along_dim`` on the device, before
  the copy to the host.
- The copy to the host goes into a pinned buffer with
  ``non_blocking=True`` and a ``torch.cuda.Event`` recorded after it; the
  finisher thread waits on that event (on the CPU the rows are already
  host memory).
- A loop built with a mesh carries ``sharded_score``
  (``parallel/sharding.py``): the wave's scores are the sharded dense
  columns gathered whole, from the dense static pair (a mesh's webhook
  scores dense, as in JAX).  Under ``--multihost`` the controller turns
  it off and the wave scores on rank 0's device.
- ``/explain/<uid>`` returns the loop's explain record for the pod
  (``enable_explain``), under either score backend; the ``/debug/*``
  pages of the unported layers answer ``{"enabled": false}``, as the
  JAX package does with those layers off.

Every thread (webhook handlers, the loop's cycle thread, the static
refresher) enqueues on the device's current stream, which torch shares
across threads; snapshots are never patched in place, so a wave reads
one consistent state.
"""

from __future__ import annotations

import dataclasses
import json
import queue as queue_mod
import threading
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import Resource
from kubernetesnetawarescheduler_tpu_torch.core.gang import parse_gang_shapes
from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
from kubernetesnetawarescheduler_tpu_torch.core.score import NEG_INF
from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
    compute_static,
    score_pods_auto,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Binding, Pod

MAX_EXTENDER_PRIORITY = 10  # k8s scheduler extender convention


def _pod_from_k8s(obj: Mapping[str, Any]) -> Pod:
    """Translate a (subset of a) v1.Pod manifest into our Pod.

    Resource requests come from the sum over containers' requests;
    netaware extensions ride in annotations: ``netaware/peers`` (JSON
    {pod: traffic}), ``netaware/group``, ``netaware/affinity``,
    ``netaware/anti``, and the gang contract (core/gang.py):
    ``netaware/pod-group`` (name), ``netaware/pod-group-min-member``
    (int; the gang gates until this many members arrive) and
    ``netaware/pod-group-timeout-s`` (float; 0 = cfg.gang_timeout_s).
    Malformed numbers degrade to 0 rather than rejecting the pod — a
    gang with min_member <= 1 schedules independently, the safe
    direction.
    """
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    annotations = meta.get("annotations") or {}
    requests = {"cpu": 0.0, "mem": 0.0, "net_bw": 0.0}
    for ctr in spec.get("containers") or ():
        req = ((ctr.get("resources") or {}).get("requests") or {})
        requests["cpu"] += _parse_cpu(req.get("cpu", "0"))
        requests["mem"] += _parse_mem(req.get("memory", "0"))
        requests["net_bw"] += float(req.get("netaware/bandwidth-gbps", 0.0))
    peers = {}
    if "netaware/peers" in annotations:
        try:
            peers = {str(k): float(v) for k, v in
                     json.loads(annotations["netaware/peers"]).items()}
        except (ValueError, AttributeError):
            peers = {}
    selector = spec.get("nodeSelector") or {}
    tolerations = frozenset(
        str(t.get("key")) for t in spec.get("tolerations") or ()
        if t.get("key"))
    labels = meta.get("labels") or {}
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", "") or meta.get("name", ""),
        scheduler_name=spec.get("schedulerName", ""),
        requests=requests,
        peers=peers,
        tolerations=tolerations,
        node_selector=frozenset(f"{k}={v}" for k, v in selector.items()),
        labels=frozenset(f"{k}={v}" for k, v in labels.items()),
        group=annotations.get("netaware/group", ""),
        affinity_groups=frozenset(
            g for g in annotations.get("netaware/affinity", "").split(",")
            if g),
        anti_groups=frozenset(
            g for g in annotations.get("netaware/anti", "").split(",") if g),
        priority=float(spec.get("priority", 0) or 0),
        pod_group=str(annotations.get("netaware/pod-group", "")),
        gang_min_member=_parse_int(
            annotations.get("netaware/pod-group-min-member", 0)),
        gang_timeout_s=_parse_float(
            annotations.get("netaware/pod-group-timeout-s", 0.0)),
        gang_shapes=parse_gang_shapes(str(
            annotations.get("netaware/pod-group-shapes", "") or "")),
    )


def _parse_int(text: Any) -> int:
    try:
        return int(float(text))
    except (TypeError, ValueError):
        return 0


def _parse_float(text: Any) -> float:
    try:
        return float(text)
    except (TypeError, ValueError):
        return 0.0


def _parse_cpu(text: str) -> float:
    text = str(text)
    if text.endswith("m"):
        return float(text[:-1]) / 1000.0
    try:
        return float(text)
    except ValueError:
        return 0.0


_MEM_SUFFIX = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
               "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12}


def _parse_mem(text: str) -> float:
    """Memory quantity -> GiB (our mem resource unit)."""
    text = str(text)
    for suffix, mult in _MEM_SUFFIX.items():
        if text.endswith(suffix):
            try:
                return float(text[: -len(suffix)]) * mult / 2**30
            except ValueError:
                return 0.0
    try:
        return float(text) / 2**30
    except ValueError:
        return 0.0


class _ScoreBatcher:
    """Coalesces concurrent webhook score requests into one kernel
    dispatch, sized to the actual demand.

    Requests queue; the request that finds the queue EMPTY becomes its
    wave's leader: it sleeps one tick (``adaptive_tick_s``), then keeps
    gathering while requests keep arriving — until the batch is full
    (``max_pods``), the ``adaptive_max_s`` deadline fires, or a silent
    tick finds no other client mid-request — and runs ONE score call
    whose pod axis is the demand padded to a power of two (floor 8), not
    ``max_pods``.  A lone request pays one ~0.5 ms tick.  ``window_s``
    forces a fixed pre-wait for latency-insensitive deployments.

    The leader encodes, snapshots, scores, gathers the candidate columns
    on the device and starts the copy to the host, then hands the wave
    to the finisher thread and returns: the next wave forms and encodes
    while this one's copy is in flight.
    """

    def __init__(self, loop: SchedulerLoop, window_s: float = 0.0,
                 adaptive_max_s: float = 0.004,
                 adaptive_tick_s: float = 0.0005) -> None:
        self._loop = loop
        self._window = window_s
        self._adaptive_max = adaptive_max_s
        self._adaptive_tick = adaptive_tick_s
        self._lock = threading.Lock()          # guards _queue/_active
        self._dispatch_lock = threading.Lock()  # one kernel at a time
        self._queue: list[list] = []  # [pod, event, row|exc, cand_idx]
        # Requests currently inside score() (enqueued, not yet
        # returned): a silent tick only ends a wave when NO other client
        # is active, so under concurrency the window keeps absorbing
        # until the batch is full or the deadline fires.
        self._active = 0
        self.dispatches = 0  # score dispatches (observability)
        self.requests = 0    # score requests served (observability)
        self._finish_q: Any = queue_mod.SimpleQueue()
        self._closed = False
        self._deliver_lock = threading.Lock()
        self._finisher = threading.Thread(
            target=self._finish_loop, daemon=True,
            name="extender-batch-finisher")
        self._finisher.start()
        # Static-score cache: the batch-invariant prep (metric vote +
        # net normalizers) depends only on metrics/network/validity —
        # NOT on placements — so binds between requests do not
        # invalidate it.  Keyed on the encoder's static_version.
        self._static_version: int | None = None
        self._static_val = None

    def score(self, pod: Pod,
              cand_idx: np.ndarray | None = None) -> np.ndarray:
        """Masked scores for one pod (blocking).

        With ``cand_idx`` (int node indices; ``-1`` = unknown node,
        masked by the caller): returns ``f32[len(cand_idx)]`` — the
        scores at exactly those nodes, gathered ON THE DEVICE before the
        copy to the host.  Without ``cand_idx``: the full masked row
        ``f32[N]``.

        Non-leaders park on their event at a coarse timeout; the
        non-blocking re-drain there is a liveness backstop (an entry
        appended after a claim makes the next empty-queue arrival lead)
        and lets a delivered-to thread lead the NEXT wave while a prior
        one is still in flight.
        """
        entry = [pod, threading.Event(), None, cand_idx]
        with self._lock:
            self.requests += 1
            self._active += 1
            self._queue.append(entry)
            lead = len(self._queue) == 1
        try:
            if self._window:
                time.sleep(self._window)
            if lead:
                time.sleep(self._adaptive_tick)  # let the wave gather
                with self._dispatch_lock:
                    if not entry[1].is_set():
                        self._drain_locked()
            while not entry[1].wait(timeout=0.05):
                if self._dispatch_lock.acquire(blocking=False):
                    try:
                        if not entry[1].is_set():
                            self._drain_locked()
                    finally:
                        self._dispatch_lock.release()
            if isinstance(entry[2], BaseException):
                raise entry[2]
            return entry[2]
        finally:
            with self._lock:
                self._active -= 1

    def _drain_locked(self) -> None:
        """Dispatch everything queued (caller holds _dispatch_lock)."""
        with self._lock:
            batch = self._queue
            self._queue = []
        if not batch:
            return
        if self._adaptive_max > 0:
            deadline = time.perf_counter() + self._adaptive_max
            while (len(batch) < self._loop.cfg.max_pods
                   and time.perf_counter() < deadline):
                time.sleep(self._adaptive_tick)
                with self._lock:
                    fresh = self._queue
                    self._queue = []
                    # Active requests not yet riding THIS batch: while
                    # any exist, a silent tick is a scheduling hiccup,
                    # not an idle server.
                    others = self._active - len(batch) - len(fresh)
                if not fresh and others <= 0:
                    break
                batch.extend(fresh)
        loop = self._loop
        max_pods = loop.cfg.max_pods
        handed = 0  # entries handed to the finisher (it owns those)
        try:
            for start in range(0, len(batch), max_pods):
                chunk = batch[start:start + max_pods]
                pods = [e[0] for e in chunk]
                enc = loop.encoder.encode_pods(
                    pods, node_of=loop._peer_node, lenient=True,
                    pad_to=min(_round_pow2(len(pods)), max_pods))
                # Atomic (state, version) pair: the version bumps
                # lazily inside the flush, so a separate read on either
                # side of snapshot() can mispair them.
                state, version = loop.encoder.snapshot_versioned()
                static = self._static_for(state, version)
                self.dispatches += 1
                # A mesh loop carries the sharded full-score callable:
                # the node axis over the mesh's tp ranks, the wave whole.
                sharded = getattr(loop, "sharded_score", None)
                if sharded is not None:
                    rows = sharded(state, enc, static)
                else:
                    rows = score_pods_auto(state, enc, loop.cfg, static)
                idxs = [e[3] for e in chunk]
                width = (_round_pow2(max(len(ix) for ix in idxs))
                         if all(ix is not None for ix in idxs)
                         else rows.shape[1])
                if width < rows.shape[1]:
                    # Device-side candidate gather: copy [B, C] (C = pow2
                    # max candidate count) instead of the full [B, N]
                    # plane.  Skipped when the candidate lists cover
                    # ~the whole cluster.
                    idx_mat = np.zeros((rows.shape[0], width),
                                       dtype=np.int64)
                    for i, ix in enumerate(idxs):
                        idx_mat[i, :len(ix)] = np.maximum(ix, 0)
                    out = _gather_rows(rows, idx_mat)
                    gathered = True
                else:
                    out = rows
                    gathered = False
                item = (chunk, _to_host_async(out), idxs, gathered)
                # Hand delivery to the finisher: the dispatch path is
                # free for the next wave while this one's copy is in
                # flight.
                self._finish_q.put(item)
                handed += len(chunk)
                if self._closed:
                    # close() raced this hand-off: the finisher may
                    # already be gone.  Deliver inline — _deliver is
                    # idempotent.
                    self._deliver(item)
        except BaseException as exc:  # deliver, don't strand waiters
            # Only to entries NOT handed to the finisher, which is the
            # sole owner of those.
            for e in batch[handed:]:
                if not e[1].is_set():
                    e[2] = exc
                    e[1].set()

    def close(self) -> None:
        """Stop the finisher thread (idempotent).  Waves already queued
        are delivered first — the sentinel is FIFO-ordered behind them;
        waves handed off concurrently with the close are delivered
        inline by their dispatcher (see _drain_locked)."""
        self._closed = True
        self._finish_q.put(None)

    def _finish_loop(self) -> None:
        """Deliver dispatched waves as their copies to the host land
        (daemon thread; one wave at a time, FIFO)."""
        while True:
            item = self._finish_q.get()
            if item is None:
                # Sentinel: drain anything that slipped in behind it.
                while True:
                    try:
                        item = self._finish_q.get_nowait()
                    except queue_mod.Empty:
                        return
                    if item is not None:
                        self._deliver(item)
            else:
                self._deliver(item)

    def _deliver(self, item) -> None:
        """Wait for a dispatched wave's copy and wake its waiters.
        Idempotent (guarded by _deliver_lock + the first entry's event),
        so the close()-race inline delivery cannot double-deliver."""
        chunk, (host, done), idxs, gathered = item
        with self._deliver_lock:
            if chunk and chunk[0][1].is_set():
                return  # already delivered by the other path
            try:
                if done is not None:
                    done.synchronize()
                vals = host.numpy()
                for i, e in enumerate(chunk):
                    ix = idxs[i]
                    if gathered:
                        e[2] = vals[i, :len(ix)].copy()
                    elif ix is None:
                        e[2] = vals[i].copy()
                    else:
                        e[2] = vals[i][np.maximum(ix, 0)]
                    e[1].set()
            except BaseException as exc:  # noqa: BLE001
                for e in chunk:
                    if not e[1].is_set():
                        e[2] = exc
                        e[1].set()

    def _static_for(self, state, version: int):
        if self._static_version != version:
            cfg = self._loop.cfg
            if getattr(self._loop, "sharded_score", None) is not None:
                # The sharded score is dense; its static is the dense
                # (base, C.T) pair, whatever the backend (the callable
                # warned of the coercion when it was built).
                cfg = dataclasses.replace(cfg, score_backend="xla")
            self._static_val = compute_static(state, cfg)
            self._static_version = version
        return self._static_val


def _gather_rows(rows: torch.Tensor, idx_mat: np.ndarray) -> torch.Tensor:
    """``rows[b, idx_mat[b, c]]`` on ``rows``' device — the candidate
    gather before the copy to the host."""
    idx = torch.from_numpy(idx_mat).to(rows.device, non_blocking=True)
    return torch.take_along_dim(rows, idx, dim=1)


def _to_host_async(out: torch.Tensor):
    """``(host tensor, event)``: on a card, a non-blocking copy into a
    pinned host buffer and an event recorded after it on the current
    stream (the finisher waits on the event, not on the whole device);
    on the CPU the tensor itself and no event."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _round_pow2(n: int) -> int:
    """Pod-axis pad size: next power of two >= n (floor 8).  Adaptive
    batches vary wave to wave; power-of-two quantization keeps the set
    of batch shapes the kernel sees at log2(max_pods) entries."""
    size = 8
    while size < n:
        size *= 2
    return size


# /debug pages of a loop without their layer (no fleet, rebalancer or
# policy attached): the JAX package's answers with the layer off.
_LAYER_OFF = {
    "/debug/policy": {"enabled": False},
    "/debug/fleet": {"enabled": False},
    "/debug/rebalance": {"enabled": False},
}


class ExtenderHandlers:
    """Stateless-per-request handlers bound to a SchedulerLoop.

    Scoring requests flow through a :class:`_ScoreBatcher`, so
    concurrent ``/filter``/``/prioritize`` calls share kernel launches
    and a lone request pays for an 8-pod batch, not ``max_pods``."""

    def __init__(self, loop: SchedulerLoop,
                 batch_window_s: float = 0.0) -> None:
        self._loop = loop
        self._batcher = _ScoreBatcher(loop, window_s=batch_window_s)
        # Surfaced on the loop so /metrics (utils/selfmetrics) can
        # report the coalescing rate.
        loop._extender_batcher = self._batcher

    def close(self) -> None:
        """Release the batcher's finisher thread (idempotent)."""
        self._batcher.close()

    # -- ops ----------------------------------------------------------

    def handle(self, path: str, body: bytes) -> bytes:
        if path == "/filter":
            return self._json(self.filter(json.loads(body or b"{}")))
        if path == "/prioritize":
            return self._json(self.prioritize(json.loads(body or b"{}")))
        if path == "/bind":
            return self._json(self.bind(json.loads(body or b"{}")))
        if path in ("/health", "/healthz"):
            # Liveness: the serving threads are up.  Stays true in
            # degraded mode — a browned-out API server must not get the
            # scorer restarted.
            return b'{"ok": true}'
        if path == "/readyz":
            return self._json(self.readyz())
        if path == "/gangs":
            gangs = self._loop.gangs
            if gangs is None:
                return self._json({"enabled": False})
            snap = dict(gangs.snapshot())
            snap["enabled"] = True
            snap["bound_total"] = int(self._loop.gangs_bound)
            snap["rolled_back_total"] = int(self._loop.gangs_rolled_back)
            snap["realizations"] = self._loop.encoder.gang_realizations()
            snap["shaped_degraded_total"] = int(
                self._loop.gangs_shaped_degraded)
            return self._json(snap)
        if path == "/metrics":
            from kubernetesnetawarescheduler_tpu_torch.utils.selfmetrics \
                import render_metrics

            return render_metrics(self._loop).encode()
        if path == "/debug/trace":
            flight = self._loop.flight
            if flight is None:
                return self._json({
                    "error": "flight recorder disabled "
                             "(flight_recorder_size=0)"})
            return self._json(flight.to_chrome_trace())
        if path.startswith("/explain/"):
            flight = self._loop.flight
            uid = path[len("/explain/"):]
            rec = (flight.get_explain(uid)
                   if flight is not None and uid else None)
            if rec is None:
                return self._json({
                    "error": f"no explain record for pod uid {uid!r}",
                    "enable_explain": bool(self._loop.cfg.enable_explain),
                    "retained": (flight.explains_len()
                                 if flight is not None else 0),
                })
            return self._json(rec)
        if path == "/debug/rebalance":
            # The descheduler's full state: scan/candidate/move
            # counters, the skip breakdown (which hysteresis gate or
            # budget held each candidate back), trigger attribution and
            # the live in-flight ledger depth.
            rb = getattr(self._loop, "rebalance", None)
            if rb is not None:
                return self._json(rb.summary())
        if path == "/debug/slo":
            # The SLO engine's full burn-rate state plus the quality
            # observer's outcome stats.
            slo = getattr(self._loop, "slo", None)
            quality = getattr(self._loop, "quality", None)
            return self._json({
                "slo": (slo.snapshot() if slo is not None
                        else {"enabled": False}),
                "quality": (quality.summary() if quality is not None
                            else {"enabled": False}),
            })
        if path == "/debug/policy":
            # The learned scoring policy's full state: term multipliers
            # (EMA read), ring/training counters, shadow disagreement,
            # the last promotion's gate decision, and the dataset join
            # counters (an empty ring is attributable).
            policy = getattr(self._loop, "policy", None)
            if policy is not None:
                out = policy.summary()
                ds = getattr(self._loop, "policy_dataset", None)
                out["dataset"] = (ds.summary() if ds is not None
                                  else None)
                out["eval_trace"] = getattr(self._loop,
                                            "policy_eval_trace", None)
                return self._json(out)
        if path == "/debug/fleet":
            # The fleet view (fleet/server.py): the padding bucket this
            # tenant's loop shares and with whom, dispatch volume,
            # per-tenant queue depth and SLO state, the transfer
            # registry's donors.  The FleetServer sets ``loop.fleet`` at
            # add_tenant time; a solo loop falls through to enabled=false.
            fleet = getattr(self._loop, "fleet", None)
            if fleet is not None:
                return self._json(fleet.summary())
        if path in _LAYER_OFF:
            return self._json(_LAYER_OFF[path])
        raise ValueError(f"unknown op {path!r}")

    def readyz(self) -> dict:
        """Readiness with degraded-mode visibility: the breaker state
        (open = degraded: scoring/encode continue, binds parked), the
        checkpoint-restore decision ("fresh" | "restored" | "ignored"),
        and the recovery counters.  ``ready`` stays true while degraded.
        A burning SLO degrades readiness the same way an open breaker
        does, and the burning objectives are named."""
        loop = self._loop
        breaker = loop.breaker
        state = breaker.state if breaker is not None else "closed"
        slo = getattr(loop, "slo", None)
        burning: tuple = ()
        if slo is not None:
            try:
                burning = slo.burning()
            except Exception:  # noqa: BLE001 — readiness never 500s
                burning = ()
        return {
            "ready": True,
            "degraded": state == "open" or bool(burning),
            "breaker": state,
            "slo_burning": list(burning),
            "checkpoint": loop.checkpoint_state,
            "parked_binds": len(loop._parked_binds),
            "watch_gaps": int(loop.watch_gaps),
            "relists": int(loop.relists),
        }

    @staticmethod
    def _json(obj: Any) -> bytes:
        return json.dumps(obj).encode()

    def _candidate_names(self, args: Mapping[str, Any]) -> list[str]:
        if args.get("nodenames"):
            return list(args["nodenames"])
        nodes = (args.get("nodes") or {}).get("items") or ()
        return [((n.get("metadata") or {}).get("name", "")) for n in nodes]

    def _score_row(self, args: Mapping[str, Any]
                   ) -> tuple[list[str], np.ndarray, np.ndarray]:
        """(names, feasible-mask row, score row) for the args' pod over
        the args' candidate nodes."""
        loop = self._loop
        pod = _pod_from_k8s(args.get("pod") or {})
        names = self._candidate_names(args)
        if not names:
            empty = np.zeros((0,))
            return [], empty.astype(bool), empty
        idx = []
        for name in names:
            try:
                idx.append(loop.encoder.node_index(name))
            except KeyError:
                idx.append(-1)
        idx_arr = np.asarray(idx, dtype=np.int32)
        vals = self._batcher.score(pod, idx_arr)
        ok = (idx_arr >= 0) & (vals > NEG_INF * 0.5)
        sc = np.where(ok, vals, NEG_INF)
        return names, ok, sc

    def filter(self, args: Mapping[str, Any]) -> Mapping[str, Any]:
        names, ok, _ = self._score_row(args)
        passed = [n for n, good in zip(names, ok) if good]
        failed = {n: "netaware: infeasible (capacity/taint/affinity)"
                  for n, good in zip(names, ok) if not good}
        return {"nodenames": passed, "failedNodes": failed, "error": ""}

    def prioritize(self, args: Mapping[str, Any]
                   ) -> Sequence[Mapping[str, Any]]:
        names, ok, scores = self._score_row(args)
        if not names:
            return []
        finite = scores[ok]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 1.0
        span = max(hi - lo, 1e-9)
        out = []
        for name, good, sc in zip(names, ok, scores):
            score10 = (int(round((sc - lo) / span * MAX_EXTENDER_PRIORITY))
                       if good else 0)
            out.append({"host": name, "score": score10})
        return out

    def bind(self, args: Mapping[str, Any]) -> Mapping[str, Any]:
        pod_name = args.get("podName", "")
        namespace = args.get("podNamespace", "default")
        node = args.get("node", "")
        try:
            self._loop.client.bind(Binding(pod_name=pod_name,
                                           namespace=namespace,
                                           node_name=node))
        except Exception as exc:  # relay the rejection, don't die
            return {"error": str(exc)}
        # Account the REAL resource requests, else extender-path binds
        # would never raise usage and the scorer would overcommit.
        pod = self._loop.client.get_pod(pod_name)
        if pod is None:
            pod = Pod(name=pod_name, namespace=namespace,
                      requests={r: 0.0 for r in Resource.NAMES})
        self._loop.encoder.commit(pod, node)
        # Surface any interner-overflow degradation this bind (or a
        # preceding webhook score) recorded — in extender-only
        # deployments no watch cycle runs to drain it.
        self._loop._emit_degraded_events()
        return {"error": ""}
