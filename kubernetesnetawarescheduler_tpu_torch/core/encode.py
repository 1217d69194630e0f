"""Host-side encoding: Kubernetes objects -> device tensors.

The bridge between the object world (:mod:`..k8s.types`) and the
columnar device state (:mod:`.state`).  This is where the reference's
per-pod scrape-and-parse loop (scheduler.go:275-331) becomes an
asynchronous staging buffer: telemetry updates land in pinned NumPy
staging arrays, and :meth:`Encoder.snapshot` transfers only the dirty
field groups to the device, so a scheduling cycle never waits on a
scrape and never re-uploads the big ``N x N`` matrices unless they
changed.

String sets (labels, taints, affinity groups) are interned to bit
positions so feasibility checks are bitmask algebra on device.

This is the PyTorch package's copy of the JAX package's ``Encoder``: the
numpy staging logic is the same line for line, and only the device seam
differs.  Uploads copy on every device (``torch.from_numpy`` aliases its
source, and ``.to("cpu")`` returns the same tensor, so a snapshot would
otherwise alias staging); delta patches are out-of-place ``index_put``
calls, so snapshots already handed out stay readable; u32 mask words
travel as int32 with the same bits.  The constructor takes the device
(default ``"cuda"``, raising without a card).  With a learned topology
model attached (``attach_netmodel``) the net group's snapshot is the
model's host blend of the staging planes, uploaded whole, and
``expected_device_arrays()`` routes the staging planes through the same
blend.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import (
    Metric,
    Resource,
    SchedulerConfig,
)
from kubernetesnetawarescheduler_tpu_torch.core.gang import gang_key_of
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    PodBatch,
    resolve_device,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node, Pod

# Past this many dirty indices the per-index bookkeeping costs more
# than it saves; the group collapses to the "full" sentinel.
_DELTA_MAX_INDICES = 65536


def _scatter_rows(dev: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Patch rows ``idx`` of a device tensor into a NEW tensor (out of
    place, never ``dev[idx] = vals``): previously returned snapshots
    hold the old tensor and must stay readable (a serving loop may still
    be scoring against them)."""
    return dev.index_put((idx,), vals)


def _scatter_pairs(dev: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Patch elements ``(ii, jj)`` of a device matrix into a new tensor
    (same aliasing contract as :func:`_scatter_rows`)."""
    return dev.index_put((ii, jj), vals)


def _to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``dev`` that never aliases ``host``:
    copied on every device, u32 words reinterpreted as int32."""
    a = np.ascontiguousarray(host)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(dev)


# The top bit of the last mask word is reserved: never assigned to a
# real key, so a mask carrying it can never be satisfied by any node.
# Lenient interning uses it to keep un-internable *requirements*
# conservative (infeasible) instead of silently weakened.
# Plain Python ints throughout the interning path (arbitrary precision
# — a mask spanning ``mask_words`` uint32 words is still ONE int here;
# the split into word arrays happens at array-store time): numpy scalar
# construction is ~10x a Python int op and this runs 5x per pod on the
# encode fast path.
def unknown_bit(words: int) -> int:
    """The reserved can-never-match sentinel for a ``words``-wide mask."""
    return 1 << (32 * words - 1)


# Back-compat alias for the single-word layout (tests, extender docs).
UNKNOWN_BIT = unknown_bit(1)


def int_to_words(x: int, words: int) -> np.ndarray:
    """Split an arbitrary-precision mask into ``words`` uint32 words
    (little-endian: word 0 holds bits 0..31)."""
    return np.fromiter(((x >> (32 * i)) & 0xFFFFFFFF
                        for i in range(words)), np.uint32, words)


def words_to_int(arr) -> int:
    """Inverse of :func:`int_to_words` (accepts any uint32 sequence)."""
    out = 0
    for i, w in enumerate(arr):
        out |= int(w) << (32 * i)
    return out


def _fill_words(row: np.ndarray, x: int) -> None:
    """Write mask ``x`` into a preallocated uint32 word row in place
    (allocation-free variant of :func:`int_to_words` for hot paths)."""
    for i in range(row.shape[0]):
        row[i] = (x >> (32 * i)) & 0xFFFFFFFF


class Interner:
    """Stable string -> bit-position mapping over ``32 * words - 1``
    assignable bits.

    Strict interning (trusted, self-inflicted paths: node
    registration) raises when the slot space is exhausted.  Paths fed
    by untrusted manifests — the watch-driven scheduling loop, the
    extender webhook, and the bind-time commit — pass ``lenient=True``:
    an unknown-when-full key yields ``on_overflow`` — callers choose
    the conservative direction for their constraint (``self.unknown``
    for must-match requirements, 0 for grants like tolerations) — so
    one exotic manifest degrades only its own request (recorded per
    pod for a ConstraintDegraded event) instead of raising and taking
    the whole batch's cycle down with it."""

    def __init__(self, kind: str, words: int = 1) -> None:
        self._kind = kind
        self.words = words
        self.max_keys = 32 * words - 1
        self.unknown = unknown_bit(words)
        self._bits: dict[str, int] = {}
        self.overflow_drops = 0

    def bit(self, key: str, lenient: bool = False,
            on_overflow: int = 0) -> int:
        b = self._bits.get(key)
        if b is None:
            if len(self._bits) >= self.max_keys:
                if lenient:
                    self.overflow_drops += 1
                    return on_overflow
                raise ValueError(
                    f"too many distinct {self._kind} keys "
                    f"(max {self.max_keys}; raise cfg.mask_words to "
                    f"widen): cannot intern {key!r}")
            b = len(self._bits)
            self._bits[key] = b
        return 1 << b

    def mask(self, keys: Iterable[str], lenient: bool = False,
             on_overflow: int = 0) -> int:
        out = 0
        for key in keys:
            out |= self.bit(key, lenient=lenient, on_overflow=on_overflow)
        return out


class PreparedStream(NamedTuple):
    """Encode-ahead product of :meth:`Encoder.encode_stream_prepare`:
    host numpy arrays with every field filled EXCEPT peer slots, which
    :meth:`Encoder.finalize_stream` resolves against live placements
    just before dispatch."""

    pods: tuple
    arrays: dict
    stream_index: dict
    pristine: dict

    def __len__(self) -> int:
        return len(self.pods)


def _stream_index(pods: Sequence[Pod]) -> dict[str, int]:
    """Indexed under both the bare name and "namespace/name": fake
    workloads reference peers by bare name, KubeClient-sourced pods
    carry namespace-qualified references."""
    idx = {pod.name: i for i, pod in enumerate(pods)}
    idx.update({f"{pod.namespace}/{pod.name}": i
                for i, pod in enumerate(pods)})
    return idx


def _stream_slice(ar: Mapping[str, np.ndarray], a: int, b: int,
                  dev: torch.device):
    from kubernetesnetawarescheduler_tpu_torch.core.replay import PodStream

    return PodStream(**{name: _to_device(arr[a:b], dev)
                        for name, arr in ar.items()})


def _res_names(r: int) -> list[tuple[int, str]]:
    """Pre-enumerated resource names for allocation-free row fills."""
    return list(enumerate(Resource.NAMES[:r]))


def _fill_requests_row(row: np.ndarray, requests: Mapping[str, float],
                       res_names: list[tuple[int, str]]) -> None:
    """Write one pod's resource requests into ``row`` in place — the
    single source of truth for request→vector mapping (shared by batch
    encode, stream encode and usage accounting)."""
    for j, name in res_names:
        row[j] = requests.get(name, 0.0)


def _requests_vector(requests: Mapping[str, float], r: int) -> np.ndarray:
    vec = np.zeros((r,), np.float32)
    _fill_requests_row(vec, requests, _res_names(r))
    return vec


def selector_matches(sel_def: tuple, labels: frozenset) -> bool:
    """Evaluate a canonical labelSelector structure against a pod's
    ``k=v`` label strings — Kubernetes ``LabelSelector`` semantics
    (apimachinery ``labels.Requirement``): matchLabels AND; In needs
    the key present with a listed value; NotIn passes when the key is
    absent OR its value is unlisted; Exists/DoesNotExist test key
    presence.  ``sel_def`` is ``(((k, v), ...), ((op, key, values),
    ...))`` with both banks sorted (the canonical form the kubeclient
    parser emits)."""
    match_labels, exprs = sel_def
    for k, v in match_labels:
        if f"{k}={v}" not in labels:
            return False
    if exprs:
        keys = {s.split("=", 1)[0] for s in labels}
        for op, key, values in exprs:
            if op == "In":
                if not any(f"{key}={v}" in labels for v in values):
                    return False
            elif op == "NotIn":
                if any(f"{key}={v}" in labels for v in values):
                    return False
            elif op == "Exists":
                if key not in keys:
                    return False
            elif op == "DoesNotExist":
                if key in keys:
                    return False
            else:
                return False
    return True


class CommitRecord(NamedTuple):
    """One usage-ledger entry: everything needed to reverse a commit
    (node + request vector + group/anti bits), reconcile it (stamp),
    and consider the pod as a preemption victim (priority +
    identity)."""

    node: int
    req: np.ndarray
    stamp: float
    priority: float
    namespace: str
    name: str
    group_bit: int = 0
    anti_bits: int = 0
    # Annotation-level PDB: minimum live members of this pod's group
    # (0 = unprotected).  Preemption planning consumes this.
    pdb_min: int = 0
    # Topology-spread accounting (AFTER pdb_min: several callers build
    # records positionally): the group's bit-slot index and the node's
    # zone AT COMMIT TIME (node slots can be reused; the zone recorded
    # here is the one the count was added under).
    group_slot: int = -1
    zone: int = -1
    # Zone-scoped anti-affinity mask this pod declared (symmetric
    # residency recorded under ``zone``; 0 = none).
    zanti_bits: int = 0
    # FULL group-membership mask (annotation group bit | every
    # registered selector-group the pod's labels satisfy).  0 on
    # records restored from pre-v5 checkpoints — release/gz paths
    # fall back to ``group_bit``/``group_slot`` then.
    member_bits: int = 0
    # The pod's labels at commit time, kept so a selector-group
    # registered LATER can claim this resident retroactively
    # (register_selectors).  ``None`` = unknown (pre-v5 restore) —
    # such residents are never retro-claimed; an EMPTY set is a
    # genuinely label-less pod, which negative selectors (NotIn /
    # DoesNotExist) do match.
    labels: frozenset | None = None
    # Gang membership: the ``namespace/pod-group`` key this pod was
    # committed under ("" = not gang-scheduled).  Preemption consumes
    # this to expand one victim into its whole gang (all-or-nothing
    # holds for eviction too), and the loop uses it to release the
    # rest of a gang when a member vanishes.
    gang_key: str = ""


class Encoder:
    """Owns the staging buffers and the node/pod index maps."""

    def __init__(self, cfg: SchedulerConfig, device="cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        n, m, r = cfg.max_nodes, cfg.num_metrics, cfg.num_resources
        w = cfg.mask_words
        self.labels = Interner("label", w)
        self.taints = Interner("taint", w)
        self.groups = Interner("group", w)
        # labelSelector-parity group machinery: group key -> canonical
        # selector structure (see :func:`selector_matches`).  A pod is
        # a member of every registered selector its LABELS satisfy —
        # no annotation opt-in required (kube semantics; the
        # ``netaware.io/group`` annotation remains an additional,
        # label-free membership surface).  ``_selector_gen`` bumps on
        # every new registration so shape-cache entries computed
        # against an older registry can never serve stale memberships.
        self._selector_defs: dict[str, tuple] = {}
        self._selector_gen = 0
        # Live committed members per group bit-slot (cluster-wide):
        # backs the first-pod escape hatch (a required affinity term
        # whose group has NO member anywhere is waived for the first
        # self-member pod, like kube-scheduler's special case).
        self._group_member_counts = np.zeros((32 * w,), np.int64)
        # Real policy/v1 PodDisruptionBudgets (uid -> the reduced
        # object), consumed by the preemption planner beside the
        # annotation-level surface.
        self._pdbs: dict[str, object] = {}
        self._node_index: dict[str, int] = {}
        self._node_names: list[str] = []
        # Slots freed by remove_node, reused FIFO (oldest-freed first).
        # _node_gen[i] increments on every removal, so an in-flight
        # scheduling cycle that captured the pre-removal name table
        # (node_table()) can detect that slot i now means a different
        # node and drop the stale commit instead of booking usage onto
        # the wrong node.  _node_stamp[i] is the registration time
        # (monotonic) guarding the reconcile race where a node is
        # registered after a list_nodes() snapshot was taken.
        self._free_slots: "list[int]" = []
        self._node_gen: "list[int]" = []
        self._node_stamp: "list[float]" = []
        self._lock = threading.RLock()

        # Lazy label interning: a node's raw label strings live here;
        # only strings some pod's selector references are ever given a
        # bit (so per-node-unique labels like kubernetes.io/hostname
        # never consume slots — the reference-scale failure mode of
        # interning everything eagerly was a hard crash at node #32).
        # _label_nodes is the reverse map used to backfill the bit
        # column when a selector first references an existing label.
        self._node_labels: dict[int, frozenset[str]] = {}
        self._label_nodes: dict[str, set[int]] = {}
        # Key-presence reverse map for nodeAffinity Exists /
        # DoesNotExist: label KEY -> nodes carrying any value of it.
        # Presence bits intern in the same label table under the bare
        # key (collision-free: full label strings always contain '=').
        self._label_keys: dict[str, set[int]] = {}
        # Numeric nodeAffinity (Gt/Lt): label KEY -> column of the
        # parsed-value table below (NaN = absent/non-numeric, failing
        # every comparison).  Columns intern on first Gt/Lt reference,
        # backfilling values for nodes already carrying the key.
        self._numeric_keys: dict[str, int] = {}
        self._node_numeric = np.full((n, cfg.max_numeric_labels),
                                     np.nan, np.float32)

        # Staging (host) arrays — mirror of ClusterState fields.
        self._metrics = np.zeros((n, m), np.float32)
        self._metrics_age = np.full((n,), 1e9, np.float32)  # unseen = stale
        self._lat = np.zeros((n, n), np.float32)
        self._bw = np.zeros((n, n), np.float32)
        self._cap = np.zeros((n, r), np.float32)
        self._used = np.zeros((n, r), np.float32)
        self._node_valid = np.zeros((n,), bool)
        self._label_bits = np.zeros((n, w), np.uint32)
        self._taint_bits = np.zeros((n, w), np.uint32)
        self._group_bits = np.zeros((n, w), np.uint32)
        self._resident_anti = np.zeros((n, w), np.uint32)
        # Topology spread: interned zone per node (-1 unknown) and the
        # per-(group bit-slot, zone) scheduled-pod counts — the
        # resident state behind topologySpreadConstraints.
        self._node_zone = np.full((n,), -1, np.int32)
        self._zone_index: dict[str, int] = {}
        self._gz_counts = np.zeros((32 * w, self.cfg.max_zones),
                                   np.int32)
        # Per-(node, bit) member counts behind _group_bits /
        # _resident_anti: a bit clears only when its count hits zero
        # (precise release; see release()).
        self._group_refs = np.zeros((n, 32 * w), np.int32)
        self._anti_refs = np.zeros((n, 32 * w), np.int32)
        # Zone-scoped symmetric anti-affinity residency: per-ZONE OR of
        # resident pods' zone-anti masks, refcounted like _anti_refs so
        # a bit clears only when its last declaring member leaves.
        self._az_anti = np.zeros((cfg.max_zones, w), np.uint32)
        self._az_anti_refs = np.zeros((cfg.max_zones, 32 * w), np.int32)

        # Usage ledger: uid -> CommitRecord; release() reverses exactly
        # what commit recorded (see the allocation section), and the
        # preemption planner reads it to find victims.  _early_releases
        # marks pods whose termination beat their commit — an
        # insertion-ordered dict used as a set, so bounding evicts
        # oldest-first (release()).
        self._committed: dict[str, CommitRecord] = {}
        self._early_releases: dict[str, None] = {}
        # Gangs whose members are ASSUMED (usage committed) but whose
        # all-or-nothing bind has not confirmed: gang key -> member
        # [uid, namespace, name, node_name] entries.  Persisted by the
        # checkpoint so a crash inside the bind window rolls the whole
        # gang back deterministically on restore (no member of a gang
        # may survive in the ledger without the rest).
        self._inflight_gangs: dict[str, list[list]] = {}
        # Live-migration ledger (core/rebalance.py): moves staged
        # between evict and re-bind, persisted by checkpoints so a
        # crash mid-move restores fully-moved-or-fully-reverted.
        self._inflight_migrations: dict[str, list[list]] = {}
        # Elastic-reshape ledger: gangs mid-reshape, staged
        # between the first member eviction and the last re-pin.
        # gang key -> [old_count, new_count, member entries] where
        # each member entry is [uid, namespace, name, from_node,
        # to_node] (to_node "" = the member is DROPPED by the new
        # shape).  Persisted by checkpoints so a crash mid-reshape
        # restores fully-old-shape-or-fully-new-shape, never a hybrid.
        self._inflight_reshapes: dict[str, list] = {}
        # Committed realization per gang: gang key -> [chosen_count,
        # declared_count].  Written when a shaped gang commits or a
        # reshape completes; read by the checkpoint meta and audited
        # by tools/state_audit.py against the committed ledger.
        self._gang_realizations: dict[str, list[int]] = {}

        # Nominations (kube's nominatedNodeName analog): a preemptor
        # whose victims are terminating holds a capacity reservation on
        # its target node so the freed space is not stolen by the next
        # batch.  _reserved is added to `used` in snapshot(); the hold
        # is dropped when the preemptor is encoded for scoring (its own
        # request takes over), commits, or expires.
        self._nominations: dict[str, tuple[int, np.ndarray, float]] = {}
        self._reserved = np.zeros((n, r), np.float32)
        # Victims whose graceful deletion is in flight (delete accepted,
        # DELETED not yet confirmed).  The preemption planner treats
        # them as already gone: not victim candidates again, not live
        # members for PDB min-available accounting.
        self._terminating: set[str] = set()

        # Constraint-shape cache for the encode hot path (see
        # _pod_constraint_rows).  _degrade_capture, when not None,
        # accumulates _record_degraded counts so a cache entry stores
        # the shape's true per-pod degradation regardless of event
        # dedup or the bounded record deque.
        self._shape_cache: dict[tuple, tuple] = {}
        self._degrade_capture: int | None = None
        self.shape_cache_hits = 0
        self.shape_cache_misses = 0

        # Optional learned topology model (netmodel.TopologyModel):
        # when attached AND enabled, the net snapshot group uploads the
        # confidence-blended matrices instead of the raw probe staging
        # arrays.  None/disabled leaves the net path bit-identical.
        self.netmodel = None

        # Dirty tracking per transfer group, so snapshot() uploads the
        # 100 MB-class N x N matrices only when the probe pipeline
        # actually moved them.
        self._dirty = {"metrics": True, "net": True, "alloc": True,
                       "topo": True}
        # Per-group dirty INDEX sets refining the booleans above: node
        # rows for metrics/alloc/topo, (i, j) element pairs for net.
        # ``None`` is the "full" sentinel — the whole group must be
        # re-uploaded (bulk rewrite, overflow past _DELTA_MAX_INDICES,
        # or a mutation whose footprint isn't row-shaped).  Start full:
        # the first snapshot has no device cache to patch.
        self._dirty_rows: dict = {"metrics": None, "alloc": None,
                                  "topo": None}
        self._dirty_pairs: "set | None" = None
        self._cache: dict[str, torch.Tensor] = {}
        # Host->device transfer accounting for the delta-ingest path
        # (bytes actually shipped: values plus their indices).
        self.snapshot_delta_bytes_total = 0
        self.snapshot_full_bytes_total = 0
        # Monotonic counter of static-score-input rebuilds (metrics/
        # net/topo snapshot groups); see snapshot() and
        # static_version.
        self._static_version = 0
        # Per-version delta descriptors for static consumers
        # (static_delta_since): one entry per static_version bump,
        # capturing which static groups moved and, for net, WHICH
        # (i, j) pairs (None = full).  Bounded: a consumer more than
        # maxlen versions behind gets a gap -> full rebuild.
        from collections import deque as _deque
        self._static_deltas: "_deque" = _deque(maxlen=128)
        # Pods whose constraints were degraded by interner overflow
        # ((namespace, name, dropped_count) tuples, bounded), drained
        # by the loop into per-pod Warning events.  ``_degraded_seen``
        # dedupes per pod identity: dropped keys are never cached by
        # the Interner, so the same pod re-drops at commit and on
        # every retry cycle — without the guard that is one Warning
        # event per cycle forever.
        from collections import deque
        self._degraded_pods: deque = deque(maxlen=256)
        self._degraded_seen: set[tuple[str, str]] = set()
        self.degraded_total = 0  # distinct pods degraded (self-metrics)

    def pop_degraded(self) -> list[tuple[str, str, int, tuple]]:
        """Drain the constraint-degradation records
        (``(namespace, name, dropped_count, detail_strings)``)
        accumulated since the last call — see
        :meth:`_constraint_bits`.  ``detail_strings`` names the
        parse-time term drops (e.g. which anti-affinity term stopped
        being enforced), so operators get term-level diagnostics, not
        just a count."""
        with self._lock:
            out = list(self._degraded_pods)
            self._degraded_pods.clear()
        return out

    @property
    def static_version(self) -> int:
        """Monotonic version of the batch-invariant score inputs
        (metrics, lat/bw, node validity/labels/taints).  Serving paths
        may cache derived static scores as long as this is unchanged;
        placement commits (the ``alloc`` group) do NOT bump it."""
        return self._static_version

    # -- nodes --------------------------------------------------------

    def node_index(self, name: str) -> int:
        return self._node_index[name]

    def node_slot(self, name: str) -> int | None:
        """Slot index of ``name``, or None if unregistered (probe
        threads hold target lists that can lag a node removal)."""
        with self._lock:
            return self._node_index.get(name)

    def node_name(self, index: int) -> str:
        return self._node_names[index]

    @property
    def num_nodes(self) -> int:
        return len(self._node_names)

    def upsert_node(self, node: Node) -> int:
        """Register or refresh a node; returns its index.

        Labels are NOT interned here (lazy interning): the raw strings
        are recorded in ``_node_labels``/``_label_nodes`` and the bit
        row carries only labels already referenced by some pod's
        selector.  Eager interning of every label crashed real clusters
        around node #32 (per-node-unique ``kubernetes.io/hostname=…``
        labels exhausting the slot space)."""
        with self._lock:
            idx = self._node_index.get(node.name)
            if idx is None:
                if self._free_slots:
                    idx = self._free_slots.pop(0)
                    self._node_names[idx] = node.name
                elif len(self._node_names) >= self.cfg.max_nodes:
                    raise ValueError(
                        f"cluster exceeds max_nodes={self.cfg.max_nodes}")
                else:
                    idx = len(self._node_names)
                    self._node_names.append(node.name)
                    self._node_gen.append(0)
                    self._node_stamp.append(0.0)
                self._node_index[node.name] = idx
                self._node_stamp[idx] = time.monotonic()
            self._cap[idx] = _requests_vector(node.capacity,
                                              self.cfg.num_resources)
            # A cordoned (spec.unschedulable) node drops out of every
            # mask exactly like an unready one — running pods keep
            # their usage, new pods don't land.
            self._node_valid[idx] = node.ready and not node.unschedulable
            self._set_node_labels(idx, node.labels)
            # Node taints ARE eager: every taint must be representable
            # or pods lacking a toleration could slip on (the
            # conservative direction is a bit no pod tolerates, which
            # is exactly what a fresh bit is until granted).
            _fill_words(self._taint_bits[idx],
                        self.taints.mask(node.taints))
            self._node_zone[idx] = self._intern_zone(node)
            self._mark_rows("topo", idx)
            self._mark_rows("alloc", idx)
            return idx

    def _intern_zone(self, node: Node) -> int:
        """Topology domain id for a node (caller holds the lock):
        ``Node.zone`` or its ``topology.kubernetes.io/zone=`` label.
        -1 when absent or past ``max_zones`` — such nodes are invisible
        to spread constraints (degrades open, never crashes)."""
        zone = node.zone
        if not zone:
            for s in node.labels:
                if s.startswith("topology.kubernetes.io/zone="):
                    zone = s.split("=", 1)[1]
                    break
        if not zone:
            return -1
        zi = self._zone_index.get(zone)
        if zi is None:
            if len(self._zone_index) >= self.cfg.max_zones:
                return -1
            zi = len(self._zone_index)
            self._zone_index[zone] = zi
        return zi

    def _set_node_labels(self, idx: int, labels: Iterable[str]) -> None:
        """Record a node's raw label set and rebuild its bit row from
        the already-interned subset (caller holds the lock)."""
        new = frozenset(labels)
        old = self._node_labels.get(idx, frozenset())
        if new != old:
            for s in old - new:
                nodes = self._label_nodes.get(s)
                if nodes is not None:
                    nodes.discard(idx)
                    if not nodes:
                        del self._label_nodes[s]
            for s in new - old:
                self._label_nodes.setdefault(s, set()).add(idx)
            old_keys = {s.split("=", 1)[0] for s in old}
            new_keys = {s.split("=", 1)[0] for s in new}
            for key in old_keys - new_keys:
                nodes = self._label_keys.get(key)
                if nodes is not None:
                    nodes.discard(idx)
                    if not nodes:
                        del self._label_keys[key]
            for key in new_keys - old_keys:
                self._label_keys.setdefault(key, set()).add(idx)
            self._node_labels[idx] = new
        table = self.labels._bits
        bits = 0
        for s in new:
            b = table.get(s)
            if b is not None:
                bits |= 1 << b
            # Presence bit (Exists/DoesNotExist): interned under the
            # bare key, set whenever the node carries ANY value of it.
            kb = table.get(s.split("=", 1)[0])
            if kb is not None:
                bits |= 1 << kb
        _fill_words(self._label_bits[idx], bits)
        # Numeric Gt/Lt table: refresh this node's value for every
        # registered numeric key (label updates can change them).
        for key, col in self._numeric_keys.items():
            self._node_numeric[idx, col] = self._parse_numeric_label(
                new, key)

    @staticmethod
    def _parse_numeric_label(labels, key: str) -> float:
        """The node's value for ``key`` as a float (NaN when absent or
        non-numeric — kube's Gt/Lt fail on both)."""
        prefix = key + "="
        for s in labels:
            if s.startswith(prefix):
                try:
                    return float(s[len(prefix):])
                except ValueError:
                    return float("nan")
        return float("nan")

    def _numeric_col(self, key: str, lenient: bool) -> int | None:
        """Column of the numeric-value table for label ``key``,
        interning (and backfilling every node already carrying the
        key) on first sight.  ``None`` on lenient overflow — the
        caller degrades the term CLOSED.  Caller holds the lock."""
        col = self._numeric_keys.get(key)
        if col is not None:
            return col
        if len(self._numeric_keys) >= self.cfg.max_numeric_labels:
            if lenient:
                return None
            raise ValueError(
                f"too many numeric nodeAffinity keys "
                f"(max {self.cfg.max_numeric_labels}; raise "
                f"cfg.max_numeric_labels): cannot intern {key!r}")
        col = len(self._numeric_keys)
        self._numeric_keys[key] = col
        for idx in self._label_keys.get(key, ()):
            self._node_numeric[idx, col] = self._parse_numeric_label(
                self._node_labels.get(idx, ()), key)
        self._mark_rows("topo", *self._label_keys.get(key, ()))
        return col

    def _selector_mask(self, keys: Iterable[str], lenient: bool) -> int:
        """Intern a pod selector's label keys, backfilling the bit of a
        newly-interned label onto every node that already carries it
        (caller holds the lock).  Overflow degrades to the UNKNOWN
        sentinel: a selector we cannot represent matches nowhere rather
        than everywhere."""
        table = self.labels._bits
        out = 0
        for key in keys:
            known = key in table
            b = self.labels.bit(key, lenient,
                                on_overflow=self.labels.unknown)
            out |= b
            if not known and key in table:
                carriers = self._label_nodes.get(key)
                if carriers:
                    word, pos = divmod(table[key], 32)
                    for idx in carriers:
                        self._label_bits[idx, word] |= np.uint32(1 << pos)
                    self._mark_rows("topo", *carriers)
        return out

    def _presence_mask(self, keys: Iterable[str], lenient: bool) -> int:
        """Intern label-KEY presence bits (nodeAffinity Exists /
        DoesNotExist), backfilling a newly-interned key onto every node
        that already carries any value of it (caller holds the lock).
        Same overflow direction as :meth:`_selector_mask`: UNKNOWN, so
        an unrepresentable presence requirement matches nowhere."""
        table = self.labels._bits
        out = 0
        for key in keys:
            known = key in table
            b = self.labels.bit(key, lenient,
                                on_overflow=self.labels.unknown)
            out |= b
            if not known and key in table:
                carriers = self._label_keys.get(key)
                if carriers:
                    word, pos = divmod(table[key], 32)
                    for idx in carriers:
                        self._label_bits[idx, word] |= np.uint32(1 << pos)
                    self._mark_rows("topo", *carriers)
        return out

    def mark_unready(self, name: str) -> None:
        """Failure detection hook: an unready node drops out of every
        mask without resizing anything.  Unknown names are ignored —
        scrape/probe threads hold target lists that can lag a node
        removal, and a KeyError here would kill the ingest thread."""
        with self._lock:
            idx = self._node_index.get(name)
            if idx is None:
                return
            self._node_valid[idx] = False
            self._mark_rows("topo", idx)

    def remove_node(self, name: str) -> None:
        """Node DELETED: free the slot for reuse.

        The reference was blind to node removal (scheduler.go:175-184
        logs node ADDs only), and round 1 of this build leaked slots
        until ``max_nodes`` — fatal for a long-running daemon on a
        churning cluster.  Everything the node carried is cleared:
        telemetry, lat/bw row+column, capacity/usage, constraint bits,
        refcounts, the label reverse map, and every usage-ledger entry
        for pods that lived there (their node is gone; the watch will
        also deliver their deletions, which then no-op as early-release
        markers).  Unknown names are ignored (duplicate DELETED
        delivery)."""
        with self._lock:
            idx = self._node_index.pop(name, None)
            if idx is None:
                return
            # Release ledger entries bound to this node BEFORE zeroing
            # usage (release subtracts; the zeroing below makes the
            # order moot, but the refcount arrays must agree).
            for uid in [u for u, rec in self._committed.items()
                        if rec.node == idx]:
                self._gz_sub(self._committed[uid])
                del self._committed[uid]
                self._terminating.discard(uid)
            for uid in [u for u, (i, _, _) in self._nominations.items()
                        if i == idx]:
                self._drop_nomination_locked(uid)
            self._metrics[idx] = 0.0
            self._metrics_age[idx] = 1e9
            self._reserved[idx] = 0.0
            self._lat[idx, :] = 0.0
            self._lat[:, idx] = 0.0
            self._bw[idx, :] = 0.0
            self._bw[:, idx] = 0.0
            if self.netmodel is not None:
                # Slot reuse must not inherit the old node's learned
                # coordinates/factors (lock order: encoder, then
                # model — the model never calls back in).
                self.netmodel.reset_node(idx)
            self._cap[idx] = 0.0
            self._used[idx] = 0.0
            self._node_valid[idx] = False
            self._set_node_labels(idx, ())
            self._node_labels.pop(idx, None)
            self._taint_bits[idx] = 0
            self._group_bits[idx] = 0
            self._resident_anti[idx] = 0
            self._group_refs[idx] = 0
            self._anti_refs[idx] = 0
            self._node_zone[idx] = -1
            self._node_names[idx] = ""
            self._node_gen[idx] += 1
            self._free_slots.append(idx)
            # Row-shaped dirt for the row groups; the net clear is a
            # full row AND column — rare enough (node DELETED) that a
            # full net re-upload beats tracking 2N pairs.
            self._mark_rows("metrics", idx)
            self._mark_rows("alloc", idx)
            self._mark_rows("topo", idx)
            self._mark_full("net")

    def is_committed(self, uid: str) -> bool:
        """Whether a pod's usage is in the ledger (cheap duplicate
        check for the loop's healed-409 path)."""
        with self._lock:
            return uid in self._committed

    def committed_node(self, uid: str) -> str | None:
        """Node NAME the ledger holds this pod's usage at, or None.
        A checkpoint-restored commit must bind at this node — the
        assume already happened in a previous process life, and a
        re-score (whose snapshot includes the pod's own usage) can
        land anywhere else, stranding the recorded usage."""
        with self._lock:
            rec = self._committed.get(uid)
            if rec is None:
                return None
            name = self._node_names[rec.node]
            return name or None

    def note_gang_inflight(self, gang_key: str,
                           entries: list[list]) -> None:
        """Record a gang entering its assume->bind window (entries:
        ``[uid, namespace, name, node_name]`` per member).  A
        checkpoint taken inside the window persists this so restore
        rolls the gang back instead of resurrecting a half-bound
        subset."""
        with self._lock:
            self._inflight_gangs[gang_key] = [list(e) for e in entries]

    def clear_gang_inflight(self, gang_key: str) -> None:
        """The gang's bind resolved (bound or rolled back)."""
        with self._lock:
            self._inflight_gangs.pop(gang_key, None)

    def rollback_gang_members(self, uids: Iterable[str]) -> int:
        """Ledger-driven rollback of gang member commits by uid (the
        restore path; the live path goes through ``release`` with the
        member Pod in hand).  Returns how many records were reversed."""
        n = 0
        with self._lock:
            for uid in uids:
                rec = self._committed.pop(uid, None)
                if rec is not None:
                    self._release_record(rec)
                    self._mark_rows("alloc", rec.node)
                    n += 1
        return n

    def note_migration_inflight(self, move_key: str,
                                entries: list[list]) -> None:
        """Record a live migration entering its evict->rebind window
        (entries: ``[uid, namespace, name, from_node, to_node]`` per
        member).  A checkpoint taken inside the window persists this
        so restore rolls ALL members back — the move becomes
        fully-reverted rather than half-evicted (the rebalancer's
        all-or-nothing contract, tests/test_rebalance.py)."""
        with self._lock:
            self._inflight_migrations[move_key] = [
                list(e) for e in entries]

    def clear_migration_inflight(self, move_key: str) -> None:
        """The move resolved (every member re-bound, or reverted)."""
        with self._lock:
            self._inflight_migrations.pop(move_key, None)

    def migrations_inflight(self) -> dict[str, list[list]]:
        """Snapshot of the live-migration ledger (deep copy; the
        checkpoint writer and tools/state_audit.py read this)."""
        with self._lock:
            return {k: [list(e) for e in v]
                    for k, v in self._inflight_migrations.items()}

    def note_reshape_inflight(self, gang_key: str, old_count: int,
                              new_count: int,
                              entries: list[list]) -> None:
        """Record a gang entering its reshape window (entries:
        ``[uid, namespace, name, from_node, to_node]`` per affected
        member; ``to_node == ""`` means the new shape DROPS the
        member).  Written BEFORE the first eviction; a checkpoint
        taken inside the window persists it so restore settles the
        gang to fully-the-old-shape, never a hybrid.  A gang already
        mid-reshape raises — one gang in two concurrent reshapes is
        the exact corruption tools/state_audit.py treats as fatal."""
        with self._lock:
            if gang_key in self._inflight_reshapes:
                raise ValueError(
                    f"gang {gang_key} is already mid-reshape")
            self._inflight_reshapes[gang_key] = [
                int(old_count), int(new_count),
                [list(e) for e in entries]]

    def clear_reshape_inflight(self, gang_key: str,
                               committed_count: int | None = None,
                               declared_count: int | None = None) -> None:
        """The reshape resolved (new shape fully pinned, or fully
        reverted).  When it COMMITTED, record the new realization so
        checkpoint meta and the state audit see the shape the ledger
        now holds."""
        with self._lock:
            self._inflight_reshapes.pop(gang_key, None)
            if committed_count is not None:
                self._gang_realizations[gang_key] = [
                    int(committed_count),
                    int(declared_count
                        if declared_count is not None
                        else committed_count)]

    def reshapes_inflight(self) -> dict[str, list]:
        """Snapshot of the reshape ledger (deep copy; the checkpoint
        writer and tools/state_audit.py read this)."""
        with self._lock:
            return {k: [v[0], v[1], [list(e) for e in v[2]]]
                    for k, v in self._inflight_reshapes.items()}

    def note_gang_realization(self, gang_key: str, chosen: int,
                              declared: int) -> None:
        """Record the physical realization a shaped gang committed at
        (chosen members placed out of declared) — the checkpoint-meta
        fact the reshape audit cross-checks against committed member
        placements."""
        if not gang_key:
            return
        with self._lock:
            self._gang_realizations[gang_key] = [int(chosen),
                                                 int(declared)]

    def drop_gang_realization(self, gang_key: str) -> None:
        """The gang left the ledger (rolled back / fully released)."""
        with self._lock:
            self._gang_realizations.pop(gang_key, None)

    def gang_realizations(self) -> dict[str, list[int]]:
        """Snapshot of committed realizations (deep copy)."""
        with self._lock:
            return {k: list(v)
                    for k, v in self._gang_realizations.items()}

    def gang_members(self, gang_key: str) -> list[tuple[str, "CommitRecord"]]:
        """Committed ledger entries belonging to one gang (by the
        ``namespace/pod-group`` key recorded at commit time) — the
        preemption planner's victim-expansion surface: evicting one
        slice-job member strands the rest, so the whole gang goes.
        Host dict scan; preemption planning is rare and already does
        a full ledger pass."""
        if not gang_key:
            return []
        with self._lock:
            return [(uid, rec) for uid, rec in self._committed.items()
                    if rec.gang_key == gang_key]

    def known_node_names(self) -> list[str]:
        """Currently registered node names (copy, lock-consistent)."""
        with self._lock:
            return list(self._node_index)

    def node_table(self) -> tuple[list[str], list[int]]:
        """Snapshot of ``(slot -> name, slot -> generation)`` taken in
        one lock acquisition.  A scheduling cycle resolves assignment
        indices against THIS table (not live lookups), and re-checks
        the generation before committing usage — so a slot freed and
        reused mid-cycle yields the old (now-unknown) node name at bind
        (rejected by the API server) rather than a silent bind/commit
        onto whatever node inherited the index."""
        with self._lock:
            return list(self._node_names), list(self._node_gen)

    def topology_features(self) -> dict[str, float]:
        """Size/topology fingerprint of this cluster for the fleet
        transfer registry: valid node count, zone-class count,
        and the mean/std of the OBSERVED (nonzero) latency/bandwidth
        entries.  Donor matching compares these — a policy learned on
        a similar-shaped, similar-fabric cluster is the best
        warm-start candidate."""
        with self._lock:
            valid = self._node_valid.copy()
            zones = self._node_zone[valid]
            lat = self._lat[np.ix_(valid, valid)]
            bw = self._bw[np.ix_(valid, valid)]
        n = int(valid.sum())
        lat_obs = lat[lat > 0]
        bw_obs = bw[bw > 0]
        return {
            "nodes": float(n),
            "zones": float(len({int(z) for z in zones if z >= 0})),
            "lat_mean": float(lat_obs.mean()) if lat_obs.size else 0.0,
            "lat_std": float(lat_obs.std()) if lat_obs.size else 0.0,
            "bw_mean": float(bw_obs.mean()) if bw_obs.size else 0.0,
            "bw_std": float(bw_obs.std()) if bw_obs.size else 0.0,
        }

    def slot_generation(self, idx: int) -> int:
        with self._lock:
            return self._node_gen[idx]

    def reconcile_nodes(self, listed_names, listed_at: float) -> int:
        """Remove registered nodes absent from a full node listing.

        ``listed_at`` (``time.monotonic()`` taken BEFORE the listing
        request) guards the race where a node is registered after the
        listing was snapshotted — such nodes are skipped this round,
        mirroring :meth:`reconcile_committed`.  Returns removals."""
        listed = set(listed_names)
        with self._lock:
            stale = [name for name, idx in self._node_index.items()
                     if name not in listed
                     and self._node_stamp[idx] < listed_at]
        for name in stale:
            self.remove_node(name)
        return len(stale)

    def mark_ready(self, name: str) -> None:
        """Recovery hook: the inverse of :meth:`mark_unready`."""
        with self._lock:
            idx = self._node_index.get(name)
            if idx is None:
                return
            self._node_valid[idx] = True
            self._mark_rows("topo", idx)

    # -- telemetry ----------------------------------------------------

    def update_metrics(self, name: str, values: Mapping[str, float],
                       age_s: float = 0.0) -> None:
        """Ingest one node's metric sample (node_exporter shaped:
        :class:`Metric` channel names).  Non-finite values are dropped —
        one NaN reaching the score matrix would poison every comparison
        against that node — and a sample with no usable channel does not
        reset staleness."""
        with self._lock:
            idx = self._node_index.get(name)
            if idx is None:
                return  # node removed; a late scrape result is noise
            any_ok = False
            for chan, chan_name in enumerate(Metric.NAMES):
                if chan_name in values:
                    val = float(values[chan_name])
                    if np.isfinite(val):
                        self._metrics[idx, chan] = val
                        any_ok = True
            if any_ok:
                self._metrics_age[idx] = age_s
                self._mark_rows("metrics", idx)

    def age_metrics(self, dt_s: float) -> None:
        with self._lock:
            # Every valid node's age moves: full-group dirt (the
            # metrics group is O(N x M) small — not worth indexing).
            self._metrics_age[self._node_valid] += dt_s
            self._mark_full("metrics")

    def update_link(self, a: str, b: str, lat_ms: float | None = None,
                    bw_bps: float | None = None) -> None:
        """Ingest one probe measurement (the iperf3 result of
        run.sh:12, generalized to pairwise)."""
        with self._lock:
            i = self._node_index.get(a)
            j = self._node_index.get(b)
            if i is None or j is None:
                return  # an endpoint was removed; drop the late probe
            if lat_ms is not None and np.isfinite(lat_ms) and lat_ms >= 0:
                self._lat[i, j] = self._lat[j, i] = lat_ms
            if bw_bps is not None and np.isfinite(bw_bps) and bw_bps >= 0:
                self._bw[i, j] = self._bw[j, i] = bw_bps
            self._mark_pair(i, j)
            self._mark_pair(j, i)

    def set_network(self, lat_ms: np.ndarray, bw_bps: np.ndarray) -> None:
        """Bulk-load full matrices (fake-cluster generator path)."""
        with self._lock:
            k = lat_ms.shape[0]
            self._lat[:k, :k] = lat_ms
            self._bw[:k, :k] = bw_bps
            self._mark_full("net")

    def attach_netmodel(self, model) -> None:
        """Attach a :class:`~..netmodel.TopologyModel`; the next net
        snapshot flush blends its predictions (if enabled)."""
        with self._lock:
            self.netmodel = model
            self._mark_full("net")

    def touch_net(self) -> None:
        """Mark the net group dirty without a probe write — used after
        a model refit, whose new predictions change the BLENDED
        matrices even though no staging entry moved."""
        with self._lock:
            self._mark_full("net")

    # -- allocation ---------------------------------------------------
    #
    # Usage is LEDGERED by pod uid: release() reverses exactly what
    # commit recorded, and only for pods we committed.  This makes the
    # accounting robust against (a) foreign pods — a cluster-wide
    # watch delivers deletions of pods other schedulers bound, which
    # must not subtract usage we never added — and (b) the
    # release-before-commit race: a pod that terminates between its
    # bind POST and commit_many() gets an "early release" marker, and
    # the late commit is then dropped instead of leaking forever.

    def commit(self, pod: Pod, node_name: str) -> None:
        """Host-side bookkeeping of a bind: usage + group/anti bits."""
        self.commit_many([pod], [self._node_index[node_name]])

    def commit_many(self, pods: Sequence[Pod],
                    node_indices: Sequence[int]) -> None:
        """Batched commit: one lock acquisition, vectorized usage
        accounting (``np.add.at`` handles repeated nodes)."""
        if not pods:
            return
        r = self.cfg.num_resources
        idx = np.asarray(node_indices, np.int64)
        reqs = np.zeros((len(pods), r), np.float32)
        res_names = _res_names(r)
        for i, pod in enumerate(pods):
            _fill_requests_row(reqs[i], pod.requests, res_names)
        with self._lock:
            # Intern the group bits FIRST, before any state mutation
            # (under the lock — the Interner itself is unsynchronized),
            # and LENIENTLY: the pod was already scored with degraded
            # bits if the interner is full, so the commit must land the
            # SAME (possibly reduced) bits rather than raise mid-batch
            # with usage accounting half-applied.  Any drop that first
            # happens here (extender-path binds commit pods this
            # encoder never scored) is recorded for the per-pod
            # ConstraintDegraded event like every other drop.
            bits = []
            for pod in pods:
                defs = getattr(pod, "selector_defs", None)
                dropped_defs = (self.register_selectors(defs, True)
                                if defs else 0)
                # Snapshot AFTER register_selectors: its failed bit()
                # calls already bump overflow_drops, and dropped_defs
                # reports them — snapshotting before would count each
                # failure twice in the ConstraintDegraded event.
                before = self.groups.overflow_drops
                bits.append((
                    (self.groups.bit(pod.group, lenient=True)
                     if pod.group else 0),
                    (self.groups.mask(pod.anti_groups, lenient=True)
                     if pod.anti_groups else 0),
                    (self.groups.mask(
                        getattr(pod, "zone_anti_groups", ()) or (),
                        lenient=True)
                     if getattr(pod, "zone_anti_groups", None) else 0),
                    self._membership_mask(pod, lenient=True)))
                if self.groups.overflow_drops > before or dropped_defs:
                    self._record_degraded(
                        pod, self.groups.overflow_drops - before
                        + dropped_defs)
            keep = np.ones(len(pods), bool)
            for i, pod in enumerate(pods):
                if pod.uid in self._committed:
                    # Already accounted (duplicate delivery healed as a
                    # 409): committing again would double-count usage
                    # that a single release can never fully undo.
                    keep[i] = False
                    continue
                if pod.uid in self._early_releases:
                    # Terminated before we could account it: skip.
                    del self._early_releases[pod.uid]
                    keep[i] = False
                    continue
                gbit = bits[i][0]
                member = bits[i][3]
                # Spread-count slot (the constraint's selector group
                # or the own group); the UNKNOWN sentinel counts
                # nothing (its gz row never matches).
                gslot = self._spread_slot(pod)
                zone = int(self._node_zone[int(idx[i])])
                zanti = bits[i][2]
                if zanti and zone < 0:
                    # A zone-anti declaration landing on a zone-less
                    # node cannot be recorded (the node is its own
                    # topology domain) — flag the silent non-
                    # enforcement like every other degradation.
                    self._record_degraded(pod, 1)
                    zanti = 0
                self._committed[pod.uid] = CommitRecord(
                    int(idx[i]), reqs[i].copy(), time.monotonic(),
                    float(pod.priority), pod.namespace, pod.name,
                    bits[i][0], bits[i][1],
                    int(getattr(pod, "pdb_min_available", 0)),
                    group_slot=gslot, zone=zone, zanti_bits=zanti,
                    member_bits=member,
                    labels=frozenset(getattr(pod, "labels", None)
                                     or ()),
                    gang_key=gang_key_of(pod))
                # Zone presence + member counts for EVERY membership
                # bit (selector groups included), not just the own
                # group: gz_counts is what zone affinity and spread
                # read.
                m = member
                while m:
                    b = m & -m
                    m ^= b
                    slot = b.bit_length() - 1
                    if zone >= 0:
                        self._gz_counts[slot, zone] += 1
                    self._group_member_counts[slot] += 1
                self._drop_nomination(pod.uid)
            np.add.at(self._used, idx[keep], reqs[keep])
            w = self.cfg.mask_words
            for i, pod in enumerate(pods):
                if not keep[i]:
                    continue
                rec = self._committed[pod.uid]
                if rec.member_bits:
                    self._group_bits[idx[i]] |= int_to_words(
                        rec.member_bits, w)
                    self._ref_add(self._group_refs, int(idx[i]),
                                  rec.member_bits)
                if rec.anti_bits:
                    self._resident_anti[idx[i]] |= int_to_words(
                        rec.anti_bits, w)
                    self._ref_add(self._anti_refs, int(idx[i]),
                                  rec.anti_bits)
                if rec.zanti_bits:
                    self._az_anti[rec.zone] |= int_to_words(
                        rec.zanti_bits, w)
                    self._ref_add(self._az_anti_refs, rec.zone,
                                  rec.zanti_bits)
            self._mark_rows("alloc", *(int(i) for i in idx[keep]))

    def release(self, pod: Pod, node_name: str = "",
                rollback: bool = False) -> None:
        """Reverse this pod's commit (pod deletion/completion).

        Ledger-driven: the subtraction uses the committed record, not
        the caller's view, so double-release is a no-op and foreign
        pods (never committed) do not corrupt usage.  A release that
        beats the commit leaves an early-release marker consumed by
        :meth:`commit_many`.  Group/anti bits are refcounted per
        (node, bit): the bit clears when the LAST member pod leaves —
        without this, a node that ever hosted group ``g`` would block
        anti-``g`` pods forever.

        ``rollback=True`` is the assume-then-bind undo: release the
        commit if it still exists, but NEVER plant an early-release
        marker — the marker guards deletion-beats-commit races, and a
        rollback whose record was already removed (node scale-down
        deleted it directly) planting one would silently cancel the
        pod's next legitimate commit after a requeue, leaving a
        running pod's usage unaccounted forever."""
        with self._lock:
            if self._nominations:
                self._drop_nomination_locked(pod.uid)
            self._terminating.discard(pod.uid)
            rec = self._committed.pop(pod.uid, None)
            if rec is None:
                if rollback:
                    return
                self._early_releases[pod.uid] = None
                if len(self._early_releases) > 4096:
                    # Bound stray markers (e.g. a pod whose bind failed
                    # then got deleted) by evicting the OLDEST — a
                    # fresh marker guards a live race; an old one is
                    # almost certainly a stray.
                    del self._early_releases[
                        next(iter(self._early_releases))]
                return
            self._release_record(rec)
            self._mark_rows("alloc", rec.node)

    def _release_record(self, rec: CommitRecord) -> None:
        """Reverse one ledger record (caller holds the lock)."""
        w = self.cfg.mask_words
        self._used[rec.node] = np.maximum(
            self._used[rec.node] - rec.req, 0.0)
        # member_bits supersets group_bit on v5+ records; pre-v5
        # restores carry member_bits=0 and fall back to the own bit.
        member = rec.member_bits or rec.group_bit
        if member:
            cleared = self._ref_sub(self._group_refs, rec.node, member)
            self._group_bits[rec.node] &= np.invert(
                int_to_words(cleared, w))
        if rec.anti_bits:
            cleared = self._ref_sub(self._anti_refs, rec.node,
                                    rec.anti_bits)
            self._resident_anti[rec.node] &= np.invert(
                int_to_words(cleared, w))
        if rec.zanti_bits and rec.zone >= 0:
            cleared = self._ref_sub(self._az_anti_refs, rec.zone,
                                    rec.zanti_bits)
            self._az_anti[rec.zone] &= np.invert(
                int_to_words(cleared, w))
        self._gz_sub(rec)

    def _gz_sub(self, rec: CommitRecord) -> None:
        """Reverse one record's zone-presence/member counts (caller
        holds the lock).  v5+ records reverse every membership bit;
        pre-v5 restores (member_bits == 0) reverse the legacy single
        own-group slot for gz — their member counts were rebuilt from
        ``group_bit``, so that is what the count decrement mirrors."""
        member = rec.member_bits or rec.group_bit
        m = member
        while m:
            b = m & -m
            m ^= b
            slot = b.bit_length() - 1
            if rec.member_bits and rec.zone >= 0:
                self._gz_counts[slot, rec.zone] = max(
                    0, self._gz_counts[slot, rec.zone] - 1)
            self._group_member_counts[slot] = max(
                0, self._group_member_counts[slot] - 1)
        if member:
            # Count-only dirt: gz/member counts ship whole whenever
            # the alloc group is dirty, so no row index is needed.
            self._mark_rows("alloc")
        if not rec.member_bits and rec.group_slot >= 0 and rec.zone >= 0:
            self._gz_counts[rec.group_slot, rec.zone] = max(
                0, self._gz_counts[rec.group_slot, rec.zone] - 1)
            self._mark_rows("alloc")

    @staticmethod
    def _ref_add(refs: np.ndarray, node: int, bits: int) -> None:
        while bits:
            b = bits & -bits
            refs[node, b.bit_length() - 1] += 1
            bits ^= b

    @staticmethod
    def _ref_sub(refs: np.ndarray, node: int, bits: int) -> int:
        """Decrement refcounts for each set bit; returns the mask of
        bits whose count reached zero (to be cleared)."""
        cleared = 0
        while bits:
            b = bits & -bits
            pos = b.bit_length() - 1
            if refs[node, pos] > 0:
                refs[node, pos] -= 1
            if refs[node, pos] == 0:
                cleared |= b
            bits ^= b
        return cleared

    # -- nominations --------------------------------------------------

    def nominate(self, uid: str, node_name: str,
                 requests: Mapping[str, float]) -> None:
        """Reserve capacity on ``node_name`` for preemptor ``uid``
        while its victims terminate (nominatedNodeName semantics:
        without this, the space freed by eviction is up for grabs by
        any pod scored in the interim)."""
        with self._lock:
            idx = self._node_index.get(node_name)
            if idx is None:
                return
            self._drop_nomination_locked(uid)
            req = _requests_vector(requests, self.cfg.num_resources)
            self._nominations[uid] = (idx, req, time.monotonic())
            self._reserved[idx] += req
            self._mark_rows("alloc", idx)

    def _drop_nomination_locked(self, uid: str) -> None:
        entry = self._nominations.pop(uid, None)
        if entry is not None:
            idx, req, _ = entry
            self._reserved[idx] = np.maximum(
                self._reserved[idx] - req, 0.0)
            self._mark_rows("alloc", idx)

    def _drop_nomination(self, uid: str) -> None:
        with self._lock:
            self._drop_nomination_locked(uid)

    def mark_terminating(self, uid: str) -> None:
        """Record that a victim's graceful deletion was accepted; the
        planner stops counting it as live.  Cleared on release (the
        DELETED confirmation) or by reconcile."""
        with self._lock:
            if uid in self._committed:
                self._terminating.add(uid)

    def expire_nominations(self, ttl_s: float) -> int:
        """Drop reservations older than ``ttl_s`` (a victim that never
        terminates must not hold capacity hostage).  Returns drops."""
        cutoff = time.monotonic() - ttl_s
        with self._lock:
            stale = [uid for uid, (_, _, t) in self._nominations.items()
                     if t < cutoff]
            for uid in stale:
                self._drop_nomination_locked(uid)
        return len(stale)

    def reconcile_committed(self, alive_uids,
                            listed_at: float | None = None) -> int:
        """Release every ledger entry whose pod no longer exists.

        The watch cannot deliver deletions that happened while the
        daemon was down (a restored checkpoint carries their committed
        usage forever otherwise); a periodic listing of live pods
        closes that gap.  ``listed_at`` (``time.monotonic()`` taken
        BEFORE the listing request) guards the race where a pod is
        committed after the listing was snapshotted — entries stamped
        later are skipped this round.  Returns entries released."""
        alive = set(alive_uids)
        cutoff = float("inf") if listed_at is None else listed_at
        released = 0
        with self._lock:
            stale = [u for u, rec in self._committed.items()
                     if u not in alive and rec.stamp < cutoff]
            for uid in stale:
                rec = self._committed.pop(uid)
                self._release_record(rec)
                self._mark_rows("alloc", rec.node)
                self._terminating.discard(uid)
                released += 1
            # Terminating markers must track the ledger.
            self._terminating &= set(self._committed)
            # Early-release markers for pods that no longer exist can
            # never be consumed by a commit — drop them.
            for uid in [u for u in self._early_releases
                        if u not in alive]:
                del self._early_releases[uid]
        return released

    # -- delta-ingest bookkeeping -------------------------------------

    def _mark_rows(self, group: str, *rows: int) -> None:
        """Mark ``group`` dirty at node rows ``rows``.  No rows means
        flag-only dirt (e.g. the zone-count sidecars of the alloc
        group, which are always shipped whole).  Caller holds the
        lock."""
        self._dirty[group] = True
        s = self._dirty_rows[group]
        if s is not None:
            s.update(rows)
            if len(s) > _DELTA_MAX_INDICES:
                self._dirty_rows[group] = None

    def _mark_full(self, group: str) -> None:
        """Mark ``group`` dirty for a full re-upload: bulk rewrites
        (interner backfill, set_network) or footprints the row/pair
        protocol cannot express.  Caller holds the lock."""
        self._dirty[group] = True
        if group == "net":
            self._dirty_pairs = None
        else:
            self._dirty_rows[group] = None

    def _mark_pair(self, i: int, j: int) -> None:
        """Mark net element (i, j) dirty.  DIRECTED — symmetric
        writers mark both orientations.  Caller holds the lock."""
        self._dirty["net"] = True
        if self._dirty_pairs is not None:
            self._dirty_pairs.add((int(i), int(j)))
            if len(self._dirty_pairs) > _DELTA_MAX_INDICES:
                self._dirty_pairs = None

    def _rows_idx(self, group: str, n: int,
                  delta_on: bool) -> "np.ndarray | None":
        """Resolve a dirty group to a scatter row-index vector, or
        None to force a full upload (delta disabled, no device cache
        yet, full sentinel, or past the dirty-fraction escalation
        knob — scattering most of the array costs more than one
        contiguous transfer)."""
        rows = self._dirty_rows[group]
        if (not delta_on or rows is None
                or len(rows) > self.cfg.delta_full_fraction * n):
            return None
        return np.array(sorted(rows), np.int32)

    def _full_up(self, key: str, host) -> None:
        """Full-group transfer of one cached array (+accounting).

        The copy is load-bearing: ``torch.from_numpy`` aliases its
        source and ``.to("cpu")`` returns the same tensor, so without it
        a CPU "device" plane would ALIAS the staging array and every
        later in-place staging write would leak into snapshots already
        handed out — breaking the immutable-snapshot contract and making
        device-vs-staging drift undetectable."""
        arr = _to_device(host, self.device)
        self._cache[key] = arr
        self.snapshot_full_bytes_total += arr.numel() * arr.element_size()

    def _rows_up(self, key: str, idx: np.ndarray, host) -> None:
        """Scatter-patch rows ``idx`` of one cached array from its
        host staging twin (+accounting: values plus indices)."""
        vals = _to_device(host[idx], self.device)
        self._cache[key] = _scatter_rows(
            self._cache[key], _to_device(idx.astype(np.int64), self.device),
            vals)
        self.snapshot_delta_bytes_total += int(
            vals.numel() * vals.element_size() + idx.nbytes)

    def _pairs_up(self, key: str, ii: np.ndarray, jj: np.ndarray,
                  host) -> None:
        """Scatter-patch elements (ii, jj) of one cached matrix."""
        vals = _to_device(host[ii, jj], self.device)
        self._cache[key] = _scatter_pairs(
            self._cache[key], _to_device(ii.astype(np.int64), self.device),
            _to_device(jj.astype(np.int64), self.device), vals)
        self.snapshot_delta_bytes_total += int(
            vals.numel() * vals.element_size() + ii.nbytes + jj.nbytes)

    def static_delta_since(self, version: int) -> "dict | None":
        """Merged static-input dirty descriptor covering
        ``(version, current_static_version]``.

        Returns None when the bounded per-version history cannot prove
        coverage (consumer too many versions behind, or delta tracking
        disabled) — the caller must rebuild its static prep from
        scratch.  Otherwise a dict with ``metrics``/``topo``/``net``
        booleans and ``net_pairs``: the union of dirty (i, j) net
        elements across the span, or None meaning the whole net group
        moved (bulk rewrite / netmodel blend, which is global)."""
        with self._lock:
            cur = self._static_version
            if version == cur:
                return {"metrics": False, "topo": False, "net": False,
                        "net_pairs": frozenset()}
            ents = [(v, d) for v, d in self._static_deltas
                    if v > version]
            if version > cur or len(ents) != cur - version:
                return None
            metrics = topo = net = False
            pairs: "set | None" = set()
            for _, d in ents:
                metrics = metrics or d["metrics"]
                topo = topo or d["topo"]
                if d["net"]:
                    net = True
                    if pairs is not None:
                        if d["net_pairs"] is None:
                            pairs = None
                        else:
                            pairs |= d["net_pairs"]
            return {"metrics": metrics, "topo": topo, "net": net,
                    "net_pairs": (None if pairs is None
                                  else frozenset(pairs))}

    # -- snapshot -----------------------------------------------------

    def snapshot(self) -> ClusterState:
        """Device view of the current staging state; transfers only
        dirty groups (double-buffering: the returned pytree is
        immutable, later updates build a new one)."""
        return self.snapshot_versioned()[0]

    def snapshot_versioned(self) -> tuple[ClusterState, int]:
        """:meth:`snapshot` plus the matching :attr:`static_version`,
        read atomically under the encoder lock.

        The pairing matters for static-score caching: the version
        bumps lazily inside the flush, so reading it in a separate
        call before OR after the snapshot can mispair it with the
        state (a dirty flag pending at the pre-read, or a concurrent
        thread's flush after it) and serve stale static scores against
        fresh state."""
        with self._lock:
            # Version the static-score inputs (metrics/net/topo): any
            # rebuild of those cache groups invalidates cached
            # batch-invariant score prep held by serving paths (the
            # extender batcher keys on this counter — an explicit
            # contract, not reliance on array-object reuse).
            static_bumped = (self._dirty["metrics"] or self._dirty["net"]
                             or self._dirty["topo"])
            if static_bumped:
                self._static_version += 1
            model = self.netmodel
            net_blend = model is not None and model.enabled
            if static_bumped and self.cfg.enable_delta_state:
                # Record this version's dirty footprint for static
                # consumers (static_delta_since).  The netmodel blend
                # mixes every element regardless of which probes moved,
                # so its net footprint is always "full".
                pairs = self._dirty_pairs
                self._static_deltas.append((self._static_version, {
                    "metrics": self._dirty["metrics"],
                    "topo": self._dirty["topo"],
                    "net": self._dirty["net"],
                    # Empty pairs with the net flag up = boolean-only
                    # dirt (external poke): record "whole group moved"
                    # so static consumers rebuild, never skip.
                    "net_pairs": ((None if (net_blend or not pairs)
                                   else frozenset(pairs))
                                  if self._dirty["net"] else frozenset()),
                }))
            # Delta ingest patches the previous device arrays in place
            # of full transfers when the dirty footprint is small; the
            # scattered values are computed by the SAME host formulas
            # as the full path, so the resulting pytree is
            # bit-identical (property-tested in test_static_delta).
            delta_on = bool(self.cfg.enable_delta_state) and bool(self._cache)
            n = self._node_valid.shape[0]
            if self._dirty["metrics"]:
                idx = self._rows_idx("metrics", n, delta_on)
                # Dirty flag with NO recorded rows = someone set the
                # boolean directly (the pre-delta contract, still used
                # by tests poking staging arrays) — coverage is
                # unprovable, so ship the whole group.  Internal
                # writers always record rows, so this costs nothing in
                # the steady state.
                if idx is None or len(idx) == 0:
                    self._full_up("metrics", self._metrics)
                    self._full_up("metrics_age", self._metrics_age)
                else:
                    self._rows_up("metrics", idx, self._metrics)
                    self._rows_up("metrics_age", idx, self._metrics_age)
            if self._dirty["net"]:
                if net_blend:
                    # The blend mixes every element: the whole group
                    # goes up, through the same function as
                    # expected_device_arrays().
                    lat_host, bw_host = model.blend(self._lat, self._bw)
                    self._full_up("lat", lat_host)
                    self._full_up("bw", bw_host)
                else:
                    pairs = self._dirty_pairs
                    # Empty pair set with the net flag up: boolean-only
                    # dirt (see the metrics branch) — full upload.
                    if (not delta_on or not pairs
                            or len(pairs) >
                            self.cfg.delta_full_fraction * n * n):
                        self._full_up("lat", self._lat)
                        self._full_up("bw", self._bw)
                    else:
                        srt = sorted(pairs)
                        ii = np.array([p[0] for p in srt], np.int32)
                        jj = np.array([p[1] for p in srt], np.int32)
                        self._pairs_up("lat", ii, jj, self._lat)
                        self._pairs_up("bw", ii, jj, self._bw)
            if self._dirty["alloc"]:
                # Nominated reservations count as used: the scoring
                # kernel must not hand a preemptor's freed space to
                # someone else (the preemptor's own hold is dropped
                # when it is encoded for scoring).  Row-sliceable: the
                # reservation array is zero except at nominated rows,
                # and every row whose reservation moves is marked.
                used_host = (self._used + self._reserved
                             if self._nominations else self._used)
                idx = self._rows_idx("alloc", n, delta_on)
                if idx is None:
                    self._full_up("cap", self._cap)
                    self._full_up("used", used_host)
                    self._full_up("group_bits", self._group_bits)
                    self._full_up("resident_anti", self._resident_anti)
                elif len(idx):
                    self._rows_up("cap", idx, self._cap)
                    self._rows_up("used", idx, used_host)
                    self._rows_up("group_bits", idx, self._group_bits)
                    self._rows_up("resident_anti", idx,
                                  self._resident_anti)
                # The zone-count sidecars are O(slots x zones) small
                # and not row-shaped: shipped whole whenever the alloc
                # group is dirty.
                self._full_up("gz_counts", self._gz_counts)
                self._full_up("az_anti", self._az_anti)
            if self._dirty["topo"]:
                idx = self._rows_idx("topo", n, delta_on)
                if idx is None or len(idx) == 0:
                    self._full_up("node_valid", self._node_valid)
                    self._full_up("label_bits", self._label_bits)
                    self._full_up("taint_bits", self._taint_bits)
                    self._full_up("node_zone", self._node_zone)
                    self._full_up("node_numeric", self._node_numeric)
                else:
                    self._rows_up("node_valid", idx, self._node_valid)
                    self._rows_up("label_bits", idx, self._label_bits)
                    self._rows_up("taint_bits", idx, self._taint_bits)
                    self._rows_up("node_zone", idx, self._node_zone)
                    self._rows_up("node_numeric", idx,
                                  self._node_numeric)
            for key in self._dirty:
                self._dirty[key] = False
            self._dirty_rows = {"metrics": set(), "alloc": set(),
                                "topo": set()}
            self._dirty_pairs = set()
            return ClusterState(**self._cache), self._static_version

    def expected_device_arrays(self) -> "dict[str, np.ndarray]":
        """Host-side truth of what the device cache must hold after a
        flush: the staging arrays routed through the SAME transforms
        the snapshot transfer path applies (netmodel blend on the net
        group, nomination reservations folded into ``used``).  The
        anti-entropy auditor (core/integrity.py) digests this against
        the live device planes — bit-exact agreement is the invariant
        the delta-ingest design promises.  Returns copies (safe to
        digest outside the lock)."""
        with self._lock:
            model = self.netmodel
            if model is not None and model.enabled:
                lat, bw = model.blend(self._lat, self._bw)
                lat = np.asarray(lat, np.float32)
                bw = np.asarray(bw, np.float32)
            else:
                lat, bw = self._lat.copy(), self._bw.copy()
            used = (self._used + self._reserved if self._nominations
                    else self._used.copy())
            return {
                "metrics": self._metrics.copy(),
                "metrics_age": self._metrics_age.copy(),
                "lat": lat,
                "bw": bw,
                "cap": self._cap.copy(),
                "used": used,
                "node_valid": self._node_valid.copy(),
                "label_bits": self._label_bits.copy(),
                "taint_bits": self._taint_bits.copy(),
                "group_bits": self._group_bits.copy(),
                "resident_anti": self._resident_anti.copy(),
                "node_zone": self._node_zone.copy(),
                "gz_counts": self._gz_counts.copy(),
                "az_anti": self._az_anti.copy(),
                "node_numeric": self._node_numeric.copy(),
            }

    # -- pods ---------------------------------------------------------

    def _constraint_bits(self, pod: Pod, lenient: bool
                         ) -> tuple[int, int, int, int, int]:
        """Intern one pod's constraint sets → (tol, sel, aff, anti,
        group) bitmasks; single source of truth for batch AND stream
        encoding.

        Overflow direction per constraint: dropping a toleration/anti/
        own-group is conservative (more constrained / untracked); a
        must-match selector or required-affinity key degrades to the
        UNKNOWN sentinel (infeasible) rather than silently matching
        anywhere.

        Any lenient-mode drop records the pod in ``_degraded_pods`` so
        the loop can emit a per-pod Warning event — an operator must be
        able to tell WHICH pods lost constraints, not just read an
        aggregate overflow counter (the anti-affinity drop in
        particular silently stops being enforced).
        """
        drops_before = (self.taints.overflow_drops
                        + self.labels.overflow_drops
                        + self.groups.overflow_drops)
        if lenient and getattr(pod, "parse_degraded", 0):
            # Constraints already lost at PARSE time (kubeclient
            # dropped an unrepresentable required term): surface them
            # through the same per-pod event stream as interner drops.
            self._record_degraded(pod, int(pod.parse_degraded))
        bits = (
            self.taints.mask(pod.tolerations, lenient),
            self._selector_mask(pod.node_selector, lenient),
            self.groups.mask(pod.affinity_groups, lenient,
                             on_overflow=self.groups.unknown),
            self.groups.mask(pod.anti_groups, lenient),
            self._membership_mask(pod, lenient),
        )
        drops_after = (self.taints.overflow_drops
                       + self.labels.overflow_drops
                       + self.groups.overflow_drops)
        if drops_after > drops_before:
            self._record_degraded(pod, drops_after - drops_before)
        return bits

    def _zone_bits(self, pod: Pod, lenient: bool,
                   record: bool = True) -> tuple[int, int]:
        """Intern one pod's zone-scoped (anti-)affinity groups →
        (zaff, zanti) masks in the group bit space.  Overflow
        direction mirrors the hostname pair: a required zone-affinity
        group degrades to UNKNOWN (present in no zone — infeasible),
        a zone-anti group drops (untracked, recorded per pod)."""
        zaff_src = getattr(pod, "zone_affinity_groups", ()) or ()
        zanti_src = getattr(pod, "zone_anti_groups", ()) or ()
        if not zaff_src and not zanti_src:
            return 0, 0
        before = self.groups.overflow_drops
        zaff = self.groups.mask(zaff_src, lenient,
                                on_overflow=self.groups.unknown)
        zanti = self.groups.mask(zanti_src, lenient)
        if record and self.groups.overflow_drops > before:
            self._record_degraded(
                pod, self.groups.overflow_drops - before)
        return zaff, zanti

    def _record_degraded(self, pod: Pod, count: int) -> None:
        """Queue one ConstraintDegraded record per pod identity
        (caller holds the lock); repeat drops for the same pod (commit
        after encode, retry cycles) are not re-recorded."""
        if self._degrade_capture is not None:
            # Shape-cache capture (see _pod_constraint_rows): tally
            # only — the caller records ONE event with the shape's
            # total afterwards, so miss and hit pods of one shape
            # report the same count (piecemeal recording here would
            # give the miss pod only its first source's count, the
            # identity dedup suppressing the rest).
            self._degrade_capture += count
            return
        key = (pod.namespace, pod.name)
        if key in self._degraded_seen:
            return
        if len(self._degraded_seen) >= 4096:
            # Bounded: on a pathological fleet, prefer occasional
            # duplicate events over unbounded growth.
            self._degraded_seen.clear()
        self._degraded_seen.add(key)
        self.degraded_total += 1
        detail = tuple(getattr(pod, "parse_degraded_detail", ()) or ())
        self._degraded_pods.append((pod.namespace, pod.name, count,
                                    detail))

    def register_selectors(self, defs: Mapping[str, tuple],
                           lenient: bool) -> int:
        """Register selector-group definitions (group key → canonical
        structure for :func:`selector_matches`); returns the count of
        keys that could not get a bit (interner overflow — the caller
        records the degradation per pod).

        A NEW registration retroactively claims committed residents
        whose labels match — node group bits, refcounts, zone counts
        and the cluster-wide member counts all update — because
        Kubernetes evaluates selectors against live pods: a selector
        first seen after its members were scheduled must still see
        them.  Bumps ``_selector_gen`` so shape-cache entries computed
        against the older registry die.  Caller holds the lock."""
        degraded = 0
        w = self.cfg.mask_words
        for key, sel_def in defs.items():
            if key in self._selector_defs:
                continue
            before = self.groups.overflow_drops
            bit = self.groups.bit(key, lenient=lenient)
            if self.groups.overflow_drops > before or not bit:
                degraded += 1
                continue
            self._selector_defs[key] = tuple(sel_def)
            self._selector_gen += 1
            slot = bit.bit_length() - 1
            for uid, rec in self._committed.items():
                if (rec.labels is None or (rec.member_bits & bit)
                        or not selector_matches(sel_def, rec.labels)):
                    continue
                self._committed[uid] = rec._replace(
                    member_bits=rec.member_bits | bit)
                self._group_bits[rec.node] |= int_to_words(bit, w)
                self._ref_add(self._group_refs, rec.node, bit)
                if rec.zone >= 0:
                    self._gz_counts[slot, rec.zone] += 1
                self._group_member_counts[slot] += 1
                self._mark_rows("alloc", rec.node)
        return degraded

    def _membership_mask(self, pod: Pod, lenient: bool) -> int:
        """The pod's FULL group-membership mask: its annotation group
        bit | every registered selector-group its labels satisfy
        (label-driven membership, kube semantics — no annotation
        opt-in).  Caller holds the lock."""
        mask = self.groups.bit(pod.group, lenient) if pod.group else 0
        labels = getattr(pod, "labels", None)
        if labels is not None:
            # An EMPTY label set still evaluates: kube's NotIn /
            # DoesNotExist (and the empty selector) match label-less
            # pods too.
            for key, sel_def in self._selector_defs.items():
                if selector_matches(sel_def, labels):
                    mask |= self.groups.bit(key, lenient=True)
        return mask

    def _spread_slot(self, pod: Pod) -> int:
        """Bit-slot of the pod's topology-spread COUNTED group: the
        constraint's labelSelector group when parsed
        (``pod.spread_group``), else the pod's own group.  Caller
        holds the lock."""
        sg = getattr(pod, "spread_group", "") or pod.group
        if not sg:
            return -1
        bit = self.groups.bit(sg, lenient=True)
        return bit.bit_length() - 1 if bit else -1

    def set_pdb(self, pdb) -> None:
        """Upsert a real ``policy/v1`` PodDisruptionBudget: registers
        its selector as a selector-group (member counting then rides
        the same label-driven machinery as affinity) and records the
        disruption bound for the preemption planner.

        A selector that cannot get a group bit (interner exhausted)
        leaves the PDB UNENFORCED — the preemption planner finds no
        slot and skips the bound (degrades OPEN).  Unlike every other
        degradation that would otherwise be silent, this is
        surfaced through the same ConstraintDegraded event channel the
        per-pod drops use, naming the PDB."""
        with self._lock:
            degraded = False
            if pdb.selector_key:
                self.register_selectors(
                    {pdb.selector_key: pdb.selector_def}, lenient=True)
                degraded = pdb.selector_key not in self._selector_defs
            self._pdbs[pdb.uid or f"{pdb.namespace}/{pdb.name}"] = pdb
            if degraded:
                # Same identity-dedup discipline as _record_degraded:
                # the PDB watch re-delivers on every resync, and
                # without dedup each upsert re-fires the event while
                # the interner stays exhausted.
                key = (pdb.namespace, f"pdb/{pdb.name}")
                if key not in self._degraded_seen:
                    if len(self._degraded_seen) >= 4096:
                        self._degraded_seen.clear()
                    self._degraded_seen.add(key)
                    self.degraded_total += 1
                    self._degraded_pods.append((
                        pdb.namespace, pdb.name, 1,
                        (f"PodDisruptionBudget {pdb.namespace}/"
                         f"{pdb.name} selector could not get a group"
                         " bit (interner exhausted); its disruption"
                         " bound is NOT enforced (degrades OPEN)",)))

    def remove_pdb(self, uid: str) -> None:
        with self._lock:
            self._pdbs.pop(uid, None)

    def _apply_first_pod_escape(self, aff_row: np.ndarray,
                                zaff_row: np.ndarray,
                                gbit_row: np.ndarray,
                                granted: set) -> None:
        """Kube-scheduler's required-affinity special case: a term
        whose group has NO live member anywhere is waived when the
        incoming pod itself is a member — without it, the first pod of
        a Deployment whose replicas carry required self-affinity
        deadlocks Pending forever.

        The waiver applies only when NO earlier pod of the same encode
        pass is a member either (``granted`` is the caller's
        accumulated member-slot set): an earlier member will normally
        place this pass, and the conflict loop then chains the later
        pod onto it within the batch — exactly the sequential
        co-location kube's one-at-a-time queue gives (a sidecar queued
        after its app must land beside it, not take the waiver).
        Zone-scoped terms use the same cluster-wide member counts
        (kube's rule is "no pod in the cluster matches the selector",
        not per-domain).  Caller holds the lock."""
        member = words_to_int(gbit_row)
        if not member:
            return
        for row in (aff_row, zaff_row):
            m = words_to_int(row)
            cand = m & member
            drop = 0
            while cand:
                b = cand & -cand
                cand ^= b
                slot = b.bit_length() - 1
                if (self._group_member_counts[slot] == 0
                        and slot not in granted):
                    drop |= b
            if drop:
                _fill_words(row, m & ~drop)

    def _soft_rows(self, pod: Pod, sel_bits_row: np.ndarray,
                   sel_w_row: np.ndarray, grp_bits_row: np.ndarray,
                   grp_w_row: np.ndarray, zone_bits_row: np.ndarray,
                   zone_w_row: np.ndarray) -> None:
        """Fill one pod's soft-affinity term rows (caller holds the
        lock; rows are ``u32[T, W]`` / ``f32[T]`` slices).

        Always lenient: a preference we cannot intern degrades
        score-neutrally.  Label terms go through
        :meth:`_selector_mask` so a newly-referenced label backfills
        onto already-registered nodes; on overflow the mask carries
        the UNKNOWN sentinel, which no node has — the term then simply
        never matches (0 contribution), exactly the right degradation
        for a *preference*.  Group terms intern like anti-affinity
        groups (0 on overflow = no contribution).
        """
        t_max = sel_w_row.shape[0]

        def top_terms(terms):
            # Over budget, keep the strongest preferences: zero-weight
            # terms are no-ops (dropped outright), and the k8s parser's
            # multi-value In expansion can inflate one stanza into
            # several terms — truncating by declaration order would let
            # such an expansion evict an unrelated, heavier stanza.
            live = [(x, float(w)) for x, w in terms if w]
            live.sort(key=lambda t: -abs(t[1]))  # stable: ties keep order
            return live[:t_max]

        for t, (labels, weight) in enumerate(
                top_terms(pod.soft_node_affinity)):
            mask = self._selector_mask(labels, lenient=True)
            if mask:
                _fill_words(sel_bits_row[t], mask)
                sel_w_row[t] = weight
        for t, (grp, weight) in enumerate(
                top_terms(pod.soft_group_affinity)):
            bit = self.groups.bit(grp, lenient=True) if grp else 0
            if bit:
                _fill_words(grp_bits_row[t], bit)
                grp_w_row[t] = weight
        for t, (grp, weight) in enumerate(
                top_terms(pod.soft_zone_affinity)):
            bit = self.groups.bit(grp, lenient=True) if grp else 0
            if bit:
                _fill_words(zone_bits_row[t], bit)
                zone_w_row[t] = weight

    def _ns_rows(self, pod: Pod, anyof_row: np.ndarray,
                 forbid_row: np.ndarray, used_row: np.ndarray,
                 num_col_row: np.ndarray, num_lo_row: np.ndarray,
                 num_hi_row: np.ndarray,
                 lenient: bool, record: bool = True) -> None:
        """Fill one pod's hard-nodeAffinity rows from
        ``pod.required_node_affinity`` (caller holds the lock).

        Rows are ``anyof u32[T2, E, W]`` / ``forbid u32[T2, W]`` /
        ``used bool[T2]`` / numeric ``col i32[T2, NE]`` +
        ``lo/hi f32[T2, NE]`` slices.  Ops map as: In -> any-of over
        the interned ``key=value`` strings; Exists -> any-of over
        the key-presence bit; NotIn/DoesNotExist -> the term's forbid
        mask; Gt/Lt -> a (numeric-column, lo, hi) comparison slot
        (same-key Gt+Lt merge into one interval).  Hard constraints
        degrade CLOSED: terms beyond the budget are dropped (fewer OR
        branches = stricter), an over-budget or unrepresentable
        expression marks its term unsatisfiable via the UNKNOWN
        sentinel (no node carries it), and a pod whose every term
        degrades away keeps one unsatisfiable term rather than
        silently losing the constraint.  Strict mode raises instead.
        Every lenient degradation is recorded for the per-pod
        ConstraintDegraded event unless ``record=False`` (read-only
        callers like the preemption planner, which re-encodes a pod
        the scoring path already recorded).
        """
        terms = tuple(getattr(pod, "required_node_affinity", ()) or ())
        if not terms:
            return
        t2, e_max = anyof_row.shape[0], anyof_row.shape[1]
        ne_max = num_col_row.shape[1]
        unknown = self.labels.unknown
        degraded = 0
        if len(terms) > t2:
            if not lenient:
                raise ValueError(
                    f"pod {pod.name}: {len(terms)} nodeSelectorTerms "
                    f"exceed max_ns_terms={t2}")
            degraded += len(terms) - t2
            terms = terms[:t2]
        for t, term in enumerate(terms):
            used_row[t] = True
            anyofs: list[int] = []
            numeric: dict[int, list[float]] = {}  # col -> [lo, hi]
            forbid = 0
            unsat = False
            for expr in term:
                try:
                    op, key, values = expr[0], expr[1], tuple(expr[2])
                except (TypeError, IndexError, KeyError):
                    # Malformed expression (programmatic Pod with the
                    # wrong nesting, not kubeclient output): a batch
                    # encode must not die on one bad pod — closed, per
                    # the hard-constraint rule.
                    if not lenient:
                        raise ValueError(
                            f"pod {pod.name}: malformed nodeAffinity "
                            f"expression {expr!r}") from None
                    degraded += 1
                    unsat = True
                    continue
                if op == "In":
                    if not values:
                        unsat = True  # k8s validation forbids; closed
                        continue
                    anyofs.append(self._selector_mask(
                        (f"{key}={v}" for v in values), lenient))
                elif op == "Exists":
                    anyofs.append(self._presence_mask((key,), lenient))
                elif op == "NotIn":
                    m = self._selector_mask(
                        (f"{key}={v}" for v in values), lenient)
                    if m & unknown:
                        # A forbidden value we cannot track: nodes
                        # carrying it are indistinguishable — closed.
                        unsat = True
                    forbid |= m & ~unknown
                elif op == "DoesNotExist":
                    m = self._presence_mask((key,), lenient)
                    if m & unknown:
                        unsat = True
                    forbid |= m & ~unknown
                elif op in ("Gt", "Lt"):
                    # Numeric comparison: kube parses the single value
                    # as an integer (we accept any float — a strict
                    # superset); unparseable values and column-budget
                    # overflow degrade the term CLOSED.
                    try:
                        val = float(values[0])
                    except (IndexError, ValueError, TypeError):
                        if not lenient:
                            raise ValueError(
                                f"pod {pod.name}: non-numeric "
                                f"{op} value {values!r}") from None
                        degraded += 1
                        unsat = True
                        continue
                    col = self._numeric_col(key, lenient)
                    if col is None:
                        degraded += 1
                        unsat = True
                        continue
                    lo, hi = numeric.setdefault(
                        col, [-np.inf, np.inf])
                    if op == "Gt":
                        numeric[col][0] = max(lo, val)
                    else:
                        numeric[col][1] = min(hi, val)
                else:
                    if not lenient:
                        raise ValueError(
                            f"pod {pod.name}: unsupported nodeAffinity "
                            f"operator {op!r}")
                    degraded += 1
                    unsat = True
            if len(anyofs) > e_max:
                if not lenient:
                    raise ValueError(
                        f"pod {pod.name}: {len(anyofs)} matchExpressions "
                        f"exceed max_ns_exprs={e_max}")
                degraded += len(anyofs) - e_max
                unsat = True
            if len(numeric) > ne_max:
                if not lenient:
                    raise ValueError(
                        f"pod {pod.name}: {len(numeric)} numeric "
                        f"Gt/Lt keys exceed max_ns_num={ne_max}")
                degraded += len(numeric) - ne_max
                unsat = True
            if unsat:
                anyof_row[t].fill(0)
                _fill_words(anyof_row[t, 0], unknown)
                forbid_row[t].fill(0)
                num_col_row[t].fill(-1)
                degraded += 1
            else:
                for e, m in enumerate(anyofs):
                    _fill_words(anyof_row[t, e], m)
                _fill_words(forbid_row[t], forbid)
                for j, (col, (lo, hi)) in enumerate(
                        sorted(numeric.items())):
                    num_col_row[t, j] = col
                    num_lo_row[t, j] = lo
                    num_hi_row[t, j] = hi
        if degraded and record:
            self._record_degraded(pod, degraded)

    def _pod_constraint_rows(self, pod: Pod, lenient: bool,
                             rows: tuple) -> tuple:
        """Fill one pod's 19 constraint-row slices and return its
        ``_constraint_bits`` tuple — with a SHAPE cache: pods of one
        service/Deployment share identical constraint sets (same
        tolerations/selectors/affinities/terms), so the interning and
        row-building work runs once per distinct shape and later pods
        memcpy the rows (measured ~2x on the 65k-pod stream encode).

        Cache safety: interned bits are stable once assigned (the
        tables only grow) and lazy label/presence backfill happens on
        first intern — both exactly-once effects a later identical
        shape no longer needs.  Degradation is replayed per pod: the
        compute's recorded drop count is stored and re-recorded for
        every cache-hit pod (events are per-pod, identity-keyed).
        Strict and lenient entries are keyed apart (strict must keep
        raising); a strict-mode raise caches nothing.  Caller holds
        the lock.
        """
        # New selector definitions must land BEFORE the cache lookup —
        # a registration bumps _selector_gen (part of the key below),
        # so entries whose memberships were computed against the older
        # registry can never be served stale.
        defs = getattr(pod, "selector_defs", None)
        if defs:
            dropped = self.register_selectors(defs, lenient=lenient)
            if dropped:
                self._record_degraded(pod, dropped)
        key: tuple | None = (
            lenient, pod.tolerations, pod.node_selector,
            pod.affinity_groups, pod.anti_groups, pod.group,
            getattr(pod, "labels", frozenset()),
            getattr(pod, "spread_group", ""), self._selector_gen,
            pod.required_node_affinity, pod.zone_affinity_groups,
            pod.zone_anti_groups, pod.soft_node_affinity,
            pod.soft_group_affinity, pod.soft_zone_affinity,
            int(getattr(pod, "parse_degraded", 0)))
        try:
            cached = self._shape_cache.get(key)
        except TypeError:
            # Programmatic Pods may carry list/set-valued fields (the
            # dataclass doesn't coerce); they encode fine, they just
            # can't key the cache — bypass it rather than crash the
            # lenient batch.
            key = None
            cached = None
        if cached is not None:
            self.shape_cache_hits += 1
            bits, nonzero, d_delta = cached
            # Only the rows the compute actually touched are stored
            # (targets are pre-zeroed): typical pods copy 1-3 small
            # arrays, not 16 — the copies were otherwise eating the
            # cache's win.
            for j, src in nonzero:
                rows[j][...] = src
            if d_delta:
                self._record_degraded(pod, d_delta)
            return bits
        (tol_r, sel_r, aff_r, anti_r, gbit_r, ssel_r, ssel_w_r,
         sgrp_r, sgrp_w_r, szone_r, szone_w_r, ns_any_r, ns_forb_r,
         ns_used_r, ns_ncol_r, ns_nlo_r, ns_nhi_r, zaff_r,
         zanti_r) = rows
        # Rows the compute may have written, tracked EXPLICITLY (a
        # superset is fine: untouched rows still hold the caller's
        # defaults, so an extra copy is a no-op).  The previous
        # ``r.any()`` sweep over all 19 rows cost ~30% of a rich-
        # constraint stream encode (160k tiny-ndarray reductions per
        # 10k pods) and, worse, the ns numeric rows' NON-zero defaults
        # (-1 / ±inf) made every cache entry store-and-copy them even
        # for pods with no nodeAffinity at all.
        touched: list[int] = []
        # Capture the compute's INTENDED degradation count through the
        # explicit accumulator (deque-length arithmetic would read 0
        # once the bounded _degraded_pods is full, or when this pod's
        # identity was already recorded).
        self._degrade_capture = 0
        try:
            bits = self._constraint_bits(pod, lenient)
            for j, (row, val) in enumerate(
                    zip((tol_r, sel_r, aff_r, anti_r, gbit_r), bits)):
                if val:  # rows are pre-zeroed; most masks are 0
                    _fill_words(row, val)
                    touched.append(j)
            self._soft_rows(pod, ssel_r, ssel_w_r, sgrp_r, sgrp_w_r,
                            szone_r, szone_w_r)
            if pod.soft_node_affinity:
                touched += [5, 6]
            if pod.soft_group_affinity:
                touched += [7, 8]
            if pod.soft_zone_affinity:
                touched += [9, 10]
            self._ns_rows(pod, ns_any_r, ns_forb_r, ns_used_r,
                          ns_ncol_r, ns_nlo_r, ns_nhi_r, lenient)
            if getattr(pod, "required_node_affinity", ()) or ():
                touched += [11, 12, 13, 14, 15, 16]
            zb = self._zone_bits(pod, lenient)
            if zb[0]:
                _fill_words(zaff_r, zb[0])
                touched.append(17)
            if zb[1]:
                _fill_words(zanti_r, zb[1])
                touched.append(18)
            d_delta = self._degrade_capture
        finally:
            # A strict-mode raise must not leave the accumulator armed
            # for unrelated later _record_degraded calls.
            self._degrade_capture = None
        if d_delta:
            self._record_degraded(pod, d_delta)
        if key is not None:
            # Counted here — after a successful, hashable compute —
            # so the unhashable bypass and strict-mode raises don't
            # inflate it (the bounded cache's evictions still recount
            # shapes; the metric is compute COUNT, not cardinality).
            self.shape_cache_misses += 1
            if len(self._shape_cache) >= 8192:
                # Bounded: pathological all-distinct fleets fall back
                # to compute-per-pod, never unbounded memory.
                self._shape_cache.clear()
            self._shape_cache[key] = (
                bits,
                tuple((j, rows[j].copy()) for j in touched),
                d_delta)
        return bits

    def encode_pods(self, pods: Sequence[Pod],
                    node_of: Callable[[str], str],
                    lenient: bool = False,
                    pad_to: int | None = None) -> PodBatch:
        """Build a :class:`PodBatch` for up to ``cfg.max_pods`` pods.

        ``node_of`` resolves a peer pod name to its node name ("" if
        unplaced — such peers are dropped: traffic to a pod that has no
        home yet cannot pull the placement anywhere).  ``lenient``
        governs interner overflow (see :class:`Interner`): pass True
        for request-driven paths fed by untrusted manifests.

        ``pad_to`` overrides the batch's padded pod-axis extent
        (default ``cfg.max_pods``): request-driven paths like the
        extender webhook batch to the actual demand so a lone request
        does not pay a ``max_pods``-shaped kernel.  Each distinct value
        is a differently shaped batch — callers should quantize.
        """
        cfg = self.cfg
        p, k, r = pad_to or cfg.max_pods, cfg.max_peers, cfg.num_resources
        w = cfg.mask_words
        if len(pods) > p:
            raise ValueError(f"batch of {len(pods)} exceeds "
                             f"{'pad_to' if pad_to else 'max_pods'}={p}")
        req = np.zeros((p, r), np.float32)
        peers = np.full((p, k), -1, np.int32)
        traffic = np.zeros((p, k), np.float32)
        tol = np.zeros((p, w), np.uint32)
        sel = np.zeros((p, w), np.uint32)
        aff = np.zeros((p, w), np.uint32)
        anti = np.zeros((p, w), np.uint32)
        gbit = np.zeros((p, w), np.uint32)
        prio = np.zeros((p,), np.float32)
        valid = np.zeros((p,), bool)
        t_soft = cfg.max_soft_terms
        ssel = np.zeros((p, t_soft, w), np.uint32)
        ssel_w = np.zeros((p, t_soft), np.float32)
        sgrp = np.zeros((p, t_soft, w), np.uint32)
        sgrp_w = np.zeros((p, t_soft), np.float32)
        szone = np.zeros((p, t_soft, w), np.uint32)
        szone_w = np.zeros((p, t_soft), np.float32)
        gidx = np.full((p,), -1, np.int32)
        sp_skew = np.zeros((p,), np.int32)
        sp_hard = np.zeros((p,), bool)
        t2, e_ns = cfg.max_ns_terms, cfg.max_ns_exprs
        ne = cfg.max_ns_num
        ns_any = np.zeros((p, t2, e_ns, w), np.uint32)
        ns_forb = np.zeros((p, t2, w), np.uint32)
        ns_used = np.zeros((p, t2), bool)
        ns_ncol = np.full((p, t2, ne), -1, np.int32)
        ns_nlo = np.full((p, t2, ne), -np.inf, np.float32)
        ns_nhi = np.full((p, t2, ne), np.inf, np.float32)
        zaff = np.zeros((p, w), np.uint32)
        zanti = np.zeros((p, w), np.uint32)
        granted: set[int] = set()  # first-pod escape, one per group
        with self._lock:
            for i, pod in enumerate(pods):
                # A nominated preemptor entering scoring: its own
                # request is about to compete for the reserved space —
                # drop the hold so it does not block itself.
                if self._nominations:
                    self._drop_nomination_locked(pod.uid)
                req[i] = _requests_vector(pod.requests, r)
                slot = 0
                for peer_name, vol in pod.peers.items():
                    if slot >= k:
                        break  # peer list truncated at max_peers
                    peer_node = node_of(peer_name)
                    if not peer_node:
                        continue
                    idx = self._node_index.get(peer_node)
                    if idx is None:
                        continue
                    peers[i, slot] = idx
                    traffic[i, slot] = vol
                    slot += 1
                bits = self._pod_constraint_rows(pod, lenient, (
                    tol[i], sel[i], aff[i], anti[i], gbit[i],
                    ssel[i], ssel_w[i], sgrp[i], sgrp_w[i],
                    szone[i], szone_w[i], ns_any[i], ns_forb[i],
                    ns_used[i], ns_ncol[i], ns_nlo[i], ns_nhi[i],
                    zaff[i], zanti[i]))
                self._apply_first_pod_escape(aff[i], zaff[i], gbit[i],
                                             granted)
                m = words_to_int(gbit[i])
                while m:
                    b = m & -m
                    m ^= b
                    granted.add(b.bit_length() - 1)
                gidx[i] = self._spread_slot(pod)
                sp_skew[i] = int(getattr(pod, "spread_maxskew", 0))
                sp_hard[i] = bool(getattr(pod, "spread_hard", True))
                if sp_skew[i] > 0 and gidx[i] < 0:
                    # A spread constraint with no countable group is
                    # inert — a DoNotSchedule pod would silently
                    # schedule anywhere.  Flag it like every other
                    # constraint degradation.
                    self._record_degraded(pod, 1)
                prio[i] = pod.priority
                valid[i] = True
        dev = self.device
        return PodBatch(**{name: _to_device(arr, dev) for name, arr in dict(
            req=req, peers=peers, peer_traffic=traffic, tol_bits=tol,
            sel_bits=sel, affinity_bits=aff, anti_bits=anti,
            group_bit=gbit, priority=prio, pod_valid=valid,
            soft_sel_bits=ssel, soft_sel_w=ssel_w, soft_grp_bits=sgrp,
            soft_grp_w=sgrp_w, soft_zone_bits=szone, soft_zone_w=szone_w,
            group_idx=gidx, spread_maxskew=sp_skew, spread_hard=sp_hard,
            ns_anyof=ns_any, ns_forbid=ns_forb, ns_term_used=ns_used,
            ns_num_col=ns_ncol, ns_num_lo=ns_nlo, ns_num_hi=ns_nhi,
            zaff_bits=zaff, zanti_bits=zanti).items()})

    def encode_stream(self, pods: Sequence[Pod],
                      node_of: Callable[[str], str],
                      lenient: bool = False):
        """Encode a whole workload for the device-resident replay
        (:func:`~kubernetesnetawarescheduler_tpu_torch.core.replay.replay_stream`).

        One-shot form of :meth:`encode_stream_chunks` — a single chunk
        spanning the whole workload, field-for-field identical to the
        chunked pass."""
        return next(self.encode_stream_chunks(
            pods, node_of, chunk_pods=max(len(pods), 1),
            lenient=lenient))

    def encode_stream_chunks(self, pods: Sequence[Pod],
                             node_of: Callable[[str], str],
                             chunk_pods: int,
                             lenient: bool = False):
        """ONE encode pass over the workload, yielded as
        :class:`PodStream` chunks of ``chunk_pods`` pods (the final
        chunk shorter; one empty chunk for an empty workload).

        The chunked pass and :meth:`encode_stream` are field-for-field
        equal: peer stream indices are GLOBAL (the index space covers
        the whole workload, so peers crossing chunk boundaries resolve
        identically), and the first-pod-escape ``granted`` set persists
        across chunks.  The encoder lock is held per chunk rather than
        across the pass, so a concurrent binder can interleave
        ``commit_many`` between chunks (the overlapped pipeline drain
        in bench/density.py) instead of stalling until the whole
        workload is encoded — safe because commits only ADD committed
        group members, which the escape already sees through
        ``granted`` for every in-stream pod.

        Unlike :meth:`encode_pods`, peers naming pods *within this
        stream* are kept as stream indices (resolved on device against
        the replay's own assignments); peers already placed resolve to
        node indices via ``node_of`` here, host-side.

        Peer-slot allocation mirrors the host loop draining this stream
        in ``cfg.max_pods``-sized batches: an in-stream peer in the same
        or a later batch can never have a node by the time this pod is
        scored (the host's ``node_of`` returns "" and skips it without
        consuming a slot), so it is skipped here too.  Residual
        divergence from the host loop is only possible past
        ``max_peers`` when an earlier-batch peer ends up unschedulable
        (the host frees its slot, the stream cannot know in advance).
        """
        ar = self._alloc_stream_arrays(len(pods))
        stream_index = _stream_index(pods)
        res_names = _res_names(self.cfg.num_resources)
        # First-pod escape: ``granted`` accumulates member slots of
        # every pod already encoded this pass, so only the genuinely
        # FIRST member of a group can take the waiver — later pods
        # chain onto earlier members (in the conflict loop within a
        # batch, or via committed counts across the host loop's
        # batches; the stream sees both through this one set, under
        # the same earlier-pods-bind approximation the peer-slot logic
        # uses).
        granted: set[int] = set()
        if chunk_pods < 1:
            raise ValueError(f"chunk_pods must be >= 1, got {chunk_pods}")

        s = len(pods)
        pos = 0
        while True:
            end = min(pos + chunk_pods, s)
            with self._lock:
                for i in range(pos, end):
                    pod = pods[i]
                    self._fill_stream_row(i, pod, ar, granted,
                                          lenient, res_names)
                    self._resolve_peer_slots(i, pod, stream_index,
                                             ar, node_of)
            yield _stream_slice(ar, pos, end, self.device)
            pos = end
            if pos >= s:
                return

    def _alloc_stream_arrays(self, s: int) -> dict[str, np.ndarray]:
        """Zero-initialized host-side arrays for a ``s``-pod stream,
        keyed by :class:`PodStream` field name."""
        cfg = self.cfg
        k, r, w = cfg.max_peers, cfg.num_resources, cfg.mask_words
        t_soft = cfg.max_soft_terms
        t2, e_ns = cfg.max_ns_terms, cfg.max_ns_exprs
        return {
            "req": np.zeros((s, r), np.float32),
            "peer_pods": np.full((s, k), -1, np.int32),
            "peer_nodes": np.full((s, k), -1, np.int32),
            "peer_traffic": np.zeros((s, k), np.float32),
            "tol_bits": np.zeros((s, w), np.uint32),
            "sel_bits": np.zeros((s, w), np.uint32),
            "affinity_bits": np.zeros((s, w), np.uint32),
            "anti_bits": np.zeros((s, w), np.uint32),
            "group_bit": np.zeros((s, w), np.uint32),
            "priority": np.zeros((s,), np.float32),
            "pod_valid": np.zeros((s,), bool),
            "soft_sel_bits": np.zeros((s, t_soft, w), np.uint32),
            "soft_sel_w": np.zeros((s, t_soft), np.float32),
            "soft_grp_bits": np.zeros((s, t_soft, w), np.uint32),
            "soft_grp_w": np.zeros((s, t_soft), np.float32),
            "soft_zone_bits": np.zeros((s, t_soft, w), np.uint32),
            "soft_zone_w": np.zeros((s, t_soft), np.float32),
            "group_idx": np.full((s,), -1, np.int32),
            "spread_maxskew": np.zeros((s,), np.int32),
            "spread_hard": np.zeros((s,), bool),
            "ns_anyof": np.zeros((s, t2, e_ns, w), np.uint32),
            "ns_forbid": np.zeros((s, t2, w), np.uint32),
            "ns_term_used": np.zeros((s, t2), bool),
            "ns_num_col": np.full((s, t2, cfg.max_ns_num), -1,
                                  np.int32),
            "ns_num_lo": np.full((s, t2, cfg.max_ns_num), -np.inf,
                                 np.float32),
            "ns_num_hi": np.full((s, t2, cfg.max_ns_num), np.inf,
                                 np.float32),
            "zaff_bits": np.zeros((s, w), np.uint32),
            "zanti_bits": np.zeros((s, w), np.uint32),
        }

    def _fill_stream_row(self, i: int, pod: Pod,
                         ar: dict[str, np.ndarray],
                         granted: set[int] | None, lenient: bool,
                         res_names) -> None:
        """Everything about row ``i`` EXCEPT peer resolution — the
        placement-independent share of the encode (requests,
        constraint bitmaps, spread slots).  With ``granted`` given,
        also applies the first-pod escape inline (the serial path);
        ``granted=None`` defers it to :meth:`finalize_stream`, which
        must re-judge it against the member counts current at dispatch
        time (commits mutate them).  Caller holds ``self._lock``."""
        _fill_requests_row(ar["req"][i], pod.requests, res_names)
        self._pod_constraint_rows(pod, lenient, (
            ar["tol_bits"][i], ar["sel_bits"][i],
            ar["affinity_bits"][i], ar["anti_bits"][i],
            ar["group_bit"][i],
            ar["soft_sel_bits"][i], ar["soft_sel_w"][i],
            ar["soft_grp_bits"][i], ar["soft_grp_w"][i],
            ar["soft_zone_bits"][i], ar["soft_zone_w"][i],
            ar["ns_anyof"][i], ar["ns_forbid"][i],
            ar["ns_term_used"][i], ar["ns_num_col"][i],
            ar["ns_num_lo"][i], ar["ns_num_hi"][i],
            ar["zaff_bits"][i], ar["zanti_bits"][i]))
        if granted is not None:
            self._apply_first_pod_escape(ar["affinity_bits"][i],
                                         ar["zaff_bits"][i],
                                         ar["group_bit"][i], granted)
            m = words_to_int(ar["group_bit"][i])
            while m:
                b = m & -m
                m ^= b
                granted.add(b.bit_length() - 1)
        ar["group_idx"][i] = self._spread_slot(pod)
        ar["spread_maxskew"][i] = int(getattr(pod, "spread_maxskew", 0))
        ar["spread_hard"][i] = bool(getattr(pod, "spread_hard", True))
        if ar["spread_maxskew"][i] > 0 and ar["group_idx"][i] < 0:
            # A spread constraint with no countable group is inert — a
            # DoNotSchedule pod would silently schedule anywhere.
            # Flag it like every other constraint degradation.
            self._record_degraded(pod, 1)
        ar["priority"][i] = pod.priority
        ar["pod_valid"][i] = True

    def _resolve_peer_slots(self, i: int, pod: Pod,
                            stream_index: dict[str, int],
                            ar: dict[str, np.ndarray],
                            node_of: Callable[[str], str]) -> None:
        """Peer-slot allocation for row ``i`` — the only
        placement-DEPENDENT share of the encode (``node_of`` consults
        live placements).  Caller holds ``self._lock``."""
        k = self.cfg.max_peers
        batch = self.cfg.max_pods
        peer_pods = ar["peer_pods"]
        peer_nodes = ar["peer_nodes"]
        traffic = ar["peer_traffic"]
        slot = 0
        for peer_name, vol in pod.peers.items():
            if slot >= k:
                break
            j = stream_index.get(peer_name)
            if j is not None:
                if j // batch >= i // batch:
                    # Same/later batch: unresolvable at scoring time,
                    # exactly as the host loop sees it — don't burn a
                    # slot.
                    continue
                peer_pods[i, slot] = j
            else:
                peer_node = node_of(peer_name)
                idx = (self._node_index.get(peer_node)
                       if peer_node else None)
                if idx is None:
                    continue
                peer_nodes[i, slot] = idx
            traffic[i, slot] = vol
            slot += 1

    def encode_stream_prepare(self, pods: Sequence[Pod],
                              lenient: bool = False
                              ) -> "PreparedStream":
        """Placement-independent half of :meth:`encode_stream` — the
        encode-ahead stage of the pipelined serving loop.

        Fills every stream array EXCEPT peer slots (requests,
        constraint bitmaps, spread, first-pod escape) on the calling
        thread, typically while the PREVIOUS burst's device step is in
        flight.  :meth:`finalize_stream` completes peer resolution
        against the placements visible at that moment (after the
        previous burst's assume has published its nodes) and returns
        the :class:`PodStream`; the composition is field-for-field
        identical to a serial :meth:`encode_stream` call made at
        finalize time."""
        ar = self._alloc_stream_arrays(len(pods))
        res_names = _res_names(self.cfg.num_resources)
        with self._lock:
            for i, pod in enumerate(pods):
                # granted=None: the first-pod escape consults LIVE
                # group member counts (mutated by commits), so it is
                # deferred to finalize alongside peer resolution.
                self._fill_stream_row(i, pod, ar, None,
                                      lenient, res_names)
        pristine = {"affinity_bits": ar["affinity_bits"].copy(),
                    "zaff_bits": ar["zaff_bits"].copy()}
        return PreparedStream(pods=tuple(pods), arrays=ar,
                              stream_index=_stream_index(pods),
                              pristine=pristine)

    def finalize_stream(self, prepared: "PreparedStream",
                        node_of: Callable[[str], str]):
        """Resolve the placement-dependent leftovers of a prepared
        stream — peer slots and the first-pod escape — against the
        CURRENT placements, and return the device :class:`PodStream`.
        Cheap relative to prepare: the peer/escape loops plus the
        host→device transfer.  Idempotent: every placement-dependent
        field is rebuilt from a clean slate (fault/restart paths may
        retry it)."""
        ar = prepared.arrays
        with self._lock:
            ar["affinity_bits"][...] = prepared.pristine[
                "affinity_bits"]
            ar["zaff_bits"][...] = prepared.pristine["zaff_bits"]
            granted: set[int] = set()
            for i, pod in enumerate(prepared.pods):
                self._apply_first_pod_escape(
                    ar["affinity_bits"][i], ar["zaff_bits"][i],
                    ar["group_bit"][i], granted)
                m = words_to_int(ar["group_bit"][i])
                while m:
                    b = m & -m
                    m ^= b
                    granted.add(b.bit_length() - 1)
                ar["peer_pods"][i] = -1
                ar["peer_nodes"][i] = -1
                ar["peer_traffic"][i] = 0.0
                self._resolve_peer_slots(i, pod, prepared.stream_index,
                                         ar, node_of)
        return _stream_slice(ar, 0, len(prepared.pods), self.device)


# ---------------------------------------------------------------------
# Device wave ring: bounded device-side staging for the multi-cycle
# serving window.


def split_stream_waves(stream, wave_pods: int) -> list:
    """Slice an encoded (padded) PodStream into per-wave segments of
    ``wave_pods`` pods each.  Pure views — concatenating the segments
    back in order reproduces the original tensors bit for bit."""
    return [stream.slice(a, a + wave_pods)
            for a in range(0, stream.num_pods, wave_pods)]


def concat_stream_waves(waves: list):
    """Re-join per-wave PodStream segments along the pod axis (the
    inverse of :func:`split_stream_waves`), as device ops on
    already-staged waves: no host re-upload at dispatch time."""
    if len(waves) == 1:
        return waves[0]
    from kubernetesnetawarescheduler_tpu_torch.core.replay import PodStream

    return PodStream(**{
        f.name: torch.cat([getattr(w, f.name) for w in waves])
        for f in dataclasses.fields(PodStream)})


class DeviceWaveRing:
    """Bounded ring of pre-encoded pod waves staged on ``device``.

    The host enqueues each wave (one batch's slice of the encoded
    window) with :meth:`push` — one host→device copy per field, the only
    host→device traffic the multicycle path pays per wave — and the
    serving loop drains the whole ring into one window with
    :meth:`pop_window`.  ``push`` returns False (and counts
    ``overflow_total``) when the ring is full: the caller falls back to
    per-cycle dispatch for the overflow waves instead of dropping or
    blocking, so a mis-tuned ``multicycle_queue_depth`` degrades
    throughput, never correctness."""

    def __init__(self, capacity: int, device="cuda") -> None:
        self.capacity = max(1, int(capacity))
        self.device = resolve_device(device)
        self._waves: list = []
        self.pushed_total = 0
        self.overflow_total = 0

    def __len__(self) -> int:
        return len(self._waves)

    def push(self, wave) -> bool:
        if len(self._waves) >= self.capacity:
            self.overflow_total += 1
            return False
        self._waves.append(dataclasses.replace(wave, **{
            f.name: getattr(wave, f.name).to(self.device)
            for f in dataclasses.fields(wave)}))
        self.pushed_total += 1
        return True

    def pop_window(self):
        """Drain every staged wave as one concatenated stream (None
        when the ring is empty)."""
        waves, self._waves = self._waves, []
        if not waves:
            return None
        return concat_stream_waves(waves)
