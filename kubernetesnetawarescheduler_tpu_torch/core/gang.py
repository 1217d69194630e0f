r"""Gang scheduling: all-or-nothing, network-topology-aware placement
of pod groups.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/core/gang.py``.
Pods placed one at a time deadlock multi-host slice jobs: a 16-pod job
that gets 8 members placed hoards capacity forever while the other 8
wait for nodes the first 8 are blocking.  Gang scheduling treats the JOB
as the placement unit:

- Pods annotated with a pod-group (name + minMember + optional timeout)
  are GATED in :class:`GangRegistry` instead of scheduled — they leave
  the pending queue but bind nothing until every member has arrived.
- A complete gang is scored JOINTLY: a first pass places members with
  the normal batched assigner, a second pass re-scores every member row
  with a co-placement bias derived from the ``C[N, N]`` pairwise
  net-desirability matrix (:func:`gang_bias` — mean C column over the
  tentative member nodes, a column gather), and whichever pass wins the
  group objective (:func:`intra_gang_pair_score` — members placed first,
  pairwise desirability second) is committed.
- The commit is ATOMIC: assume-all (encoder usage committed up front)
  then bind-all through :meth:`ClusterClient.bind_gang`; ANY member
  failure rolls back EVERY member.

State machine:

    Pending -> Gated -> Assumed -> Bound
                  \         \-> RolledBack (-> Gated on retry)
                   \-> TimedOut (members requeued)

The registry is plain-Python bookkeeping on the scheduler loop's cycle
thread (plus watch-thread ``pod_gone`` calls, hence the lock); the
device work is the scoring helpers, torch expressions on the state's
tensors.  The second pass re-enters the assigner through its
``{"raw", "ok"}`` static seam (``core/assign.py::_static_parts``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod

# Gang phases (strings, not an Enum: they travel through JSON in the
# extender's /gangs response and the checkpoint meta unchanged).
PENDING = "Pending"          # first member seen, below minMember
GATED = "Gated"              # complete, waiting for a scheduling cycle
ASSUMED = "Assumed"          # usage committed, binds in flight
BOUND = "Bound"              # every member bound
ROLLED_BACK = "RolledBack"   # a member failed; every commit reversed
TIMED_OUT = "TimedOut"       # minMember never arrived in time


def gang_key_of(pod: Pod) -> str:
    """Canonical gang identity, ``namespace/pod-group`` — or "" for
    pods that schedule independently (no group, or minMember <= 1:
    a gang of one is just a pod)."""
    group = getattr(pod, "pod_group", "") or ""
    if not group:
        return ""
    if int(getattr(pod, "gang_min_member", 0) or 0) <= 1:
        return ""
    return f"{getattr(pod, 'namespace', 'default') or 'default'}/{group}"


@dataclasses.dataclass
class Gang:
    """One pod group's gate state."""

    key: str
    min_member: int
    deadline: float                 # monotonic; gate expiry
    members: dict[str, Pod] = dataclasses.field(default_factory=dict)
    phase: str = PENDING
    created: float = 0.0            # monotonic; first member arrival

    @property
    def complete(self) -> bool:
        return len(self.members) >= self.min_member


class GangRegistry:
    """Aggregates annotated pods into gangs and gates them until the
    whole group is admissible.

    Threading: ``admit``/``flush_timeouts`` run on the scheduling cycle
    thread; ``pod_gone`` arrives from the watch thread — all structural
    access holds ``_lock``.  Phase history for released gangs is kept
    (bounded) so phase queries about gangs that already resolved still
    answer.
    """

    _HISTORY_MAX = 1024

    def __init__(self, cfg: SchedulerConfig,
                 now=time.monotonic) -> None:
        self.cfg = cfg
        self._now = now
        self._gangs: dict[str, Gang] = {}
        self._phase_history: dict[str, str] = {}
        self._lock = threading.Lock()
        self.admitted = 0        # gangs that reached minMember
        self.bound = 0           # gangs fully bound
        self.rolled_back = 0     # gangs rolled back after a failure
        self.timed_out = 0       # gangs whose gate expired

    # -- gating ---------------------------------------------------------

    def admit(self, pod: Pod) -> list[Pod] | None:
        """Gate one annotated pod.  Returns the full member list when
        this pod COMPLETES its gang (the gang leaves the gate and the
        caller owns scheduling it), else None (pod absorbed)."""
        key = gang_key_of(pod)
        if not key:
            raise ValueError(f"pod {pod.name} carries no gang key")
        with self._lock:
            gang = self._gangs.get(key)
            if gang is None:
                timeout = (float(getattr(pod, "gang_timeout_s", 0.0)
                                 or 0.0)
                           or self.cfg.gang_timeout_s)
                now = self._now()
                gang = Gang(key=key,
                            min_member=int(pod.gang_min_member),
                            deadline=now + timeout, created=now)
                self._gangs[key] = gang
            # minMember may legitimately differ across members during
            # a rolling spec update; the LARGEST seen wins (gating on
            # the smaller could bind a subset of the new size).
            gang.min_member = max(gang.min_member,
                                  int(pod.gang_min_member))
            gang.members[pod.uid] = pod
            if not gang.complete:
                self._phase_history.pop(key, None)
                return None
            del self._gangs[key]
            gang.phase = GATED
            self._record_phase(key, GATED)
            self.admitted += 1
            return list(gang.members.values())

    def flush_timeouts(self) -> list[tuple[str, list[Pod]]]:
        """Expire incomplete gangs whose gate deadline passed.
        Returns ``(key, members)`` per expired gang; the caller emits
        FailedScheduling events and requeues the members."""
        now = self._now()
        expired: list[tuple[str, list[Pod]]] = []
        with self._lock:
            for key, gang in list(self._gangs.items()):
                if now >= gang.deadline:
                    del self._gangs[key]
                    self._record_phase(key, TIMED_OUT)
                    self.timed_out += 1
                    expired.append((key, list(gang.members.values())))
        return expired

    def pod_gone(self, pod: Pod) -> None:
        """A gated member was deleted before its gang completed:
        drop it (and the gang entirely when it was the last member)."""
        key = gang_key_of(pod)
        if not key:
            return
        with self._lock:
            gang = self._gangs.get(key)
            if gang is None:
                return
            gang.members.pop(pod.uid, None)
            if not gang.members:
                del self._gangs[key]
                self._phase_history.pop(key, None)

    # -- phase bookkeeping (scheduling-side transitions) ---------------

    def note_assumed(self, key: str) -> None:
        self._record_phase(key, ASSUMED, lock=True)

    def note_bound(self, key: str) -> None:
        with self._lock:
            self._record_phase(key, BOUND)
            self.bound += 1

    def note_rolled_back(self, key: str) -> None:
        with self._lock:
            self._record_phase(key, ROLLED_BACK)
            self.rolled_back += 1

    def _record_phase(self, key: str, phase: str,
                      lock: bool = False) -> None:
        if lock:
            with self._lock:
                self._record_phase(key, phase)
            return
        self._phase_history[key] = phase
        while len(self._phase_history) > self._HISTORY_MAX:
            self._phase_history.pop(next(iter(self._phase_history)))

    def phase_of(self, key: str) -> str:
        """Current phase of a gang by ``namespace/name`` key, or ""
        for a gang this scheduler has never seen."""
        with self._lock:
            gang = self._gangs.get(key)
            if gang is not None:
                return gang.phase
            return self._phase_history.get(key, "")

    def snapshot(self) -> dict:
        """Observability view: gated gangs + counters."""
        with self._lock:
            gated = {
                key: {"members": len(g.members),
                      "min_member": g.min_member,
                      "phase": g.phase,
                      "age_s": round(self._now() - g.created, 3)}
                for key, g in self._gangs.items()
            }
            return {
                "gated": gated,
                "recent": dict(self._phase_history),
                "counters": {"admitted": self.admitted,
                             "bound": self.bound,
                             "rolled_back": self.rolled_back,
                             "timed_out": self.timed_out},
            }


# ---------------------------------------------------------------------------
# Group objective: intra-gang pairwise net desirability via C[N, N].
# ---------------------------------------------------------------------------


def _net_normalizers(state):
    """The max-over-valid-pairs normalizers ``(bw_max, lat_max)`` —
    the SAME span :func:`~.score.net_normalizers` gives the per-pod
    network term, so the gang bias is on its scale."""
    from kubernetesnetawarescheduler_tpu_torch.core.score import (
        net_normalizers,
    )

    return net_normalizers(state.lat, state.bw, state.node_valid)


def _index(state, nodes) -> torch.Tensor:
    return torch.as_tensor(np.asarray(nodes, np.int64),
                           device=state.bw.device)


def _f32(x: float) -> float:
    return float(np.float32(x))


def gang_bias(state, member_nodes: Sequence[int],
              cfg: SchedulerConfig) -> torch.Tensor:
    """Co-placement bias ``f32[N]`` for the joint re-scoring pass:
    ``gang_weight * mean_j C[n, m_j]`` over the gang's tentative
    member nodes ``m_j`` — how net-desirable node ``n`` is as a
    placement for ONE member given where the others currently sit.

    A column gather of the (never materialized) C matrix:
    ``C[:, idx] = w_bw * bw[:, idx]/bw_max - w_lat * lat[:, idx]/
    lat_max`` with the loopback pin (rows equal to a member's node get
    ``w_bw``) — linear in bw/lat, so gathering columns first is exact.
    O(N * M) work and memory."""
    idx = _index(state, member_nodes)
    bw_max, lat_max = _net_normalizers(state)
    w = cfg.weights
    c = (_f32(w.peer_bw) * state.bw[:, idx] / bw_max
         - _f32(w.peer_lat) * state.lat[:, idx] / lat_max)
    n = state.bw.shape[0]
    same = (torch.arange(n, device=idx.device)[:, None] == idx[None, :])
    c = torch.where(same, _f32(w.peer_bw), c)
    c = torch.where(state.node_valid[:, None], c, 0.0)
    return _f32(cfg.gang_weight) * c.mean(dim=1)


def _pair_terms(state, nodes: torch.Tensor, valid: torch.Tensor,
                cfg: SchedulerConfig) -> np.ndarray:
    """``f32[S, M, M]`` on the host: per row of ``nodes i64[S, M]`` the
    ``C`` of every ordered pair of valid members (loopback pin for
    co-placed pairs, self pairs and invalid members 0)."""
    bw_max, lat_max = _net_normalizers(state)
    w = cfg.weights
    idx = nodes.clamp(0, state.bw.shape[0] - 1)
    rows, cols = idx[:, :, None], idx[:, None, :]
    c = (_f32(w.peer_bw) * state.bw[rows, cols] / bw_max
         - _f32(w.peer_lat) * state.lat[rows, cols] / lat_max)
    c = torch.where(rows == cols, _f32(w.peer_bw), c)
    m = nodes.shape[1]
    eye = torch.eye(m, dtype=torch.bool, device=nodes.device)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye
    return torch.where(ok, c, 0.0).cpu().numpy()


def _seq_sum(values, acc=np.float32(0.0)) -> np.float32:
    for v in values:
        acc = np.float32(acc + v)
    return acc


def _lanes_sum(lanes) -> np.float32:
    """LLVM's ``vector.reduce.fadd`` under ``reassoc``: halve the
    vector, add the halves lane by lane, repeat."""
    lanes = list(lanes)
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [np.float32(lanes[i] + lanes[i + h]) for i in range(h)]
    return lanes[0]


def _row_lanes_sum(c: np.ndarray) -> np.float32:
    """One lane per row, each summed in column order, then the lanes
    reduced by :func:`_lanes_sum`."""
    return _lanes_sum(_seq_sum(row) for row in c)


def _column_lanes_sum(c: np.ndarray, tail: bool) -> np.float32:
    """Rows in order over 8 column lanes: lane ``l`` adds the row's
    columns ``l, l + 8, ...`` to the running sum's lane (the running
    sum rides in lane 0), and the lanes are reduced after each row.
    With ``tail``, the last 8 columns skip the lanes and are added one
    by one after them."""
    split = c.shape[1] - 8 if tail else c.shape[1]
    acc = np.float32(0.0)
    for row in c:
        lanes = [np.float32(-0.0)] * 8
        lanes[0] = acc
        for j, v in enumerate(row[:split]):
            lanes[j % 8] = np.float32(lanes[j % 8] + v)
        acc = _seq_sum(row[split:], _lanes_sum(lanes))
    return acc


def _xla_sum(c: np.ndarray, batch: int | None = None) -> np.float32:
    """The sum of one ``f32[M, M]`` in the order XLA:CPU adds it, so the
    gang objective has the JAX package's bits: the two passes of
    :func:`place_gang` often place the same nodes in another member
    order, and that tie goes one way or the other by the last bit.

    ``batch`` is ``None`` for the eager sum of
    :func:`intra_gang_pair_score`; for :func:`realization_scores` it is
    the number of rows its jitted program reduces at once (padded to a
    power of two), which moves LLVM's choice of vectorization.  The
    eager sum vectorizes across rows for ``M`` of 2, 4 or 8 and adds in
    row-major order otherwise.  The jitted one vectorizes across rows
    for ``M`` up to 4, and for 8 when it reduces at most 2 rows;
    otherwise it walks the rows over 8 column lanes, the last 8 columns
    added one by one when it reduces a single row.  These are the
    programs XLA:CPU builds for an x86-64 host with 256-bit vectors;
    ``tests/test_torch_gang.py`` holds them against the JAX package."""
    m = c.shape[0]
    if batch is None:
        if m in (2, 4, 8):
            return _row_lanes_sum(c)
        return _seq_sum(c.reshape(-1))
    if m <= 4 or (m == 8 and batch <= 2):
        return _row_lanes_sum(c)
    return _column_lanes_sum(c, tail=batch == 1)


def intra_gang_pair_score(state, member_nodes: Sequence[int],
                          cfg: SchedulerConfig) -> float:
    """The group objective: ``sum_{i != j} C[n_i, n_j]`` over the
    chosen member nodes — the total pairwise net desirability of the
    gang's placement.  Member pairs sharing a node score the loopback
    pin (``w_bw``); only the self pair ``i == j`` is excluded.
    Unplaced members (index < 0) are skipped.  Returns a host float."""
    nodes = np.asarray(member_nodes, np.int64)
    nodes = nodes[nodes >= 0]
    if len(nodes) < 2:
        return 0.0
    idx = _index(state, nodes)[None, :]
    c = _pair_terms(state, idx, torch.ones_like(idx, dtype=torch.bool), cfg)
    return float(_xla_sum(c[0]))


def mean_intra_gang_bw(bw: np.ndarray,
                       member_nodes: Sequence[int]) -> float:
    """Mean raw pairwise bandwidth over a gang's member placements,
    against a GROUND-TRUTH bandwidth matrix (e.g. the one
    ``build_fake_cluster`` returns).  Same-node member pairs talk over
    loopback, counted as the matrix's best link; unplaced members are
    skipped."""
    nodes = np.asarray(member_nodes, np.int64)
    nodes = nodes[nodes >= 0]
    m = len(nodes)
    if m < 2:
        return 0.0
    sub = np.asarray(bw)[np.ix_(nodes, nodes)].astype(np.float64)
    loop = float(np.max(bw))
    same = nodes[:, None] == nodes[None, :]
    sub = np.where(same, loop, sub)
    off = ~np.eye(m, dtype=bool)
    return float(sub[off].mean())


# ---------------------------------------------------------------------------
# Elastic realizations: a gang may declare a FAMILY of acceptable physical
# shapes instead of one rigid member count.
# ---------------------------------------------------------------------------


def parse_gang_shapes(raw: str) -> tuple:
    """Parse a ``netaware/pod-group-shapes`` annotation into the
    canonical ``((member_count, priority), ...)`` family.

    Grammar: comma-separated ``count[:priority]`` terms, e.g.
    ``"8,4:0.5,2:0.2"`` — place all 8 members if feasible, else 4 at
    half desirability, else 2.  Priority defaults to 1.0 and must land
    in (0, 1]; counts must be positive integers.  Malformed input
    degrades to ``()`` (the rigid gang) — never an exception on the
    watch path."""
    if not raw or not isinstance(raw, str):
        return ()
    out: dict[int, float] = {}
    try:
        for term in raw.split(","):
            term = term.strip()
            if not term:
                continue
            if ":" in term:
                cs, ps = term.split(":", 1)
                count, prio = int(cs), float(ps)
            else:
                count, prio = int(term), 1.0
            if count < 1 or not (0.0 < prio <= 1.0):
                return ()
            # Duplicate counts keep the HIGHEST declared priority.
            out[count] = max(out.get(count, 0.0), prio)
    except (ValueError, TypeError):
        return ()
    return tuple(sorted(out.items(), key=lambda kv: (-kv[0], kv[1])))


def gang_shapes_of(members: Sequence[Pod]) -> tuple:
    """The gang-level realization family: the union of every member's
    declared shapes (highest priority wins per count), clipped to the
    arrived member count, with the FULL shape always present at
    priority 1.0.  Returns ``((count, priority), ...)`` sorted by
    count descending."""
    n = len(members)
    fam: dict[int, float] = {n: 1.0}
    for pod in members:
        for count, prio in getattr(pod, "gang_shapes", ()) or ():
            count = int(count)
            if 1 <= count <= n and count != n:
                fam[count] = max(fam.get(count, 0.0), float(prio))
    return tuple(sorted(fam.items(), key=lambda kv: (-kv[0], kv[1])))


def realization_scores(state, nodes_stack: np.ndarray,
                       valid_stack: np.ndarray,
                       cfg: SchedulerConfig) -> np.ndarray:
    """Score S candidate realizations in one batched expression.

    ``nodes_stack`` is ``i32[S, M]`` member node indices (padded with
    -1), ``valid_stack`` ``bool[S, M]`` marking live members.  Returns
    ``f64[S]`` — each row's :func:`intra_gang_pair_score` (the same
    math: pairwise C over valid members, loopback pin for co-placed
    pairs, self-pairs excluded), so per-shape and cross-shape
    comparisons share one scale.  The JAX package pads M to a power of
    two (at least 2) to bound its retraces; padded members are invalid
    and add nothing, but the width sets XLA's order of addition, so the
    port pads M the same way and sums each row as :func:`_xla_sum`
    does."""
    dev = state.bw.device
    s, m = np.asarray(nodes_stack).shape
    mp = 1 << max(1, (m - 1).bit_length())
    nodes = np.full((s, mp), -1, np.int64)
    valid = np.zeros((s, mp), bool)
    nodes[:, :m] = nodes_stack
    valid[:, :m] = np.asarray(valid_stack, bool) & (nodes[:, :m] >= 0)
    c = _pair_terms(state, torch.as_tensor(nodes, device=dev),
                    torch.as_tensor(valid, device=dev), cfg)
    sp = 1 << max(0, (s - 1).bit_length())
    return np.array([_xla_sum(row, batch=sp) for row in c], np.float64)


def realization_key(target: int, placed: int, priority: float,
                    score: float) -> tuple:
    """The realized-desirability ordering every shape decision uses:
    feasibility first (all ``target`` members placed), then
    priority-weighted placed count, then the pairwise net score.
    Strict ``>`` between keys is the "strictly improves" bar."""
    return (1 if placed == target else 0,
            float(priority) * placed, float(score))


def _host(assignment: torch.Tensor) -> np.ndarray:
    """The assigner's answer on the host (a device sync)."""
    return assignment.cpu().numpy()


def place_gang_shaped(state, batch, cfg: SchedulerConfig, static,
                      assign_fn, num_members: int, shapes: Sequence):
    """Shape-aware joint placement: run the two-pass C-matrix
    placement once per declared realization (each with the member rows
    beyond that shape's count masked infeasible through the assigner's
    ``{"raw", "ok"}`` static seam), then score ALL candidate
    realizations with one :func:`realization_scores` call and return
    the winner under :func:`realization_key`.

    A realization of count ``k`` places the FIRST ``k`` members of the
    batch.  Returns ``(assignment, chosen_count, info)``: the host
    assignment array for the whole batch, how many members the winning
    realization targets (0 = nothing feasible at any declared shape),
    and a debug dict.  With a single declared shape equal to the full
    member count this reduces EXACTLY to :func:`place_gang`."""
    from kubernetesnetawarescheduler_tpu_torch.core import (
        assign as assign_lib,
    )

    shapes = [(int(c), float(p)) for c, p in shapes
              if 1 <= int(c) <= num_members]
    if not shapes:
        shapes = [(num_members, 1.0)]
    if len(shapes) == 1 and shapes[0][0] == num_members:
        a = place_gang(state, batch, cfg, static, assign_fn,
                       num_members)
        placed = int(np.sum(a[:num_members] >= 0))
        return a, (num_members if placed == num_members else 0), {
            "shapes_scored": 1, "chosen": num_members,
            "priority": shapes[0][1], "rigid": True}

    raw, ok = assign_lib._static_parts(state, batch, cfg, static)
    width = int(ok.shape[0])

    # candidates: (shape_idx, count, priority, assignment)
    candidates: list[tuple[int, int, float, np.ndarray]] = []
    for si, (count, prio) in enumerate(shapes):
        row_mask = torch.zeros((width,), dtype=torch.bool, device=ok.device)
        row_mask[:count] = True
        okm = ok & row_mask[:, None]
        a0 = _host(assign_fn(state, batch, cfg, {"raw": raw, "ok": okm}))
        candidates.append((si, count, prio, a0))
        placed0 = a0[:count]
        if cfg.gang_weight > 0 and np.any(placed0 >= 0):
            bias = gang_bias(state, placed0[placed0 >= 0], cfg)
            st1 = {"raw": raw + bias[None, :].to(raw.dtype), "ok": okm}
            a1 = _host(assign_fn(state, batch, cfg, st1))
            candidates.append((si, count, prio, a1))

    mmax = max(c for _, c, _, _ in candidates)
    nodes_stack = np.full((len(candidates), mmax), -1, np.int32)
    valid_stack = np.zeros((len(candidates), mmax), bool)
    for ci, (_, count, _, a) in enumerate(candidates):
        nodes_stack[ci, :count] = a[:count]
        valid_stack[ci, :count] = True
    scores = realization_scores(state, nodes_stack, valid_stack, cfg)

    best = None
    best_key = None
    for ci, (si, count, prio, a) in enumerate(candidates):
        placed = int(np.sum(a[:count] >= 0))
        key = realization_key(count, placed, prio, float(scores[ci]))
        # Strict >: ties keep the earlier candidate (declaration order,
        # pass 1 before pass 2) — the tie shape place_gang uses.
        if best_key is None or key > best_key:
            best, best_key = (ci, si, count, prio, a, placed), key
    ci, si, count, prio, a, placed = best
    chosen = count if placed == count else 0
    info = {"shapes_scored": len(shapes),
            "candidates": len(candidates), "chosen": chosen,
            "priority": prio, "score": float(scores[ci]),
            "rigid": False}
    return a, chosen, info


def place_gang(state, batch, cfg: SchedulerConfig, static, assign_fn,
               num_members: int):
    """Joint two-pass placement of one gang's member batch.

    Pass 1 places members with the normal assigner.  Pass 2 re-scores
    every member's row with :func:`gang_bias` built from pass 1's
    placements — injected through the assigner's ``{"raw", "ok"}``
    static seam, so conflict resolution (capacity, affinity, spread)
    still runs in full — and re-assigns.  The pass that wins the group
    objective (members placed first, then :func:`intra_gang_pair_score`)
    is returned.

    ``static`` is the caller's batch-invariant prep (may be None);
    ``assign_fn`` is the loop's assigner.  Returns a host ``np.ndarray``
    assignment for the batch (padded entries included; only the first
    ``num_members`` are the gang)."""
    from kubernetesnetawarescheduler_tpu_torch.core import (
        assign as assign_lib,
    )

    a0 = _host(assign_fn(state, batch, cfg, static))
    placed0 = a0[:num_members]
    if cfg.gang_weight <= 0 or not np.any(placed0 >= 0):
        return a0
    raw, ok = assign_lib._static_parts(state, batch, cfg, static)
    bias = gang_bias(state, placed0[placed0 >= 0], cfg)
    biased = {"raw": raw + bias[None, :].to(raw.dtype), "ok": ok}
    a1 = _host(assign_fn(state, batch, cfg, biased))
    placed1 = a1[:num_members]
    key0 = (int(np.sum(placed0 >= 0)),
            intra_gang_pair_score(state, placed0, cfg))
    key1 = (int(np.sum(placed1 >= 0)),
            intra_gang_pair_score(state, placed1, cfg))
    return a1 if key1 > key0 else a0
