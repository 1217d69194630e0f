"""Priority preemption: make room for a pod no feasible node can hold.

The PyTorch package's copy of ``kubernetesnetawarescheduler_tpu/core/
preempt.py``.  The planner reads only the :class:`~.encode.Encoder`'s
numpy staging and ledger, which the port keeps as they are, so the
module is the reference's host code unchanged: the same victims and
target node on the same encoder state.

The reference has no notion of priority or preemption (its scoring
ignores the pod entirely, scheduler/scheduler.go:248); stock
kube-scheduler's preemption is the capability users expect from a
scheduler at this position, so the framework provides the same shape:
when a pod is unschedulable, find the node where evicting the
cheapest set of strictly-lower-priority pods frees enough capacity,
evict them, and requeue the pod.

The planner is host-side and ledger-driven: the usage ledger
(:class:`~.encode.CommitRecord`) already knows, per bound pod, its
node, request vector and priority — exactly the victim-candidate
table.  Node-level static feasibility (taints/selector/validity) is
checked against the encoder's host mirrors, mirroring the device
kernel's mask (core/score.py feasibility_mask) so a plan is never made
for a node the scorer would reject anyway.

Semantics notes (documented deltas vs kube-scheduler):
- victims are chosen lowest-priority-first until the pod fits; the
  node is chosen to minimize (highest victim priority, victim count) —
  kube-scheduler's primary tie-breakers;
- PodDisruptionBudgets come from TWO surfaces, strictest wins: real
  ``policy/v1`` PDB objects (watched from the API server, selectors
  canonicalized to label-driven selector-groups — Encoder.set_pdb)
  and the annotation (``netaware.io/pdb-min-available`` on the
  members of a ``group``).  The planner never disrupts a protected
  group below its bound, a pod matching several protected selectors
  consumes each one's budget, and a groupless pod with the annotation
  is outright unevictable.  Percentage bounds resolve against live
  member counts (kube uses the controller's expected scale — a
  documented delta);
- gangs (core/gang.py) are evicted all-or-nothing, mirroring how they
  are placed: a gang with any member at >= the preemptor's priority
  contributes NO victim candidates, and choosing any member of an
  evictable gang expands the plan to every live co-member (on any
  node) so no partially-placed gang survives a preemption;
- eviction is graceful (``cfg.preemption_grace_s`` becomes
  DeleteOptions.gracePeriodSeconds) and the preemptor is requeued only
  after every victim's deletion is CONFIRMED through the watch (or
  ``cfg.preemption_wait_s`` expires), holding a capacity reservation
  on the target node in the interim (nominatedNodeName semantics —
  Encoder.nominate) so the freed space is not stolen.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.core.encode import (
    Encoder,
    _requests_vector,
    int_to_words,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod


@dataclasses.dataclass(frozen=True)
class Victim:
    uid: str
    namespace: str
    name: str
    priority: float
    node: str


@dataclasses.dataclass(frozen=True)
class PreemptionPlan:
    pod_name: str
    node_name: str
    victims: tuple[Victim, ...]


def _refs_after(refs_row: np.ndarray, evicted_bits: list[int]) -> int:
    """Resident bit set remaining once the given members leave: bits
    whose refcount survives the subtraction.  Phantom refs (checkpoint
    restores without ledger members) keep their bit — conservative,
    matching Encoder._release_record semantics."""
    counts = refs_row.astype(np.int64).copy()
    for bits in evicted_bits:
        while bits:
            b = bits & -bits
            pos = b.bit_length() - 1
            if counts[pos] > 0:
                counts[pos] -= 1
            bits ^= b
    out = 0
    for pos in np.nonzero(counts > 0)[0]:
        out |= 1 << int(pos)
    return out


def _ns_ok_nodes(labels: np.ndarray, ns_any: np.ndarray,
                 ns_forb: np.ndarray, ns_used: np.ndarray,
                 node_numeric: np.ndarray | None = None,
                 ns_ncol: np.ndarray | None = None,
                 ns_nlo: np.ndarray | None = None,
                 ns_nhi: np.ndarray | None = None) -> np.ndarray:
    """Host mirror of the kernel's hard-nodeAffinity mask
    (score.ns_affinity_ok), ``bool[N]`` over label-bit rows — same
    bit rows the device sees, so the plan can never target a node the
    scoring kernel still rejects on matchExpressions (numeric Gt/Lt
    included; NaN fails, like the kernel)."""
    if not ns_used.any():
        return np.ones(labels.shape[0], bool)
    expr_unused = (ns_any == 0).all(axis=-1)                   # [T2, E]
    hit = ((labels[:, None, None, :] & ns_any[None]) != 0).any(axis=-1)
    expr_ok = expr_unused[None] | hit                          # [N, T2, E]
    clean = ((labels[:, None, :] & ns_forb[None]) == 0).all(axis=-1)
    term_ok = expr_ok.all(axis=2) & clean & ns_used[None]      # [N, T2]
    if ns_ncol is not None and (ns_ncol >= 0).any():
        vals = node_numeric[:, np.clip(ns_ncol, 0, None)]  # [N, T2, NE]
        with np.errstate(invalid="ignore"):
            in_range = (vals > ns_nlo[None]) & (vals < ns_nhi[None])
        term_ok &= ((ns_ncol[None] < 0) | in_range).all(axis=2)
    return term_ok.any(axis=1)


def plan_preemption(encoder: Encoder, pod: Pod) -> PreemptionPlan | None:
    """Find the cheapest eviction set that makes ``pod`` fit somewhere.

    Mirrors the scoring kernel's FULL feasibility mask (not just
    capacity): a plan is only made for a node where, after the chosen
    victims leave, taints/selector/affinity/anti-affinity (both
    directions) all pass — so real workloads are never evicted from a
    node the kernel would still reject.
    Anti-affinity conflicts make their resident pods *mandatory*
    victims; an un-internable selector keeps the node infeasible
    (UNKNOWN sentinel, same as the kernel's lenient encode).

    Returns None when no node can host the pod even after evicting
    every strictly-lower-priority pod (the scoring kernel's own
    verdict of "unschedulable" then stands).
    """
    cfg = encoder.cfg
    w = cfg.mask_words
    req = _requests_vector(pod.requests, cfg.num_resources)
    prio = float(pod.priority)

    with encoder._lock:
        n_real = len(encoder._node_names)
        if n_real == 0:
            return None
        valid = encoder._node_valid[:n_real].copy()
        cap = encoder._cap[:n_real].copy()
        # Reservations count as used (the scoring snapshot does the
        # same): a second preemptor must not plan onto capacity an
        # earlier preemptor's nomination already holds.
        used = (encoder._used[:n_real] + encoder._reserved[:n_real])
        group_refs = encoder._group_refs[:n_real].copy()
        anti_refs = encoder._anti_refs[:n_real].copy()
        terminating = set(encoder._terminating)
        # Same interning (and overflow directions) as the kernel's
        # lenient encode — _constraint_bits is the single source of
        # truth; it also backfills lazily-interned selector labels,
        # so the label/taint snapshots are taken AFTER it runs.
        tol_i, sel_i, aff_i, anti_i, gbit_i = \
            encoder._constraint_bits(pod, lenient=True)
        # Hard nodeAffinity matchExpressions: encoded through the SAME
        # _ns_rows the kernel encode uses (interning + lazy backfill),
        # so the label snapshot below already carries any bits this
        # pod's terms just interned.
        ns_any = np.zeros((cfg.max_ns_terms, cfg.max_ns_exprs, w),
                          np.uint32)
        ns_forb = np.zeros((cfg.max_ns_terms, w), np.uint32)
        ns_used = np.zeros((cfg.max_ns_terms,), bool)
        ns_ncol = np.full((cfg.max_ns_terms, cfg.max_ns_num), -1,
                          np.int32)
        ns_nlo = np.full((cfg.max_ns_terms, cfg.max_ns_num), -np.inf,
                         np.float32)
        ns_nhi = np.full((cfg.max_ns_terms, cfg.max_ns_num), np.inf,
                         np.float32)
        encoder._ns_rows(pod, ns_any, ns_forb, ns_used, ns_ncol,
                         ns_nlo, ns_nhi, lenient=True, record=False)
        zaff_i, zanti_i = encoder._zone_bits(pod, lenient=True,
                                             record=False)
        gz_full = encoder._gz_counts.copy()
        az_refs = encoder._az_anti_refs.copy()
        taints = encoder._taint_bits[:n_real].copy()
        labels = encoder._label_bits[:n_real].copy()
        ns_ok = _ns_ok_nodes(labels, ns_any, ns_forb, ns_used,
                             encoder._node_numeric[:n_real],
                             ns_ncol, ns_nlo, ns_nhi)
        # Topology spread (hard mode only — soft never blocks): the
        # preemptor's zone-count row and the zone map, so a plan is
        # never made for a node the spread filter would still mask
        # after the victims leave.
        node_zone = encoder._node_zone[:n_real].copy()
        gslot = gbit_i.bit_length() - 1 if gbit_i else -1
        spread_skew = int(getattr(pod, "spread_maxskew", 0))
        spread_gate = (spread_skew > 0 and gslot >= 0
                       and bool(getattr(pod, "spread_hard", True)))
        counts0 = (encoder._gz_counts[gslot].copy() if spread_gate
                   else None)
        # Eligible domains for the spread min (Honor policy, matching
        # score.spread_terms): zones holding >= 1 valid node that
        # passes the POD's taints/selector — loop-invariant, computed
        # once (not per candidate node).
        elig_zones: list[int] = []
        if spread_gate:
            tol_w = int_to_words(tol_i, w)
            sel_w = int_to_words(sel_i, w)
            tol_ok = ((taints & ~tol_w) == 0).all(axis=1)
            sel_ok = ((labels & sel_w) == sel_w).all(axis=1)
            elig_nodes = (valid & tol_ok & sel_ok & ns_ok
                          & (node_zone >= 0))
            elig_zones = sorted({int(z) for z in node_zone[elig_nodes]})
        # Victim candidates per node: strictly lower priority only.
        # Disruption accounting is per group bit-SLOT over FULL
        # membership masks (a pod matching two protected selectors
        # consumes both budgets, kube semantics).  Two protection
        # surfaces merge, strictest wins: the annotation
        # (``netaware.io/pdb-min-available`` on members of a group)
        # and REAL policy/v1 PodDisruptionBudget objects
        # (Encoder.set_pdb — selector-group member counting).  A
        # groupless pod with the annotation is simply not a candidate
        # (it protects itself).
        # Gang all-or-nothing holds for eviction too (core/gang.py): a
        # bound gang is evictable only as a UNIT.  Pre-pass: collect
        # live members per gang key and decide evictability — every
        # member must be strictly lower priority than the preemptor
        # and not self-protecting, else evicting any subset would
        # leave a partially-placed gang, the exact state gang
        # scheduling exists to prevent.  Members of a non-evictable
        # gang are simply not victim candidates.
        gang_members_all: dict[str, list[tuple[str, object]]] = {}
        for uid, rec in encoder._committed.items():
            if rec.gang_key and uid not in terminating:
                gang_members_all.setdefault(rec.gang_key, []).append(
                    (uid, rec))
        gang_evictable = {
            key: all(r.priority < prio
                     and not (r.pdb_min and not r.group_bit)
                     for _, r in mem)
            for key, mem in gang_members_all.items()}
        victims_by_node: dict[int, list] = {}
        members_by_slot: dict[int, int] = {}
        ann_min_by_slot: dict[int, int] = {}
        for uid, rec in encoder._committed.items():
            if uid in terminating:
                # Graceful deletion in flight: not live for PDB
                # accounting, not evictable again (re-deleting a
                # terminating pod frees nothing).
                continue
            m = rec.member_bits or rec.group_bit
            while m:
                b = m & -m
                m ^= b
                s = b.bit_length() - 1
                members_by_slot[s] = members_by_slot.get(s, 0) + 1
            if rec.pdb_min and rec.group_bit:
                s = rec.group_bit.bit_length() - 1
                ann_min_by_slot[s] = max(ann_min_by_slot.get(s, 0),
                                         rec.pdb_min)
            if rec.priority < prio and rec.node < n_real:
                if rec.pdb_min and not rec.group_bit:
                    continue  # self-protecting singleton
                if rec.gang_key and not gang_evictable.get(
                        rec.gang_key, True):
                    continue  # gang holds a non-evictable member
                victims_by_node.setdefault(rec.node, []).append((uid, rec))
        # Allowed disruptions per protected slot (never negative: an
        # already-underprovisioned group cannot be disrupted at all).
        # Percentages resolve against live members — ceil for
        # minAvailable, floor for maxUnavailable, both conservative.
        group_budget: dict[int, int] = {}

        def _bound(slot: int, allowed: float) -> None:
            allowed = max(int(allowed), 0)
            group_budget[slot] = min(
                group_budget.get(slot, allowed), allowed)

        for s, mn in ann_min_by_slot.items():
            _bound(s, members_by_slot.get(s, 0) - mn)
        for pdb in encoder._pdbs.values():
            if not pdb.selector_key:
                continue
            bit = encoder.groups.bit(pdb.selector_key, lenient=True)
            if not bit:
                # Interner exhausted: bound untrackable, the PDB
                # degrades OPEN.  Not silent — Encoder.set_pdb already
                # emitted a ConstraintDegraded event naming this PDB
                # when the registration failed.
                continue
            s = bit.bit_length() - 1
            members = members_by_slot.get(s, 0)
            if pdb.min_available is not None:
                _bound(s, members - int(pdb.min_available))
            if pdb.min_available_pct is not None:
                _bound(s, members - math.ceil(
                    members * pdb.min_available_pct / 100.0))
            if pdb.max_unavailable is not None:
                _bound(s, int(pdb.max_unavailable))
            if pdb.max_unavailable_pct is not None:
                _bound(s, math.floor(
                    members * pdb.max_unavailable_pct / 100.0))
        node_names = list(encoder._node_names)

    tol_w = int_to_words(tol_i, w)
    sel_w = int_to_words(sel_i, w)
    static_ok = (valid
                 & np.all((taints & ~tol_w) == 0, axis=-1)
                 & np.all((labels & sel_w) == sel_w, axis=-1)
                 & ns_ok)

    best: tuple[float, int, int] | None = None  # (max_vprio, count, node)
    best_set: list[Victim] = []
    best_gangs: list[str] = []
    for node in range(n_real):
        if not static_ok[node]:
            continue
        cands = victims_by_node.get(node, [])
        free = cap[node] - used[node]

        # Per-plan PDB budget: evicting a pod consumes one allowed
        # disruption of EVERY protected group it is a member of.
        budget = dict(group_budget)

        def _prot_slots(rec) -> list[int]:
            m = rec.member_bits or rec.group_bit
            out = []
            while m:
                b = m & -m
                m ^= b
                s = b.bit_length() - 1
                if s in budget:
                    out.append(s)
            return out

        def takeable(rec) -> bool:
            return all(budget[s] > 0 for s in _prot_slots(rec))

        def take(rec) -> None:
            for s in _prot_slots(rec):
                budget[s] -= 1

        # Mandatory victims: residents whose group conflicts with the
        # pod's anti-affinity, or who declared anti-affinity against
        # the pod's group (the symmetric direction) — at host scope
        # AND zone scope (a zone-conflicting resident ON THIS NODE is
        # evictable; only cross-node zone residents force the skip in
        # the zone post-check below).  Only committed (ledgered,
        # strictly-lower-priority) pods are evictable; a PDB-protected
        # mandatory victim makes the node infeasible.
        mandatory: list[tuple[str, object]] = []
        # Zone terms only bind on zoned nodes (a zone-less node is its
        # own empty domain — the kernel enforces nothing there, so
        # evicting for a zone conflict would be a wasted eviction).
        zanti_here = zanti_i if node_zone[node] >= 0 else 0
        if anti_i or gbit_i or zanti_here:
            mandatory = [
                (uid, rec) for uid, rec in cands
                if (rec.group_bit & (anti_i | zanti_here))
                or ((rec.anti_bits
                     | (rec.zanti_bits if node_zone[node] >= 0 else 0))
                    & gbit_i)]
        ok_budget = True
        for _, rec in mandatory:
            if not takeable(rec):
                ok_budget = False
                break
            take(rec)
        if not ok_budget:
            continue

        chosen_recs = list(mandatory)
        chosen_uids = {uid for uid, _ in chosen_recs}

        # After the mandatory set leaves, do the conflict bits clear?
        # (A higher-priority member or a phantom ref keeps the bit —
        # node infeasible.)
        rem_group = _refs_after(
            group_refs[node], [rec.group_bit for _, rec in chosen_recs])
        rem_anti = _refs_after(
            anti_refs[node], [rec.anti_bits for _, rec in chosen_recs])
        if (rem_group & anti_i) or (rem_anti & gbit_i):
            continue

        # Capacity: free + chosen victims' requests; extend
        # lowest-priority-first until the pod fits.
        acc = free + sum((rec.req for _, rec in chosen_recs),
                         np.zeros_like(free))
        if not np.all(req <= acc + 1e-9):
            extras = sorted(
                (e for e in cands if e[0] not in chosen_uids),
                key=lambda e: (e[1].priority, e[1].stamp))
            for uid, rec in extras:
                if np.all(req <= acc + 1e-9):
                    break
                if not takeable(rec):
                    continue  # PDB budget exhausted for its group
                take(rec)
                acc = acc + rec.req
                chosen_recs.append((uid, rec))
                chosen_uids.add(uid)
            if not np.all(req <= acc + 1e-9):
                continue
        elif not chosen_recs:
            # Statically fits with free capacity and no conflicting
            # residents, yet the kernel said unschedulable — the block
            # is something eviction cannot lift (unsatisfied affinity,
            # in-batch contention).  Skip.
            continue

        # Required pod affinity must still hold after ALL evictions
        # (capacity victims may carry the last member of a required
        # group off the node).
        if aff_i:
            rem_group = _refs_after(
                group_refs[node],
                [rec.group_bit for _, rec in chosen_recs])
            if not (rem_group & aff_i):
                continue

        # Zone-scoped (anti-)affinity, CONSERVATIVE: victims are only
        # ever chosen on the candidate node, so a zone conflict held
        # up by residents on OTHER nodes of the zone makes the node
        # infeasible (no cross-node victim hunting).  Checks mirror
        # score.zone_affinity_ok, evaluated on post-eviction counts.
        if zaff_i or zanti_i or gbit_i:
            z = int(node_zone[node])
            if z < 0:
                if zaff_i:
                    continue  # empty domain: required zaff unsatisfiable
            else:
                def _cnt_after(slot: int) -> int:
                    c = int(gz_full[slot, z])
                    c -= sum(1 for _, rec in chosen_recs
                             if rec.group_slot == slot and rec.zone == z)
                    return max(0, c)

                def _slots(bits: int):
                    while bits:
                        b = bits & -bits
                        yield b.bit_length() - 1
                        bits ^= b

                if zaff_i and not any(_cnt_after(s) > 0
                                      for s in _slots(zaff_i)):
                    continue
                if zanti_i and any(_cnt_after(s) > 0
                                   for s in _slots(zanti_i)):
                    continue
                if gbit_i:
                    rem_az = _refs_after(
                        az_refs[z],
                        [rec.zanti_bits for _, rec in chosen_recs
                         if rec.zone == z])
                    if rem_az & gbit_i:
                        continue

        # Hard topology spread must pass AFTER the chosen set leaves
        # (victims of the preemptor's own group lower their recorded
        # zone's count); otherwise the eviction would be wasted on a
        # node the spread filter still masks.  Unknown-zone nodes
        # degrade open, matching score.spread_terms.
        if spread_gate and node_zone[node] >= 0:
            counts = counts0.copy()
            for _, rec in chosen_recs:
                if rec.group_slot == gslot and rec.zone >= 0:
                    counts[rec.zone] = max(0, counts[rec.zone] - 1)
            min_c = (min(int(counts[z]) for z in elig_zones)
                     if elig_zones else 0)
            if int(counts[node_zone[node]]) + 1 - min_c > spread_skew:
                continue

        chosen = [Victim(uid, rec.namespace, rec.name, rec.priority,
                         node_names[node]) for uid, rec in chosen_recs]
        key = (max((v.priority for v in chosen), default=-np.inf),
               len(chosen), node)
        if best is None or key < best:
            best = key
            best_set = chosen
            best_gangs = sorted({rec.gang_key for _, rec in chosen_recs
                                 if rec.gang_key})
    if best is None:
        return None
    # Preempting one gang member releases the WHOLE gang: expand the
    # winning set with every live co-member (wherever it is bound) so
    # the survivors don't linger as a partially-placed gang burning
    # capacity without their peers.  Co-members re-arrive through the
    # informer and re-gate as a fresh gang.  The plan key above counts
    # only node-local victims — a documented approximation: gang
    # expansion is a consequence of the choice, not a cost the
    # node-ranking trades off.
    victims = list(best_set)
    have = {v.uid for v in victims}
    for gkey in best_gangs:
        for uid, rec in gang_members_all.get(gkey, []):
            if uid not in have and rec.node < n_real:
                have.add(uid)
                victims.append(Victim(uid, rec.namespace, rec.name,
                                      rec.priority,
                                      node_names[rec.node]))
    return PreemptionPlan(pod.name, node_names[best[2]],
                          tuple(victims))


def execute_preemption(client, encoder: Encoder,
                       plan: PreemptionPlan,
                       grace_seconds: int | None = None
                       ) -> Sequence[Victim]:
    """Delete the plan's victims through the API server (graceful:
    ``grace_seconds`` becomes DeleteOptions.gracePeriodSeconds).

    Usage release is NOT done here: the deletion fans out through the
    client's pod-deleted signal (watch DELETED / FakeCluster handler),
    which routes into the ledger exactly once — the same path every
    other deletion takes.  The loop holds the preemptor until those
    confirmations land (see SchedulerLoop._try_preempt).  Returns the
    victims actually deleted."""
    return evict_as_unit(client, encoder, plan.victims,
                         grace_seconds=grace_seconds)


def evict_as_unit(client, encoder: Encoder,
                  victims: Sequence[Victim],
                  grace_seconds: int | None = None
                  ) -> Sequence[Victim]:
    """Evict a set of pods as one unit — the shared eviction primitive
    of preemption (victim sets) and the rebalancer (live-migration
    member sets, core/rebalance.py).  Best-effort per pod; callers
    that need all-or-nothing compare ``len(returned)`` against
    ``len(victims)`` and compensate (the rebalancer reverts the move
    and re-adds the already-deleted members)."""
    done = []
    for v in victims:
        try:
            client.delete_pod(v.name, namespace=v.namespace,
                              grace_seconds=grace_seconds)
            # Planner-side bookkeeping: this pod is no longer live
            # (PDB accounting) nor re-evictable while it terminates.
            encoder.mark_terminating(v.uid)
            done.append(v)
        except Exception:  # noqa: BLE001 — best-effort per pod
            continue
    return done
