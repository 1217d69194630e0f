"""Continuous rebalancing: a budgeted, crash-safe live-migration
descheduler.

The PyTorch package's copy of the JAX package's ``core/rebalance.py``.
Once a pod binds it keeps its node while links degrade underneath it;
the ingest quarantine detects that, and this module acts on it:

- :meth:`Rebalancer.tick` runs at maintain cadence on all four loop
  paths.  It first settles in-flight moves (completion / timeout
  revert), then scans every bound pod ON THE DEVICE: one batched torch
  expression (:func:`_scan`) computes each pod's current-placement net
  score against the best feasible alternative node, reusing
  :func:`core.score.net_desirability` (same normalization, same
  loopback pin the scorer optimized) and the winner tie-break
  contract of :func:`core.score.winner_from_scores` (lowest index of
  the max — candidate targets are bit-identical with what a fresh
  schedule of the pod would pick under the frozen snapshot).
- Candidates pass through hysteresis — minimum relative gain, minimum
  placement age (CommitRecord.stamp), per-pod move cooldown — so a
  healthy cluster stays quiet, plus trigger inputs that make a sick
  one loud: LinkDegraded/LinkQuarantined streaks (serve.py feeds the
  structured ``(src, dst, reason, streak)`` Event payload back in),
  the placement-quality observer's regret over the SLO ceiling (when a
  loop carries one), and node
  drain (current node no longer valid) which bypasses the gain bar
  entirely.
- Execution is bounded by an explicit eviction budget
  (``rebalance_evictions_per_hour`` sliding window +
  ``rebalance_max_moves_per_cycle``) and PDB-style per-group
  disruption limits (CommitRecord.pdb_min live-member floors, the
  same accounting the preemption planner enforces).
- Every move is staged in the encoder's migration ledger
  (``note_migration_inflight``) BEFORE the first eviction and cleared
  only when every member is re-bound.  Checkpoints persist the ledger
  (``migrations_inflight`` in meta, riding the MANIFEST protocol), and
  restore rolls back every staged member — so a crash mid-move lands
  fully-moved or fully-reverted, never a half-evicted gang.

Move mechanics (the API server cannot rebind a bound pod):
a single-pod move = stage ledger -> evict (the deletion fans through
the client's pod-deleted signal, releasing old usage exactly once,
same path as preemption) -> pin the target by committing the pod at
the new node -> re-add the cleared pod; when it re-arrives Pending,
``SchedulerLoop._redirect_committed`` redirects its bind to the
ledger's pinned node — the exact mechanism checkpoint restore already
uses.  A gang moves as a unit: all members staged, all evicted
(preempt's evict-as-a-unit reuse), all re-added; the gang path's
atomic assume-all/bind_gang/rollback seam re-places them jointly
all-or-nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod

__all__ = ["Rebalancer"]

_EPS = 1e-9


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scan(lat, bw, valid, free, chosen, peers, traffic, req,
          w_bw: float, w_lat: float):
    """Device-side improvement scan over the bound-pod batch: one
    batched torch expression on the inputs' device.

    Inputs: staging planes ``lat/bw f32[N, N]``, ``valid bool[N]``,
    ``free f32[N, R]`` (capacity - used); per-pod ``chosen i32[B]``,
    ``peers i32[B, K]`` (-1 = empty), ``traffic f32[B, K]``, ``req
    f32[B, R]``; the score weights.  Returns ``(mine f32[B], best
    f32[B], target i32[B])`` where ``target`` follows the
    winner_from_scores tie-break (-1 = no feasible node at all).

    The net score of every node against a pod's peers is accumulated
    over the peer slots in order 0..K-1 into one ``[B, N]`` buffer, each
    slot a row gather of ``C.T`` (no ``[N, B, K]`` temporary)."""
    from kubernetesnetawarescheduler_tpu_torch.core.score import (
        NEG_INF,
        net_desirability,
        winner_from_scores,
    )

    c = net_desirability(lat, bw, valid, w_bw, w_lat)
    ct = c.T.contiguous()
    m = peers >= 0
    safe = torch.where(m, peers, 0).long()
    w = torch.where(m, traffic, 0.0)
    b, n = chosen.shape[0], ct.shape[0]
    cost = torch.zeros((b, n), dtype=torch.float32, device=ct.device)
    for k in range(peers.shape[1]):
        cost += ct[safe[:, k]] * w[:, k, None]
    rows = torch.arange(b, device=ct.device)
    mine = cost[rows, chosen.long()]
    # A candidate must be valid and fit the pod's request; the CURRENT
    # node is exempt from the fit check (its free already excludes
    # this pod's own usage).
    cols = torch.arange(n, dtype=torch.int32, device=ct.device)
    fits = cols[None, :] == chosen[:, None]
    fit_all = torch.ones((b, n), dtype=torch.bool, device=ct.device)
    for r in range(free.shape[1]):
        fit_all &= free[None, :, r] >= req[:, r, None]
    scores = torch.where(valid[None, :] & (fit_all | fits), cost, NEG_INF)
    best, target = winner_from_scores(scores)
    return mine, best, target


@dataclasses.dataclass
class _Move:
    """One staged live migration (single pod, or a whole gang)."""

    key: str
    gang_key: str                     # "" = single-pod move
    members: list[list]               # [uid, ns, name, from, to] each
    deadline: float                   # monotonic revert deadline
    trigger: str                      # gain | link | regret | drain
    gain: float


@dataclasses.dataclass
class _Reshape:
    """One staged elastic reshape: a gang transitioning between
    declared realizations through the crash-safe reshape ledger."""

    gang_key: str
    members: list[list]               # [uid, ns, name, from, to] each
    old_count: int
    new_count: int
    declared: int                     # full declared member count
    family: tuple                     # ((count, priority), ...)
    deadline: float                   # monotonic revert deadline
    trigger: str                      # shrink | regrow | retile
    gain: float


class Rebalancer:
    """Budgeted descheduler over the encoder's committed ledger.

    Single-threaded by construction: ``tick`` runs on the maintain
    path of whichever loop variant owns the encoder, and the trigger
    feeds (``note_link_event``) only append to a lock-free dict of
    floats — worst case a racing scan reads a slightly stale trigger.
    """

    def __init__(self, cfg: SchedulerConfig, encoder, client) -> None:
        self.cfg = cfg
        self.encoder = encoder
        self.client = client
        self._seq = 0
        self._inflight: dict[str, _Move] = {}
        self._last_move: dict[str, float] = {}      # uid -> monotonic
        self._evictions: collections.deque[float] = collections.deque()
        # Trigger feeds: node name -> (monotonic stamp, reason).
        self._hot_nodes: dict[str, tuple[float, str]] = {}
        self._last_tick = 0.0
        # Counters (exact; selfmetrics/debug/bench read these).
        self.scans_total = 0
        self.candidates_total = 0
        self.moves_total = 0
        self.pods_evicted_total = 0
        self.moves_completed = 0
        self.moves_reverted = 0
        self.half_moved_gangs = 0
        self.pins_skipped = 0
        self.skipped_gain = 0
        self.skipped_age = 0
        self.skipped_cooldown = 0
        self.skipped_budget = 0
        self.skipped_disruption = 0
        self.triggers_link = 0
        self.triggers_regret = 0
        self.triggers_drain = 0
        self.last_scan_pods = 0
        self.last_scan_candidates = 0
        self.last_scan_moves = 0
        # Last scan's wall split, ms: host = staging copy and the pod
        # rows, upload = host-to-device copies, device = the scan.
        self.last_scan_ms: dict[str, float] = {}
        self._pinned: dict[str, torch.Tensor] = {}
        # Elastic reshaping: staged reshapes keyed by gang key
        # (one gang may never be in two concurrent reshapes — the
        # encoder ledger raises) plus their counters.
        self._inflight_reshapes: dict[str, _Reshape] = {}
        self.reshapes_total = 0
        self.reshapes_completed = 0
        self.reshapes_reverted = 0
        self.half_shaped_gangs = 0
        self.reshape_shrinks = 0
        self.reshape_regrows = 0
        self.reshape_retiles = 0
        self.skipped_reshape_gain = 0
        self.skipped_reshape_budget = 0

    # -- trigger feeds ----------------------------------------------

    def note_link_event(self, src: str, dst: str, reason: str,
                        streak: int = 1) -> None:
        """Feed a LinkDegraded/LinkQuarantined Event's structured
        payload back in: pods currently placed on either endpoint get
        trigger priority (and a relaxed gain bar) at the next scan."""
        now = time.monotonic()
        for node in (src, dst):
            if node:
                self._hot_nodes[node] = (now, reason)

    def _node_hot(self, node: str, now: float) -> bool:
        entry = self._hot_nodes.get(node)
        if entry is None:
            return False
        # Trigger heat decays after two scan intervals (a link that
        # stopped degrading stops forcing moves), floored at 30s so a
        # fast-ticking deployment doesn't expire the evidence between
        # the Event arriving and the very next scan.
        ttl = max(2.0 * self.cfg.rebalance_interval_s, 30.0)
        if now - entry[0] > ttl:
            del self._hot_nodes[node]
            return False
        return True

    # -- the maintain-cadence entry point ---------------------------

    def tick(self, loop, now: float | None = None) -> int:
        """Settle in-flight moves, scan, execute.  Returns the number
        of moves EXECUTED this tick (0 on a quiet cluster)."""
        now = time.monotonic() if now is None else now
        if now - self._last_tick < self.cfg.rebalance_interval_s:
            return 0
        self._last_tick = now
        self._settle(now)
        self._settle_reshapes(now)
        moved = 0
        if self.cfg.rebalance_max_moves_per_cycle > 0:
            # Budget 0 is a complete no-op for the move scan (tests
            # pin bit-identical placements): no scan, no device work,
            # no Events.
            moved = self._scan_and_move(loop, now)
        if (getattr(self.cfg, "enable_gang_reshaping", False)
                and getattr(self.cfg, "reshape_max_per_cycle", 0) > 0):
            moved += self._reshape_pass(loop, now)
        return moved

    # -- in-flight settlement ---------------------------------------

    def _settle(self, now: float) -> None:
        """Completion / timeout pass over staged moves.  A move
        completes when every member is bound again (the gang seam
        guarantees all-or-nothing, so mixed states are transient); a
        timed-out move is reverted: unbound members' target pins are
        rolled back so the pods re-place freely, and the ledger entry
        clears either way."""
        enc, client = self.encoder, self.client
        for key, mv in list(self._inflight.items()):
            bound = []
            for uid, _ns, name, _frm, _to in mv.members:
                try:
                    bound.append(bool(client.node_of(name)))
                except KeyError:
                    bound.append(False)
            if all(bound):
                enc.clear_migration_inflight(key)
                del self._inflight[key]
                self.moves_completed += 1
                continue
            if now < mv.deadline:
                continue
            # Timeout revert.  A gang observed part-bound at its
            # deadline is exactly the half-moved state the ledger
            # exists to prevent — count it loudly (the chaos drill
            # asserts this stays 0) and roll the unbound rest back.
            if mv.gang_key and any(bound) and not all(bound):
                self.half_moved_gangs += 1
            unbound = [m[0] for m, b in zip(mv.members, bound)
                       if not b]
            enc.rollback_gang_members(unbound)
            enc.clear_migration_inflight(key)
            del self._inflight[key]
            self.moves_reverted += 1

    # -- scan --------------------------------------------------------

    def _stage(self, name: str, host: np.ndarray,
               dev: torch.device) -> torch.Tensor:
        """A copy of one f32 staging plane on ``dev``.  On a card the
        copy goes through a pinned buffer reused across ticks (the
        previous tick's upload finished at its synchronize) and the
        upload is asynchronous; on the CPU it is a plain copy."""
        if dev.type != "cuda":
            return torch.from_numpy(np.array(host, dtype=np.float32))
        buf = self._pinned.get(name)
        if buf is None or tuple(buf.shape) != host.shape:
            buf = torch.empty(host.shape, dtype=torch.float32,
                              pin_memory=True)
            self._pinned[name] = buf
        buf.numpy()[...] = host
        return buf.to(dev, non_blocking=True)

    def _scan_and_move(self, loop, now: float) -> int:
        enc = self.encoder
        inflight_uids = {m[0] for mv in self._inflight.values()
                         for m in mv.members}
        inflight_uids |= {m[0]
                          for rs in self._inflight_reshapes.values()
                          for m in rs.members}
        pods_all = self.client.list_all_pods() or []
        rows: list[tuple[Pod, Any, int]] = []   # (pod, rec, node_idx)
        with enc._lock:
            committed = dict(enc._committed)
        for pod in pods_all:
            if not pod.node_name or pod.uid in inflight_uids:
                continue
            rec = committed.get(pod.uid)
            if rec is None:
                continue
            idx = enc.node_slot(pod.node_name)
            if idx is None or idx != rec.node:
                continue
            rows.append((pod, rec, int(idx)))
        self.scans_total += 1
        self.last_scan_pods = len(rows)
        self.last_scan_candidates = 0
        self.last_scan_moves = 0
        if not rows:
            return 0

        # The scan reads the STAGING planes (the truth), never the
        # device cache, which state chaos may have corrupted.  On a
        # card they go up through pinned buffers kept across ticks.
        t0 = time.perf_counter()
        dev = enc.device
        with enc._lock:
            lat = self._stage("lat", enc._lat, dev)
            bw = self._stage("bw", enc._bw, dev)
            valid = np.array(enc._node_valid, dtype=bool)
            free = np.maximum(
                enc._cap - enc._used, 0.0).astype(np.float32)

        # The JAX package pads the pod axis to a power of two to bound
        # its retraces; with no trace to bound, this scan does not pad.
        b = len(rows)
        k = self.cfg.max_peers
        r = free.shape[1]
        chosen = np.zeros((b,), np.int32)
        peers = np.full((b, k), -1, np.int32)
        traffic = np.zeros((b, k), np.float32)
        req = np.zeros((b, r), np.float32)
        for i, (pod, rec, idx) in enumerate(rows):
            chosen[i] = idx
            req[i, :] = rec.req
            kk = 0
            for peer_name, weight in pod.peers.items():
                if kk >= k:
                    break
                peer_node = loop._peer_node(peer_name)
                if not peer_node:
                    continue
                pidx = enc.node_slot(peer_node)
                if pidx is None:
                    continue
                peers[i, kk] = int(pidx)
                traffic[i, kk] = float(weight)
                kk += 1
        t1 = time.perf_counter()
        args = [lat, bw] + [torch.from_numpy(x).to(dev) for x in (
            valid, free, chosen, peers, traffic, req)]
        _sync(dev)
        t2 = time.perf_counter()
        mine, best, target = _scan(
            *args, self.cfg.weights.peer_bw, self.cfg.weights.peer_lat)
        _sync(dev)
        t3 = time.perf_counter()
        mine, best, target = (x.cpu().numpy() for x in (mine, best, target))
        self.last_scan_ms = {"upload": (t2 - t1) * 1e3,
                             "device": (t3 - t2) * 1e3,
                             "host": (t1 - t0) * 1e3}

        # -- hysteresis + triggers (host) ---------------------------
        cfg = self.cfg
        candidates = []        # (priority, gain, i, trigger)
        regrets = self._regret_by_uid(loop)
        for i, (pod, rec, idx) in enumerate(rows):
            tgt = int(target[i])
            gain = float(best[i] - mine[i])
            if tgt < 0 or tgt == idx or gain <= 0.0:
                continue
            trigger = ""
            if not valid[idx]:
                trigger = "drain"
            elif self._node_hot(pod.node_name, now):
                trigger = "link"
            elif regrets.get(pod.uid, 0.0) > cfg.slo_regret_ceiling:
                trigger = "regret"
            # Hysteresis discipline: an UNTRIGGERED candidate is pure
            # opportunism (healthy clusters carry structural net
            # regret — the scheduler trades the net term against
            # balance/fit, the quality bench measures it), so it
            # faces every gate.  A candidate with degradation
            # EVIDENCE (link event streak, regret over the SLO
            # ceiling) bypasses the gain and age bars — the trigger
            # is the justification — but still honors the per-pod
            # cooldown; only drain bypasses that too.
            # Relative gain against the score MAGNITUDE (not the
            # current score, which sits near zero for marginal
            # placements and would make any epsilon look huge).
            rel = gain / max(abs(float(best[i])),
                             abs(float(mine[i])), _EPS)
            if not trigger and rel < cfg.rebalance_min_gain:
                self.skipped_gain += 1
                continue
            age = now - rec.stamp
            if not trigger and age < cfg.rebalance_min_age_s:
                self.skipped_age += 1
                continue
            last = self._last_move.get(pod.uid)
            if (trigger != "drain" and last is not None
                    and now - last < cfg.rebalance_cooldown_s):
                self.skipped_cooldown += 1
                continue
            candidates.append((bool(trigger), gain, i,
                               trigger or "gain"))
        self.candidates_total += len(candidates)
        self.last_scan_candidates = len(candidates)
        if not candidates:
            return 0
        candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)

        # -- budgets + execution ------------------------------------
        moves = 0
        group_evicted: dict[Any, int] = {}
        for triggered, gain, i, trigger in candidates:
            if moves >= cfg.rebalance_max_moves_per_cycle:
                self.skipped_budget += 1
                continue
            pod, rec, idx = rows[i]
            members = self._move_members(pod, rec)
            if members is None:
                continue
            n_evict = len(members)
            if not self._eviction_budget_ok(n_evict, now):
                self.skipped_budget += 1
                continue
            charges = self._disruption_charges(members, group_evicted,
                                               committed)
            if charges is None:
                self.skipped_disruption += 1
                continue
            ok = self._execute(loop, pod, rec, members,
                               int(target[i]), gain, trigger, now)
            if ok:
                # Charge PDB headroom only for moves that actually
                # happened — a failed _execute (raced node delete,
                # partial eviction) must not consume the group's
                # budget for later valid candidates this cycle.
                for gk, n in charges.items():
                    group_evicted[gk] = group_evicted.get(gk, 0) + n
                moves += 1
                if trigger == "link":
                    self.triggers_link += 1
                elif trigger == "regret":
                    self.triggers_regret += 1
                elif trigger == "drain":
                    self.triggers_drain += 1
        self.last_scan_moves = moves
        return moves

    def _regret_by_uid(self, loop) -> dict[str, float]:
        quality = getattr(loop, "quality", None)
        if quality is None:
            return {}
        try:
            return {o["pod_uid"]: float(o.get("regret", 0.0))
                    for o in quality.outcomes()}
        except Exception:  # noqa: BLE001 — triggers are advisory
            return {}

    # -- budget gates ------------------------------------------------

    def _eviction_budget_ok(self, n: int, now: float) -> bool:
        budget = self.cfg.rebalance_evictions_per_hour
        if budget <= 0:
            return False
        while self._evictions and now - self._evictions[0] > 3600.0:
            self._evictions.popleft()
        return len(self._evictions) + n <= budget

    def _disruption_charges(self, members: list[tuple[Pod, Any]],
                            group_evicted: dict[Any, int],
                            committed: dict[str, Any]) -> (
            dict[Any, int] | None):
        """PDB-style floor: a group with ``pdb_min`` live members may
        not drop below it, counting every eviction this cycle already
        charged against the group (same accounting the preemption
        planner's group_budget enforces).  Returns the per-group
        charges for the caller to apply AFTER the move executes (a
        failed move must not consume the group's headroom), or None
        when any group would drop below its floor."""
        charges: dict[Any, int] = {}
        for _pod, rec in members:
            gk = rec.gang_key or (rec.group_bit or None)
            if gk is None or rec.pdb_min <= 0:
                continue
            charges[gk] = charges.get(gk, 0) + 1
        for gk, n in charges.items():
            live = sum(
                1 for r in committed.values()
                if (r.gang_key or (r.group_bit or None)) == gk)
            already = group_evicted.get(gk, 0)
            pdb_min = max(r.pdb_min for _p, r in members
                          if (r.gang_key or (r.group_bit or None))
                          == gk)
            if live - already - n < pdb_min:
                return None
        return charges

    # -- move construction / execution ------------------------------

    def _move_members(self, pod: Pod, rec) -> (
            list[tuple[Pod, Any]] | None):
        """Expand a candidate to the unit that must move together: the
        pod alone, or its whole gang (evicting one slice-job member
        strands the rest — the preemption planner's rule)."""
        if not rec.gang_key:
            return [(pod, rec)]
        members = []
        for uid, mrec in self.encoder.gang_members(rec.gang_key):
            mpod = self.client.get_pod(mrec.name)
            if mpod is None or not mpod.node_name:
                return None     # gang mid-churn: not a safe unit now
            members.append((mpod, mrec))
        return members or None

    def _execute(self, loop, pod: Pod, rec,
                 members: list[tuple[Pod, Any]], target_idx: int,
                 gain: float, trigger: str, now: float) -> bool:
        """Stage -> evict -> pin -> re-add.  The ledger entry lands
        BEFORE the first eviction so every crash window restores to
        fully-reverted; it clears in ``_settle`` once every member is
        bound again."""
        from kubernetesnetawarescheduler_tpu_torch.core.preempt import (
            Victim,
            evict_as_unit,
        )

        enc, client = self.encoder, self.client
        single = len(members) == 1 and not rec.gang_key
        try:
            to_node = enc.node_name(target_idx) if single else ""
        except Exception:  # noqa: BLE001 — slot raced a node delete
            return False
        if single and not to_node:
            return False
        self._seq += 1
        key = f"mv{self._seq}-{pod.uid[:8]}"
        entries = [[p.uid, p.namespace, p.name, p.node_name,
                    to_node if single else ""]
                   for p, _r in members]
        enc.note_migration_inflight(key, entries)
        victims = [Victim(uid=p.uid, namespace=p.namespace,
                          name=p.name, priority=r.priority,
                          node=p.node_name) for p, r in members]
        done = evict_as_unit(client, enc, victims)
        if len(done) != len(victims):
            # Partial eviction failure: the deleted members re-add
            # below and re-place freely; nothing stays pinned.  Their
            # deletions were still real disruption, so they count
            # against the sliding budget window and the eviction
            # totals — otherwise repeated partial failures would churn
            # pods invisibly and unboundedly.
            enc.clear_migration_inflight(key)
            self.moves_reverted += 1
            done_uids = {v.uid for v in done}
            for _v in done:
                self._evictions.append(now)
                self.pods_evicted_total += 1
            for p, _r in members:
                if p.uid in done_uids:
                    self._readd(client, p)
            return False
        cleared = [dataclasses.replace(p, node_name="")
                   for p, _r in members]
        if single:
            # Pin the target: the pod re-arrives Pending and
            # _redirect_committed routes its bind to this node (the
            # checkpoint-restore mechanism, reused verbatim).
            # commit_many silently skips uids that are still committed
            # (its duplicate-delivery guard), and with a watch-based
            # client the eviction's DELETED event — which releases the
            # old record — can land AFTER this point.  Only commit
            # once the old record is gone, then VERIFY the pin took;
            # a miss is counted (pins_skipped) rather than hidden, and
            # the move degrades to a bare eviction that reverts at its
            # deadline.
            if enc.committed_node(pod.uid) is None:
                enc.commit_many(cleared, [target_idx])
            if enc.committed_node(pod.uid) != to_node:
                self.pins_skipped += 1
        added = all(self._readd(client, p) for p in cleared)
        if not added:
            # No add_pod surface (live cluster): the eviction IS the
            # move — the workload controller recreates the pod (new
            # uid), the pin can never match, and the entry reverts at
            # its deadline, releasing any pinned usage.
            pass
        self._inflight[key] = _Move(
            key=key, gang_key=rec.gang_key or "", members=entries,
            deadline=now + self.cfg.rebalance_move_timeout_s,
            trigger=trigger, gain=gain)
        for p, _r in members:
            self._last_move[p.uid] = now
            # The sliding-hour window lives entirely on the monotonic
            # clock tick() runs on — mixing in time.time() here would
            # make _eviction_budget_ok's prune comparison (monotonic
            # minus epoch, hugely negative) never fire, silently
            # turning the per-hour budget into a lifetime cap.
            self._evictions.append(now)
            self.pods_evicted_total += 1
        self.moves_total += 1
        return True

    @staticmethod
    def _readd(client, pod: Pod) -> bool:
        add = getattr(client, "add_pod", None)
        if add is None:
            return False
        cleared = (pod if not pod.node_name
                   else dataclasses.replace(pod, node_name=""))
        try:
            add(cleared)
            return True
        except Exception:  # noqa: BLE001 — re-add is best-effort
            return False

    # -- elastic reshaping -------------------------------------------

    def _settle_reshapes(self, now: float) -> None:
        """Completion / timeout pass over staged reshapes.  A reshape
        completes when at least ``new_count`` of the gang's members
        are bound again (the shape-aware gang path may even have
        regrown past the target when capacity returned — record the
        realization it actually committed).  At the deadline, a gang
        resting at SOME declared realization completes at that count
        (shrunk-further is still never-hybrid); a gang resting at a
        count the family never declared is the half-shaped corruption
        the drill pins at zero — counted loudly, unbound members
        rolled back."""
        enc, client = self.encoder, self.client
        for key, rs in list(self._inflight_reshapes.items()):
            bound = []
            for uid, _ns, name, _frm, _to in rs.members:
                try:
                    bound.append(bool(client.node_of(name)))
                except KeyError:
                    bound.append(False)
            n_bound = sum(bound)
            if n_bound >= rs.new_count:
                enc.clear_reshape_inflight(
                    key, committed_count=n_bound,
                    declared_count=rs.declared)
                del self._inflight_reshapes[key]
                self.reshapes_completed += 1
                continue
            if now < rs.deadline:
                continue
            family_counts = {c for c, _p in rs.family}
            if n_bound == 0:
                # Fully reverted: nothing bound; lingering commits
                # (pins the crash window left) roll back and the
                # members re-place freely via resync.
                enc.rollback_gang_members(m[0] for m in rs.members)
                enc.clear_reshape_inflight(key)
                enc.drop_gang_realization(key)
                self.reshapes_reverted += 1
            elif n_bound in family_counts:
                # Landed on a DECLARED (if unintended) realization —
                # still never-hybrid; record what actually committed.
                enc.clear_reshape_inflight(
                    key, committed_count=n_bound,
                    declared_count=rs.declared)
                self.reshapes_reverted += 1
            else:
                # Part-bound at an undeclared count at the deadline:
                # the exact half-shaped state the ledger exists to
                # prevent (the chaos drill asserts this stays 0).
                self.half_shaped_gangs += 1
                unbound = [m[0] for m, b in zip(rs.members, bound)
                           if not b]
                enc.rollback_gang_members(unbound)
                enc.clear_reshape_inflight(key)
                self.reshapes_reverted += 1
            del self._inflight_reshapes[key]

    def _gang_units(self, loop) -> dict[str, dict]:
        """Group the cluster's shaped gangs: gang key -> {"bound":
        [(pod, rec)], "pending": [pod], "family": ((count, prio),...),
        "declared": n}.  Only gangs declaring MORE than the rigid full
        shape are returned — everything else is invisible to the
        reshape pass (the bit-identical-when-undeclared property)."""
        from kubernetesnetawarescheduler_tpu_torch.core.gang import (
            gang_key_of,
            gang_shapes_of,
        )

        enc = self.encoder
        with enc._lock:
            committed = dict(enc._committed)
        units: dict[str, dict] = {}
        pods_all = self.client.list_all_pods() or []
        by_gang: dict[str, list[Pod]] = {}
        for pod in pods_all:
            gk = gang_key_of(pod)
            if gk:
                by_gang.setdefault(gk, []).append(pod)
        for gk, pods in by_gang.items():
            pods = sorted(pods, key=lambda p: p.name)
            bound, pending = [], []
            for pod in pods:
                rec = committed.get(pod.uid)
                if pod.node_name and rec is not None:
                    bound.append((pod, rec))
                elif not pod.node_name:
                    pending.append(pod)
            if not bound:
                continue
            members = [p for p, _r in bound] + pending
            family = gang_shapes_of(members)
            if len(family) < 2:
                continue
            units[gk] = {"bound": bound, "pending": pending,
                         "family": family,
                         "declared": len(members)}
        return units

    def evaluate_reshape(self, loop, gang_key: str, unit: dict,
                         now: float) -> dict | None:
        """Score the gang's current realization against the best
        declared alternative under the FROZEN snapshot.  Returns an
        executable plan dict (new_count/assignment/gain/kind/...)
        only when the alternative STRICTLY improves realized
        desirability (:func:`core.gang.realization_key` ordering,
        with the ``reshape_min_gain`` bar on equal-weight re-tiles),
        else None.  Public so the property suite can pin the
        strictly-improves contract without executing evictions."""
        from kubernetesnetawarescheduler_tpu_torch.core.gang import (
            place_gang_shaped,
            realization_key,
            realization_scores,
        )

        enc = self.encoder
        bound, pending = unit["bound"], unit["pending"]
        family, declared = unit["family"], unit["declared"]
        family_map = dict(family)
        members = [p for p, _r in bound] + pending
        if len(members) > loop.cfg.max_pods:
            return None

        # Current realization, measured over members on VALID nodes
        # only (a zonal outage's stranded members realize nothing).
        with enc._lock:
            valid = np.array(enc._node_valid, dtype=bool)
        cur_idx = []
        for pod, _rec in bound:
            i = enc.node_slot(pod.node_name)
            if i is not None and valid[int(i)]:
                cur_idx.append(int(i))
        cur_target = len(bound)
        cur_prio = family_map.get(
            cur_target, max(cur_target / max(declared, 1), 1e-3))

        # Fresh shape-aware placement of the WHOLE member set under
        # the frozen snapshot (same encode/assign path the gang
        # scheduler uses; members' own usage stays committed, which
        # only under-reports capacity — conservative).
        cleared = [dataclasses.replace(p, node_name="")
                   for p in members]
        batch = loop.encoder.encode_pods(
            cleared, node_of=loop._peer_node, lenient=True)
        state, static_version = loop.encoder.snapshot_versioned()
        static = loop._static_for(state, static_version)
        assign_fn = loop._assign
        assignment, chosen, info = place_gang_shaped(
            state, batch, loop.cfg, static, assign_fn, len(members),
            family)
        if chosen <= 0:
            return None

        # One padded/vmapped dispatch scores BOTH realizations on the
        # same frozen scale.
        mmax = max(len(cur_idx), chosen, 1)
        nodes = np.full((2, mmax), -1, np.int32)
        vmask = np.zeros((2, mmax), bool)
        nodes[0, :len(cur_idx)] = cur_idx
        vmask[0, :len(cur_idx)] = True
        nodes[1, :chosen] = assignment[:chosen]
        vmask[1, :chosen] = True
        scores = realization_scores(state, nodes, vmask, loop.cfg)
        cur_key = realization_key(cur_target, len(cur_idx), cur_prio,
                                  float(scores[0]))
        new_prio = family_map.get(chosen, 1.0)
        new_key = realization_key(chosen, chosen, new_prio,
                                  float(scores[1]))
        if not new_key > cur_key:
            return None
        if new_key[:2] == cur_key[:2]:
            # Same feasibility and priority-weighted width: a pure
            # re-tile must clear the relative gain bar, or a healthy
            # gang would churn on score noise.
            rel = (new_key[2] - cur_key[2]) / max(
                abs(new_key[2]), abs(cur_key[2]), _EPS)
            if rel < getattr(self.cfg, "reshape_min_gain", 0.0):
                self.skipped_reshape_gain += 1
                return None
        kind = ("shrink" if chosen < cur_target
                else "regrow" if chosen > cur_target else "retile")
        return {"gang_key": gang_key, "new_count": chosen,
                "old_count": cur_target, "declared": declared,
                "family": family, "kind": kind,
                "gain": float(new_key[2] - cur_key[2]),
                "cur_key": cur_key, "new_key": new_key}

    def _reshape_pass(self, loop, now: float) -> int:
        """Find degraded shaped gangs and reshape the best candidates
        under the shared eviction budget.  A gang is CONSIDERED when
        it shows degradation evidence (a member node invalid or hot)
        or sits below its declared full shape (regrow opportunity);
        healthy full-shape gangs are only ever re-tiled over the
        reshape_min_gain bar."""
        inflight_uids = {m[0] for mv in self._inflight.values()
                         for m in mv.members}
        executed = 0
        evaluated = 0
        for gk, unit in sorted(self._gang_units(loop).items()):
            if executed >= self.cfg.reshape_max_per_cycle:
                break
            if gk in self._inflight_reshapes:
                continue
            if any(p.uid in inflight_uids for p, _r in unit["bound"]):
                continue
            last = self._last_move.get(gk)
            if (last is not None
                    and now - last < self.cfg.rebalance_cooldown_s):
                continue
            degraded = False
            with self.encoder._lock:
                valid = np.array(self.encoder._node_valid, dtype=bool)
            for pod, _rec in unit["bound"]:
                i = self.encoder.node_slot(pod.node_name)
                if (i is None or not valid[int(i)]
                        or self._node_hot(pod.node_name, now)):
                    degraded = True
                    break
            below_full = len(unit["bound"]) < unit["declared"]
            if not degraded and not below_full:
                continue
            if evaluated >= max(8, 2 * self.cfg.reshape_max_per_cycle):
                break
            evaluated += 1
            plan = self.evaluate_reshape(loop, gk, unit, now)
            if plan is None:
                continue
            n_evict = len(unit["bound"])
            if not self._eviction_budget_ok(n_evict, now):
                self.skipped_reshape_budget += 1
                continue
            if self._execute_reshape(loop, unit, plan, now):
                executed += 1
        return executed

    def _execute_reshape(self, loop, unit: dict, plan: dict,
                         now: float) -> bool:
        """Stage the reshape ledger -> evict every bound member ->
        re-add -> wake parked surplus.  The ledger entry lands BEFORE
        the first eviction, so every crash window restores to
        fully-the-old-shape; the shape-aware gang path re-places the
        re-gated members jointly all-or-nothing at the best feasible
        realization, and ``_settle_reshapes`` records what committed."""
        from kubernetesnetawarescheduler_tpu_torch.core.preempt import (
            Victim,
            evict_as_unit,
        )

        enc, client = self.encoder, self.client
        gk = plan["gang_key"]
        bound = unit["bound"]
        entries = [[p.uid, p.namespace, p.name, p.node_name, ""]
                   for p, _r in bound]
        try:
            enc.note_reshape_inflight(gk, plan["old_count"],
                                      plan["new_count"], entries)
        except ValueError:
            return False        # raced into a concurrent reshape
        victims = [Victim(uid=p.uid, namespace=p.namespace,
                          name=p.name, priority=r.priority,
                          node=p.node_name) for p, r in bound]
        done = evict_as_unit(client, enc, victims)
        if len(done) != len(victims):
            # Partial eviction: revert the staging, re-add what was
            # evicted (they re-place freely), and charge the real
            # disruption against the budget window.
            enc.clear_reshape_inflight(gk)
            self.reshapes_reverted += 1
            done_uids = {v.uid for v in done}
            for _v in done:
                self._evictions.append(now)
                self.pods_evicted_total += 1
            for p, _r in bound:
                if p.uid in done_uids:
                    self._readd(client, p)
            return False
        for p, _r in bound:
            self._readd(client,
                        dataclasses.replace(p, node_name=""))
            self._evictions.append(now)
            self.pods_evicted_total += 1
            self._last_move[p.uid] = now
        # Wake parked surplus members (a regrow needs them to re-gate
        # alongside the evicted members so the gang completes at the
        # larger shape).
        requeue = getattr(loop, "_requeue_parked", None)
        if requeue is not None:
            requeue()
        self._last_move[gk] = now
        self._inflight_reshapes[gk] = _Reshape(
            gang_key=gk, members=entries,
            old_count=plan["old_count"],
            new_count=plan["new_count"],
            declared=plan["declared"], family=plan["family"],
            deadline=now + self.cfg.rebalance_move_timeout_s,
            trigger=plan["kind"], gain=plan["gain"])
        self.reshapes_total += 1
        if plan["kind"] == "shrink":
            self.reshape_shrinks += 1
        elif plan["kind"] == "regrow":
            self.reshape_regrows += 1
        else:
            self.reshape_retiles += 1
        return True

    # -- reads -------------------------------------------------------

    def disruption_per_pod_hour(self, n_pods: int) -> float:
        """Evictions per pod per hour over the sliding window — the
        disruption a run reports beside the budget.  Prunes with the
        same monotonic clock the window's stamps use."""
        now = time.monotonic()
        while self._evictions and now - self._evictions[0] > 3600.0:
            self._evictions.popleft()
        return len(self._evictions) / max(1, n_pods)

    def summary(self) -> dict[str, Any]:
        """One-shot stats block for /debug/rebalance, /metrics and
        bench artifacts."""
        return {
            "enabled": True,
            "scans_total": self.scans_total,
            "candidates_total": self.candidates_total,
            "moves_total": self.moves_total,
            "moves_completed": self.moves_completed,
            "moves_reverted": self.moves_reverted,
            "moves_inflight": len(self._inflight),
            "pods_evicted_total": self.pods_evicted_total,
            "half_moved_gangs": self.half_moved_gangs,
            "pins_skipped": self.pins_skipped,
            "skipped_gain": self.skipped_gain,
            "skipped_age": self.skipped_age,
            "skipped_cooldown": self.skipped_cooldown,
            "skipped_budget": self.skipped_budget,
            "skipped_disruption": self.skipped_disruption,
            "triggers_link": self.triggers_link,
            "triggers_regret": self.triggers_regret,
            "triggers_drain": self.triggers_drain,
            "last_scan_pods": self.last_scan_pods,
            "last_scan_candidates": self.last_scan_candidates,
            "last_scan_moves": self.last_scan_moves,
            "evictions_window": len(self._evictions),
            "budget_per_hour":
                self.cfg.rebalance_evictions_per_hour,
            # Elastic reshaping sub-block: half_shaped_gangs must stay
            # 0 wherever it appears.
            "reshape": {
                "enabled": bool(getattr(self.cfg,
                                        "enable_gang_reshaping",
                                        False)),
                "reshapes_total": self.reshapes_total,
                "reshapes_completed": self.reshapes_completed,
                "reshapes_reverted": self.reshapes_reverted,
                "reshapes_inflight": len(self._inflight_reshapes),
                "half_shaped_gangs": self.half_shaped_gangs,
                "shrinks": self.reshape_shrinks,
                "regrows": self.reshape_regrows,
                "retiles": self.reshape_retiles,
                "skipped_gain": self.skipped_reshape_gain,
                "skipped_budget": self.skipped_reshape_budget,
            },
        }
