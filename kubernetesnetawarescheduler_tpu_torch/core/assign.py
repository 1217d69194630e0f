"""Assignment: from masked score matrices to per-pod node choices.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/core/assign.py``.
A whole batch is assigned on the device, with capacity stateful across
the batch:

- :func:`assign_greedy` — exact sequential semantics: pods placed one at
  a time in (priority desc, index asc) order, re-masking after every
  placement.  The oracle the parallel path is tested against.
- :func:`assign_parallel` — iterative conflict resolution: every
  unassigned pod argmaxes its masked row, each contested node accepts a
  checked PREFIX of its contenders, rejected pods get a same-round second
  chance at their best untouched node, usage and masks update, repeat.

Both are deterministic: ties break on (higher priority, lower pod index,
lower node index).  The JAX ``lax.while_loop`` becomes a Python loop
whose continue test is one host sync per round, and each ``lax.cond``
gate a Python ``if`` on a scalar (:func:`~.state.host_flag` counts both).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vmap

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import score as score_lib
from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
    plane_digest_vector,
)
from kubernetesnetawarescheduler_tpu_torch.core.score import (
    NEG_HALF,
    NEG_INF,
    _EPS,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    PodBatch,
    add_zone_counts,
    bit_planes,
    commit_assignments,
    concat_shards,
    exact_matmul,
    host_flag,
    index_tree,
    local_rows,
    planes_to_words,
    scatter_add_rows,
    scatter_add_rows_shard,
    scatter_or_onehot,
    shard_pods,
)
from kubernetesnetawarescheduler_tpu_torch.utils.tracing import span

UNASSIGNED = -1
_INT32_MAX = int(np.iinfo(np.int32).max)


def _static_parts(state: ClusterState, pods: PodBatch, cfg: SchedulerConfig,
                  static=None, transposed: bool = False):
    """Batch-invariant pieces: base + network (+ soft) score and the
    static mask (validity, taints, node selectors, nodeAffinity).

    ``static`` is the backend's precomputed prep
    (:func:`~.tiled_score.compute_assign_static`).  With
    ``cfg.score_backend == "pallas"`` the raw score and static mask come
    from the static tile kernel; otherwise from the dense torch path.

    A ``{"raw": f32[P, N], "ok": bool[P, N]}`` dict is the caller's own
    precomputed pair, returned as it is (transposed when asked): the
    gang path injects its co-placement bias through this seam
    (:func:`~.gang.place_gang`)."""
    if isinstance(static, dict):
        raw, ok = static["raw"], static["ok"]
        return (raw.T, ok.T) if transposed else (raw, ok)
    if cfg.score_backend == "pallas":
        return tiled_score.static_scores_tiled(state, pods, cfg, static,
                                               transposed=transposed)
    if static is None:
        static = score_lib.static_node_scores(state, cfg)
    base, ct = static
    if transposed:
        soft_t = score_lib.soft_affinity_scores(state, pods, cfg,
                                                transposed=True)
        net_t = score_lib.network_scores(state, pods, cfg, ct=ct,
                                         transposed=True)
        return (base[:, None] + net_t + soft_t,
                score_lib.static_feasibility_t(state, pods))
    soft = score_lib.soft_affinity_scores(state, pods, cfg)
    net = score_lib.network_scores(state, pods, cfg, ct=ct)
    return base[None, :] + net + soft, score_lib.static_feasibility(state,
                                                                    pods)


def _dynamic_mask(pods: PodBatch, used: torch.Tensor, cap: torch.Tensor,
                  group_bits: torch.Tensor,
                  resident_anti: torch.Tensor) -> torch.Tensor:
    """Placement-dependent constraints ``bool[P, N]``: capacity fit and
    pod (anti-)affinity in both directions, against the current usage
    and groups.  Required affinity is a SUBSET test."""
    free = cap - used
    fits = (pods.req[:, None, :] <= free[None, :, :] + _EPS).all(dim=-1)
    aff_req = pods.affinity_bits[:, None, :]
    affinity = ((group_bits[None, :, :] & aff_req) == aff_req).all(dim=-1)
    anti = ((group_bits[None, :, :] & pods.anti_bits[:, None, :])
            == 0).all(dim=-1)
    sym = ((resident_anti[None, :, :] & pods.group_bit[:, None, :])
           == 0).all(dim=-1)
    return fits & affinity & anti & sym


def _balance(pods: PodBatch, used: torch.Tensor,
             cap: torch.Tensor) -> torch.Tensor:
    cap = cap.clamp_min(_EPS)
    frac = (used[None, :, :] + pods.req[:, None, :]) / cap[None, :, :]
    return frac.amax(dim=-1)


def _first_max_index(row: torch.Tensor) -> torch.Tensor:
    """Lowest index of the maximum of a 1-D row (0-d int64)."""
    ids = torch.arange(row.shape[0], device=row.device)
    return torch.where(row == row.amax(), ids, row.shape[0]).amin()


def assign_greedy(state: ClusterState, pods: PodBatch, cfg: SchedulerConfig,
                  static=None) -> torch.Tensor:
    """Sequential greedy assignment, ``i32[P]`` (-1 = unschedulable).

    Pods are placed one at a time in (priority desc, index asc) order;
    every placement updates capacity, group masks, zone counts and
    zone-anti residency for the pods after it."""
    p = pods.num_pods
    n = state.num_nodes
    dev = state.device
    raw, static_ok = _static_parts(state, pods, cfg, static)
    w_bal = float(np.float32(cfg.weights.balance))
    w_spread = float(np.float32(cfg.weights.spread))
    order = torch.argsort(-pods.priority, stable=True)
    gmax, zmax = state.gz_counts.shape
    has_zone = state.node_zone >= 0
    zrow = state.node_zone.clamp(0, zmax - 1).long()
    sact = score_lib.spread_active(pods)
    cap = state.cap.clamp_min(_EPS)
    node_ids = torch.arange(n, device=dev)
    zone_ids = torch.arange(zmax, device=dev)
    used, group_bits, resident_anti = (state.used, state.group_bits,
                                       state.resident_anti)
    gz, az = state.gz_counts, state.az_anti
    nodes_sorted = []
    for i in order.tolist():
        req = pods.req[i]
        bal_row = ((used + req[None, :]) / cap).amax(dim=-1)
        fits = (req[None, :] <= state.cap - used + _EPS).all(dim=-1)
        aff = pods.affinity_bits[i][None, :]
        affinity = ((group_bits & aff) == aff).all(dim=-1)
        anti = ((group_bits & pods.anti_bits[i][None, :]) == 0).all(dim=-1)
        sym = ((resident_anti & pods.group_bit[i][None, :]) == 0).all(dim=-1)
        # Topology spread against the CURRENT counts (Honor-policy min
        # over the pod's eligible domains).
        cz = gz[pods.group_idx[i].clamp(0, gmax - 1).long()]
        cnt = cz[zrow]
        elig = static_ok[i] & has_zone
        min_c = torch.where(elig, cnt, 2 ** 30).amin()
        skew_after = cnt + 1 - min_c
        maxskew = pods.spread_maxskew[i]
        hard = pods.spread_hard[i]
        violates = sact[i] & has_zone & (skew_after > maxskew)
        spread_ok = ~(violates & hard)
        excess = (skew_after - maxskew).clamp_min(0).to(torch.float32)
        pen = torch.where(violates & ~hard, w_spread * excess, 0.0)
        # Zone-scoped (anti-)affinity against the CURRENT carries.
        zwords = planes_to_words((gz > 0).T)
        pres = zwords[zrow]
        azn = az[zrow]
        zaff = pods.zaff_bits[i][None, :]
        zone_ok = (
            torch.where(has_zone, ((pres & zaff) == zaff).all(dim=-1),
                        (zaff == 0).all())
            & (~has_zone | ((pres & pods.zanti_bits[i][None, :])
                            == 0).all(dim=-1))
            & (~has_zone | ((azn & pods.group_bit[i][None, :])
                            == 0).all(dim=-1)))
        ok = (static_ok[i] & fits & affinity & anti & sym & spread_ok
              & zone_ok)
        row = torch.where(ok, raw[i] - w_bal * bal_row - pen, NEG_INF)
        choice = _first_max_index(row)
        feasible = row[choice] > NEG_HALF
        nodes_sorted.append(torch.where(feasible, choice, UNASSIGNED))
        placed = feasible & pods.pod_valid[i]
        hit = placed & (node_ids == choice)                  # [N]
        used = torch.where(hit[:, None], used + req[None, :], used)
        group_bits = torch.where(hit[:, None],
                                 group_bits | pods.group_bit[i][None, :],
                                 group_bits)
        resident_anti = torch.where(
            hit[:, None], resident_anti | pods.anti_bits[i][None, :],
            resident_anti)
        pzone = state.node_zone[choice]
        zhit = placed & (pzone >= 0) & (zone_ids == pzone)   # [Z]
        gplanes = bit_planes(pods.group_bit[i][None, :], torch.int32)[0]
        gz = gz + torch.where(zhit[None, :], gplanes[:, None], 0)
        az = torch.where(zhit[:, None], az | pods.zanti_bits[i][None, :], az)
    assignment = torch.full((p,), UNASSIGNED, dtype=torch.int32, device=dev)
    if nodes_sorted:
        assignment[order] = torch.stack(nodes_sorted).to(torch.int32)
    return torch.where(pods.pod_valid, assignment, UNASSIGNED)


def _assoc_cumsum0(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 in the odd/even recursion of
    ``jax.lax.associative_scan``, so the f32 sums round exactly as the
    JAX package's do (``torch.cumsum`` adds in another order, and the
    capacity prefix compares these sums against free capacity)."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = _assoc_cumsum0(x[0:n - 1:2] + x[1::2])
    if n % 2 == 0:
        even = odd[:-1] + x[2::2]
    else:
        even = odd + x[2::2]
    even = torch.cat([x[:1], even])
    out = torch.empty_like(x)
    out[0::2] = even
    out[1::2] = odd
    return out


def _cummax0(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _set_rows(x: torch.Tensor, rows: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``x.at[rows].set(vals, mode="drop")`` for ``rows`` in ``[0, N]``,
    where row ``N`` is the drop sentinel.  Duplicate real rows must carry
    identical values (they do at every call site)."""
    n = x.shape[0]
    ext = torch.cat([x, x[:1]])
    ext[rows.long()] = vals
    return ext[:n]


def _segment_starts(group_id: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones((1,), dtype=torch.bool,
                                 device=group_id.device),
                      group_id[1:] != group_id[:-1]])


def assign_parallel(state: ClusterState, pods: PodBatch,
                    cfg: SchedulerConfig, static=None, *,
                    with_stats: bool = False):
    """Batched iterative conflict-resolution assignment, ``i32[P]``.

    Each round: every still-unassigned pod argmaxes its masked score row;
    each chosen node accepts a capacity/conflict/repricing-checked PREFIX
    of its contenders (priority desc, pod index asc); pods rejected at
    their argmax node re-propose their best untouched node in a
    SECOND-CHANCE pass; usage and masks update; remaining pods re-pick
    next round.  Terminates when no unassigned pod has a feasible node.

    The carried matrix is the CORE (static + capacity + host-scoped
    groups + balance) in node-major ``[N, P]`` layout, patched at the
    winners' node rows each round; zone-scoped terms are re-derived per
    round as an overlay.  ``with_stats=True`` also returns the number of
    conflict rounds executed (a Python int; each round costs one host
    sync for its continue test).

    Spans (:func:`~..utils.tracing.span`): ``assign.static`` over the
    set-up up to the first continue test, ``assign.round`` over each
    round with its continue test."""
    with span("assign.static"):
        body, carry, go = _parallel_setup(state, pods, cfg, static)
    rounds = 0
    while go:
        with span("assign.round"):
            *carry, cont = body(*carry)
            go = host_flag(cont, "assign.continue")
        rounds += 1
    assignment = torch.where(pods.pod_valid, carry[6], UNASSIGNED)
    if with_stats:
        return assignment, rounds
    return assignment


def _parallel_setup(state: ClusterState, pods: PodBatch,
                    cfg: SchedulerConfig, static=None):
    """:func:`assign_parallel`'s set-up: the static parts, the round
    ``body``, the first carry and whether a first round runs (the first
    continue test, one host sync)."""
    p = pods.num_pods
    n = state.num_nodes
    if (n + 1) * p > _INT32_MAX:
        # The composite key below would wrap and silently corrupt winner
        # selection; fail loudly instead.
        raise ValueError(
            f"max_nodes*max_pods={n}*{p} overflows the int32 "
            "winner-selection key; reduce the batch or node padding")
    dev = state.device
    rawT, static_okT = _static_parts(state, pods, cfg, static,
                                     transposed=True)
    w_bal = float(np.float32(cfg.weights.balance))
    pod_ids = torch.arange(p, dtype=torch.int32, device=dev)
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    cap = state.cap
    cap_eps = cap.clamp_min(_EPS)
    req = pods.req

    order = torch.argsort(-pods.priority, stable=True)
    rank = torch.zeros((p,), dtype=torch.int32, device=dev)
    rank[order] = pod_ids
    mask_b = 32 * pods.group_bit.shape[1]
    gb_planes = bit_planes(pods.group_bit, torch.int32)
    ab_planes = bit_planes(pods.anti_bits, torch.int32)
    zpair_conflict = (
        (((pods.zanti_bits[:, None, :] & pods.group_bit[None, :, :]) != 0)
         .any(dim=-1)
         | ((pods.group_bit[:, None, :] & pods.zanti_bits[None, :, :]) != 0)
         .any(dim=-1))
        & (rank[:, None] < rank[None, :]))

    def argmax2(s_m):
        """(choice, best, second_best) over axis 0 of ``[N, P]``: first
        max, and the best value on any OTHER row."""
        best = s_m.amax(dim=0)
        choice = torch.where(s_m == best[None, :], row_ids, n).amin(dim=0)
        second = torch.where(row_ids == choice[None, :], NEG_INF,
                             s_m).amax(dim=0)
        return choice.to(torch.int32), best, second

    def core_scores_t(used, group_bits, resident_anti, assignment):
        """The carried CORE matrix ``f32[N, P]``: raw score minus
        balance, masked by the static and host-scoped dynamic
        constraints and assigned-pod retirement."""
        free = cap - used
        fits = (req[None, :, :] <= free[:, None, :] + _EPS).all(dim=-1)
        aff_req = pods.affinity_bits[None, :, :]
        affinity = ((group_bits[:, None, :] & aff_req)
                    == aff_req).all(dim=-1)
        anti = ((group_bits[:, None, :] & pods.anti_bits[None, :, :])
                == 0).all(dim=-1)
        sym = ((resident_anti[:, None, :] & pods.group_bit[None, :, :])
               == 0).all(dim=-1)
        bal = ((used[:, None, :] + req[None, :, :])
               / cap_eps[:, None, :]).amax(dim=-1)
        ok = (static_okT & fits & affinity & anti & sym
              & (assignment == UNASSIGNED)[None, :])
        return torch.where(ok, rawT - w_bal * bal, NEG_INF)

    # Does ANY zone-scoped work exist for this batch?  When not, the
    # overlay is the identity and the second-chance pass is allowed.
    zone_work = host_flag(
        score_lib.spread_active(pods).any()
        | (pods.zaff_bits != 0).any() | (pods.zanti_bits != 0).any()
        | (state.az_anti != 0).any(), "assign.zone_work")
    static_ok_pn = static_okT.T if zone_work else None

    def overlay(sT, gz, az):
        """Zone-scoped terms against the CURRENT zone state: the spread
        penalty/mask and zone (anti-)affinity."""
        if not zone_work:
            return sT
        spread_pen, spread_ok = score_lib.spread_terms(
            state, pods, cfg, gz_counts=gz, static_ok=static_ok_pn)
        zone_ok = score_lib.zone_affinity_ok(state, pods, gz_counts=gz,
                                             az_anti=az)
        return torch.where((spread_ok & zone_ok).T, sT - spread_pen.T,
                           NEG_INF)

    idx = torch.arange(p, dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, mask_b), dtype=torch.int32, device=dev)

    def accept(second_best, choice_x, feas_x, used):
        """Per-node multi-accept prefix over one proposal set: beyond its
        best contender a node accepts the following ones (priority
        order) while they cumulatively fit its free capacity, no
        pairwise group/anti conflict exists with an earlier member, and
        the node stays each member's best choice once the balance
        penalty is re-priced with everyone queued ahead of it."""
        key = torch.where(feas_x, choice_x * p + rank, n * p + rank)
        perm = torch.argsort(key)
        group_id = key[perm] // p
        first = _segment_starts(group_id)
        req_sorted = req[perm]
        csum = _assoc_cumsum0(req_sorted)
        base = torch.where(first[:, None], csum - req_sorted, -float("inf"))
        seg_csum = csum - _cummax0(base)
        node_sorted = group_id.clamp(0, n - 1).long()
        fits_cum = (seg_csum <= (cap - used)[node_sorted] + _EPS).all(dim=-1)
        bal_after = ((used[node_sorted] + seg_csum)
                     / cap_eps[node_sorted]).amax(dim=-1)
        raw_sel = rawT.gather(
            0, choice_x.clamp(0, n - 1).long()[None, :])[0]
        adj_sorted = raw_sel[perm] - w_bal * bal_after
        stays_best = adj_sorted >= second_best[perm] - 1e-6
        # Segmented EXCLUSIVE running OR of earlier contenders'
        # group/anti planes, via cummax with a per-segment offset.
        seg2 = (group_id * 2)[:, None]
        gbp, abp = gb_planes[perm], ab_planes[perm]
        incl_gb = _cummax0(seg2 + gbp) - seg2
        incl_ab = _cummax0(seg2 + abp) - seg2
        excl_gb = torch.where(first[:, None], 0,
                              torch.cat([zero_row, incl_gb[:-1]])) >= 1
        excl_ab = torch.where(first[:, None], 0,
                              torch.cat([zero_row, incl_ab[:-1]])) >= 1
        pair_ok = (~(excl_ab & (gbp >= 1)).any(dim=1)
                   & ~(excl_gb & (abp >= 1)).any(dim=1))
        good = fits_cum & pair_ok & stays_best
        seg_start = _cummax0(torch.where(first, idx, -1))
        last_bad = _cummax0(torch.where(~good, idx, -1))
        prefix_ok = last_bad < seg_start
        out = torch.zeros((p,), dtype=torch.bool, device=dev)
        out[perm] = (first | prefix_ok) & (group_id < n)
        return out

    def seg_or_updates(choice_x, winner_x, group_bits, resident_anti):
        """Per-node OR of the winners' group/anti planes into the node
        bit fields: one row write per node segment, read at the
        segment's last row of a segmented running OR."""
        key = torch.where(winner_x, choice_x * p + rank, n * p + rank)
        perm = torch.argsort(key)
        group_id = key[perm] // p
        first = _segment_starts(group_id)
        node_sorted = group_id.clamp(0, n - 1)
        seg2 = (group_id * 2)[:, None]
        win_sorted = winner_x[perm].to(torch.int32)[:, None]
        or_gb = (_cummax0(seg2 + gb_planes[perm] * win_sorted) - seg2) >= 1
        or_ab = (_cummax0(seg2 + ab_planes[perm] * win_sorted) - seg2) >= 1
        last_of_seg = torch.cat([first[1:], torch.ones(
            (1,), dtype=torch.bool, device=dev)])
        seg_cols = torch.where(last_of_seg & (group_id < n), node_sorted, n)
        safe = seg_cols.clamp(0, n - 1).long()
        new_group = _set_rows(group_bits, seg_cols,
                              group_bits[safe] | planes_to_words(or_gb))
        new_anti = _set_rows(resident_anti, seg_cols,
                             resident_anti[safe] | planes_to_words(or_ab))
        return new_group, new_anti

    def row_patch(sT, wnodes, used_x, group_x, anti_x, assignment_x):
        """Recompute the core values at the given node rows against the
        post-placement allocation state and patch them into the carried
        matrix; also return the patch (the second-chance pass reads it
        as the re-priced pass-A alternatives).  Row ``n`` is the drop
        sentinel."""
        cc = wnodes.clamp(0, n - 1).long()
        sub_used = used_x[cc]
        sub_cap = cap[cc]
        fits2 = (req[None, :, :] <= (sub_cap - sub_used)[:, None, :]
                 + _EPS).all(dim=-1)
        gb = group_x[cc]
        ra = anti_x[cc]
        aff_req2 = pods.affinity_bits[None, :, :]
        affinity2 = ((gb[:, None, :] & aff_req2) == aff_req2).all(dim=-1)
        aok = ((gb[:, None, :] & pods.anti_bits[None, :, :])
               == 0).all(dim=-1)
        sym2 = ((ra[:, None, :] & pods.group_bit[None, :, :])
                == 0).all(dim=-1)
        bal = ((sub_used[:, None, :] + req[None, :, :])
               / sub_cap.clamp_min(_EPS)[:, None, :]).amax(dim=-1)
        ok = (static_okT[cc] & fits2 & affinity2 & aok & sym2
              & (assignment_x == UNASSIGNED)[None, :]
              & (wnodes < n)[:, None])
        sub = torch.where(ok, rawT[cc] - w_bal * bal, NEG_INF)
        return _set_rows(sT, wnodes, sub), sub

    def body(sT, used, group_bits, resident_anti, gz, az, assignment):
        s_ov = overlay(sT, gz, az)
        alive = (assignment == UNASSIGNED) & pods.pod_valid
        s_m = torch.where(alive[None, :], s_ov, NEG_INF)
        choice, val, second_best = argmax2(s_m)
        feasible = val > NEG_HALF
        winner = accept(second_best, choice, feasible, used)

        # Topology-spread round cap: keep only the best-ranked
        # spread-active winner per (group, zone) this round.
        choice_l = choice.clamp(0, n - 1).long()
        zone_of = state.node_zone[choice_l]
        s_active = (winner & score_lib.spread_active(pods)
                    & (zone_of >= 0))
        zdim = state.gz_counts.shape[1]
        gzmax = state.gz_counts.shape[0] * zdim
        gz_id = torch.where(s_active, pods.group_idx * zdim + zone_of,
                            gzmax + rank)
        key2 = gz_id * p + rank
        perm2 = torch.argsort(key2)
        first2 = _segment_starts(key2[perm2] // p)
        keep = torch.zeros((p,), dtype=torch.bool, device=dev)
        keep[perm2] = first2
        winner = winner & keep

        # Zone-anti round cap: demote winners that zone-conflict with a
        # better-ranked same-zone winner.
        zsame = (winner[:, None] & winner[None, :]
                 & (zone_of[:, None] == zone_of[None, :])
                 & (zone_of >= 0)[:, None])
        winner = winner & ~(zsame & zpair_conflict).any(dim=0)

        # Pass-A allocation updates.
        assignment_a = torch.where(winner, choice, assignment)
        used_a = scatter_add_rows(used, choice, req, winner)
        group_a, anti_a = seg_or_updates(choice, winner, group_bits,
                                         resident_anti)
        wnodes_a = torch.where(winner, choice, n)
        s_patched, sub_a = row_patch(sT, wnodes_a, used_a, group_a, anti_a,
                                     assignment_a)

        # Second-chance pass: pods rejected at their argmax node
        # re-propose their best UNTOUCHED node in the same round, only
        # where it beats their best re-priced pass-A alternative.  Off
        # under zone work (pass A may move zone state).
        if not zone_work and host_flag((~winner & feasible).any(),
                                       "assign.second_chance"):
            va_new = sub_a.amax(dim=0)
            s_b = _set_rows(sT, wnodes_a, torch.full_like(sub_a, NEG_INF))
            alive_b = alive & ~winner
            s_bm = torch.where(alive_b[None, :], s_b, NEG_INF)
            choice_b, val_b, sb2 = argmax2(s_bm)
            feas_b = (val_b > NEG_HALF) & (val_b >= va_new - 1e-6)
            winner_b = accept(torch.maximum(sb2, va_new), choice_b, feas_b,
                              used)
            winner_m = winner | winner_b
            choice_m = torch.where(winner_b, choice_b, choice)
            new_assignment = torch.where(winner_m, choice_m, assignment)
            new_used = scatter_add_rows(used_a, choice_b, req, winner_b)
            new_group, new_anti = seg_or_updates(choice_b, winner_b,
                                                 group_a, anti_a)
            wnodes_b = torch.where(winner_b, choice_b, n)
            new_sT, _ = row_patch(s_patched, wnodes_b, new_used, new_group,
                                  new_anti, new_assignment)
        else:
            winner_m, choice_m, new_assignment = winner, choice, assignment_a
            new_used, new_group, new_anti = used_a, group_a, anti_a
            new_sT = s_patched
        progress = winner_m.any()
        new_gz = add_zone_counts(gz, state.node_zone, pods.group_bit,
                                 choice_m, winner_m)
        zone_of_m = state.node_zone[choice_m.clamp(0, n - 1).long()]
        zmax = az.shape[0]
        zhot = (winner_m & (zone_of_m >= 0))[:, None] & (
            zone_of_m.clamp(0, zmax - 1)[:, None]
            == torch.arange(zmax, device=dev)[None, :])
        new_az = az | scatter_or_onehot(zhot, pods.zanti_bits)
        alive2 = (new_assignment == UNASSIGNED) & pods.pod_valid
        cont = progress & (torch.where(alive2[None, :], new_sT, NEG_INF)
                           > NEG_HALF).any()
        return (new_sT, new_used, new_group, new_anti, new_gz, new_az,
                new_assignment, cont)

    assignment = torch.full((p,), UNASSIGNED, dtype=torch.int32, device=dev)
    carry = (core_scores_t(state.used, state.group_bits,
                           state.resident_anti, assignment),
             state.used, state.group_bits, state.resident_anti,
             state.gz_counts, state.az_anti, assignment)
    return body, carry, host_flag((carry[0] > NEG_HALF).any(),
                                  "assign.continue")


# ---------------------------------------------------------------------------
# The conflict loop over a lane axis (the fleet's one dispatch).
# ---------------------------------------------------------------------------


def _tree_fields(tree) -> dict:
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def _set_rows_f(x: torch.Tensor, rows: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """:func:`_set_rows` without the in-place write (``vmap`` batches an
    out-of-place ``index_put``)."""
    n = x.shape[0]
    return torch.cat([x, x[:1]]).index_put((rows.long(),), vals)[:n]


def _static_parts_lanes(states: ClusterState, pods: PodBatch,
                        cfg: SchedulerConfig, statics):
    """Node-major ``(raw f32[K, N, P], static_ok bool[K, N, P])``: one
    lane launch of the static kernel under ``"pallas"``; under
    ``"xla"`` the solo :func:`_static_parts` once per lane (once per
    cycle, never per round)."""
    if cfg.score_backend == "pallas":
        return tiled_score.static_scores_tiled_lanes(states, pods, cfg,
                                                     statics,
                                                     transposed=True)
    parts = [_static_parts(index_tree(states, k), index_tree(pods, k), cfg,
                           None if statics is None
                           else index_tree(statics, k), transposed=True)
             for k in range(pods.req.shape[0])]
    return (torch.stack([raw for raw, _ in parts]),
            torch.stack([ok for _, ok in parts]))


def _lane_scatter_add(base: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`~.state.scatter_add_rows` over a lane axis, with one
    ``[N, P] x [P, R]`` product per lane, the solo path's own call: a
    batched product may sum three or more pods on one node in another
    order, and ``used`` must keep the solo bits."""
    n = base.shape[1]
    onehot = (mask[..., None] & (
        idx[..., None] == torch.arange(n, device=idx.device))).to(
            torch.float32)
    add = torch.where(mask[..., None], vals, torch.zeros_like(vals))
    return base + torch.stack([exact_matmul(onehot[k].T, add[k])
                               for k in range(base.shape[0])])


def assign_parallel_lanes(states: ClusterState, pods: PodBatch,
                          cfg: SchedulerConfig, statics=None):
    """:func:`assign_parallel` over a leading lane axis: ``states`` and
    ``pods`` are :func:`~.state.stack_trees` results (``[K, ...]`` per
    leaf), ``statics`` the stacked per-lane backend prep (or None).
    Returns ``(assignment i32[K, P], rounds i32[K])``; lane ``k`` equals
    ``assign_parallel`` on lane ``k`` alone, bit for bit, and depends on
    no other lane.

    This is what ``jax.vmap`` makes of the JAX loop.  The rounds run on
    the host with ONE :func:`~.state.host_flag` per round for all K
    lanes (a solo loop pays one per round per tenant, plus its gates);
    each lane's ``cont`` and round count stay on the device, and a
    finished lane's carry is frozen with ``torch.where`` until the last
    lane stops.  The two host gates of the solo loop become per-lane
    selects: the zone overlay (computed for every lane once any lane has
    zone work) and the second-chance pass (computed every round, taken
    only by a lane without zone work whose pass A left a feasible pod
    unplaced).  A round is three ``torch.func.vmap`` bodies around the
    two usage updates, which run per lane (:func:`_lane_scatter_add`)."""
    k_lanes, p = pods.req.shape[:2]
    n = states.metrics.shape[1]
    if (n + 1) * p > _INT32_MAX:
        raise ValueError(
            f"max_nodes*max_pods={n}*{p} overflows the int32 "
            "winner-selection key; reduce the batch or node padding")
    dev = states.metrics.device
    rawT, static_okT = _static_parts_lanes(states, pods, cfg, statics)
    w_bal = float(np.float32(cfg.weights.balance))
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    idx = torch.arange(p, dtype=torch.int32, device=dev)

    def unpack(c):
        return ClusterState(**c["st"]), PodBatch(**c["pd"])

    def consts(c):
        state, lp = unpack(c)
        order = torch.argsort(-lp.priority, stable=True)
        rank = torch.zeros((p,), dtype=torch.int32, device=dev).scatter(
            0, order, idx)
        zpc = (
            (((lp.zanti_bits[:, None, :] & lp.group_bit[None, :, :]) != 0)
             .any(dim=-1)
             | ((lp.group_bit[:, None, :] & lp.zanti_bits[None, :, :]) != 0)
             .any(dim=-1))
            & (rank[:, None] < rank[None, :]))
        zwork = (score_lib.spread_active(lp).any()
                 | (lp.zaff_bits != 0).any() | (lp.zanti_bits != 0).any()
                 | (state.az_anti != 0).any())
        return {"rank": rank, "gbp": bit_planes(lp.group_bit, torch.int32),
                "abp": bit_planes(lp.anti_bits, torch.int32), "zpc": zpc,
                "zwork": zwork}

    def argmax2(s_m):
        best = s_m.amax(dim=0)
        choice = torch.where(s_m == best[None, :], row_ids, n).amin(dim=0)
        second = torch.where(row_ids == choice[None, :], NEG_INF,
                             s_m).amax(dim=0)
        return choice.to(torch.int32), best, second

    def core_scores_t(c, used, group_bits, resident_anti, assignment):
        state, lp = unpack(c)
        cap = state.cap
        free = cap - used
        fits = (lp.req[None, :, :] <= free[:, None, :] + _EPS).all(dim=-1)
        aff_req = lp.affinity_bits[None, :, :]
        affinity = ((group_bits[:, None, :] & aff_req)
                    == aff_req).all(dim=-1)
        anti = ((group_bits[:, None, :] & lp.anti_bits[None, :, :])
                == 0).all(dim=-1)
        sym = ((resident_anti[:, None, :] & lp.group_bit[None, :, :])
               == 0).all(dim=-1)
        bal = ((used[:, None, :] + lp.req[None, :, :])
               / cap.clamp_min(_EPS)[:, None, :]).amax(dim=-1)
        ok = (c["okT"] & fits & affinity & anti & sym
              & (assignment == UNASSIGNED)[None, :])
        return torch.where(ok, c["rawT"] - w_bal * bal, NEG_INF)

    def overlay(c, sT, gz, az):
        state, lp = unpack(c)
        spread_pen, spread_ok = score_lib.spread_terms_ungated(
            state, lp, cfg, gz, static_ok=c["okT"].T)
        zone_ok = score_lib.zone_affinity_ungated(state, lp, gz, az)
        ov = torch.where((spread_ok & zone_ok).T, sT - spread_pen.T,
                         NEG_INF)
        return torch.where(c["zwork"], ov, sT)

    def accept(c, second_best, choice_x, feas_x, used):
        state, lp = unpack(c)
        rank, cap = c["rank"], state.cap
        key = torch.where(feas_x, choice_x * p + rank, n * p + rank)
        perm = torch.argsort(key)
        group_id = key[perm] // p
        first = _segment_starts(group_id)
        req_sorted = lp.req[perm]
        csum = _assoc_cumsum0(req_sorted)
        base = torch.where(first[:, None], csum - req_sorted, -float("inf"))
        seg_csum = csum - _cummax0(base)
        node_sorted = group_id.clamp(0, n - 1).long()
        fits_cum = (seg_csum <= (cap - used)[node_sorted] + _EPS).all(dim=-1)
        bal_after = ((used[node_sorted] + seg_csum)
                     / cap.clamp_min(_EPS)[node_sorted]).amax(dim=-1)
        raw_sel = c["rawT"].gather(
            0, choice_x.clamp(0, n - 1).long()[None, :])[0]
        adj_sorted = raw_sel[perm] - w_bal * bal_after
        stays_best = adj_sorted >= second_best[perm] - 1e-6
        seg2 = (group_id * 2)[:, None]
        gbp, abp = c["gbp"][perm], c["abp"][perm]
        incl_gb = _cummax0(seg2 + gbp) - seg2
        incl_ab = _cummax0(seg2 + abp) - seg2
        zero_row = torch.zeros_like(gbp[:1])
        excl_gb = torch.where(first[:, None], 0,
                              torch.cat([zero_row, incl_gb[:-1]])) >= 1
        excl_ab = torch.where(first[:, None], 0,
                              torch.cat([zero_row, incl_ab[:-1]])) >= 1
        pair_ok = (~(excl_ab & (gbp >= 1)).any(dim=1)
                   & ~(excl_gb & (abp >= 1)).any(dim=1))
        good = fits_cum & pair_ok & stays_best
        seg_start = _cummax0(torch.where(first, idx, -1))
        last_bad = _cummax0(torch.where(~good, idx, -1))
        prefix_ok = last_bad < seg_start
        return torch.zeros((p,), dtype=torch.bool, device=dev).scatter(
            0, perm, (first | prefix_ok) & (group_id < n))

    def seg_or_updates(c, choice_x, winner_x, group_bits, resident_anti):
        key = torch.where(winner_x, choice_x * p + c["rank"],
                          n * p + c["rank"])
        perm = torch.argsort(key)
        group_id = key[perm] // p
        first = _segment_starts(group_id)
        node_sorted = group_id.clamp(0, n - 1)
        seg2 = (group_id * 2)[:, None]
        win_sorted = winner_x[perm].to(torch.int32)[:, None]
        or_gb = (_cummax0(seg2 + c["gbp"][perm] * win_sorted) - seg2) >= 1
        or_ab = (_cummax0(seg2 + c["abp"][perm] * win_sorted) - seg2) >= 1
        last_of_seg = torch.cat([first[1:], torch.ones(
            (1,), dtype=torch.bool, device=dev)])
        seg_cols = torch.where(last_of_seg & (group_id < n), node_sorted, n)
        safe = seg_cols.clamp(0, n - 1).long()
        new_group = _set_rows_f(group_bits, seg_cols,
                                group_bits[safe] | planes_to_words(or_gb))
        new_anti = _set_rows_f(resident_anti, seg_cols,
                               resident_anti[safe] | planes_to_words(or_ab))
        return new_group, new_anti

    def row_patch(c, sT, wnodes, used_x, group_x, anti_x, assignment_x):
        state, lp = unpack(c)
        cc = wnodes.clamp(0, n - 1).long()
        sub_used = used_x[cc]
        sub_cap = state.cap[cc]
        fits2 = (lp.req[None, :, :] <= (sub_cap - sub_used)[:, None, :]
                 + _EPS).all(dim=-1)
        gb = group_x[cc]
        ra = anti_x[cc]
        aff_req2 = lp.affinity_bits[None, :, :]
        affinity2 = ((gb[:, None, :] & aff_req2) == aff_req2).all(dim=-1)
        aok = ((gb[:, None, :] & lp.anti_bits[None, :, :])
               == 0).all(dim=-1)
        sym2 = ((ra[:, None, :] & lp.group_bit[None, :, :])
                == 0).all(dim=-1)
        bal = ((sub_used[:, None, :] + lp.req[None, :, :])
               / sub_cap.clamp_min(_EPS)[:, None, :]).amax(dim=-1)
        ok = (c["okT"][cc] & fits2 & affinity2 & aok & sym2
              & (assignment_x == UNASSIGNED)[None, :]
              & (wnodes < n)[:, None])
        sub = torch.where(ok, c["rawT"][cc] - w_bal * bal, NEG_INF)
        return _set_rows_f(sT, wnodes, sub), sub

    def init(c):
        state, lp = unpack(c)
        assignment = torch.full_like(lp.group_idx, UNASSIGNED)
        sT = core_scores_t(c, state.used, state.group_bits,
                           state.resident_anti, assignment)
        return ((sT, state.used, state.group_bits, state.resident_anti,
                 state.gz_counts, state.az_anti, assignment),
                (sT > NEG_HALF).any())

    def round_a(c, carry, zone_any):
        """Argmax, accept, and the round's spread and zone-anti caps."""
        state, lp = unpack(c)
        sT, used, _, _, gz, az, assignment = carry
        s_ov = overlay(c, sT, gz, az) if zone_any else sT
        alive = (assignment == UNASSIGNED) & lp.pod_valid
        s_m = torch.where(alive[None, :], s_ov, NEG_INF)
        choice, val, second_best = argmax2(s_m)
        feasible = val > NEG_HALF
        winner = accept(c, second_best, choice, feasible, used)
        rank = c["rank"]
        zone_of = state.node_zone[choice.clamp(0, n - 1).long()]
        s_active = (winner & score_lib.spread_active(lp) & (zone_of >= 0))
        zdim = state.gz_counts.shape[1]
        gzmax = state.gz_counts.shape[0] * zdim
        gz_id = torch.where(s_active, lp.group_idx * zdim + zone_of,
                            gzmax + rank)
        key2 = gz_id * p + rank
        perm2 = torch.argsort(key2)
        first2 = _segment_starts(key2[perm2] // p)
        keep = torch.zeros((p,), dtype=torch.bool, device=dev).scatter(
            0, perm2, first2)
        winner = winner & keep
        zsame = (winner[:, None] & winner[None, :]
                 & (zone_of[:, None] == zone_of[None, :])
                 & (zone_of >= 0)[:, None])
        winner = winner & ~(zsame & c["zpc"]).any(dim=0)
        return choice, feasible, winner, alive

    def round_b(c, carry, choice, feasible, winner, alive, used_a):
        """Pass A's updates and the second-chance proposal."""
        sT, used, group_bits, resident_anti, _, _, assignment = carry
        assignment_a = torch.where(winner, choice, assignment)
        group_a, anti_a = seg_or_updates(c, choice, winner, group_bits,
                                         resident_anti)
        wnodes_a = torch.where(winner, choice, n)
        s_patched, sub_a = row_patch(c, sT, wnodes_a, used_a, group_a,
                                     anti_a, assignment_a)
        va_new = sub_a.amax(dim=0)
        s_b = _set_rows_f(sT, wnodes_a, torch.full_like(sub_a, NEG_INF))
        s_bm = torch.where((alive & ~winner)[None, :], s_b, NEG_INF)
        choice_b, val_b, sb2 = argmax2(s_bm)
        feas_b = (val_b > NEG_HALF) & (val_b >= va_new - 1e-6)
        take_b = ~c["zwork"] & (~winner & feasible).any()
        winner_b = accept(c, torch.maximum(sb2, va_new), choice_b, feas_b,
                          used) & take_b
        return (assignment_a, group_a, anti_a, s_patched, choice_b,
                winner_b, take_b)

    def round_c(c, carry, cont, choice, winner, used_a, b, used_b):
        """Pass B's updates, the per-lane second-chance select, the zone
        planes, the next ``cont``; a finished lane keeps its carry."""
        state, lp = unpack(c)
        _, _, _, _, gz, az, assignment = carry
        (assignment_a, group_a, anti_a, s_patched, choice_b, winner_b,
         take_b) = b
        winner_mb = winner | winner_b
        choice_mb = torch.where(winner_b, choice_b, choice)
        assignment_b = torch.where(winner_mb, choice_mb, assignment)
        group_b, anti_b = seg_or_updates(c, choice_b, winner_b, group_a,
                                         anti_a)
        wnodes_b = torch.where(winner_b, choice_b, n)
        sT_b, _ = row_patch(c, s_patched, wnodes_b, used_b, group_b,
                            anti_b, assignment_b)

        def pick(on_b, on_a):
            return torch.where(take_b, on_b, on_a)

        winner_m = pick(winner_mb, winner)
        choice_m = pick(choice_mb, choice)
        new_assignment = pick(assignment_b, assignment_a)
        new_sT = pick(sT_b, s_patched)
        new_used = pick(used_b, used_a)
        new_group, new_anti = pick(group_b, group_a), pick(anti_b, anti_a)
        new_gz = add_zone_counts(gz, state.node_zone, lp.group_bit,
                                 choice_m, winner_m)
        zone_of_m = state.node_zone[choice_m.clamp(0, n - 1).long()]
        zmax = az.shape[0]
        zhot = (winner_m & (zone_of_m >= 0))[:, None] & (
            zone_of_m.clamp(0, zmax - 1)[:, None]
            == torch.arange(zmax, device=dev)[None, :])
        new_az = az | scatter_or_onehot(zhot, lp.zanti_bits)
        alive2 = (new_assignment == UNASSIGNED) & lp.pod_valid
        cont_new = winner_m.any() & (torch.where(
            alive2[None, :], new_sT, NEG_INF) > NEG_HALF).any()
        new = (new_sT, new_used, new_group, new_anti, new_gz, new_az,
               new_assignment)
        return (tuple(torch.where(cont, x, x0) for x, x0 in zip(new, carry)),
                cont & cont_new)

    c = {"st": _tree_fields(states), "pd": _tree_fields(pods),
         "rawT": rawT, "okT": static_okT}
    c.update(vmap(consts)(c))
    zone_any = host_flag(c["zwork"].any(), "lanes.zone_work")
    carry, cont = vmap(init)(c)
    rounds = torch.zeros((k_lanes,), dtype=torch.int32, device=dev)
    while host_flag(cont.any(), "lanes.continue"):
        choice, feasible, winner, alive = vmap(
            round_a, in_dims=(0, 0, None))(c, carry, zone_any)
        used_a = _lane_scatter_add(carry[1], choice, pods.req, winner)
        b = vmap(round_b)(c, carry, choice, feasible, winner, alive, used_a)
        used_b = _lane_scatter_add(used_a, b[4], pods.req, b[5])
        rounds = rounds + cont.to(torch.int32)
        carry, cont = vmap(round_c)(c, carry, cont, choice, winner, used_a,
                                    b, used_b)
    return torch.where(pods.pod_valid, carry[6], UNASSIGNED), rounds


# ---------------------------------------------------------------------------
# The conflict loop as explicit SPMD over a (dp, tp) mesh.
# ---------------------------------------------------------------------------


def _static_parts_spmd(state: ClusterState, lp: PodBatch,
                       cfg: SchedulerConfig, static, mesh):
    """Node-major ``(raw f32[rows, Ps], static_ok bool[rows, Ps])``: the
    rank's tile of :func:`_static_parts`, its node shard by its pods.
    ``static`` is the shard's dense pair
    (:func:`~.score.static_node_scores_spmd`; computed here when None),
    or a precomputed tile: ``{"raw", "ok"}`` pod-major or ``{"rawT",
    "okT"}`` node-major (the row-shard kernel route)."""
    if isinstance(static, dict):
        if "rawT" in static:
            return static["rawT"], static["okT"]
        return static["raw"].T, static["ok"].T
    if static is None:
        static = score_lib.static_node_scores_spmd(state, cfg, mesh)
    base, ct = static
    off = mesh.tp_index * state.num_nodes
    soft_t = score_lib.soft_affinity_scores(state, lp, cfg, transposed=True)
    net_t = score_lib.network_scores_shard(lp, cfg, ct, off, transposed=True)
    return (base[:, None] + net_t + soft_t,
            score_lib.static_feasibility_t(state, lp))


def _mesh_geometry(state: ClusterState, pods: PodBatch, mesh):
    """``(P, Ps, pod offset, rows, N, node offset)`` of this rank."""
    p = pods.num_pods
    if p % mesh.dp != 0:
        raise ValueError(f"max_pods={p} does not split over dp={mesh.dp}")
    ps = p // mesh.dp
    rows = state.num_nodes
    return p, ps, mesh.dp_index * ps, rows, rows * mesh.tp, \
        mesh.tp_index * rows


def assign_parallel_spmd(state: ClusterState, pods: PodBatch,
                         cfg: SchedulerConfig, mesh, static=None, *,
                         with_stats: bool = False, node_zone=None):
    """:func:`assign_parallel` as explicit SPMD over a ``(dp, tp)`` mesh:
    the same assignment, bit for bit.  Collective: every rank of
    ``mesh`` calls it with its node shard ``state`` (``tp`` rows of
    every node-axis leaf, the zone planes whole) and the WHOLE batch
    ``pods``; each returns the whole ``i32[P]`` assignment (and the
    round count with ``with_stats``).  ``node_zone`` is the whole
    cluster's ``i32[N]`` when the caller has it (else gathered here).

    The carried core matrix is node-major, so a rank holds its tile
    ``[N/tp, P/dp]`` (its nodes by its dp rows of the batch); everything
    of length P is whole on every rank.  Per round:

    - ``argmax2``: each rank's per-pod (best, lowest index, second best)
      over its rows, with the raw score and the node's usage and
      capacity at its pick, gathered over ``tp``; the value is the max,
      the node the lowest GLOBAL index among equal maxima (JAX's
      ``pmin`` combine), the second best the max of the winning shard's
      own second best and every other shard's best — all exact.  Then
      the ``P/dp`` proposals are gathered over ``dp``.
    - ``accept`` runs on every rank over the whole proposal set (its
      segment sums are differences of prefix sums over ALL contenders,
      so a subset would round otherwise), reading each contender's node
      through the gathered usage and capacity.
    - the usage commit is the one-hot product at the whole cluster's
      shape, of which each rank adds its rows
      (:func:`~.state.scatter_add_rows_shard`); the group/anti ORs and
      the row patch write only the rank's rows.
    - the zone caps and zone counts read the whole ``node_zone``.
    - the continue test, the second-chance gate and the zone-work gate
      are each one MAX all-reduce over the world (:meth:`Mesh.flag`),
      so every rank takes the same branch and joins the same
      collectives."""
    p, ps, poff, ns, n, off = _mesh_geometry(state, pods, mesh)
    if (n + 1) * p > _INT32_MAX:
        raise ValueError(
            f"max_nodes*max_pods={n}*{p} overflows the int32 "
            "winner-selection key; reduce the batch or node padding")
    if n >= 1 << 24:
        raise ValueError(f"{n} nodes exceed the f32-exact node index of the "
                         "argmax gather")
    dev = state.device
    lp = shard_pods(pods, mesh.dp_index, mesh.dp)
    rawT, static_okT = _static_parts_spmd(state, lp, cfg, static, mesh)
    if node_zone is None:
        node_zone = concat_shards(mesh, state.node_zone, "tp")
    w_bal = float(np.float32(cfg.weights.balance))
    pod_ids = torch.arange(p, dtype=torch.int32, device=dev)
    row_ids = (off + torch.arange(ns, dtype=torch.int32, device=dev))[:, None]
    lcols = torch.arange(ps, device=dev)
    cap = state.cap
    cap_eps = cap.clamp_min(_EPS)
    req = pods.req
    r_res = req.shape[1]

    order = torch.argsort(-pods.priority, stable=True)
    rank = torch.zeros((p,), dtype=torch.int32, device=dev)
    rank[order] = pod_ids
    mask_b = 32 * pods.group_bit.shape[1]
    gb_planes = bit_planes(pods.group_bit, torch.int32)
    ab_planes = bit_planes(pods.anti_bits, torch.int32)
    zpair_conflict = (
        (((pods.zanti_bits[:, None, :] & pods.group_bit[None, :, :]) != 0)
         .any(dim=-1)
         | ((pods.group_bit[:, None, :] & pods.zanti_bits[None, :, :]) != 0)
         .any(dim=-1))
        & (rank[:, None] < rank[None, :]))

    def argmax2(s_m, used, extra=None):
        """Whole-batch ``(choice i32[P], best, second, raw at choice,
        used[choice] [P, R], cap[choice] [P, R])`` of the tiles ``s_m``
        over every rank, plus the tp max of ``extra`` (a per-local-pod
        f32 row) when given."""
        best_l = s_m.amax(dim=0)
        choice_l = torch.where(s_m == best_l[None, :], row_ids,
                               n).amin(dim=0)
        second_l = torch.where(row_ids == choice_l[None, :], NEG_INF,
                               s_m).amax(dim=0)
        cl = (choice_l - off).clamp(0, ns - 1).long()
        cols = [best_l, choice_l.to(torch.float32), second_l,
                rawT[cl, lcols]]
        if extra is not None:
            cols.append(extra)
        pack = torch.cat([torch.stack(cols, dim=1), used[cl], cap[cl]],
                         dim=1)                               # [Ps, C]
        allp = mesh.gather(pack, "tp")                        # [tp, Ps, C]
        bests, choices = allp[:, :, 0], allp[:, :, 1]
        best = bests.amax(dim=0)
        choice = torch.where(bests == best[None, :], choices,
                             float(n)).amin(dim=0)
        win = (bests == best[None, :]) & (choices == choice[None, :])
        second = torch.where(win, allp[:, :, 2], bests).amax(dim=0)
        pick = win.to(torch.int8).argmax(dim=0)               # [Ps]
        chosen = allp[pick, lcols]                            # [Ps, C]
        out = torch.cat([torch.stack([choice, best, second], dim=1),
                         chosen[:, 3:]], dim=1)
        if extra is not None:
            out[:, 4] = allp[:, :, 4].amax(dim=0)
        out = concat_shards(mesh, out, "dp")                          # [P, C]
        j = 5 if extra is not None else 4
        res = (out[:, 0].to(torch.int32), out[:, 1], out[:, 2], out[:, 3],
               out[:, j:j + r_res], out[:, j + r_res:j + 2 * r_res])
        return res + ((out[:, 4],) if extra is not None else ())

    def core_scores_t(used, group_bits, resident_anti, assignment_l):
        free = cap - used
        fits = (lp.req[None, :, :] <= free[:, None, :] + _EPS).all(dim=-1)
        aff_req = lp.affinity_bits[None, :, :]
        affinity = ((group_bits[:, None, :] & aff_req)
                    == aff_req).all(dim=-1)
        anti = ((group_bits[:, None, :] & lp.anti_bits[None, :, :])
                == 0).all(dim=-1)
        sym = ((resident_anti[:, None, :] & lp.group_bit[None, :, :])
               == 0).all(dim=-1)
        bal = ((used[:, None, :] + lp.req[None, :, :])
               / cap_eps[:, None, :]).amax(dim=-1)
        ok = (static_okT & fits & affinity & anti & sym
              & (assignment_l == UNASSIGNED)[None, :])
        return torch.where(ok, rawT - w_bal * bal, NEG_INF)

    zone_work = mesh.flag(
        score_lib.spread_active(pods).any()
        | (pods.zaff_bits != 0).any() | (pods.zanti_bits != 0).any()
        | (state.az_anti != 0).any(), "zone_work")
    static_ok_pn = static_okT.T if zone_work else None

    def node_min(x):
        return mesh.reduce(x, "min", "tp")

    def overlay(sT, gz, az):
        if not zone_work:
            return sT
        spread_pen, spread_ok = score_lib.spread_terms_ungated(
            state, lp, cfg, gz, static_ok=static_ok_pn, node_min=node_min)
        zone_ok = score_lib.zone_affinity_ungated(state, lp, gz, az)
        return torch.where((spread_ok & zone_ok).T, sT - spread_pen.T,
                           NEG_INF)

    idx = torch.arange(p, dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, mask_b), dtype=torch.int32, device=dev)

    def accept(second_best, choice_x, feas_x, raw_sel, used_c, cap_c):
        """:func:`assign_parallel`'s ``accept`` over the whole proposal
        set, each contender's node read through ``used_c``/``cap_c``
        (its chosen node's rows) instead of a node-axis gather."""
        key = torch.where(feas_x, choice_x * p + rank, n * p + rank)
        perm = torch.argsort(key)
        group_id = key[perm] // p
        first = _segment_starts(group_id)
        req_sorted = req[perm]
        csum = _assoc_cumsum0(req_sorted)
        base = torch.where(first[:, None], csum - req_sorted, -float("inf"))
        seg_csum = csum - _cummax0(base)
        fits_cum = (seg_csum <= (cap_c - used_c)[perm] + _EPS).all(dim=-1)
        bal_after = ((used_c[perm] + seg_csum)
                     / cap_c.clamp_min(_EPS)[perm]).amax(dim=-1)
        adj_sorted = raw_sel[perm] - w_bal * bal_after
        stays_best = adj_sorted >= second_best[perm] - 1e-6
        seg2 = (group_id * 2)[:, None]
        gbp, abp = gb_planes[perm], ab_planes[perm]
        incl_gb = _cummax0(seg2 + gbp) - seg2
        incl_ab = _cummax0(seg2 + abp) - seg2
        excl_gb = torch.where(first[:, None], 0,
                              torch.cat([zero_row, incl_gb[:-1]])) >= 1
        excl_ab = torch.where(first[:, None], 0,
                              torch.cat([zero_row, incl_ab[:-1]])) >= 1
        pair_ok = (~(excl_ab & (gbp >= 1)).any(dim=1)
                   & ~(excl_gb & (abp >= 1)).any(dim=1))
        good = fits_cum & pair_ok & stays_best
        seg_start = _cummax0(torch.where(first, idx, -1))
        last_bad = _cummax0(torch.where(~good, idx, -1))
        prefix_ok = last_bad < seg_start
        out = torch.zeros((p,), dtype=torch.bool, device=dev)
        out[perm] = (first | prefix_ok) & (group_id < n)
        return out

    def seg_or_updates(choice_x, winner_x, group_bits, resident_anti):
        key = torch.where(winner_x, choice_x * p + rank, n * p + rank)
        perm = torch.argsort(key)
        group_id = key[perm] // p
        first = _segment_starts(group_id)
        node_sorted = group_id.clamp(0, n - 1)
        seg2 = (group_id * 2)[:, None]
        win_sorted = winner_x[perm].to(torch.int32)[:, None]
        or_gb = (_cummax0(seg2 + gb_planes[perm] * win_sorted) - seg2) >= 1
        or_ab = (_cummax0(seg2 + ab_planes[perm] * win_sorted) - seg2) >= 1
        last_of_seg = torch.cat([first[1:], torch.ones(
            (1,), dtype=torch.bool, device=dev)])
        seg_cols = local_rows(torch.where(last_of_seg & (group_id < n),
                                          node_sorted, n), off, ns)
        safe = seg_cols.clamp(0, ns - 1).long()
        new_group = _set_rows(group_bits, seg_cols,
                              group_bits[safe] | planes_to_words(or_gb))
        new_anti = _set_rows(resident_anti, seg_cols,
                             resident_anti[safe] | planes_to_words(or_ab))
        return new_group, new_anti

    def row_patch(sT, wnodes, used_x, group_x, anti_x, assignment_l):
        """The shard's rows among ``wnodes`` (global, ``n`` = none)
        recomputed and patched; the patch rows of other shards' nodes
        come back NEG_INF."""
        wl = local_rows(wnodes, off, ns)
        inside = wl < ns
        cc = wl.clamp(0, ns - 1).long()
        sub_used = used_x[cc]
        sub_cap = cap[cc]
        fits2 = (lp.req[None, :, :] <= (sub_cap - sub_used)[:, None, :]
                 + _EPS).all(dim=-1)
        gb = group_x[cc]
        ra = anti_x[cc]
        aff_req2 = lp.affinity_bits[None, :, :]
        affinity2 = ((gb[:, None, :] & aff_req2) == aff_req2).all(dim=-1)
        aok = ((gb[:, None, :] & lp.anti_bits[None, :, :])
               == 0).all(dim=-1)
        sym2 = ((ra[:, None, :] & lp.group_bit[None, :, :])
                == 0).all(dim=-1)
        bal = ((sub_used[:, None, :] + lp.req[None, :, :])
               / sub_cap.clamp_min(_EPS)[:, None, :]).amax(dim=-1)
        ok = (static_okT[cc] & fits2 & affinity2 & aok & sym2
              & (assignment_l == UNASSIGNED)[None, :]
              & inside[:, None])
        sub = torch.where(ok, rawT[cc] - w_bal * bal, NEG_INF)
        return _set_rows(sT, wl, sub), sub

    def local(x):
        return x[poff:poff + ps]

    def body(sT, used, group_bits, resident_anti, gz, az, assignment):
        s_ov = overlay(sT, gz, az)
        alive = (assignment == UNASSIGNED) & pods.pod_valid
        s_m = torch.where(local(alive)[None, :], s_ov, NEG_INF)
        choice, val, second_best, raw_sel, used_c, cap_c = argmax2(s_m,
                                                                   used)
        feasible = val > NEG_HALF
        winner = accept(second_best, choice, feasible, raw_sel, used_c,
                        cap_c)

        choice_l = choice.clamp(0, n - 1).long()
        zone_of = node_zone[choice_l]
        s_active = (winner & score_lib.spread_active(pods)
                    & (zone_of >= 0))
        zdim = state.gz_counts.shape[1]
        gzmax = state.gz_counts.shape[0] * zdim
        gz_id = torch.where(s_active, pods.group_idx * zdim + zone_of,
                            gzmax + rank)
        key2 = gz_id * p + rank
        perm2 = torch.argsort(key2)
        first2 = _segment_starts(key2[perm2] // p)
        keep = torch.zeros((p,), dtype=torch.bool, device=dev)
        keep[perm2] = first2
        winner = winner & keep
        zsame = (winner[:, None] & winner[None, :]
                 & (zone_of[:, None] == zone_of[None, :])
                 & (zone_of >= 0)[:, None])
        winner = winner & ~(zsame & zpair_conflict).any(dim=0)

        assignment_a = torch.where(winner, choice, assignment)
        used_a = scatter_add_rows_shard(used, choice, req, winner, off, n)
        group_a, anti_a = seg_or_updates(choice, winner, group_bits,
                                         resident_anti)
        wnodes_a = torch.where(winner, choice, n)
        s_patched, sub_a = row_patch(sT, wnodes_a, used_a, group_a, anti_a,
                                     local(assignment_a))

        if not zone_work and mesh.flag((~winner & feasible).any(),
                                       "second_chance"):
            s_b = _set_rows(sT, local_rows(wnodes_a, off, ns),
                            torch.full_like(sub_a, NEG_INF))
            alive_b = alive & ~winner
            s_bm = torch.where(local(alive_b)[None, :], s_b, NEG_INF)
            (choice_b, val_b, sb2, raw_b, used_cb, cap_cb,
             va_new) = argmax2(s_bm, used, extra=sub_a.amax(dim=0))
            feas_b = (val_b > NEG_HALF) & (val_b >= va_new - 1e-6)
            winner_b = accept(torch.maximum(sb2, va_new), choice_b, feas_b,
                              raw_b, used_cb, cap_cb)
            winner_m = winner | winner_b
            choice_m = torch.where(winner_b, choice_b, choice)
            new_assignment = torch.where(winner_m, choice_m, assignment)
            new_used = scatter_add_rows_shard(used_a, choice_b, req,
                                              winner_b, off, n)
            new_group, new_anti = seg_or_updates(choice_b, winner_b,
                                                 group_a, anti_a)
            wnodes_b = torch.where(winner_b, choice_b, n)
            new_sT, _ = row_patch(s_patched, wnodes_b, new_used, new_group,
                                  new_anti, local(new_assignment))
        else:
            winner_m, choice_m, new_assignment = winner, choice, assignment_a
            new_used, new_group, new_anti = used_a, group_a, anti_a
            new_sT = s_patched
        progress = winner_m.any()
        new_gz = add_zone_counts(gz, node_zone, pods.group_bit, choice_m,
                                 winner_m)
        zone_of_m = node_zone[choice_m.clamp(0, n - 1).long()]
        zmax = az.shape[0]
        zhot = (winner_m & (zone_of_m >= 0))[:, None] & (
            zone_of_m.clamp(0, zmax - 1)[:, None]
            == torch.arange(zmax, device=dev)[None, :])
        new_az = az | scatter_or_onehot(zhot, pods.zanti_bits)
        alive2 = (new_assignment == UNASSIGNED) & pods.pod_valid
        cont = progress & (torch.where(local(alive2)[None, :], new_sT,
                                       NEG_INF) > NEG_HALF).any()
        return (new_sT, new_used, new_group, new_anti, new_gz, new_az,
                new_assignment, cont)

    assignment = torch.full((p,), UNASSIGNED, dtype=torch.int32, device=dev)
    carry = (core_scores_t(state.used, state.group_bits,
                           state.resident_anti, local(assignment)),
             state.used, state.group_bits, state.resident_anti,
             state.gz_counts, state.az_anti, assignment)
    cont = (carry[0] > NEG_HALF).any()
    rounds = 0
    while mesh.flag(cont, "continue"):
        *carry, cont = body(*carry)
        rounds += 1
    assignment = torch.where(pods.pod_valid, carry[6], UNASSIGNED)
    if with_stats:
        return assignment, rounds
    return assignment


def assign_greedy_spmd(state: ClusterState, pods: PodBatch,
                       cfg: SchedulerConfig, mesh, static=None, *,
                       node_zone=None) -> torch.Tensor:
    """:func:`assign_greedy` as explicit SPMD over a ``(dp, tp)`` mesh,
    bit for bit; the arguments are :func:`assign_parallel_spmd`'s.  The
    rank's static tile is gathered over ``dp`` (every pod's row on the
    rank's nodes); per pod, in priority order, each rank scores its rows
    and the choice is the tp combine of :func:`assign_parallel_spmd`'s
    ``argmax2`` (max value, lowest global index), with the spread
    minimum a MIN all-reduce over ``tp`` for a spread-active pod."""
    p, ps, poff, ns, n, off = _mesh_geometry(state, pods, mesh)
    dev = state.device
    lp = shard_pods(pods, mesh.dp_index, mesh.dp)
    rawT, okT = _static_parts_spmd(state, lp, cfg, static, mesh)
    raw = concat_shards(mesh, rawT.T.contiguous(), "dp")              # [P, rows]
    static_ok = concat_shards(mesh, okT.T.contiguous(), "dp")
    if node_zone is None:
        node_zone = concat_shards(mesh, state.node_zone, "tp")
    w_bal = float(np.float32(cfg.weights.balance))
    w_spread = float(np.float32(cfg.weights.spread))
    order = torch.argsort(-pods.priority, stable=True)
    gmax, zmax = state.gz_counts.shape
    zone_l = state.node_zone
    has_zone = zone_l >= 0
    zrow = zone_l.clamp(0, zmax - 1).long()
    sact = score_lib.spread_active(pods)
    sact_host = sact.tolist()
    cap = state.cap.clamp_min(_EPS)
    node_ids = off + torch.arange(ns, device=dev)
    zone_ids = torch.arange(zmax, device=dev)
    used, group_bits, resident_anti = (state.used, state.group_bits,
                                       state.resident_anti)
    gz, az = state.gz_counts, state.az_anti
    nodes_sorted = []
    for i in order.tolist():
        req = pods.req[i]
        bal_row = ((used + req[None, :]) / cap).amax(dim=-1)
        fits = (req[None, :] <= state.cap - used + _EPS).all(dim=-1)
        aff = pods.affinity_bits[i][None, :]
        affinity = ((group_bits & aff) == aff).all(dim=-1)
        anti = ((group_bits & pods.anti_bits[i][None, :]) == 0).all(dim=-1)
        sym = ((resident_anti & pods.group_bit[i][None, :]) == 0).all(dim=-1)
        cz = gz[pods.group_idx[i].clamp(0, gmax - 1).long()]
        cnt = cz[zrow]
        elig = static_ok[i] & has_zone
        min_c = torch.where(elig, cnt, 2 ** 30).amin()
        if sact_host[i]:
            min_c = mesh.reduce(min_c, "min", "tp")
        skew_after = cnt + 1 - min_c
        maxskew = pods.spread_maxskew[i]
        hard = pods.spread_hard[i]
        violates = sact[i] & has_zone & (skew_after > maxskew)
        spread_ok = ~(violates & hard)
        excess = (skew_after - maxskew).clamp_min(0).to(torch.float32)
        pen = torch.where(violates & ~hard, w_spread * excess, 0.0)
        zwords = planes_to_words((gz > 0).T)
        pres = zwords[zrow]
        azn = az[zrow]
        zaff = pods.zaff_bits[i][None, :]
        zone_ok = (
            torch.where(has_zone, ((pres & zaff) == zaff).all(dim=-1),
                        (zaff == 0).all())
            & (~has_zone | ((pres & pods.zanti_bits[i][None, :])
                            == 0).all(dim=-1))
            & (~has_zone | ((azn & pods.group_bit[i][None, :])
                            == 0).all(dim=-1)))
        ok = (static_ok[i] & fits & affinity & anti & sym & spread_ok
              & zone_ok)
        row = torch.where(ok, raw[i] - w_bal * bal_row - pen, NEG_INF)
        best_l = row.amax()
        choice_l = torch.where(row == best_l, node_ids, n).amin()
        allp = mesh.gather(torch.stack([best_l, choice_l.to(torch.float32)]),
                           "tp")                                # [tp, 2]
        best = allp[:, 0].amax()
        choice = torch.where(allp[:, 0] == best, allp[:, 1],
                             float(n)).amin().to(torch.int64)
        feasible = best > NEG_HALF
        nodes_sorted.append(torch.where(feasible, choice, UNASSIGNED))
        placed = feasible & pods.pod_valid[i]
        hit = placed & (node_ids == choice)
        used = torch.where(hit[:, None], used + req[None, :], used)
        group_bits = torch.where(hit[:, None],
                                 group_bits | pods.group_bit[i][None, :],
                                 group_bits)
        resident_anti = torch.where(
            hit[:, None], resident_anti | pods.anti_bits[i][None, :],
            resident_anti)
        pzone = node_zone[choice.clamp(0, n - 1)]
        zhit = placed & (pzone >= 0) & (zone_ids == pzone)
        gplanes = bit_planes(pods.group_bit[i][None, :], torch.int32)[0]
        gz = gz + torch.where(zhit[None, :], gplanes[:, None], 0)
        az = torch.where(zhit[:, None], az | pods.zanti_bits[i][None, :], az)
    assignment = torch.full((p,), UNASSIGNED, dtype=torch.int32, device=dev)
    if nodes_sorted:
        assignment[order] = torch.stack(nodes_sorted).to(torch.int32)
    return torch.where(pods.pod_valid, assignment, UNASSIGNED)


def schedule_batch(state: ClusterState, pods: PodBatch, cfg: SchedulerConfig,
                   method: str = "parallel"):
    """Score + assign + commit: returns ``(assignment, new_state)``."""
    if method == "greedy":
        assignment = assign_greedy(state, pods, cfg)
    elif method == "parallel":
        assignment = assign_parallel(state, pods, cfg)
    else:
        raise ValueError(f"unknown method {method!r}")
    return assignment, commit_assignments(state, pods, assignment)


def _assign_with_rounds(state: ClusterState, pods: PodBatch,
                        cfg: SchedulerConfig, static, method: str):
    if method == "greedy":
        return assign_greedy(state, pods, cfg, static), 1
    if method == "parallel":
        return assign_parallel(state, pods, cfg, static, with_stats=True)
    raise ValueError(f"unknown method {method!r}")


def fused_schedule_step(state: ClusterState, pods: PodBatch,
                        cfg: SchedulerConfig, static=None,
                        method: str = "parallel",
                        with_digest: bool = False):
    """The whole per-batch scheduling decision as one call: score +
    conflict resolution + usage commit.  Returns ``(new_state,
    assignment i32[P], rounds)``, plus with ``with_digest`` the committed
    state's per-plane digest (``integrity.plane_digest_vector``, int32
    bits of ``u32[len(PLANES)]``) as a fourth output.  Results equal
    :func:`schedule_batch`'s exactly (the same assigner and commit run
    inside).  ``static`` is the backend prep from
    :func:`~.tiled_score.compute_assign_static`.

    torch has no buffer donation.  The new state shares every plane the
    commit does not touch (the N×N ``lat``/``bw`` among them) with the
    input, uncopied; the input stays valid, and a caller must not rely
    on it being consumed."""
    assignment, rounds = _assign_with_rounds(state, pods, cfg, static,
                                             method)
    new_state = commit_assignments(state, pods, assignment)
    if with_digest:
        return new_state, assignment, rounds, plane_digest_vector(new_state)
    return new_state, assignment, rounds


def fused_schedule_window(state: ClusterState, pods_window: PodBatch,
                          cfg: SchedulerConfig, static=None,
                          method: str = "parallel"):
    """K fused per-batch steps in one call: ``pods_window`` is a
    :class:`~.state.PodBatch` whose every field carries a leading window
    axis ``[K, P, ...]``; each step is the :func:`fused_schedule_step`
    body with the committed state threaded into the next.  Returns
    ``(new_state, assignment i32[K, P], rounds i32[K])``.  Peers are node
    indices, already resolved.  The untouched planes are shared with the
    input, as in :func:`fused_schedule_step`."""
    if method not in ("greedy", "parallel"):
        raise ValueError(f"unknown method {method!r}")
    assignments, rounds = [], []
    for k in range(pods_window.req.shape[0]):
        batch = PodBatch(**{f.name: getattr(pods_window, f.name)[k]
                            for f in dataclasses.fields(PodBatch)})
        a, r = _assign_with_rounds(state, batch, cfg, static, method)
        state = commit_assignments(state, batch, a)
        assignments.append(a)
        rounds.append(r)
    return (state, torch.stack(assignments),
            torch.tensor(rounds, dtype=torch.int32, device=state.device))
