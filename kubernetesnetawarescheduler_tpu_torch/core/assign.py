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
    host_flag,
    planes_to_words,
    scatter_add_rows,
    scatter_or_onehot,
)

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
    sync for its continue test)."""
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
        | (state.az_anti != 0).any())
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
        if not zone_work and host_flag((~winner & feasible).any()):
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
    cont = (carry[0] > NEG_HALF).any()
    rounds = 0
    while host_flag(cont):
        *carry, cont = body(*carry)
        rounds += 1
    assignment = torch.where(pods.pod_valid, carry[6], UNASSIGNED)
    if with_stats:
        return assignment, rounds
    return assignment


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
