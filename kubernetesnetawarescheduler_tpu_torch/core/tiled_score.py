"""Host side of the tiled score kernels (``score_backend="pallas"``).

The counterpart of ``kubernetesnetawarescheduler_tpu/core/pallas_score.py``
minus the kernels themselves, which live in :mod:`.kernels`.  This module
computes what the kernels take — the normalizers and ``params`` once per
replay (or patched from the encoder's dirty footprint), the pod side per
batch — and joins the constraints that stay outside the kernels (soft
zone term, nodeAffinity and zone masks, and topology spread behind its
gate), exactly where the JAX package joins them.  The fused winner
(:func:`score_winner_tiled`) takes the winner kernel only when none of
those joins is live.

The Pallas packing layouts (``podf``/``podi``/``nodef``/``nodei``) exist
for TPU BlockSpecs and are not copied: the CUDA kernels read the state's
own row-major tensors, and mask their ragged edges themselves, so no
O(N²) padded copy of ``bw``/``lat`` is ever made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import score as score_lib
from kubernetesnetawarescheduler_tpu_torch.core.kernels import (
    PodPack,
    StaticPack,
    masked_tile_scores,
    static_tile_scores,
    static_tile_scores_lanes,
    winner_tile_scores,
)
from kubernetesnetawarescheduler_tpu_torch.core.score import NEG_INF, _EPS
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    PodBatch,
    host_flag,
    index_tree,
    stack_trees,
)


def static_tile_inputs(state: ClusterState, cfg: SchedulerConfig):
    """The tiled kernels' batch-invariant prep: ``(base f32[N], bw_max,
    lat_max)`` — the metric vote and the global normalizers, without
    materializing ``C``."""
    base = score_lib.metric_scores(state, cfg)
    bw_max, lat_max = score_lib.net_normalizers(state.lat, state.bw,
                                                state.node_valid)
    return base, bw_max, lat_max


def kernel_params(cfg: SchedulerConfig, bw_max: torch.Tensor,
                  lat_max: torch.Tensor) -> torch.Tensor:
    """``params f32[8]``: wbw, wlat, 1/bw_max, 1/lat_max, wbal, eps,
    wsoft, row_offset.  The row offset (global node index of output row
    0) is 0 on one device; a row-sharded caller sets its shard's."""
    w = cfg.weights
    dev = bw_max.device

    def f(x):
        return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                            device=dev)

    return torch.stack([
        f(w.peer_bw), f(w.peer_lat), 1.0 / bw_max, 1.0 / lat_max,
        f(w.balance), f(_EPS), f(w.soft_affinity / 100.0), f(0)])


def static_replay_pack(state: ClusterState, cfg: SchedulerConfig,
                       inputs=None) -> StaticPack:
    """Batch-invariant kernel inputs, computed ONCE per replay: params
    (weights and global normalizers), the metric vote and the static node
    planes, over ``state``'s own tensors (no copy of the N×N matrices).
    Everything placements can change is left out; per batch only the pod
    side and the group-bits rows are handed over.  ``inputs`` is an
    optional precomputed :func:`static_tile_inputs`."""
    base, bw_max, lat_max = (static_tile_inputs(state, cfg)
                             if inputs is None else inputs)
    validf = state.node_valid.to(torch.float32)
    return StaticPack(
        params=kernel_params(cfg, bw_max, lat_max),
        bw=state.bw.contiguous(), lat=state.lat.contiguous(),
        validk=validf, base=base.contiguous(), node_valid=validf,
        taint=state.taint_bits.contiguous(),
        label=state.label_bits.contiguous())


def pack_pods(pods: PodBatch, num_nodes: int) -> PodPack:
    """The per-batch pod side of the kernels: the dense traffic matrix
    and the pod planes, with each soft term's weight zeroed where its
    bits are empty."""
    sel_w = torch.where((pods.soft_sel_bits != 0).any(dim=-1),
                        pods.soft_sel_w, 0.0)
    grp_w = torch.where((pods.soft_grp_bits != 0).any(dim=-1),
                        pods.soft_grp_w, 0.0)
    return PodPack(
        t=score_lib.peer_traffic_matrix(pods, num_nodes),
        req=pods.req.contiguous(),
        pod_valid=pods.pod_valid.to(torch.float32),
        tol=pods.tol_bits.contiguous(), sel=pods.sel_bits.contiguous(),
        affinity=pods.affinity_bits.contiguous(),
        anti=pods.anti_bits.contiguous(),
        group_bit=pods.group_bit.contiguous(),
        soft_sel=pods.soft_sel_bits.contiguous(),
        soft_grp=pods.soft_grp_bits.contiguous(),
        soft_sel_w=sel_w.contiguous(), soft_grp_w=grp_w.contiguous())


def static_scores_tiled(state: ClusterState, pods: PodBatch,
                        cfg: SchedulerConfig,
                        static: StaticPack | None = None,
                        transposed: bool = False):
    """``(raw f32[P, N], static_ok bool[P, N])`` for the assign path —
    node-major ``[N, P]`` with ``transposed`` — from the static kernel,
    plus the joins kept outside it: the soft zone term and the hard
    nodeAffinity mask (both self-gated).  Capacity, groups and balance
    stay with the conflict loop, which recomputes them per round."""
    if static is None:
        static = static_replay_pack(state, cfg)
    raw, ok = static_tile_scores(static, state.group_bits.contiguous(),
                                 pack_pods(pods, state.num_nodes),
                                 cfg.use_bfloat16, transposed=transposed)
    raw = raw + score_lib.soft_zone_scores(state, pods, cfg,
                                           transposed=transposed)
    ok = ok & score_lib.ns_affinity_ok(state, pods, transposed=transposed)
    return raw, ok


def static_scores_tiled_lanes(states: ClusterState, pods: PodBatch,
                              cfg: SchedulerConfig,
                              statics: StaticPack | None = None,
                              transposed: bool = False):
    """:func:`static_scores_tiled` over a leading lane axis (``states``,
    ``pods`` and ``statics`` stacked ``[K, ...]``): ONE lane launch of
    the static kernel for every lane (JAX vmaps ``_static_pallas_call``,
    which adds a grid dimension), then each lane's soft zone term and
    nodeAffinity mask, self-gated as on the solo path.  Returns ``(raw
    f32[K, P, N], static_ok bool[K, P, N])``, node-major ``[K, N, P]``
    with ``transposed``; lane ``k`` equals :func:`static_scores_tiled`
    on lane ``k`` bit for bit."""
    k_lanes = pods.req.shape[0]
    n = states.metrics.shape[1]
    lanes = [(index_tree(states, k), index_tree(pods, k))
             for k in range(k_lanes)]
    if statics is None:
        statics = stack_trees([static_replay_pack(st, cfg)
                               for st, _ in lanes])
    raw, ok = static_tile_scores_lanes(
        statics, states.group_bits.contiguous(),
        stack_trees([pack_pods(pd, n) for _, pd in lanes]),
        cfg.use_bfloat16, transposed=transposed)
    raws = [raw[k] + score_lib.soft_zone_scores(st, pd, cfg,
                                                transposed=transposed)
            for k, (st, pd) in enumerate(lanes)]
    oks = [ok[k] & score_lib.ns_affinity_ok(st, pd, transposed=transposed)
           for k, (st, pd) in enumerate(lanes)]
    return torch.stack(raws), torch.stack(oks)


def _masked_kernel_args(state: ClusterState, pods: PodBatch,
                        cfg: SchedulerConfig, static=None) -> tuple:
    """What the masked and the winner kernel take, in their wrappers'
    argument order."""
    return (static_replay_pack(state, cfg, static), state.used.contiguous(),
            state.cap.contiguous(), state.group_bits.contiguous(),
            state.resident_anti.contiguous(),
            pack_pods(pods, state.num_nodes), cfg.use_bfloat16)


def score_pods_tiled(state: ClusterState, pods: PodBatch,
                     cfg: SchedulerConfig, static=None) -> torch.Tensor:
    """Masked score matrix ``f32[P, N]`` from the masked kernel — the
    same contract as :func:`~.score.score_pods`.  ``static`` is an
    optional precomputed :func:`static_tile_inputs`.  The soft zone term,
    the nodeAffinity and zone masks and topology spread join outside the
    kernel; spread (and the static-mask recompute it needs) only when
    some pod carries a spread constraint."""
    out = masked_tile_scores(*_masked_kernel_args(state, pods, cfg, static))
    # The additive soft term cannot resurrect a masked entry: NEG_INF is
    # -1e30 and weights are O(10).
    out = out + score_lib.soft_zone_scores(state, pods, cfg)
    out = torch.where(score_lib.ns_affinity_ok(state, pods), out, NEG_INF)
    out = torch.where(score_lib.zone_affinity_ok(state, pods), out, NEG_INF)
    if host_flag(score_lib.spread_active(pods).any()):
        spread_pen, spread_ok = score_lib.spread_terms(
            state, pods, cfg,
            static_ok=score_lib.static_feasibility(state, pods))
        out = torch.where(spread_ok, out - spread_pen, NEG_INF)
    return out


def winner_joins_active(state: ClusterState, pods: PodBatch) -> bool:
    """Is any constraint that :func:`score_pods_tiled` joins OUTSIDE the
    tile kernel live for this (state, batch)?  The in-kernel winner is
    exact only when every out-of-kernel join is a no-op (soft zone adds
    zeros, the ns/zone masks are all-true, spread is inactive); when one
    is live the winner is taken after the joins, by the two-stage path.
    Each predicate mirrors its join's own gate in :mod:`.score`.  One
    host sync (:func:`~.state.host_flag`), the port's ``lax.cond``."""
    return host_flag((pods.soft_zone_bits != 0).any()
                     | pods.ns_term_used.any()
                     | (pods.zaff_bits != 0).any()
                     | (pods.zanti_bits != 0).any()
                     | (state.az_anti != 0).any()
                     | score_lib.spread_active(pods).any())


def score_winner_tiled(state: ClusterState, pods: PodBatch,
                       cfg: SchedulerConfig, static=None):
    """Fused winner selection: ``(best f32[P], node i32[P])`` with
    ``node == -1`` for infeasible rows, equal to
    ``score.winner_from_scores(score_pods_tiled(...))`` (tie-breaks
    included).  With no out-of-kernel join live it launches the winner
    kernel, which writes 8 bytes per pod instead of the ``[P, N]``
    score plane; otherwise it takes the two-stage path.  ``static`` is an
    optional precomputed :func:`static_tile_inputs`."""
    if winner_joins_active(state, pods):
        return score_lib.winner_from_scores(
            score_pods_tiled(state, pods, cfg, static))
    return winner_tile_scores(*_masked_kernel_args(state, pods, cfg, static))


def compute_static(state: ClusterState, cfg: SchedulerConfig):
    """Backend-appropriate batch-invariant prep for
    :func:`score_pods_auto` (depends only on metrics, network and
    validity, never on placements)."""
    if cfg.score_backend == "pallas":
        return static_tile_inputs(state, cfg)
    return score_lib.static_node_scores(state, cfg)


def compute_assign_static(state: ClusterState, cfg: SchedulerConfig):
    """Backend-appropriate batch-invariant prep for the assign/replay
    path: the dense ``(base, C.T)`` pair, or the kernels'
    :class:`~.kernels.StaticPack`."""
    if cfg.score_backend == "pallas":
        return static_replay_pack(state, cfg)
    return score_lib.static_node_scores(state, cfg)


def static_replay_pack_delta(state: ClusterState, cfg: SchedulerConfig,
                             prev: StaticPack, ex: score_lib.NetExtrema,
                             ii: np.ndarray, jj: np.ndarray):
    """Delta rebuild of :func:`static_replay_pack`, equal field by field
    to the full path: returns ``(pack, extrema)``.  Preconditions: since
    ``prev`` was packed only net elements ``(ii, jj)`` changed and
    topology/validity did not.  ``base`` (O(N·M)) is recomputed and the
    normalizers come from the updated extrema into ``params``; a moved
    normalizer costs no O(N²) work, since the pack holds the raw
    ``bw``/``lat``.  Those are the snapshot's own tensors, which the
    encoder already patched out of place at the dirty pairs, so the pack
    takes them as they are (no copy, and ``prev`` stays readable)."""
    ex2 = score_lib.net_extrema_update(state, ex, ii, jj)
    bw_max, lat_max = score_lib.extrema_normalizers(ex2, state.device)
    return dataclasses.replace(
        prev, params=kernel_params(cfg, bw_max, lat_max),
        bw=state.bw.contiguous(), lat=state.lat.contiguous(),
        base=score_lib.metric_scores(state, cfg).contiguous()), ex2


def compute_assign_static_incremental(state: ClusterState,
                                      cfg: SchedulerConfig, prev,
                                      ex: score_lib.NetExtrema | None,
                                      dirty: dict | None):
    """Incremental :func:`compute_assign_static`: returns ``(static,
    extrema)``, patching ``prev`` when the dirty footprint permits and
    rebuilding otherwise.

    ``dirty`` is the merged descriptor from
    ``Encoder.static_delta_since`` (None = coverage unprovable).  A full
    rebuild runs with no previous value, no descriptor, any topology
    dirt (validity changes every mask and both normalizers), or a
    whole-group net rewrite.  Metrics-only dirt recomputes just the
    O(N·M) base; net pair dirt takes the O(|dirty|) patch path."""
    pairs = None if dirty is None else dirty.get("net_pairs")
    if (prev is None or ex is None or dirty is None
            or dirty.get("topo")
            or (dirty.get("net") and pairs is None)):
        return (compute_assign_static(state, cfg),
                score_lib.net_extrema_scan(state))
    if pairs:
        srt = sorted(pairs)
        ii = np.array([p[0] for p in srt], np.int32)
        jj = np.array([p[1] for p in srt], np.int32)
    else:
        ii = jj = np.zeros(0, np.int32)
    if cfg.score_backend == "pallas":
        return static_replay_pack_delta(state, cfg, prev, ex, ii, jj)
    return score_lib.static_node_scores_delta(state, cfg, prev, ex, ii, jj)


def score_winner_auto(state: ClusterState, pods: PodBatch,
                      cfg: SchedulerConfig, static=None):
    """Backend dispatch for the fused winner (:func:`score_pods_auto`'s
    twin): ``(best f32[P], node i32[P])``, ``node == -1`` infeasible.
    ``static`` is an optional precomputed :func:`compute_static`.  With
    ``cfg.enable_winner_fusion`` off the two-stage score → winner path
    runs instead, with the same results."""
    if not cfg.enable_winner_fusion:
        return score_lib.winner_from_scores(
            score_pods_auto(state, pods, cfg, static))
    if cfg.score_backend == "pallas":
        return score_winner_tiled(state, pods, cfg, static)
    return score_lib.score_winner(state, pods, cfg, static)


def score_pods_auto(state: ClusterState, pods: PodBatch,
                    cfg: SchedulerConfig, static=None) -> torch.Tensor:
    """Dispatch on ``cfg.score_backend``: the dense torch path or the
    masked tile kernel.  ``static`` is an optional precomputed
    :func:`compute_static`."""
    if cfg.score_backend == "pallas":
        return score_pods_tiled(state, pods, cfg, static)
    return score_lib.score_pods(state, pods, cfg, static)
