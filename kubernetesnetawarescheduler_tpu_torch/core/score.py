"""The dense score/filter path: batched pod x node scoring in torch.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/core/score.py``
(``score_backend="xla"``).  For a batch of ``P`` pods against ``N`` nodes:

    score[p, n] = metric_score[n]                    (continuous vote)
                + (T @ C)[p, n]                      (network cost)
                + soft[p, n]                         (preferred affinity)
                - w_balance * worst_fit[p, n]        (soft bin packing)
                - spread_penalty[p, n]
                + (-inf where infeasible)            (batched masks)

``T[P, N]`` is the per-pod traffic-to-node matrix and ``C[N, N] = w_bw *
bw_norm - w_lat * lat_norm`` the pairwise network desirability, with
its diagonal pinned to the loopback optimum ``w_bw``.

The JAX package gates its optional constraint blocks with ``lax.cond``;
here each gate is a Python ``if`` on a scalar (one host sync on the
card, counted by :func:`~.state.host_flag`).  The scorers take an
optional weight vector ``wvec`` (:func:`weights_vector`), a tensor that
replaces every ``cfg.weights`` constant of the expression — the policy
layer's counterfactual re-scoring seam; ``None`` keeps the constants.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import (
    GOODNESS,
    SchedulerConfig,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    ClusterState,
    PodBatch,
    concat_shards,
    exact_matmul,
    host_flag,
    planes_to_words,
)

# The f32 value of -1e30 (as a Python float, so torch compares and fills
# in f32 with the exact same value the JAX package uses).
NEG_INF = float(np.float32(-1e30))
NEG_HALF = float(np.float32(-1e30) * np.float32(0.5))
_EPS = 1e-9

# Canonical order of the flat weight vector the scoring functions
# optionally accept (``wvec``): the ScoreWeights field order, which
# policy/model.WEIGHT_FIELDS mirrors.
WVEC_FIELDS = ("cpu", "mem", "net_tx", "net_rx", "bandwidth", "disk",
               "peer_bw", "peer_lat", "balance", "soft_affinity",
               "spread")


def weights_vector(weights) -> np.ndarray:
    """Flatten a :class:`ScoreWeights` into the canonical ``f32[11]``
    vector the ``wvec`` arguments below take (as a tensor on the
    state's device).  ``weights_vector(cfg.weights)`` gives the same
    bits as ``wvec=None``."""
    return np.asarray([float(getattr(weights, f))
                       for f in WVEC_FIELDS], np.float32)


def normalize_metrics(metrics: torch.Tensor, node_valid: torch.Tensor,
                      goodness: torch.Tensor) -> torch.Tensor:
    """Min-max normalize each metric channel over valid nodes to [0, 1],
    flipped so that 1.0 is always "best"."""
    valid = node_valid[:, None]
    big = float(np.float32(3.4e38))
    lo = torch.where(valid, metrics, big).amin(dim=0)
    hi = torch.where(valid, metrics, -big).amax(dim=0)
    span = (hi - lo).clamp_min(_EPS)
    unit = ((metrics - lo[None, :]) / span[None, :]).clamp(0.0, 1.0)
    flipped = torch.where(goodness[None, :] > 0, unit, 1.0 - unit)
    return torch.where(valid, flipped, 0.0)


def metric_scores(state: ClusterState, cfg: SchedulerConfig,
                  wvec: torch.Tensor | None = None) -> torch.Tensor:
    """Pod-independent per-node score ``f32[N]``: the weighted continuous
    vote over normalized metrics, decayed toward 0.5 by staleness, with
    nodes below ``cfg.stale_conf_floor`` confidence left out of the
    normalization span.  ``wvec`` replaces ``cfg.weights``."""
    dev = state.device
    extra = (0.0,) * (cfg.num_metrics - len(GOODNESS))
    goodness = torch.tensor(GOODNESS + extra, dtype=torch.float32,
                            device=dev)
    if wvec is None:
        w = torch.tensor(cfg.weights.metric_vector() + extra,
                         dtype=torch.float32, device=dev)
    else:
        w = torch.nn.functional.pad(
            wvec[:len(GOODNESS)].to(torch.float32), (0, len(extra)))
    conf = torch.exp(-state.metrics_age / cfg.staleness_tau_s)
    span_valid = state.node_valid & (conf > cfg.stale_conf_floor)
    norm = normalize_metrics(state.metrics, span_valid, goodness)
    blended = conf[:, None] * norm + (1.0 - conf[:, None]) * 0.5
    score = exact_matmul(blended, w)
    return torch.where(state.node_valid, score, 0.0)


def peer_traffic_matrix(pods: PodBatch, num_nodes: int) -> torch.Tensor:
    """Scatter the ragged peer lists into a dense ``T[P, N]`` traffic
    matrix (peers with index -1 or >= N are dropped).  Duplicate peers on
    one node add in peer-slot order, on every device: the sum is built
    slot by slot instead of with an atomic scatter."""
    p, k = pods.peers.shape
    valid = (pods.peers >= 0) & pods.pod_valid[:, None]
    traffic = torch.where(valid, pods.peer_traffic, 0.0)
    peers = torch.where(valid, pods.peers, -1)
    cols = torch.arange(num_nodes, device=peers.device)[None, :]
    t = torch.zeros((p, num_nodes), dtype=torch.float32,
                    device=peers.device)
    for j in range(k):
        t = t + torch.where(peers[:, j, None] == cols,
                            traffic[:, j, None], 0.0)
    return t


def net_normalizers(lat: torch.Tensor, bw: torch.Tensor,
                    node_valid: torch.Tensor):
    """``(bw_max, lat_max)``: the maxima over valid pairs, clamped at
    ``_EPS`` (0-d f32 tensors)."""
    pair_valid = node_valid[:, None] & node_valid[None, :]
    bw_max = torch.where(pair_valid, bw, 0.0).amax().clamp_min(_EPS)
    lat_max = torch.where(pair_valid, lat, 0.0).amax().clamp_min(_EPS)
    return bw_max, lat_max


def net_desirability(lat: torch.Tensor, bw: torch.Tensor,
                     node_valid: torch.Tensor, w_bw, w_lat) -> torch.Tensor:
    """``C[N, N] = w_bw * bw_norm - w_lat * lat_norm`` over valid pairs,
    diagonal pinned to ``w_bw`` (co-located endpoints talk over
    loopback, which no physical link beats).  The weights are Python
    floats or 0-d f32 tensors."""
    pair_valid = node_valid[:, None] & node_valid[None, :]
    bw_max, lat_max = net_normalizers(lat, bw, node_valid)
    c = w_bw * bw / bw_max - w_lat * lat / lat_max
    eye = torch.eye(lat.shape[0], dtype=torch.bool, device=lat.device)
    diag = (w_bw.to(torch.float32) if torch.is_tensor(w_bw)
            else float(np.float32(w_bw)))
    c = torch.where(eye, diag, c)
    return torch.where(pair_valid, c, 0.0)


def net_cost_matrix(state: ClusterState, cfg: SchedulerConfig,
                    wvec: torch.Tensor | None = None) -> torch.Tensor:
    """The network desirability matrix of ``state`` under ``cfg``'s
    weights, or ``wvec``'s (:func:`net_desirability`)."""
    if wvec is None:
        w_bw, w_lat = cfg.weights.peer_bw, cfg.weights.peer_lat
    else:
        w_bw, w_lat = wvec[6], wvec[7]
    return net_desirability(state.lat, state.bw, state.node_valid,
                            w_bw, w_lat)


def _use_bf16(cfg: SchedulerConfig, device: torch.device) -> bool:
    """The dense path rounds to bf16 only where the JAX package would use
    it natively: ``cfg.use_bfloat16`` on the accelerator (a CUDA device
    here), never on the CPU."""
    return cfg.use_bfloat16 and device.type == "cuda"


def prep_net_matrix(c: torch.Tensor, cfg: SchedulerConfig) -> torch.Tensor:
    """Transpose (and, in bf16 mode on the card, round to bf16) the
    desirability matrix into the layout the score product consumes.
    Done once per replay, not per batch."""
    ct = c.T.contiguous()
    return ct.to(torch.bfloat16) if _use_bf16(cfg, c.device) else ct


def static_node_scores(state: ClusterState, cfg: SchedulerConfig,
                       wvec: torch.Tensor | None = None):
    """The two batch-invariant score ingredients: the metric vote
    ``base f32[N]`` and the prepared ``C.T``."""
    return (metric_scores(state, cfg, wvec=wvec),
            prep_net_matrix(net_cost_matrix(state, cfg, wvec=wvec), cfg))


class NetExtrema(NamedTuple):
    """Host-side running normalizers of :func:`net_cost_matrix`: the
    masked maxima of ``bw``/``lat`` over valid pairs BEFORE the ``_EPS``
    clamp, plus the flat index of a pair currently holding each maximum.
    As long as the holder pair is not dirtied, a running ``max(old,
    dirty max)`` equals a full re-scan; only a dirtied holder can make
    the true maximum retreat, which forces a re-scan."""
    bw_m: float
    lat_m: float
    bw_arg: int
    lat_arg: int


def net_extrema_scan(state: ClusterState) -> NetExtrema:
    """Full O(N²) extrema scan (device reduce, host scalars).  The
    float() round trip through f64 is exact for f32 values, so the
    scalars rebuild the identical normalizers on the device."""
    pv = state.node_valid[:, None] & state.node_valid[None, :]
    bwm = torch.where(pv, state.bw, 0.0).reshape(-1)
    latm = torch.where(pv, state.lat, 0.0).reshape(-1)
    bi = int(torch.argmax(bwm))
    li = int(torch.argmax(latm))
    return NetExtrema(float(bwm[bi]), float(latm[li]), bi, li)


def net_extrema_update(state: ClusterState, ex: NetExtrema,
                       ii: np.ndarray, jj: np.ndarray) -> NetExtrema:
    """:class:`NetExtrema` after only pairs ``(ii, jj)`` of ``bw``/``lat``
    changed.  Equal to :func:`net_extrema_scan` in the max VALUES (the
    tracked holder may differ from argmax's first index, which only
    decides when a later re-scan triggers, never the normalizers)."""
    if len(ii) == 0:
        return ex
    n = state.bw.shape[0]
    flat = ii.astype(np.int64) * n + jj.astype(np.int64)
    dirty = set(flat.tolist())
    dev = state.device
    iid = torch.from_numpy(ii.astype(np.int64)).to(dev)
    jjd = torch.from_numpy(jj.astype(np.int64)).to(dev)
    pv = state.node_valid[iid] & state.node_valid[jjd]
    vb = torch.where(pv, state.bw[iid, jjd], 0.0)
    vl = torch.where(pv, state.lat[iid, jjd], 0.0)

    def one(m, arg, vals):
        if arg in dirty:
            return None  # holder dirtied: the max may have retreated
        k = int(torch.argmax(vals))
        v = float(vals[k])
        return (v, int(flat[k])) if v > m else (m, arg)

    nb = one(ex.bw_m, ex.bw_arg, vb)
    nl = one(ex.lat_m, ex.lat_arg, vl)
    if nb is None or nl is None:
        full = net_extrema_scan(state)
        return NetExtrema(full.bw_m if nb is None else nb[0],
                          full.lat_m if nl is None else nl[0],
                          full.bw_arg if nb is None else nb[1],
                          full.lat_arg if nl is None else nl[1])
    return NetExtrema(nb[0], nl[0], nb[1], nl[1])


def extrema_normalizers(ex: NetExtrema, dev: torch.device):
    """``(bw_max, lat_max)`` as :func:`net_normalizers` returns them (0-d
    f32, clamped at ``_EPS``), from host extrema instead of a scan."""
    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=dev).clamp_min(
            _EPS)

    return f(ex.bw_m), f(ex.lat_m)


def static_node_scores_delta(state: ClusterState, cfg: SchedulerConfig,
                             prev, ex: NetExtrema, ii: np.ndarray,
                             jj: np.ndarray):
    """Delta rebuild of :func:`static_node_scores`, bit-identical to the
    full path: returns ``((base, C.T), extrema)``.

    Preconditions: since ``prev`` was built, only net elements
    ``(ii, jj)`` changed (both orientations listed) and topology and
    validity did not.  ``base`` is O(N·M) and recomputed outright.  When
    a normalizer MOVES every element of ``C`` rescales, so the matrix is
    rebuilt; otherwise only the dirty elements of ``C.T`` are patched,
    out of place (``prev`` stays readable)."""
    base = metric_scores(state, cfg)
    ex2 = net_extrema_update(state, ex, ii, jj)
    if ex2.bw_m != ex.bw_m or ex2.lat_m != ex.lat_m:
        return (base, prep_net_matrix(net_cost_matrix(state, cfg),
                                      cfg)), ex2
    _, ct = prev
    if len(ii) == 0:
        return (base, ct), ex2
    dev = state.device
    iid = torch.from_numpy(ii.astype(np.int64)).to(dev)
    jjd = torch.from_numpy(jj.astype(np.int64)).to(dev)
    bw_max, lat_max = extrema_normalizers(ex2, dev)
    w = cfg.weights
    # The same expression as net_desirability, element by element.
    vals = (w.peer_bw * state.bw[iid, jjd] / bw_max
            - w.peer_lat * state.lat[iid, jjd] / lat_max)
    vals = torch.where(iid == jjd, float(np.float32(w.peer_bw)), vals)
    pv = state.node_valid[iid] & state.node_valid[jjd]
    vals = torch.where(pv, vals, 0.0)
    # prev holds C.T: element (i, j) of C lives at (j, i).
    return (base, ct.index_put((jjd, iid), vals.to(ct.dtype))), ex2


def network_scores(state: ClusterState, pods: PodBatch,
                   cfg: SchedulerConfig, ct: torch.Tensor | None = None,
                   transposed: bool = False) -> torch.Tensor:
    """Pod-aware network term ``f32[P, N]`` (``[N, P]`` with
    ``transposed=True``).

    Two algebraically identical forms, picked by shape as in the JAX
    package: a peer gather (``K * 16 <= N``: ``net[p] = Σ_k traffic[p, k]
    · C.T[node(k)]``, O(P·K·N)) or the dense product ``T @ C.T``.  In bf16
    mode the product takes bf16-rounded inputs and accumulates in f32."""
    if ct is None:
        ct = prep_net_matrix(net_cost_matrix(state, cfg), cfg)
    n = ct.shape[0]
    k = pods.peers.shape[1]
    if k * 16 <= n:
        valid = (pods.peers >= 0) & pods.pod_valid[:, None]
        safe = torch.where(valid, pods.peers, 0).long()
        traffic = torch.where(valid, pods.peer_traffic, 0.0)
        rows = ct[safe].to(torch.float32)                    # [P, K, N]
        net = torch.einsum("pk,pkn->pn", traffic, rows)
        return net.T if transposed else net
    t = peer_traffic_matrix(pods, n)
    if ct.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16)
    net = exact_matmul(t.to(torch.float32), ct.to(torch.float32))
    return net.T if transposed else net


def _soft_scale(cfg: SchedulerConfig, wvec: torch.Tensor | None):
    """The soft-affinity scale, ``soft_affinity / 100``, as the JAX
    package writes it: rounded once from the constant, or divided in
    f32 from ``wvec``."""
    if wvec is None:
        return float(np.float32(cfg.weights.soft_affinity / 100.0))
    return wvec[9] / 100.0


def soft_affinity_scores(state: ClusterState, pods: PodBatch,
                         cfg: SchedulerConfig,
                         transposed: bool = False,
                         wvec: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted preferred-affinity term ``f32[P, N]`` (``[N, P]``
    transposed): node-label terms (bonus where ALL the term's labels are
    present; empty terms add nothing) and resident-group terms (bonus on
    ANY overlap with ``group_bits``), scaled by ``soft_affinity / 100``,
    plus the zone-scoped term of :func:`soft_zone_scores`.  Skipped when
    no pod carries a term."""
    p = pods.pod_valid.shape[0]
    n = state.node_valid.shape[0]
    shape = (n, p) if transposed else (p, n)
    pred = ((pods.soft_sel_bits != 0).any()
            | (pods.soft_grp_bits != 0).any())
    if host_flag(pred):
        lb = state.label_bits[None, None, :, :]              # [1, 1, N, W]
        sb = pods.soft_sel_bits[:, :, None, :]               # [P, T, 1, W]
        label_match = ((lb & sb) == sb).all(dim=-1)          # [P, T, N]
        nonempty = (pods.soft_sel_bits != 0).any(dim=-1)     # [P, T]
        label_term = torch.where(nonempty[:, :, None] & label_match,
                                 pods.soft_sel_w[:, :, None], 0.0).sum(1)
        gb = state.group_bits[None, None, :, :]
        pg = pods.soft_grp_bits[:, :, None, :]
        group_match = ((gb & pg) != 0).any(dim=-1)
        group_term = torch.where(group_match, pods.soft_grp_w[:, :, None],
                                 0.0).sum(1)
        out = _soft_scale(cfg, wvec) * (label_term + group_term)
        bank = out.T if transposed else out
    else:
        bank = torch.zeros(shape, dtype=torch.float32, device=state.device)
    return bank + soft_zone_scores(state, pods, cfg, transposed=transposed,
                                   wvec=wvec)


def soft_zone_scores(state: ClusterState, pods: PodBatch,
                     cfg: SchedulerConfig,
                     transposed: bool = False,
                     wvec: torch.Tensor | None = None) -> torch.Tensor:
    """Zone-scoped preferred pod (anti-)affinity, ``f32[P, N]``: bonus
    ``w_t`` on nodes whose ZONE hosts a member of the term's group
    (``gz_counts`` presence); zone-less nodes match nothing.  Skipped
    when no pod carries a zone term."""
    p = pods.pod_valid.shape[0]
    n = state.node_valid.shape[0]
    shape = (n, p) if transposed else (p, n)
    if not host_flag((pods.soft_zone_bits != 0).any()):
        return torch.zeros(shape, dtype=torch.float32, device=state.device)
    zmax = state.az_anti.shape[0]
    zwords = planes_to_words((state.gz_counts > 0).T)        # i32[Z, W]
    has_zone = state.node_zone >= 0
    pres = zwords[state.node_zone.clamp(0, zmax - 1).long()]  # [N, W]
    zb = pods.soft_zone_bits[:, :, None, :]                  # [P, T, 1, W]
    zmatch = (((pres[None, None, :, :] & zb) != 0).any(dim=-1)
              & has_zone[None, None, :])                     # [P, T, N]
    term = torch.where(zmatch, pods.soft_zone_w[:, :, None], 0.0).sum(1)
    out = _soft_scale(cfg, wvec) * term
    return out.T if transposed else out


def spread_active(pods: PodBatch) -> torch.Tensor:
    """``bool[P]``: which pods carry a live topology-spread constraint
    (the one predicate every spread gate shares)."""
    return ((pods.spread_maxskew > 0) & (pods.group_idx >= 0)
            & pods.pod_valid)


def spread_terms(state: ClusterState, pods: PodBatch, cfg: SchedulerConfig,
                 gz_counts: torch.Tensor | None = None,
                 static_ok: torch.Tensor | None = None,
                 wvec: torch.Tensor | None = None, node_min=None):
    """Zone-level topology-spread penalty and mask, ``(f32[P, N],
    bool[P, N])``: placing on zone ``z`` is allowed iff ``count[z] + 1 -
    min(count) <= maxSkew``; hard constraints mask, soft ones pay
    ``weights.spread`` per unit of excess.  ``static_ok`` scopes the min
    to each pod's eligible domains (``nodeAffinityPolicy: Honor``).
    Skipped when no pod is spread-active.  ``node_min`` is the node-shard
    seam of :func:`spread_terms_ungated`."""
    gz = state.gz_counts if gz_counts is None else gz_counts
    n = state.num_nodes
    p = pods.num_pods
    if not host_flag(spread_active(pods).any()):
        return (torch.zeros((p, n), dtype=torch.float32, device=gz.device),
                torch.ones((p, n), dtype=torch.bool, device=gz.device))
    return spread_terms_ungated(state, pods, cfg, gz, static_ok, wvec,
                                node_min=node_min)


def spread_terms_ungated(state: ClusterState, pods: PodBatch,
                         cfg: SchedulerConfig, gz: torch.Tensor,
                         static_ok: torch.Tensor | None = None,
                         wvec: torch.Tensor | None = None, node_min=None):
    """:func:`spread_terms` without its host gate: with no spread-active
    pod it returns the gate's zero penalty and all-true mask itself.
    With ``static_ok`` given it makes no host sync and no in-place
    write, so it runs under ``torch.func.vmap`` (the fleet's lanes).

    On a node shard (a mesh's ``tp`` rows) each pod's minimum count over
    its eligible domains spans every shard: ``node_min(x)`` takes the
    shard's per-pod minima ``i32[P]`` to the whole cluster's (a MIN
    all-reduce over ``tp``, exact).  ``static_ok`` must then be given."""
    g, z = gz.shape
    active = spread_active(pods)
    cpz = gz[pods.group_idx.clamp(0, g - 1).long()]          # [P, Z]
    has_zone = state.node_zone >= 0
    cnt = cpz[:, state.node_zone.clamp(0, z - 1).long()]     # [P, N]
    big = 2 ** 30
    if static_ok is not None:
        elig = static_ok & has_zone[None, :]
        min_c = torch.where(elig, cnt, big).amin(dim=1)
        if node_min is not None:
            min_c = node_min(min_c)
    else:
        nz = torch.where(state.node_valid & has_zone, state.node_zone, z)
        zone_valid = torch.zeros((z + 1,), dtype=torch.bool,
                                 device=gz.device)
        zone_valid[nz.long()] = True
        min_c = torch.where(zone_valid[None, :z], cpz, big).amin(dim=1)
    skew_after = cnt + 1 - min_c[:, None]
    violates = (active[:, None] & has_zone[None, :]
                & (skew_after > pods.spread_maxskew[:, None]))
    ok = ~(violates & pods.spread_hard[:, None])
    excess = (skew_after - pods.spread_maxskew[:, None]).clamp_min(0).to(
        torch.float32)
    w_spread = (float(np.float32(cfg.weights.spread)) if wvec is None
                else wvec[10])
    penalty = torch.where(violates & ~pods.spread_hard[:, None],
                          w_spread * excess, 0.0)
    return penalty, ok


def balance_penalty(state: ClusterState, pods: PodBatch) -> torch.Tensor:
    """Worst-fit fractional utilization after placement, ``f32[P, N]``:
    ``max_r (used[n, r] + req[p, r]) / cap[n, r]``."""
    cap = state.cap.clamp_min(_EPS)
    frac = (state.used[None, :, :] + pods.req[:, None, :]) / cap[None, :, :]
    return frac.amax(dim=-1)


def ns_affinity_ok(state: ClusterState, pods: PodBatch,
                   transposed: bool = False) -> torch.Tensor:
    """Hard nodeAffinity matchExpressions mask, ``bool[P, N]`` (``[N, P]``
    transposed).  A pod passes a node when ANY of its OR'd terms passes;
    a term passes when each used any-of expression hits a node label bit,
    the node carries none of the term's forbid bits, and every numeric
    ``lo < value < hi`` comparison holds (NaN fails).  Pods without terms
    pass everywhere; the block is skipped when no pod has a term."""
    p = pods.pod_valid.shape[0]
    n = state.node_valid.shape[0]
    shape = (n, p) if transposed else (p, n)
    if not host_flag(pods.ns_term_used.any()):
        return torch.ones(shape, dtype=torch.bool, device=state.device)
    labels = state.label_bits                                # [N, W]
    anyof = pods.ns_anyof                                    # [P, T2, E, W]
    expr_unused = (anyof == 0).all(dim=-1)                   # [P, T2, E]
    hit = ((anyof[:, :, :, None, :] & labels[None, None, None, :, :])
           != 0).any(dim=-1)                                 # [P, T2, E, N]
    expr_ok = expr_unused[..., None] | hit
    clean = ((pods.ns_forbid[:, :, None, :] & labels[None, None, :, :])
             == 0).all(dim=-1)                               # [P, T2, N]
    term_ok = expr_ok.all(dim=2) & clean & pods.ns_term_used[:, :, None]
    if host_flag((pods.ns_num_col >= 0).any()):
        col = pods.ns_num_col                                # [P, T2, NE]
        vals = state.node_numeric[:, col.clamp_min(0).long()]  # [N,P,T2,NE]
        vals = vals.movedim(0, -1)                           # [P,T2,NE,N]
        in_range = ((vals > pods.ns_num_lo[..., None])
                    & (vals < pods.ns_num_hi[..., None]))
        num_ok = ((col[..., None] < 0) | in_range).all(dim=2)
        term_ok = term_ok & num_ok
    no_constraint = ~pods.ns_term_used.any(dim=1)
    out = no_constraint[:, None] | term_ok.any(dim=1)
    return out.T if transposed else out


def zone_affinity_ok(state: ClusterState, pods: PodBatch,
                     gz_counts: torch.Tensor | None = None,
                     az_anti: torch.Tensor | None = None) -> torch.Tensor:
    """Zone-scoped hard pod (anti-)affinity mask, ``bool[P, N]``: the
    node's zone must host members of ALL ``zaff_bits`` groups and NONE of
    the ``zanti_bits`` groups, and no zone resident may forbid the pod's
    groups (``az_anti``).  A zone-less node is an empty domain: required
    zone affinity fails there and anti-affinity passes.  Skipped when no
    pod has a zone term and no zone-anti resident exists."""
    gz = state.gz_counts if gz_counts is None else gz_counts
    az = state.az_anti if az_anti is None else az_anti
    p = pods.pod_valid.shape[0]
    n = state.node_valid.shape[0]
    pred = ((pods.zaff_bits != 0).any() | (pods.zanti_bits != 0).any()
            | (az != 0).any())
    if not host_flag(pred):
        return torch.ones((p, n), dtype=torch.bool, device=gz.device)
    return zone_affinity_ungated(state, pods, gz, az)


def zone_affinity_ungated(state: ClusterState, pods: PodBatch,
                          gz: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    """:func:`zone_affinity_ok` without its host gate (all-true when no
    pod has a zone term and no zone-anti resident exists, as the gate
    returns); no host sync, so it runs under ``torch.func.vmap``."""
    zmax = az.shape[0]
    zwords = planes_to_words((gz > 0).T)                     # i32[Z, W]
    has_zone = state.node_zone >= 0
    zrow = state.node_zone.clamp(0, zmax - 1).long()
    pres = zwords[zrow]                                      # [N, W]
    azn = az[zrow]                                           # [N, W]
    zaff_req = pods.zaff_bits[:, None, :]
    zaff = torch.where(
        has_zone[None, :],
        ((pres[None, :, :] & zaff_req) == zaff_req).all(dim=-1),
        (zaff_req == 0).all(dim=-1))
    zanti = ~has_zone[None, :] | (
        (pres[None, :, :] & pods.zanti_bits[:, None, :]) == 0).all(dim=-1)
    sym = ~has_zone[None, :] | (
        (azn[None, :, :] & pods.group_bit[:, None, :]) == 0).all(dim=-1)
    return zaff & zanti & sym


def static_feasibility(state: ClusterState, pods: PodBatch) -> torch.Tensor:
    """The placement-independent mask, ``bool[P, N]``: validity, taints ⊆
    tolerations, required node labels, hard nodeAffinity."""
    tol = ((state.taint_bits[None, :, :] & ~pods.tol_bits[:, None, :])
           == 0).all(dim=-1)
    sel = ((state.label_bits[None, :, :] & pods.sel_bits[:, None, :])
           == pods.sel_bits[:, None, :]).all(dim=-1)
    return (tol & sel & state.node_valid[None, :]
            & pods.pod_valid[:, None] & ns_affinity_ok(state, pods))


def static_feasibility_t(state: ClusterState,
                         pods: PodBatch) -> torch.Tensor:
    """:func:`static_feasibility` in node-major layout ``bool[N, P]``."""
    tol = ((state.taint_bits[:, None, :] & ~pods.tol_bits[None, :, :])
           == 0).all(dim=-1)
    sel = ((state.label_bits[:, None, :] & pods.sel_bits[None, :, :])
           == pods.sel_bits[None, :, :]).all(dim=-1)
    return (tol & sel & state.node_valid[:, None]
            & pods.pod_valid[None, :]
            & ns_affinity_ok(state, pods, transposed=True))


def feasibility_mask(state: ClusterState, pods: PodBatch,
                     static_ok: torch.Tensor | None = None) -> torch.Tensor:
    """Hard constraints as a batched ``bool[P, N]`` mask: capacity fit
    (``req <= cap - used + _EPS`` for every resource), the static mask,
    required affinity (ALL groups present), anti-affinity in both
    directions, and zone-scoped (anti-)affinity."""
    free = state.cap - state.used
    fits = (pods.req[:, None, :] <= free[None, :, :] + _EPS).all(dim=-1)
    aff_req = pods.affinity_bits[:, None, :]
    affinity = ((state.group_bits[None, :, :] & aff_req)
                == aff_req).all(dim=-1)
    anti = ((state.group_bits[None, :, :] & pods.anti_bits[:, None, :])
            == 0).all(dim=-1)
    sym = ((state.resident_anti[None, :, :] & pods.group_bit[:, None, :])
           == 0).all(dim=-1)
    if static_ok is None:
        static_ok = static_feasibility(state, pods)
    return (static_ok & fits & affinity & anti & sym
            & zone_affinity_ok(state, pods))


def _balance_weight(cfg: SchedulerConfig, wvec: torch.Tensor | None):
    return (float(np.float32(cfg.weights.balance)) if wvec is None
            else wvec[8])


def score_pods(state: ClusterState, pods: PodBatch, cfg: SchedulerConfig,
               static=None, wvec: torch.Tensor | None = None) -> torch.Tensor:
    """Full masked score matrix ``f32[P, N]``; ``NEG_INF`` marks
    infeasible.  ``static`` is an optional precomputed
    :func:`static_node_scores` pair.  ``wvec`` (a :func:`weights_vector`
    tensor) replaces every ``cfg.weights`` constant of the expression;
    ``None`` keeps them."""
    if static is None:
        static = static_node_scores(state, cfg, wvec=wvec)
    base, ct = static
    net = network_scores(state, pods, cfg, ct=ct)
    soft = soft_affinity_scores(state, pods, cfg, wvec=wvec)
    bal = _balance_weight(cfg, wvec) * balance_penalty(state, pods)
    sok = static_feasibility(state, pods)
    spread_pen, spread_ok = spread_terms(state, pods, cfg, static_ok=sok,
                                         wvec=wvec)
    raw = base[None, :] + net + soft - bal - spread_pen
    ok = feasibility_mask(state, pods, static_ok=sok) & spread_ok
    return torch.where(ok, raw, NEG_INF)


def winner_from_scores(scores: torch.Tensor):
    """Per-pod winner over a masked score matrix: ``(best f32[P], node
    i32[P])`` with ``node == -1`` where the row is all-infeasible.  Equal
    best candidates resolve to the LOWEST node index."""
    n = scores.shape[1]
    best = scores.amax(dim=1)
    cols = torch.arange(n, dtype=torch.int32, device=scores.device)[None, :]
    choice = torch.where(scores == best[:, None], cols, n).amin(dim=1)
    node = torch.where(best > NEG_HALF, choice, -1).to(torch.int32)
    return best, node


def score_winner(state: ClusterState, pods: PodBatch, cfg: SchedulerConfig,
                 static=None, wvec: torch.Tensor | None = None):
    """Score then winner: ``(best f32[P], node i32[P])``."""
    return winner_from_scores(score_pods(state, pods, cfg, static,
                                         wvec=wvec))


_GATE_KEYS = ("ok", "static_ok", "fits", "affinity", "anti", "sym_anti",
              "zone_ok", "spread_ok")


def _dense_static(state: ClusterState, cfg: SchedulerConfig, static,
                  wvec: torch.Tensor | None = None):
    """``static`` when it is the dense ``(base, C.T)`` pair, else a fresh
    :func:`static_node_scores` pair.  The kernel backend's static is a
    :class:`~.kernels.StaticPack` that carries no ``C.T``; the
    decomposition always runs dense, so it builds its own pair then."""
    if isinstance(static, tuple) and len(static) == 2:
        return static
    return static_node_scores(state, cfg, wvec=wvec)


def _explain_terms(state: ClusterState, pods: PodBatch,
                   cfg: SchedulerConfig, static=None,
                   wvec: torch.Tensor | None = None) -> dict:
    """Every additive term of :func:`score_pods` and every individual
    feasibility gate, as ``[P, N]`` (or broadcastable) tensors on the
    state's device.  ``static`` may be the dense pair or the kernel
    backend's pack (see :func:`_dense_static`)."""
    base, ct = _dense_static(state, cfg, static, wvec=wvec)
    net = network_scores(state, pods, cfg, ct=ct)
    soft = soft_affinity_scores(state, pods, cfg, wvec=wvec)
    bal = _balance_weight(cfg, wvec) * balance_penalty(state, pods)
    sok = static_feasibility(state, pods)
    spread_pen, spread_ok = spread_terms(state, pods, cfg, static_ok=sok,
                                         wvec=wvec)
    free = state.cap - state.used
    fits = (pods.req[:, None, :] <= free[None, :, :] + _EPS).all(dim=-1)
    aff_req = pods.affinity_bits[:, None, :]
    affinity = ((state.group_bits[None, :, :] & aff_req)
                == aff_req).all(dim=-1)
    anti = ((state.group_bits[None, :, :] & pods.anti_bits[:, None, :])
            == 0).all(dim=-1)
    sym = ((state.resident_anti[None, :, :] & pods.group_bit[:, None, :])
           == 0).all(dim=-1)
    zone = zone_affinity_ok(state, pods)
    ok = sok & fits & affinity & anti & sym & zone & spread_ok
    # score_pods' expression, term for term, so the winner's total is
    # the score the serving path ranked.
    raw = base[None, :] + net + soft - bal - spread_pen
    total = torch.where(ok, raw, NEG_INF)
    return {
        "base": base[None, :], "net": net, "soft": soft,
        "balance": bal, "spread": spread_pen, "total": total,
        "ok": ok, "static_ok": sok, "fits": fits,
        "affinity": affinity, "anti": anti, "sym_anti": sym,
        "zone_ok": zone, "spread_ok": spread_ok,
    }


def explain_scores(state: ClusterState, pods: PodBatch,
                   cfg: SchedulerConfig, static=None,
                   wvec: torch.Tensor | None = None
                   ) -> dict[str, np.ndarray]:
    """Host-side score decomposition for placement explainability: the
    additive terms (f32) and the feasibility gates (bool) of
    :func:`score_pods` as host numpy arrays, each ``[P, N]``.

    A separate observation, used only when ``cfg.enable_explain`` is on:
    the serving score path never calls it, so placements are identical
    with explain on or off.  ``total`` is computed with the expression
    :func:`score_pods` uses, so ``base + net + soft - balance - spread ==
    total`` where feasible.  The decomposition is dense under both
    backends; with the kernel backend's pack as ``static`` it builds its
    own dense pair."""
    terms = _explain_terms(state, pods, cfg, static=static, wvec=wvec)
    shape = tuple(terms["net"].shape)
    out = {}
    for key, val in terms.items():
        dtype = torch.bool if key in _GATE_KEYS else torch.float32
        out[key] = val.to(dtype).expand(shape).cpu().numpy().copy()
    return out


# ---------------------------------------------------------------------------
# Node shards of a mesh (``parallel/sharding.py``).  ``mesh`` is a
# :class:`~..parallel.sharding.Mesh`: ``gather``/``reduce`` over an axis,
# and the rank's ``tp_index`` of ``tp``.
# ---------------------------------------------------------------------------


def network_scores_shard(pods: PodBatch, cfg: SchedulerConfig,
                         ct: torch.Tensor, offset: int,
                         transposed: bool = False) -> torch.Tensor:
    """:func:`network_scores` on a node shard: ``ct`` holds the shard's
    columns of ``C.T`` (``[N, rows]``, the shard's rows of ``C``; the
    peer axis is whole), ``offset`` the global index of its first node.
    Returns ``f32[P, rows]`` (``[rows, P]`` transposed), each entry with
    the bits :func:`network_scores` gives it on one device.

    The peer gather runs at the whole cluster's width: the shard's
    columns sit in a zero ``[P, K, N]`` block and the shard's columns of
    the contraction are kept, so the contraction has the single-device
    shape (cuBLAS picks its kernel by shape) and sums each entry's peers
    in the same order.  The dense form contracts the peer axis, which
    every rank holds whole."""
    n, rows = ct.shape
    k = pods.peers.shape[1]
    if k * 16 <= n:
        valid = (pods.peers >= 0) & pods.pod_valid[:, None]
        safe = torch.where(valid, pods.peers, 0).long()
        traffic = torch.where(valid, pods.peer_traffic, 0.0)
        part = ct[safe].to(torch.float32)                    # [P, K, rows]
        if rows != n:
            full = torch.zeros(part.shape[:2] + (n,), dtype=torch.float32,
                               device=part.device)
            full[:, :, offset:offset + rows] = part
            part = full
        net = torch.einsum("pk,pkn->pn", traffic, part)
        net = net[:, offset:offset + rows]
        return net.T if transposed else net
    t = peer_traffic_matrix(pods, n)
    if ct.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16)
    net = exact_matmul(t.to(torch.float32), ct.to(torch.float32))
    return net.T if transposed else net


def static_tile_inputs_spmd(state: ClusterState, cfg: SchedulerConfig,
                            mesh):
    """The sharded batch-invariant inputs: ``(base f32[rows], bw_max,
    lat_max, node_valid bool[N])``, the shard's rows of the metric vote,
    the whole cluster's network normalizers and validity, each with the
    single-device bits.  Collective: every rank of the mesh calls it.

    The metric vote is O(N·M): each rank gathers the metric columns over
    ``tp`` and votes at the single-device shape (cuBLAS picks its kernel
    by shape), then keeps its rows.  The normalizers are MAX all-reduces
    of the shard maxima over ``tp``, exact."""
    rows = state.num_nodes
    off = mesh.tp_index * rows
    valid_all = concat_shards(mesh, state.node_valid, "tp")
    full = state.replace(
        metrics=concat_shards(mesh, state.metrics, "tp"),
        metrics_age=concat_shards(mesh, state.metrics_age, "tp"),
        node_valid=valid_all)
    base = metric_scores(full, cfg)[off:off + rows]
    pair_valid = state.node_valid[:, None] & valid_all[None, :]
    bw_max = mesh.reduce(torch.where(pair_valid, state.bw, 0.0).amax(),
                         "max", "tp").clamp_min(_EPS)
    lat_max = mesh.reduce(torch.where(pair_valid, state.lat, 0.0).amax(),
                          "max", "tp").clamp_min(_EPS)
    return base, bw_max, lat_max, valid_all


def static_node_scores_spmd(state: ClusterState, cfg: SchedulerConfig,
                            mesh):
    """:func:`static_node_scores` on a node shard: ``(base f32[rows],
    ct [N, rows])``, the shard's entries of the single-device pair, bit
    for bit (:func:`static_tile_inputs_spmd`).  ``C`` is formed only for
    the shard's rows (full peer columns), so no rank holds an N×N
    plane.  Collective."""
    base, bw_max, lat_max, valid_all = static_tile_inputs_spmd(state, cfg,
                                                               mesh)
    rows = state.num_nodes
    off = mesh.tp_index * rows
    pair_valid = state.node_valid[:, None] & valid_all[None, :]
    w = cfg.weights
    c = w.peer_bw * state.bw / bw_max - w.peer_lat * state.lat / lat_max
    ids = off + torch.arange(rows, device=c.device)
    cols = torch.arange(valid_all.shape[0], device=c.device)
    c = torch.where(ids[:, None] == cols[None, :],
                    float(np.float32(w.peer_bw)), c)
    c = torch.where(pair_valid, c, 0.0)
    return base, prep_net_matrix(c, cfg)


def score_pods_spmd(state: ClusterState, pods: PodBatch,
                    cfg: SchedulerConfig, static, mesh) -> torch.Tensor:
    """:func:`score_pods` on a node shard: the masked score columns
    ``f32[P, rows]`` of the shard's nodes for the whole batch, with
    ``static`` the shard's :func:`static_node_scores_spmd` pair.  The
    spread gate reads the batch, which every rank holds whole, so every
    rank takes it alike and joins the MIN all-reduce of the eligible
    minima.  Collective."""
    base, ct = static
    off = mesh.tp_index * state.num_nodes
    net = network_scores_shard(pods, cfg, ct, off)
    soft = soft_affinity_scores(state, pods, cfg)
    bal = _balance_weight(cfg, None) * balance_penalty(state, pods)
    sok = static_feasibility(state, pods)
    spread_pen, spread_ok = spread_terms(
        state, pods, cfg, static_ok=sok,
        node_min=lambda x: mesh.reduce(x, "min", "tp"))
    raw = base[None, :] + net + soft - bal - spread_pen
    ok = feasibility_mask(state, pods, static_ok=sok) & spread_ok
    return torch.where(ok, raw, NEG_INF)
