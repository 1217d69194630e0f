"""Placement-quality evaluator: prediction vs realized probe truth.

The PyTorch package's copy of the JAX package's ``obs/quality.py``.
The scheduler picks nodes from a *prediction* of the network (staging
lat/bw).  Probes keep flowing after the bind, so some time later the
repo knows what the link quality around a placement actually *was*.
This module joins the two:

- :meth:`QualityObserver.note_commit` rides the retire/commit seam of
  all four loop paths (``SchedulerLoop._span_commit`` calls it before
  the flight-recorder guard): for every pod whose bind just committed
  it captures the score-time prediction — chosen node, resolved peer
  nodes with traffic weights, the staging lat/bw for those pairs, and
  the explain store's winner score when available — into a bounded
  pending map keyed by pod uid.  Host-side reads only; no device work.
  The "prediction" is read from the raw staging planes, as the JAX
  package reads it: with a topology model attached the scorer saw the
  BLENDED planes, which never reach staging (ROADMAP Queue C), and the
  port keeps the JAX definition so both packages' outcomes compare.
- :meth:`QualityObserver.harvest` (periodic: ``SchedulerLoop.
  maintain``; explicit: bench/tests) evaluates every pending entry in
  one batched torch expression (:func:`_evaluate`) on the encoder's
  device against the *current* staging planes: per-pod realized
  bandwidth/latency (traffic-weighted over peers), realized net score
  vs the best alternative node under the same desirability the
  scheduler optimized (:func:`core.score.net_desirability`), and
  calibration residuals.  Outcomes land in a bounded uid-keyed ring.

The JAX package pads the batch to power-of-two buckets to bound its
jit cache; with no trace to bound, the port does not pad.  Placements
are identical with observation on or off.

This is the realized-outcome label stream "Learning to Score"
(PAPERS.md) needs for off-policy evaluation, and the per-pod
current-placement-cost signal the future rebalancer (ROADMAP) will
consume.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.utils.timeseries import LogHistogram

__all__ = ["QualityObserver"]

_EPS = 1e-9


@dataclass(frozen=True)
class _Pending:
    """One bound pod's score-time prediction, waiting for probe truth."""

    uid: str
    node: str
    node_idx: int
    cycle_id: int
    t_commit: float
    peer_idx: tuple[int, ...]
    peer_traffic: tuple[float, ...]
    pred_lat_ms: tuple[float, ...]
    pred_bw_bps: tuple[float, ...]
    score_pred: float | None        # explain store's winner score
    # Bind generation: the CommitRecord.stamp of the binding this
    # prediction was made for.  A pod evicted/preempted and re-bound
    # between note and harvest carries a DIFFERENT stamp — harvesting
    # the old prediction against the new binding would charge the new
    # placement with the old one's regret, so mismatches are dropped
    # (stale_dropped).  Defaulted for pre-r12 pickles/tests.
    bind_stamp: float = 0.0


def _evaluate(lat, bw, valid, chosen, peers, traffic,
              pred_lat, pred_bw, w_bw: float, w_lat: float):
    """Realized-quality evaluation of a batch of bound pods: one batched
    torch expression on the inputs' device.

    Inputs: staging planes ``lat/bw f32[N, N]``, ``valid bool[N]``;
    per-pod ``chosen i32[B]``, ``peers i32[B, K]`` (-1 = empty slot),
    ``traffic f32[B, K]``, score-time predictions ``pred_lat/pred_bw
    f32[B, K]``; the score weights.  Returns per-pod realized lat/bw,
    net score of the chosen node, best-alternative net score, regret,
    bw/lat calibration residuals and the live peer-sample count.

    The net score of every node against a pod's peers is accumulated
    over the peer slots in order 0..K-1 into one ``[B, N]`` buffer, each
    slot a row gather of ``C.T`` (no ``[N, B, K]`` temporary)."""
    from kubernetesnetawarescheduler_tpu_torch.core.score import (
        net_desirability,
    )

    c = net_desirability(lat, bw, valid, w_bw, w_lat)
    ct = c.T.contiguous()
    m = peers >= 0
    safe = torch.where(m, peers, 0).long()
    w = torch.where(m, traffic, 0.0)
    wsum = w.sum(dim=1).clamp_min(_EPS)
    ch = chosen.long()
    obs_l = lat[ch[:, None], safe]                          # [B, K]
    obs_b = bw[ch[:, None], safe]
    realized_lat = (w * obs_l).sum(dim=1) / wsum
    realized_bw = (w * obs_b).sum(dim=1) / wsum
    # Realized net score of EVERY node against this pod's peers — the
    # reduction network_scores does per candidate, under today's
    # observed desirability matrix.
    b, n = ch.shape[0], ct.shape[0]
    cost = torch.zeros((b, n), dtype=torch.float32, device=ct.device)
    for k in range(peers.shape[1]):
        cost += ct[safe[:, k]] * w[:, k, None]
    mine = cost[torch.arange(b, device=ct.device), ch]
    best = torch.where(valid[None, :], cost, -torch.inf).amax(dim=1)
    regret = (best - mine).clamp_min(0.0)
    bw_res = (w * (torch.log1p(pred_bw) - torch.log1p(obs_b)).abs()
              ).sum(dim=1) / wsum
    lat_res = (w * (pred_lat - obs_l).abs()).sum(dim=1) / wsum
    return (realized_lat, realized_bw, mine, best, regret, bw_res,
            lat_res, m.sum(dim=1))


class QualityObserver:
    """Bounded two-stage join of placement predictions and probe truth.

    Thread-safe: the serving thread calls :meth:`note_commit`, the
    maintain tick / bench calls :meth:`harvest`, scrape threads read
    :meth:`summary` — one lock, snapshot-then-math."""

    def __init__(self, cfg: SchedulerConfig) -> None:
        self.cfg = cfg
        self._ring_size = max(1, int(cfg.quality_ring_size))
        self._pending: collections.OrderedDict[str, _Pending] = (
            collections.OrderedDict())
        self._ring: collections.OrderedDict[str, dict[str, Any]] = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        # Counters (exact, never evict).
        self.noted_total = 0
        self.no_peer_total = 0
        self.pending_dropped = 0
        self.ring_evicted = 0
        self.harvested_total = 0
        self.calibration_samples = 0
        self.stale_dropped = 0
        # Distributions: regret in score units, calibration residual
        # in log1p-bw units — both small positives near 0.
        self.regret_hist = LogHistogram(lo=1e-6, hi=1e3, window=4096)
        self.bw_residual_hist = LogHistogram(lo=1e-6, hi=1e3,
                                             window=4096)
        self._pinned: dict[str, torch.Tensor] = {}

    def _stage(self, name: str, host: np.ndarray,
               dev: torch.device) -> torch.Tensor:
        """A copy of one f32 staging plane on ``dev``.  On a card the
        copy goes through a pinned buffer reused across harvests (the
        previous harvest's results reached the host after it) and the
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

    # -- stage 1: capture at the commit seam -------------------------

    def note_commit(self, loop, pods, cycle_id: int = 0) -> None:
        """Capture score-time predictions for pods whose binds just
        committed.  Called from ``SchedulerLoop._span_commit`` on all
        four paths, exception-guarded by the caller (observation must
        never break serving).  Pods that did not commit (unschedulable
        / rolled back) and pods with no resolvable peers are counted
        and skipped — a peerless pod's net term is identical on every
        node, so its regret is zero by construction."""
        enc = loop.encoder
        k_max = self.cfg.max_peers
        for pod in pods:
            node = enc.committed_node(pod.uid)
            if not node:
                continue
            idx = enc.node_slot(node)
            if idx is None:
                continue
            self.noted_total += 1
            peer_idx: list[int] = []
            peer_w: list[float] = []
            pred_lat: list[float] = []
            pred_bw: list[float] = []
            for peer_name, weight in pod.peers.items():
                if len(peer_idx) >= k_max:
                    break
                peer_node = loop._peer_node(peer_name)
                if not peer_node:
                    continue
                pidx = enc.node_slot(peer_node)
                if pidx is None:
                    continue
                peer_idx.append(int(pidx))
                peer_w.append(float(weight))
                # The staging planes ARE what the scorer consumed
                # this cycle (netmodel blend included): scalar reads,
                # no lock needed for single-element numpy access.
                pred_lat.append(float(enc._lat[idx, pidx]))
                pred_bw.append(float(enc._bw[idx, pidx]))
            if not peer_idx:
                self.no_peer_total += 1
                continue
            score_pred = None
            flight = getattr(loop, "flight", None)
            if flight is not None:
                rec = flight.get_explain(pod.uid)
                if rec is not None:
                    score_pred = rec.get("score")
            # Bind generation: the ledger stamp of THIS binding (a
            # single-element dict read, same discipline as the
            # staging scalar reads above).
            crec = enc._committed.get(pod.uid)
            bind_stamp = float(crec.stamp) if crec is not None else 0.0
            entry = _Pending(
                uid=pod.uid, node=node, node_idx=int(idx),
                cycle_id=int(cycle_id), t_commit=time.time(),
                peer_idx=tuple(peer_idx),
                peer_traffic=tuple(peer_w),
                pred_lat_ms=tuple(pred_lat),
                pred_bw_bps=tuple(pred_bw),
                score_pred=score_pred,
                bind_stamp=bind_stamp)
            with self._lock:
                self._pending.pop(pod.uid, None)
                self._pending[pod.uid] = entry
                while len(self._pending) > self._ring_size:
                    self._pending.popitem(last=False)
                    self.pending_dropped += 1

    # -- stage 2: harvest against current probe truth ----------------

    def harvest(self, enc) -> int:
        """Evaluate every pending prediction against the CURRENT
        staging lat/bw (probes have kept flowing since the commits)
        in one batched device evaluation; append outcomes to the ring.
        Returns the number of outcomes produced.  Off the hot path:
        called from ``maintain()`` and explicitly by bench/tests."""
        with self._lock:
            batch = list(self._pending.values())
            self._pending.clear()
        if not batch:
            return 0
        dev = getattr(enc, "device", torch.device("cpu"))
        with enc._lock:
            lat = self._stage("lat", enc._lat, dev)
            bw = self._stage("bw", enc._bw, dev)
            valid = np.array(enc._node_valid, dtype=bool)
            stamps = {uid: rec.stamp
                      for uid, rec in enc._committed.items()}
        # Bind-generation gate: a pod evicted/preempted/rebalanced
        # since note_commit is no longer the binding this prediction
        # described — harvesting it would score the NEW placement
        # with the OLD prediction's peers and staging reads.  Stamp
        # mismatch (or a vanished ledger entry) drops the entry.
        fresh = []
        for e in batch:
            stamp = stamps.get(e.uid)
            if (e.bind_stamp and (stamp is None
                                  or stamp != e.bind_stamp)):
                self.stale_dropped += 1
                continue
            fresh.append(e)
        batch = fresh
        if not batch:
            return 0
        b = len(batch)
        k = self.cfg.max_peers
        chosen = np.zeros((b,), np.int32)
        peers = np.full((b, k), -1, np.int32)
        traffic = np.zeros((b, k), np.float32)
        pred_lat = np.zeros((b, k), np.float32)
        pred_bw = np.zeros((b, k), np.float32)
        for i, e in enumerate(batch):
            kk = len(e.peer_idx)
            chosen[i] = e.node_idx
            peers[i, :kk] = e.peer_idx
            traffic[i, :kk] = e.peer_traffic
            pred_lat[i, :kk] = e.pred_lat_ms
            pred_bw[i, :kk] = e.pred_bw_bps
        args = [lat, bw] + [torch.from_numpy(x).to(dev) for x in (
            valid, chosen, peers, traffic, pred_lat, pred_bw)]
        out = _evaluate(*args, self.cfg.weights.peer_bw,
                        self.cfg.weights.peer_lat)
        (r_lat, r_bw, mine, best, regret, bw_res, lat_res,
         n_samp) = (x.cpu().numpy() for x in out)
        now = time.time()
        with self._lock:
            for i, e in enumerate(batch):
                outcome = {
                    "pod_uid": e.uid,
                    "node": e.node,
                    "cycle_id": e.cycle_id,
                    "t_commit": e.t_commit,
                    "t_harvest": now,
                    "peer_samples": int(n_samp[i]),
                    "realized_lat_ms": float(r_lat[i]),
                    "realized_bw_bps": float(r_bw[i]),
                    "net_score": float(mine[i]),
                    "best_net_score": float(best[i]),
                    "regret": float(regret[i]),
                    "bw_residual_log1p": float(bw_res[i]),
                    "lat_residual_ms": float(lat_res[i]),
                    "score_pred": e.score_pred,
                }
                self._ring.pop(e.uid, None)
                self._ring[e.uid] = outcome
                while len(self._ring) > self._ring_size:
                    self._ring.popitem(last=False)
                    self.ring_evicted += 1
                self.harvested_total += 1
                self.calibration_samples += int(n_samp[i])
                self.regret_hist.record(float(regret[i]))
                self.bw_residual_hist.record(float(bw_res[i]))
        return b

    # -- reads -------------------------------------------------------

    def ring_depth(self) -> int:
        with self._lock:
            return len(self._ring)

    def pending_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def outcomes(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(o) for o in self._ring.values()]

    def outcome(self, uid: str) -> dict[str, Any] | None:
        with self._lock:
            rec = self._ring.get(uid)
            return dict(rec) if rec is not None else None

    def summary(self) -> Mapping[str, Any]:
        """One-shot stats block for /debug/slo, /metrics and bench."""
        with self._lock:
            pending = len(self._pending)
            ring = len(self._ring)
        return {
            "pending": pending,
            "ring_depth": ring,
            "ring_size": self._ring_size,
            "noted_total": self.noted_total,
            "no_peer_total": self.no_peer_total,
            "pending_dropped": self.pending_dropped,
            "ring_evicted": self.ring_evicted,
            "harvested_total": self.harvested_total,
            "calibration_samples": self.calibration_samples,
            "stale_dropped": self.stale_dropped,
            "regret_p50": self.regret_hist.percentile(50),
            "regret_p99": self.regret_hist.percentile(99),
            "bw_residual_log1p_p50":
                self.bw_residual_hist.percentile(50),
            "bw_residual_log1p_p99":
                self.bw_residual_hist.percentile(99),
        }
