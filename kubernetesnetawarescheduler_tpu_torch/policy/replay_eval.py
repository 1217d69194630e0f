"""Counterfactual promotion gate: candidate weights must WIN a
replay before they may touch the live scorer.

The PyTorch package's copy of the JAX package's
``policy/replay_eval.py``, its records leg: candidate weights are never
promoted directly.  Two counterfactual legs decide:

1. **Recorded-decision re-score** (cheap, always available; ported):
   every retained explain record's candidate set is re-ranked under the
   candidate term multipliers; the candidate policy's winner is
   compared against the incumbent's recorded winner on the NET
   desirability term — the component the QualityObserver measures
   regret in.  The candidate must not regress this hindsight proxy,
   and the fraction of decisions it would have changed is the
   published disagreement rate.

2. **Seeded scenario replay** (authoritative): the same scenario trace
   replayed through the real loop under incumbent and candidate
   weights, scorecards compared on the realized-bandwidth ratio.  It
   needs ``scenario/`` (ROADMAP Queue A item 14), which is not ported:
   :func:`_replay_ratio` raises, and a loop or daemon given a replay
   trace refuses it when it is set, never mid-tick.

No trace, no promotion: without the replay leg the gate refuses
(``no_replay_trace``) and the policy keeps shadow-scoring.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig,
    ScoreWeights,
)
from kubernetesnetawarescheduler_tpu_torch.policy.model import (
    TERMS,
    _record_arrays,
)

#: ScoreWeights fields per score-term group, aligned with TERMS.
_TERM_GROUPS: dict[str, tuple[str, ...]] = {
    "base": ("cpu", "mem", "net_tx", "net_rx", "bandwidth", "disk"),
    "net": ("peer_bw", "peer_lat"),
    "soft": ("soft_affinity",),
    "balance": ("balance",),
    "spread": ("spread",),
}


def term_multipliers(candidate: ScoreWeights,
                     incumbent: ScoreWeights) -> np.ndarray:
    """Per-TERM multiplier taking incumbent weights to candidate
    weights (mean field ratio per group; a zero incumbent field
    contributes ratio 1 unless the candidate moved it, in which case
    the absolute candidate value stands in — there is no finite
    multiplier from 0)."""
    mult = np.ones((len(TERMS),), np.float64)
    for t_idx, term in enumerate(TERMS):
        ratios = []
        for field in _TERM_GROUPS[term]:
            inc = float(getattr(incumbent, field))
            cand = float(getattr(candidate, field))
            if inc != 0.0:
                ratios.append(cand / inc)
            elif cand != 0.0:
                ratios.append(cand)
        if ratios:
            mult[t_idx] = float(np.mean(ratios))
    return mult


@dataclasses.dataclass(frozen=True)
class PromotionDecision:
    """The gate's verdict — provenance that rides /debug/policy,
    checkpoint meta and the bench artifact."""

    promote: bool
    reason: str
    candidate_weights: ScoreWeights
    incumbent_ratio: float      # replay realized-bw ratio vs oracle
    candidate_ratio: float
    replay_delta: float         # candidate_ratio - incumbent_ratio
    records_delta: float        # mean net-term delta on recorded set
    disagreement_rate: float
    records_evaluated: int
    margin: float
    t_wall: float

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["candidate_weights"] = dataclasses.asdict(
            self.candidate_weights)
        return d


def rescore_records(explains: Sequence[Mapping[str, Any]],
                    multipliers: np.ndarray,
                    k_pad: int = 8) -> tuple[float, float, int]:
    """Re-rank recorded candidate sets under the candidate term
    multipliers.  Returns ``(disagreement_rate, net_delta, n)``:
    the fraction of decisions whose winner changes and the mean
    net-desirability difference (candidate winner minus incumbent
    winner — positive = candidate picks better-connected nodes on the
    recorded evidence)."""
    net_idx = TERMS.index("net")
    disagree = 0
    deltas: list[float] = []
    n = 0
    for rec in explains:
        cand = rec.get("candidates") or []
        if not cand:
            continue
        comps, feas, _cls = _record_arrays(cand, max(k_pad, len(cand)))
        if not (feas > 0).any():
            continue
        totals = np.asarray(
            [float(c.get("total", 0.0)) for c in cand]
            + [0.0] * (max(k_pad, len(cand)) - len(cand)))
        mask = feas > 0
        inc_winner = int(np.argmax(np.where(mask, totals, -np.inf)))
        cand_scores = comps.astype(np.float64) @ multipliers
        cand_winner = int(np.argmax(
            np.where(mask, cand_scores, -np.inf)))
        n += 1
        if cand_winner != inc_winner:
            disagree += 1
        deltas.append(float(comps[cand_winner, net_idx]
                            - comps[inc_winner, net_idx]))
    if n == 0:
        return 0.0, 0.0, 0
    return disagree / n, float(np.mean(deltas)), n


def _replay_ratio(trace_path: str, weights: ScoreWeights,
                  cfg: SchedulerConfig,
                  replay_kwargs: Mapping[str, Any] | None
                  ) -> tuple[float, dict[str, Any]]:
    """One counterfactual campaign: replay the trace under ``weights``
    and return the scorecard's realized-bandwidth ratio plus the card.
    The replay needs ``scenario/`` (ROADMAP Queue A item 14)."""
    raise NotImplementedError(
        "the policy gate's scenario replay needs scenario/ (ROADMAP "
        "Queue A item 14), which is not ported yet")


def evaluate_candidate(cfg: SchedulerConfig,
                       candidate: ScoreWeights,
                       incumbent: ScoreWeights,
                       explains: Sequence[Mapping[str, Any]],
                       *,
                       trace_path: str | None = None,
                       margin: float | None = None,
                       k_pad: int = 8,
                       replay_kwargs: Mapping[str, Any] | None = None,
                       ) -> PromotionDecision:
    """Run the full gate for one candidate.  Pure function of its
    inputs — the caller (loop eval tick / bench / tests) owns the
    counters and the actual weight swap."""
    if margin is None:
        margin = cfg.policy_promote_margin
    mult = term_multipliers(candidate, incumbent)
    disagreement, records_delta, n_records = rescore_records(
        explains, mult, k_pad=k_pad)
    inc_ratio = cand_ratio = -1.0
    if trace_path is None:
        return PromotionDecision(
            promote=False, reason="no_replay_trace",
            candidate_weights=candidate,
            incumbent_ratio=inc_ratio, candidate_ratio=cand_ratio,
            replay_delta=0.0, records_delta=records_delta,
            disagreement_rate=disagreement,
            records_evaluated=n_records, margin=float(margin),
            t_wall=time.time())
    # Records leg first: a candidate that loses on its OWN training
    # distribution never earns the (much more expensive) replay.
    if n_records > 0 and records_delta < 0.0:
        return PromotionDecision(
            promote=False, reason="records_regression",
            candidate_weights=candidate,
            incumbent_ratio=inc_ratio, candidate_ratio=cand_ratio,
            replay_delta=0.0, records_delta=records_delta,
            disagreement_rate=disagreement,
            records_evaluated=n_records, margin=float(margin),
            t_wall=time.time())
    inc_ratio, _ = _replay_ratio(trace_path, incumbent, cfg,
                                 replay_kwargs)
    cand_ratio, _ = _replay_ratio(trace_path, candidate, cfg,
                                  replay_kwargs)
    delta = cand_ratio - inc_ratio
    if inc_ratio < 0.0 or cand_ratio < 0.0:
        promote, reason = False, "replay_no_oracle_sample"
    elif delta >= margin:
        promote, reason = True, "replay_win"
    else:
        promote, reason = False, "replay_below_margin"
    return PromotionDecision(
        promote=promote, reason=reason,
        candidate_weights=candidate,
        incumbent_ratio=inc_ratio, candidate_ratio=cand_ratio,
        replay_delta=float(delta), records_delta=records_delta,
        disagreement_rate=disagreement,
        records_evaluated=n_records, margin=float(margin),
        t_wall=time.time())


__all__ = [
    "PromotionDecision",
    "evaluate_candidate",
    "rescore_records",
    "term_multipliers",
]
