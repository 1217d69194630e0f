"""Policy training dataset: join decisions with realized outcomes.

The PyTorch package's copy of the JAX package's ``policy/dataset.py``
(numpy only).

The policy learns from REAL decisions, not synthetic ones.  Two
stores the repo already maintains supply everything:

- the flight recorder's explain store: per shipped decision, the
  top-k candidate nodes with the additive score decomposition
  (``base/net/soft/balance/spread``) and feasibility gates;
- the QualityObserver outcome ring: per shipped decision, the
  realized regret vs the best alternative under subsequent probe
  truth, already bind-generation-gated (a pod rebound since commit
  never produces an outcome for the stale placement).

This module performs the uid join OFF the hot path (maintain
cadence): each quality outcome that has an explain record becomes one
training example — the candidate component matrix, the feasibility
mask, and a target label:

- shipped choice, when its realized regret stayed within
  ``cfg.policy_regret_margin`` (the decision was vindicated);
- else the hindsight-best candidate — the feasible candidate with the
  highest recorded net desirability, the same term the observer
  measured the regret in (the decision overpaid on the network and
  hindsight says which candidate would not have).

Outcomes are deduplicated on ``(uid, t_harvest)`` through a bounded
seen-set, so re-reading a stable outcome ring never double-counts an
example; evictions from that set only ever risk re-ingesting an old
example into a ring that samples with replacement anyway.
"""

from __future__ import annotations

import collections
from typing import Any, Mapping, NamedTuple

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.policy.model import (
    NUM_TERMS,
    TERMS,
    _record_arrays,
)


class ExampleBatch(NamedTuple):
    """One harvest's worth of training examples (numpy, host-side)."""

    comps: np.ndarray    # f32[B, K, NUM_TERMS]
    feas: np.ndarray     # f32[B, K]
    target: np.ndarray   # i32[B]
    cls: np.ndarray      # i32[B, K]
    uids: tuple[str, ...]


class PolicyDataset:
    """Bounded, idempotent outcome->example harvester.

    One instance per loop; :meth:`collect` is called from the policy
    maintain tick and by tests/bench directly.  Not thread-safe on
    its own — the caller (the maintain tick) is single-threaded, and
    the stores it reads are themselves thread-safe snapshots."""

    def __init__(self, cfg: SchedulerConfig, k_pad: int) -> None:
        self.cfg = cfg
        self.k_pad = int(k_pad)
        # (uid, t_harvest) pairs already converted to examples; twice
        # the outcome ring so the seen-set always covers everything
        # still resident in it.
        self._seen: collections.OrderedDict[tuple[str, float], None] = (
            collections.OrderedDict())
        self._seen_cap = max(16, 2 * cfg.quality_ring_size)
        self.joined_total = 0        # examples produced
        self.no_explain_total = 0    # outcome without explain record
        self.unlabelable_total = 0   # no feasible/shipped candidate

    def collect(self, flight, quality) -> ExampleBatch | None:
        """Join fresh quality outcomes against the explain store;
        returns the resulting examples (None when nothing new)."""
        if flight is None or quality is None:
            return None
        outcomes = quality.outcomes()
        if not outcomes:
            return None
        rows: list[tuple[np.ndarray, np.ndarray, np.ndarray, int]] = []
        uids: list[str] = []
        margin = self.cfg.policy_regret_margin
        for out in outcomes:
            uid = str(out.get("pod_uid", ""))
            key = (uid, float(out.get("t_harvest", 0.0)))
            if not uid or key in self._seen:
                continue
            self._seen[key] = None
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)
            rec = flight.get_explain(uid)
            if rec is None or not rec.get("candidates"):
                self.no_explain_total += 1
                continue
            example = self._label(rec, out, margin)
            if example is None:
                self.unlabelable_total += 1
                continue
            rows.append(example)
            uids.append(uid)
        if not rows:
            return None
        self.joined_total += len(rows)
        return ExampleBatch(
            comps=np.stack([r[0] for r in rows]),
            feas=np.stack([r[1] for r in rows]),
            target=np.asarray([r[3] for r in rows], np.int32),
            cls=np.stack([r[2] for r in rows]),
            uids=tuple(uids))

    def _label(self, rec: Mapping[str, Any], out: Mapping[str, Any],
               margin: float) -> tuple[np.ndarray, np.ndarray,
                                       np.ndarray, int] | None:
        cand = rec["candidates"]
        comps, feas, cls = _record_arrays(cand, self.k_pad)
        if not (feas > 0).any():
            return None
        shipped_idx = rec.get("node_index", -1)
        shipped_pos = None
        for i, c in enumerate(cand[:self.k_pad]):
            if (shipped_idx is not None
                    and int(c.get("node_index", -2)) == int(shipped_idx)
                    and feas[i] > 0):
                shipped_pos = i
                break
        regret = float(out.get("regret", 0.0))
        if shipped_pos is not None and regret <= margin:
            target = shipped_pos
        else:
            # Hindsight label: the feasible candidate with the best
            # recorded net desirability.  TERMS.index kept symbolic so
            # a component reorder breaks loudly here, not silently.
            net_col = comps[:, TERMS.index("net")]
            masked = np.where(feas > 0, net_col, -np.inf)
            target = int(np.argmax(masked))
            if not np.isfinite(masked[target]):
                return None
        return comps, feas, cls, int(target)

    def summary(self) -> dict[str, Any]:
        return {
            "joined_total": self.joined_total,
            "no_explain_total": self.no_explain_total,
            "unlabelable_total": self.unlabelable_total,
            "seen_depth": len(self._seen),
        }


__all__ = ["ExampleBatch", "PolicyDataset", "NUM_TERMS"]
