"""Learned scoring policy (``enable_learned_score``).

The PyTorch package's copy of the JAX package's ``policy/``.  Three
parts, wired through the serving loop's maintain cadence:

- :mod:`.model` — term-level multiplier model (one Adam step function
  of tensors over a bounded example ring, EMA read, npz checkpoint);
- :mod:`.dataset` — off-hot-path join of explain records and quality
  outcomes into training examples;
- :mod:`.replay_eval` — the counterfactual promotion gate: the
  recorded re-score, then a seeded scenario replay of incumbent vs
  candidate weights (``scenario/``).

Disabled (the default) the subsystem is never constructed and
scoring is bit-identical to the hand-tuned weights.
"""

from kubernetesnetawarescheduler_tpu_torch.policy.dataset import (
    PolicyDataset,
)
from kubernetesnetawarescheduler_tpu_torch.policy.model import (
    TERMS,
    PolicyParams,
    ScoringPolicy,
)
from kubernetesnetawarescheduler_tpu_torch.policy.replay_eval import (
    PromotionDecision,
    evaluate_candidate,
    rescore_records,
    term_multipliers,
)

__all__ = [
    "PolicyDataset",
    "PolicyParams",
    "PromotionDecision",
    "ScoringPolicy",
    "TERMS",
    "evaluate_candidate",
    "rescore_records",
    "term_multipliers",
]
