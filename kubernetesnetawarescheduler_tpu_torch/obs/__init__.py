"""Outcome observability: did the placements turn out good?

The PyTorch package's copy of the JAX package's ``obs/``.

Decision-level tracing (utils/flight.py) records what the
scheduler *did*; this package measures whether it was *right* once
probe data caught up, and whether the serving SLOs are holding:

- :mod:`.quality` — placement-quality evaluator joining score-time
  predictions against subsequently observed probe truth (realized
  bandwidth/latency, regret-vs-best-alternative, netmodel calibration
  residuals), appended to a bounded outcome ring.
- :mod:`.slo` — declarative SLO objectives evaluated over
  multi-window burn rates, feeding /readyz degradation, k8s Events
  and flight-span tagging.

Everything here is observation-only: nothing feeds back into scoring,
so placements are bit-identical with observation on or off (pinned by
tests/test_torch_quality_slo.py).
"""

from kubernetesnetawarescheduler_tpu_torch.obs.quality import QualityObserver
from kubernetesnetawarescheduler_tpu_torch.obs.slo import (
    Objective,
    SLOEngine,
    breach_fraction,
    burn_rate,
    is_burning,
)

__all__ = [
    "Objective",
    "QualityObserver",
    "SLOEngine",
    "breach_fraction",
    "burn_rate",
    "is_burning",
]
