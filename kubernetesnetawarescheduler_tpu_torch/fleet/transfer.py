"""Cross-cluster policy transfer.

The PyTorch package's own copy of
``kubernetesnetawarescheduler_tpu/fleet/transfer.py`` (numpy only).

A scoring policy that won its promotion gate on one tenant is a
better starting point than zero-init for a SIMILAR tenant — the
continuous-transfer observation from the HPC scheduling literature
(PAPERS.md).  The registry holds promoted donors keyed by the
size/topology fingerprint from ``Encoder.topology_features()``; a new
tenant warm-starts from the CLOSEST donor (normalized feature
distance), then learns on its own data.

The gate stays strictly per-tenant: ``warm_start`` only seeds
``ScoringPolicy`` parameters through its ``export_params`` and
``warm_start_from`` (fresh optimizer, shadow-only serving) —
the transferred policy is promoted ONLY when it wins the recipient's
own two-leg counterfactual replay, exactly like a cold-started one.
What transfer buys is fewer examples-to-promotion, which the fleet
bench leg measures (warm vs cold on a seeded scenario pair).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np


# Per-feature normalization scales for the donor distance: node count
# and fabric stats are compared in LOG space (a 64- vs 128-node tenant
# is "one doubling apart", same for 1 vs 2 GB/s fabrics), zone count
# linearly.
_LOG_FEATURES = ("nodes", "lat_mean", "bw_mean")
_LIN_FEATURES = ("zones",)


def _feature_vector(features: dict[str, float]) -> np.ndarray:
    out = []
    for k in _LOG_FEATURES:
        out.append(math.log1p(max(float(features.get(k, 0.0)), 0.0)))
    for k in _LIN_FEATURES:
        out.append(float(features.get(k, 0.0)))
    return np.asarray(out, np.float64)


@dataclass
class DonorRecord:
    """One promoted policy, frozen at registration time (numpy copies
    — the record outlives the donor tenant)."""

    cluster_id: str
    features: dict[str, float]
    theta: np.ndarray
    class_adj: np.ndarray
    promoted_version: int
    registered_t: float = field(default_factory=time.time)

    def to_dict(self) -> dict[str, Any]:
        return {
            "cluster_id": self.cluster_id,
            "features": dict(self.features),
            "promoted_version": int(self.promoted_version),
            "registered_t": self.registered_t,
        }


class TransferRegistry:
    """Thread-safe registry of promoted donor policies.

    ``register`` is called when a tenant's policy wins its promotion
    gate (the FleetServer does this on its maintain path; benches call
    it directly).  ``closest`` / ``warm_start`` serve onboarding."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._donors: dict[str, DonorRecord] = {}
        self.transfers_total = 0

    def register(self, cluster_id: str, features: dict[str, float],
                 policy) -> DonorRecord | None:
        """Record ``policy`` as a donor iff it has actually been
        promoted (``promoted_version > 0``) — a shadow-only policy has
        never proven itself and must not seed peers.  Re-registration
        replaces the tenant's previous record (latest promotion
        wins)."""
        if getattr(policy, "promoted_version", 0) <= 0:
            return None
        params = policy.export_params()
        rec = DonorRecord(
            cluster_id=str(cluster_id),
            features=dict(features),
            theta=params["theta"],
            class_adj=params["class_adj"],
            promoted_version=int(policy.promoted_version),
        )
        with self._lock:
            self._donors[rec.cluster_id] = rec
        return rec

    def closest(self, features: dict[str, float],
                exclude: str | None = None) -> DonorRecord | None:
        """The donor with the smallest normalized feature distance to
        ``features`` (None when the registry is empty or holds only
        the excluded tenant — self-transfer is meaningless)."""
        target = _feature_vector(features)
        best: DonorRecord | None = None
        best_d = math.inf
        with self._lock:
            donors = list(self._donors.values())
        for rec in donors:
            if exclude is not None and rec.cluster_id == exclude:
                continue
            d = float(np.linalg.norm(
                _feature_vector(rec.features) - target))
            if d < best_d:
                best, best_d = rec, d
        return best

    def warm_start(self, policy, features: dict[str, float],
                   exclude: str | None = None
                   ) -> DonorRecord | None:
        """Seed ``policy`` from the closest donor; returns the donor
        record used (None -> cold start, registry had no usable
        donor).  The seeded policy serves shadow-only until it wins
        the recipient tenant's own counterfactual-replay gate."""
        rec = self.closest(features, exclude=exclude)
        if rec is None:
            return None
        policy.warm_start_from(rec.theta, rec.class_adj)
        with self._lock:
            self.transfers_total += 1
        return rec

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "donors": {cid: rec.to_dict()
                           for cid, rec in self._donors.items()},
                "transfers_total": self.transfers_total,
            }
