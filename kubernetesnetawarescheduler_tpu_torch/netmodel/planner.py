"""Expected-information-gain probe planning.

The PyTorch package's copy of the JAX package's ``netmodel/planner.py``,
numpy only.  Both packages pick the same pairs, ties included: the
candidate scores are the same f32 values in the same row-major
upper-triangle order, and the top-k goes through the same
``argpartition``/``argsort``.  The port builds that score vector over
the upper triangle only, with the exponential taken only on the pairs
ever probed (a never-probed pair's age factor is exactly 1), and caches
the triangle mask and the relevance term between cycles: at 5k nodes
the JAX form builds and indexes several N² temporaries per cycle.

Stalest-pair-first probing (the orchestrator's default) spends the
budget uniformly over the pair space: at 5k nodes every pair gets
re-probed every ~54 hours whether the model is certain about it or
not.  Once a :class:`~.model.TopologyModel` is learning the topology,
the budget is better spent where a measurement changes the most
beliefs: pairs whose ENDPOINTS the model is uncertain about, weighted
by how much placement actually cares about those nodes.

The planner scores every candidate pair as::

    EIG(i, j) ~ age_factor(i, j) * (uncert(i) + uncert(j))
                * sqrt(relevance(i) * relevance(j))

- ``age_factor = 1 - exp(-age / tau)`` — a just-probed pair carries no
  new information; never-probed pairs saturate at 1.
- ``uncert = 1 / (1 + n_obs / conf_k)`` — the complement of the
  model's per-node confidence saturation; a node with many
  observations pins its coordinates/factors, so further probes on it
  are low-gain.
- ``relevance`` — an EMA of placement activity per node
  (:meth:`note_placements`), defaulting to uniform: probing decides
  placements, so nodes that actually receive pods deserve sharper
  estimates.

A configurable ``explore_frac`` share of every budget still goes to
pure stalest-first selection — the model's uncertainty estimate is
itself learned, and a persistently-wrong confident region would
otherwise never be re-measured (the classic active-learning echo
chamber).

The planner also reports the Shannon entropy of each cycle's selected
score distribution (``last_entropy_bits``) — collapsing entropy means
the planner is fixating on few pairs, a tuning signal exported via
self-metrics.
"""

from __future__ import annotations

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.netmodel.model import TopologyModel


class EIGProbePlanner:
    """Uncertainty x placement-relevance pair selection for the
    :class:`~..ingest.probe.ProbeOrchestrator` (its ``planner=`` hook).
    """

    def __init__(self, model: TopologyModel, explore_frac: float = 0.25,
                 relevance_decay: float = 0.99, seed: int = 0) -> None:
        if not 0.0 <= explore_frac <= 1.0:
            raise ValueError("explore_frac must be in [0, 1]")
        self._model = model
        self._explore_frac = float(explore_frac)
        self._decay = float(relevance_decay)
        self._relevance = np.ones((model.cfg.max_nodes,), np.float32)
        self._relevance_version = 0
        # (n, upper-triangle mask, row starts of the flat triangle) and
        # (n, relevance version, flat relevance term), reused while
        # their keys hold.
        self._tri: tuple | None = None
        self._rel: tuple | None = None
        self.last_entropy_bits = 0.0
        self.selections_total = 0

    def note_placements(self, node_indices) -> None:
        """Feed placement activity (encoder node slots of fresh binds);
        bumps those nodes' relevance EMA."""
        idx = np.asarray(list(node_indices), np.int64)
        if idx.size == 0:
            return
        self._relevance *= self._decay
        np.add.at(self._relevance, idx, 1.0)
        self._relevance_version += 1

    def _triangle(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """The ``(i < j)`` mask of an ``n x n`` plane (row-major boolean
        indexing walks it in ``np.triu_indices(n, 1)`` order) and the
        flat offset of each row's first pair."""
        if self._tri is None or self._tri[0] != n:
            mask = np.triu(np.ones((n, n), bool), 1)
            rows = np.arange(n, dtype=np.int64)
            starts = rows * (2 * n - rows - 1) // 2
            self._tri = (n, mask, starts)
        return self._tri[1], self._tri[2]

    def _relevance_flat(self, n: int, mask: np.ndarray) -> np.ndarray:
        key = (n, self._relevance_version)
        if self._rel is None or self._rel[0] != key:
            rel = np.sqrt(np.outer(self._relevance[:n],
                                   self._relevance[:n]))
            self._rel = (key, rel[mask])
        return self._rel[1]

    def select_pairs(self, n: int, budget: int,
                     stalest_fn) -> list[tuple[int, int]]:
        """Pick ``budget`` index pairs among the first ``n`` nodes.
        ``stalest_fn(k)`` is the orchestrator's stalest-first selector,
        used for the exploration share."""
        if budget <= 0 or n < 2:
            return []
        k_explore = min(budget, int(round(self._explore_frac * budget)))
        explore = [tuple(p) for p in stalest_fn(k_explore)] \
            if k_explore else []
        k_exploit = budget - len(explore)
        if k_exploit <= 0:
            self.selections_total += len(explore)
            return explore

        m = self._model
        cfg = m.cfg
        mask, starts = self._triangle(n)
        with m._lock:
            node_obs = m._node_obs[:n].copy()
            last = m._last_obs[:n, :n][mask]
            clock = m._clock
        uncert = 1.0 / (1.0 + node_obs / cfg.netmodel_conf_k)
        # age_f = 1 - exp(-age / tau): exactly 1 where never probed
        # (age +inf), the exponential only where probed.
        age_f = np.ones(last.shape, np.float32)
        seen = np.flatnonzero(np.isfinite(last))
        age = clock - last[seen]
        age_f[seen] = 1.0 - np.exp(
            -np.clip(age, 0.0, 1e12) / cfg.netmodel_tau_s)
        usum = (uncert[:, None] + uncert[None, :])[mask]
        flat = age_f * usum * self._relevance_flat(n, mask)

        taken = set(explore)
        # Over-select so dropping the exploration duplicates still
        # leaves a full budget, then trim.
        k = min(flat.size, k_exploit + len(taken))
        top = np.argpartition(flat, flat.size - k)[flat.size - k:]
        top = top[np.argsort(flat[top])[::-1]]
        exploit: list[tuple[int, int]] = []
        chosen_scores: list[float] = []
        rows = np.searchsorted(starts, top, side="right") - 1
        cols = top - starts[rows] + rows + 1
        for t, i, j in zip(top, rows, cols):
            pair = (int(i), int(j))
            if pair in taken:
                continue
            exploit.append(pair)
            chosen_scores.append(float(flat[t]))
            if len(exploit) >= k_exploit:
                break

        total = np.asarray(chosen_scores, np.float64)
        mass = float(total.sum())
        if total.size and mass > 0:
            p = total / mass
            nz = p > 0
            self.last_entropy_bits = float(
                -(p[nz] * np.log2(p[nz])).sum())
        else:
            self.last_entropy_bits = 0.0
        self.selections_total += len(explore) + len(exploit)
        return explore + exploit
