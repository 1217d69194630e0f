"""Learned scoring policy: term-level multipliers fit on the
scheduler's own decision/outcome log.

The PyTorch package's copy of the JAX package's ``policy/model.py``:
the parameters, Adam moments and EMA are f32 tensors on the policy's
device (default ``"cuda"``), the step is one function of tensors with
gradients from ``torch.autograd.grad``, and the example ring, the
shadow read and the promotion bookkeeping stay in numpy on the host.

The hand-tuned :class:`~kubernetesnetawarescheduler_tpu_torch.config.ScoreWeights`
constants are inherited from the Go reference's vote weights; nothing
in the repo ever checks whether 3/2/1/1/3/1 (or peer_bw=2 vs
balance=1) is the right trade for THIS cluster.  This module learns
that trade from evidence the system already produces: the r8 explain
store records every decision's top-k candidates WITH the additive
score decomposition, and the r11 QualityObserver joins each shipped
choice against realized probe truth (regret vs the best alternative).

Parameterization — deliberately tiny.  The score is already a sum of
five term groups (``base + net + soft - balance - spread``,
core/score.py), so the policy learns a log-space multiplier per term
group plus an optional per-zone-class additive bias:

    score_k = sum_t exp(theta[t]) * comp[t, k] + class_adj[zone_k]

``theta = 0`` is exactly the incumbent scorer (multiplier 1 per
term), so the identity init means an untrained policy shadow-agrees
with production by construction, and the learned weights stay
interpretable as "how much MORE the outcomes justify weighting the
net term" — directly mappable back onto a concrete ``ScoreWeights``
for promotion (:meth:`ScoringPolicy.to_score_weights`).

Training mirrors netmodel/model.py: one Adam mini-batch step over a
bounded host ring of examples, inverse-sqrt lr decay floored at
lr/8, and an EMA/Polyak read for serving so shadow decisions don't
jitter with the mini-batch orbit.  The objective is a masked softmax
cross-entropy over each decision's candidate set: the target is the
shipped choice when its realized regret stayed under
``cfg.policy_regret_margin``, else the hindsight-best candidate (the
feasible one with the highest net desirability — the term the
quality observer measured the regret in).

PROMOTION NEVER HAPPENS HERE.  The policy only ever (a) trains, (b)
shadow-scores recorded decisions and counts disagreement, and (c)
hands candidate weights to :mod:`policy.replay_eval`'s counterfactual
gate.  With ``enable_learned_score`` off the subsystem is never
constructed and scoring is bit-identical to a build without it
(tests/test_torch_policy.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig,
    ScoreWeights,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import resolve_device
from kubernetesnetawarescheduler_tpu_torch.netmodel.model import _adam

#: Order of the additive score-term groups the multipliers apply to
#: (matches the ``components`` dict of an explain record; balance and
#: spread are stored there as the SIGNED contribution, so a plain
#: weighted sum reproduces the total).
TERMS = ("base", "net", "soft", "balance", "spread")
NUM_TERMS = len(TERMS)

# Infeasible-candidate mask value: matches core/score.py's NEG_INF
# discipline (large-negative instead of -inf so downstream math never
# produces NaN via inf - inf).
_NEG = np.float32(-1e30)

# Polyak averaging horizon for the serving/shadow read — the same
# constant (and the same reasoning) as netmodel's prediction EMA:
# mini-batch Adam orbits its optimum, and a shadow decision flapping
# with that orbit would read as disagreement churn, not signal.
_EMA_DECAY = 0.998


class PolicyParams(NamedTuple):
    """Learnable parameters (f32 tensors on one device)."""

    theta: Any       # f32[NUM_TERMS]  log-space term multipliers
    class_adj: Any   # f32[C]          per-zone-class additive bias


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _candidate_scores(params: PolicyParams, comps, cls):
    """Policy score per candidate: ``comps[..., K, T] · exp(theta)``
    plus the zone-class bias where the candidate's class is known
    (``cls < 0`` = unknown zone, no adjustment)."""
    prod = comps * torch.exp(params.theta)
    # The term sum in order 0..T-1, as XLA reduces the five terms (a
    # vectorized sum would pair them and differ in the last bit).
    z = prod[..., 0]
    for t in range(1, prod.shape[-1]):
        z = z + prod[..., t]
    # Clamp keeps an out-of-range class (zone interned past max_zones)
    # from indexing out of bounds; the where() still zeroes unknown
    # (-1) rows.
    c = cls.clamp(0, params.class_adj.shape[0] - 1).long()
    return z + torch.where(cls >= 0, params.class_adj[c], 0.0)


def _loss(params: PolicyParams, comps, feas, target, cls):
    """Masked softmax cross-entropy of the target candidate, plus a
    light pull of theta toward 0 (multiplier 1)."""
    z = _candidate_scores(params, comps, cls)
    z = torch.where(feas > 0, z, float(_NEG))
    logp = z - torch.logsumexp(z, dim=-1, keepdim=True)
    ce = -torch.take_along_dim(logp, target.long()[:, None], dim=-1)[:, 0]
    reg = (1e-3 * params.theta.square().sum()
           + 1e-4 * params.class_adj.square().mean())
    return ce.mean() + reg


def _sgd_step(params: PolicyParams, m: PolicyParams, v: PolicyParams,
              t, ema: PolicyParams, comps, feas, target, cls, lr):
    """One Adam mini-batch step + the shadow-read EMA accumulate — the
    netmodel step applied to the policy parameters (b1/b2/eps, the
    bias-corrected moments and the EMA are identical)."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        loss = _loss(PolicyParams(*leaves), comps, feas, target, cls)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        return _adam(params, m, v, t, ema, grads, lr, PolicyParams,
                     _EMA_DECAY)


class ScoringPolicy:
    """Policy parameters + example ring + promotion bookkeeping.

    Threading: the maintain tick calls :meth:`add_examples` /
    :meth:`train` / :meth:`shadow_rank`; scrape/debug threads read
    :meth:`summary`; the counterfactual gate reads
    :meth:`to_score_weights`.  One RLock guards all mutable state
    (the policy never calls back into loop/encoder)."""

    def __init__(self, cfg: SchedulerConfig, seed: int = 0,
                 device="cuda") -> None:
        self.cfg = cfg
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        # Candidate axis padded to a pow2 of the explain top-k (the
        # JAX package's static shape, kept so the example ring and the
        # npz file have the same shapes in both packages).
        self.k_pad = _round_pow2(max(4, cfg.explain_top_k))
        self.num_classes = max(1, cfg.max_zones)
        self._reset_params_locked(
            np.zeros((NUM_TERMS,), np.float32),
            np.zeros((self.num_classes,), np.float32))

        cap = cfg.policy_ring
        self._ring_comps = np.zeros((cap, self.k_pad, NUM_TERMS),
                                    np.float32)
        self._ring_feas = np.zeros((cap, self.k_pad), np.float32)
        self._ring_target = np.zeros((cap,), np.int32)
        self._ring_cls = np.full((cap, self.k_pad), -1, np.int32)
        self._ring_pos = 0
        self._ring_count = 0
        self._batch_rng = np.random.default_rng(seed + 1)

        self.examples_total = 0     # examples ever ingested
        self.steps_total = 0        # Adam steps dispatched
        self.trains_total = 0       # train() calls that stepped
        self.evals_total = 0        # counterfactual gate runs
        self.promotions_total = 0
        self.rejections_total = 0   # gate runs that refused promotion
        self.shadow_agree_total = 0
        self.shadow_disagreement_total = 0
        # Version of the parameters the LAST promotion shipped (0 =
        # hand-tuned weights still live); provenance of that decision
        # rides checkpoint meta via last_promotion.
        self.promoted_version = 0
        self.promoted_weights: ScoreWeights | None = None
        self.last_promotion: dict[str, Any] | None = None
        self._version = 0
        self._np_params: PolicyParams | None = None
        self._refresh_np_locked()

    # -- dataset ring -------------------------------------------------

    def add_examples(self, comps: np.ndarray, feas: np.ndarray,
                     target: np.ndarray, cls: np.ndarray) -> int:
        """Insert harvested examples (``[B, k_pad, T]`` components,
        ``[B, k_pad]`` feasibility/class, ``[B]`` target index) into
        the ring.  Returns examples accepted."""
        b = int(comps.shape[0])
        if b == 0:
            return 0
        if (comps.shape[1:] != (self.k_pad, NUM_TERMS)
                or feas.shape != (b, self.k_pad)
                or cls.shape != (b, self.k_pad)
                or target.shape != (b,)):
            raise ValueError(
                f"example shapes {comps.shape}/{feas.shape}/"
                f"{cls.shape}/{target.shape} do not match "
                f"k_pad={self.k_pad}")
        cap = self._ring_comps.shape[0]
        with self._lock:
            for i in range(b):
                p = self._ring_pos
                self._ring_comps[p] = comps[i]
                self._ring_feas[p] = feas[i]
                self._ring_target[p] = target[i]
                self._ring_cls[p] = cls[i]
                self._ring_pos = (p + 1) % cap
                self._ring_count = min(self._ring_count + 1, cap)
            self.examples_total += b
        return b

    def ring_depth(self) -> int:
        with self._lock:
            return self._ring_count

    # -- training -----------------------------------------------------

    def train(self, steps: int | None = None) -> int:
        """Run ``steps`` (default ``cfg.policy_steps``) Adam steps
        over the example ring; returns steps dispatched.  Below
        ``cfg.policy_min_examples`` harvested examples nothing runs —
        a handful of decisions is noise, not a dataset."""
        cfg = self.cfg
        if steps is None:
            steps = cfg.policy_steps
        with self._lock:
            count = self._ring_count
            if count < cfg.policy_min_examples or steps <= 0:
                return 0
            params, m, v, t, ema = (self._params, self._opt_m,
                                    self._opt_v, self._opt_t,
                                    self._ema)
            lr = max(cfg.policy_lr
                     / float(np.sqrt(1.0 + self.steps_total / 500.0)),
                     cfg.policy_lr / 8.0)
            idx = np.stack([self._batch_rng.integers(
                0, count, size=cfg.policy_batch) for _ in range(steps)])
            dev = self.device
            comps, feas, target, cls = (
                torch.from_numpy(r[idx]).to(dev)
                for r in (self._ring_comps, self._ring_feas,
                          self._ring_target, self._ring_cls))
            for s in range(steps):
                params, m, v, t, ema = _sgd_step(
                    params, m, v, t, ema, comps[s], feas[s], target[s],
                    cls[s], lr)
            self._params = params
            self._opt_m, self._opt_v, self._opt_t = m, v, t
            self._ema = ema
            self.steps_total += steps
            self.trains_total += 1
            self._version += 1
            self._refresh_np_locked()
        return steps

    def _eval_params_locked(self) -> PolicyParams:
        """Bias-corrected EMA read (raw params before the first
        step) — identical discipline to netmodel."""
        t = float(self._opt_t)
        if t <= 0:
            return self._params
        c = 1.0 - _EMA_DECAY ** t
        return PolicyParams(*(e / c for e in self._ema))

    def _refresh_np_locked(self) -> None:
        self._np_params = PolicyParams(
            *(p.cpu().numpy() for p in self._eval_params_locked()))

    def _reset_params_locked(self, theta: np.ndarray,
                             class_adj: np.ndarray) -> None:
        """Parameters from host arrays, optimizer state and EMA fresh."""
        dev = self.device
        self._params = PolicyParams(theta=torch.from_numpy(theta).to(dev),
                                    class_adj=torch.from_numpy(
                                        class_adj).to(dev))
        self._opt_m = PolicyParams(*(torch.zeros_like(p)
                                     for p in self._params))
        self._opt_v = PolicyParams(*(torch.zeros_like(p)
                                     for p in self._params))
        self._opt_t = torch.zeros((), dtype=torch.float32, device=dev)
        self._ema = PolicyParams(*(torch.zeros_like(p)
                                   for p in self._params))

    # -- reads --------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def multipliers(self) -> np.ndarray:
        """``exp(theta)`` per TERMS entry, from the EMA read."""
        with self._lock:
            return np.exp(
                np.asarray(self._np_params.theta, np.float64))

    def predict(self, comps: np.ndarray, feas: np.ndarray,
                cls: np.ndarray) -> np.ndarray:
        """Host-side candidate scores ``[..., K]`` under the EMA
        parameters (infeasible candidates masked to -1e30).  Cheap
        numpy math — this is the shadow/replay read, never the
        serving hot path."""
        with self._lock:
            p = self._np_params
        mult = np.exp(p.theta.astype(np.float64))
        z = comps.astype(np.float64) @ mult
        c = np.clip(cls, 0, p.class_adj.shape[0] - 1)
        z = z + np.where(cls >= 0, p.class_adj[c], 0.0)
        return np.where(feas > 0, z, float(_NEG))

    def shadow_rank(self, record: Mapping[str, Any]) -> int | None:
        """The policy's preferred ``node_index`` for one explain
        record (None when the record has no feasible candidates).
        Counts agreement/disagreement against the shipped decision."""
        cand = record.get("candidates") or []
        if not cand:
            return None
        comps, feas, cls = _record_arrays(cand, self.k_pad)
        scores = self.predict(comps[None], feas[None], cls[None])[0]
        if not (feas > 0).any():
            return None
        best = int(np.argmax(scores))
        pick = int(cand[best]["node_index"])
        shipped = record.get("node_index", -1)
        with self._lock:
            if shipped is not None and int(shipped) == pick:
                self.shadow_agree_total += 1
            else:
                self.shadow_disagreement_total += 1
        return pick

    def disagreement_rate(self) -> float:
        with self._lock:
            n = self.shadow_agree_total + self.shadow_disagreement_total
            if n == 0:
                return 0.0
            return self.shadow_disagreement_total / n

    def to_score_weights(self, base: ScoreWeights | None = None
                         ) -> ScoreWeights:
        """Map the learned term multipliers onto a concrete
        :class:`ScoreWeights` (what the counterfactual gate replays
        and what a promotion installs): the base multiplier scales
        every metric-vote channel, net scales both peer terms, and
        soft/balance/spread scale their own knobs.  The zone-class
        bias has no ScoreWeights analog — it only sharpens the
        shadow/label model — so promotion is driven by the term
        multipliers alone."""
        w = base if base is not None else self.cfg.weights
        m = self.multipliers()
        return dataclasses.replace(
            w,
            cpu=w.cpu * m[0], mem=w.mem * m[0],
            net_tx=w.net_tx * m[0], net_rx=w.net_rx * m[0],
            bandwidth=w.bandwidth * m[0], disk=w.disk * m[0],
            peer_bw=w.peer_bw * m[1], peer_lat=w.peer_lat * m[1],
            soft_affinity=w.soft_affinity * m[2],
            balance=w.balance * m[3],
            spread=w.spread * m[4])

    def note_promotion(self, decision: Mapping[str, Any],
                       weights: ScoreWeights) -> None:
        """Record a gate-approved promotion (called by the loop AFTER
        it installed ``weights``); provenance lands in checkpoint
        meta and /debug/policy."""
        with self._lock:
            self.promotions_total += 1
            self.promoted_version = self._version
            self.promoted_weights = weights
            self.last_promotion = dict(decision)

    # -- fleet transfer (r15) -----------------------------------------

    def export_params(self) -> dict[str, np.ndarray]:
        """EMA-read parameters as plain numpy — the fleet transfer
        registry's donor payload (decoupled from this policy's device
        tensors, so a registry entry outlives the donor tenant)."""
        with self._lock:
            p = self._eval_params_locked()
            return {"theta": p.theta.cpu().numpy().astype(np.float32),
                    "class_adj": p.class_adj.cpu().numpy().astype(
                        np.float32)}

    def warm_start_from(self, theta: np.ndarray,
                        class_adj: np.ndarray) -> None:
        """Seed parameters from a donor tenant (fleet transfer).

        Optimizer state starts FRESH (``opt_t=0``, so the eval read
        returns the seeded parameters verbatim until this tenant's own
        first train step), and ``class_adj`` is zero-padded/truncated
        to this config's zone-class count — donor and recipient need
        not share ``max_zones``.  Transfer changes only where learning
        STARTS: the seeded policy still serves shadow-only until it
        wins this tenant's own counterfactual-replay gate."""
        th = np.asarray(theta, np.float32).reshape(-1)
        if th.shape[0] != NUM_TERMS:
            raise ValueError(
                f"donor theta has {th.shape[0]} terms, "
                f"expected {NUM_TERMS}")
        ca = np.zeros((self.num_classes,), np.float32)
        src = np.asarray(class_adj, np.float32).reshape(-1)
        n = min(self.num_classes, src.shape[0])
        ca[:n] = src[:n]
        with self._lock:
            self._reset_params_locked(th.copy(), ca)
            self._version += 1
            self._refresh_np_locked()

    def summary(self) -> dict[str, Any]:
        """One-shot stats block for /debug/policy, /metrics, bench."""
        with self._lock:
            mult = np.exp(np.asarray(self._np_params.theta,
                                     np.float64))
            return {
                "enabled": True,
                "version": self._version,
                "ring_depth": self._ring_count,
                "ring_size": int(self._ring_comps.shape[0]),
                "examples_total": self.examples_total,
                "steps_total": self.steps_total,
                "trains_total": self.trains_total,
                "evals_total": self.evals_total,
                "promotions_total": self.promotions_total,
                "rejections_total": self.rejections_total,
                "promoted_version": self.promoted_version,
                "shadow_agree_total": self.shadow_agree_total,
                "shadow_disagreement_total":
                    self.shadow_disagreement_total,
                "disagreement_rate": (
                    self.shadow_disagreement_total
                    / max(1, self.shadow_agree_total
                          + self.shadow_disagreement_total)),
                "multipliers": {t: float(mult[i])
                                for i, t in enumerate(TERMS)},
                "last_promotion": (dict(self.last_promotion)
                                   if self.last_promotion else None),
            }

    # -- persistence --------------------------------------------------

    def save(self, path: str) -> None:
        """Atomically persist parameters + optimizer + EMA + example
        ring + counters to one ``.npz`` (save -> load -> predict is
        exact; pinned by tests/test_torch_policy.py)."""
        with self._lock:
            arrays = {}
            for prefix, tree in (("param", self._params),
                                 ("opt_m", self._opt_m),
                                 ("opt_v", self._opt_v),
                                 ("ema", self._ema)):
                arrays.update({f"{prefix}_{n}": v.cpu().numpy()
                               for n, v in zip(PolicyParams._fields,
                                               tree)})
            arrays["opt_t"] = self._opt_t.cpu().numpy()
            arrays.update(
                ring_comps=self._ring_comps.copy(),
                ring_feas=self._ring_feas.copy(),
                ring_target=self._ring_target.copy(),
                ring_cls=self._ring_cls.copy(),
                scalars=np.asarray(
                    [self._ring_pos, self._ring_count,
                     self.examples_total, self.steps_total,
                     self.trains_total, self.evals_total,
                     self.promotions_total, self.rejections_total,
                     self.shadow_agree_total,
                     self.shadow_disagreement_total,
                     self.promoted_version, self._version],
                    np.float64))
            if self.promoted_weights is not None:
                arrays["promoted_weights"] = np.asarray(
                    _weights_to_vector(self.promoted_weights),
                    np.float64)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, cfg: SchedulerConfig, seed: int = 0,
             device="cuda") -> "ScoringPolicy":
        policy = cls(cfg, seed=seed, device=device)
        dev = policy.device

        def tree(prefix, data):
            return PolicyParams(*(torch.from_numpy(np.asarray(
                data[f"{prefix}_{n}"], np.float32)).to(dev)
                for n in PolicyParams._fields))

        with np.load(path) as data:
            for name, init in zip(PolicyParams._fields,
                                  policy._params):
                stored = data[f"param_{name}"]
                if stored.shape != tuple(init.shape):
                    raise ValueError(
                        f"policy checkpoint param {name} has shape "
                        f"{stored.shape}, config expects "
                        f"{tuple(init.shape)} (max_zones changed — "
                        "start fresh)")
            policy._params = tree("param", data)
            policy._opt_m = tree("opt_m", data)
            policy._opt_v = tree("opt_v", data)
            policy._opt_t = torch.from_numpy(np.asarray(
                data["opt_t"], np.float32)).to(dev)
            policy._ema = tree("ema", data)
            for ring in ("ring_comps", "ring_feas", "ring_target",
                         "ring_cls"):
                stored = data[ring]
                target = getattr(policy, f"_{ring}")
                if stored.shape != target.shape:
                    raise ValueError(
                        f"policy checkpoint {ring} has shape "
                        f"{stored.shape}, config ring is "
                        f"{target.shape}")
                target[...] = stored
            sc = data["scalars"]
            policy._ring_pos = int(sc[0])
            policy._ring_count = int(sc[1])
            policy.examples_total = int(sc[2])
            policy.steps_total = int(sc[3])
            policy.trains_total = int(sc[4])
            policy.evals_total = int(sc[5])
            policy.promotions_total = int(sc[6])
            policy.rejections_total = int(sc[7])
            policy.shadow_agree_total = int(sc[8])
            policy.shadow_disagreement_total = int(sc[9])
            policy.promoted_version = int(sc[10])
            policy._version = int(sc[11])
            if "promoted_weights" in data:
                policy.promoted_weights = _weights_from_vector(
                    data["promoted_weights"])
        policy._refresh_np_locked()
        return policy


# -- ScoreWeights <-> flat vector (canonical order, shared with
#    tools/state_audit.py and the checkpoint meta block) -------------

WEIGHT_FIELDS = ("cpu", "mem", "net_tx", "net_rx", "bandwidth",
                 "disk", "peer_bw", "peer_lat", "balance",
                 "soft_affinity", "spread")


def _weights_to_vector(w: ScoreWeights) -> list[float]:
    return [float(getattr(w, f)) for f in WEIGHT_FIELDS]


def _weights_from_vector(vec: Sequence[float]) -> ScoreWeights:
    return ScoreWeights(**{f: float(v)
                           for f, v in zip(WEIGHT_FIELDS, vec)})


def _record_arrays(candidates: Sequence[Mapping[str, Any]],
                   k_pad: int) -> tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
    """Pack one explain record's candidate list into the fixed
    ``[k_pad]`` arrays the policy consumes (shared by shadow ranking,
    the dataset's join and the counterfactual gate)."""
    comps = np.zeros((k_pad, NUM_TERMS), np.float32)
    feas = np.zeros((k_pad,), np.float32)
    cls = np.full((k_pad,), -1, np.int32)
    for i, c in enumerate(candidates[:k_pad]):
        cc = c.get("components") or {}
        for t_idx, term in enumerate(TERMS):
            comps[i, t_idx] = float(cc.get(term, 0.0))
        feas[i] = 1.0 if c.get("feasible") else 0.0
        cls[i] = int(c.get("zone", -1))
    return comps, feas, cls
