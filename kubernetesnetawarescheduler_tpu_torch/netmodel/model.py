"""Learned network-topology model: the sparse probe stream becomes
dense, confidence-weighted latency/bandwidth estimates.

The PyTorch package's copy of the JAX package's ``netmodel/model.py``.
The probe orchestrator's budget covers a vanishing fraction of the
pair space at scale (5k nodes = 12.5M pairs at 64 probes/cycle ≈ 54
hours per full sweep), so the ``lat``/``bw`` planes the scorer reads
are almost entirely unobserved zeros.  This module treats the planes as
a MODEL fit on the probe stream:

- **Latency** — a Vivaldi-style coordinate embedding: each node gets a
  coordinate ``x[d]`` plus a non-negative "height" (access-link cost);
  predicted latency is ``||x_i - x_j|| + h_i + h_j``.
- **Bandwidth** — low-rank matrix completion in log space:
  ``log1p(bw[i, j]) ≈ mu + su_i + sv_j + u_i · v_j`` with per-node
  up/downlink biases and rank-``r`` factors for the rack/zone blocks.

Both are trained by one mini-batch Adam step function of tensors
(:func:`_sgd_step`, gradients from ``torch.autograd.grad``) over a
fixed-size host ring buffer of recent observations.  Parameters,
moments and the prediction EMA live on the model's device (default
``"cuda"``); the ring, the confidence state, the residual monitor and
:meth:`TopologyModel.blend` stay in numpy on the host, as in the JAX
package.  Parameter init and mini-batch draws come from the same numpy
generators as there (``default_rng(seed)`` / ``(seed + 1)``), so the two
packages start bit-identical and draw the same batches.

``blend()`` merges model predictions into the probe planes with two
weights per pair: direct-probe freshness ``exp(-age/tau)`` and model
confidence (a product of per-node observation-count saturations), so
fresh probes win, stale/absent pairs fall back to the model, and pairs
the model knows nothing about keep the raw probe value.  The encoder's
snapshot and its ``expected_device_arrays()`` both call it.

A residual monitor compares each fresh measurement against the current
prediction BEFORE ingesting it: a confident model disagreeing sharply
with a fresh probe is a link-degradation signal.

Threading: ``observe``/``fit`` run on the probe-orchestrator thread;
``blend`` runs under the encoder lock on snapshot paths; all mutable
state is guarded by ``_lock`` (lock order: encoder lock, then model
lock — the model never calls back into the encoder).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.state import resolve_device


class TopoParams(NamedTuple):
    """Model parameters (f32 tensors on one device; ``N = max_nodes``)."""

    x: torch.Tensor    # f32[N, d]  latency coordinates
    h: torch.Tensor    # f32[N]     access-link height (relu'd in predict)
    u: torch.Tensor    # f32[N, r]  bandwidth row factors
    v: torch.Tensor    # f32[N, r]  bandwidth col factors
    su: torch.Tensor   # f32[N]     per-node uplink bias (log-bw space)
    sv: torch.Tensor   # f32[N]     per-node downlink bias
    mu: torch.Tensor   # f32[]      global log-bandwidth level


def _pair_predict(params: TopoParams, i, j):
    """Predicted (lat_ms, log1p_bw) for observation index vectors."""
    delta = params.x[i] - params.x[j]
    dist = torch.sqrt((delta * delta).sum(dim=-1) + 1e-6)
    lat = dist + torch.relu(params.h[i]) + torch.relu(params.h[j])
    y = (params.mu + params.su[i] + params.sv[j]
         + (params.u[i] * params.v[j]).sum(dim=-1))
    return lat, y


def _loss(params: TopoParams, i, j, lat_obs, y_obs, w_lat, w_bw):
    lat_hat, y_hat = _pair_predict(params, i, j)
    l_lat = ((w_lat * (lat_hat - lat_obs).square()).sum()
             / (w_lat.sum() + 1e-6))
    l_bw = ((w_bw * (y_hat - y_obs).square()).sum()
            / (w_bw.sum() + 1e-6))
    # Light factor decay: keeps unobserved rows near zero so the
    # row/col biases (not stale factors) carry never-probed nodes.
    reg = 1e-4 * (params.u.square().mean() + params.v.square().mean())
    return l_lat + l_bw + reg


# Polyak averaging horizon for the prediction parameters: ~500 steps.
# Predictions read an EMA of the Adam iterates (bias-corrected at read
# time), not the iterates themselves: mini-batch Adam orbits its
# optimum, and that noise blurs the same-rack block edges gang
# placement keys on.
_EMA_DECAY = 0.998


def _adam(params, m, v, t, ema, grads, lr, kind, decay=_EMA_DECAY):
    """Adam moments, the bias-corrected step and the EMA accumulate (at
    ``decay``), as the JAX step writes them: ``b1 ** t`` in f32 with
    ``t`` an f32 scalar tensor.  ``kind`` is the parameter tuple type.
    The scoring policy's step shares it."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = t + 1
    m = kind(*(b1 * a + (1 - b1) * g for a, g in zip(m, grads)))
    v = kind(*(b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)))
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    params = kind(*(p - lr * (a / c1) / (torch.sqrt(b / c2) + eps)
                    for p, a, b in zip(params, m, v)))
    ema = kind(*(decay * e + (1.0 - decay) * p
                 for e, p in zip(ema, params)))
    return params, m, v, t, ema


def _sgd_step(params: TopoParams, m: TopoParams, v: TopoParams, t,
              ema: TopoParams, i, j, lat_obs, y_obs, w_lat, w_bw, lr):
    """One Adam mini-batch step + the prediction-EMA accumulate.

    Plain SGD diverges on the ``u_i . v_j`` interaction and Adagrad's
    rate decays before the factors grow (see the JAX package's notes);
    Adam's per-parameter normalized rate reaches the floor in a few
    thousand steps.  Rows with no gradient history (never-observed
    nodes) have zero moments and stay exactly at init.  ``ema`` is
    zero-initialized and bias-corrected at read time."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        loss = _loss(TopoParams(*leaves), i, j, lat_obs, y_obs, w_lat,
                     w_bw)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        return _adam(params, m, v, t, ema, grads, lr, TopoParams)


def _ordered_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a bᵀ`` for narrow f32 ``a [N, d]``, ``b [M, d]`` as the chain of
    fused multiply-adds over k = 0..d-1 that XLA's and PyTorch's CPU
    products compute (bit for bit, checked at d = 4 and 8), each FMA
    emulated exactly in f64 (an f32 product is exact in f64) and rounded
    to f32 once.  Elementwise f64 ops round alike on the card and the
    CPU, so the result is the same on both; a library product of inner
    width ``d`` would leave the order and the fusion to the library.
    For ``x xᵀ`` that is not harmless: ``|x_i|² + |x_j|² - 2 x_i·x_j``
    cancels to ≈0 for near pairs, where one ulp moves the distance by
    tens of percent."""
    f64 = torch.float64
    out = (a[:, 0, None].to(f64) * b[None, :, 0].to(f64)).to(torch.float32)
    for k in range(1, a.shape[1]):
        out = (out.to(f64) + a[:, k, None].to(f64) * b[None, :, k].to(f64)
               ).to(torch.float32)
    return out


def _predict_dense(params: TopoParams):
    """Dense ``(lat_hat[N, N], bw_hat[N, N])`` from the parameters.

    Distances via the Gram identity (no N x N x d intermediate).  Both
    products are :func:`_ordered_outer` and the squared norms are summed
    term by term in order, as XLA does: the same bits on every device
    and as the JAX package's on the CPU."""
    x = params.x
    sq = x[:, 0] * x[:, 0]
    for k in range(1, x.shape[1]):
        sq = sq + x[:, k] * x[:, k]
    d2 = sq[:, None] + sq[None, :] - 2.0 * _ordered_outer(x, x)
    dist = torch.sqrt(d2.clamp_min(0.0) + 1e-6)
    hh = torch.relu(params.h)
    lat = dist + hh[:, None] + hh[None, :]
    y = (params.mu + params.su[:, None] + params.sv[None, :]
         + _ordered_outer(params.u, params.v))
    # Clip the log-bandwidth before exp: an early-training outlier row
    # must saturate, not overflow f32 into inf.
    bw = torch.expm1(y.clamp(0.0, 60.0))
    return lat, bw


def _init_params(cfg: SchedulerConfig, seed: int,
                 dev: torch.device) -> TopoParams:
    n, d, r = cfg.max_nodes, cfg.netmodel_dim, cfg.netmodel_rank
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(r)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    return TopoParams(
        x=t(0.1 * rng.standard_normal((n, d)).astype(np.float32)),
        h=torch.zeros((n,), dtype=torch.float32, device=dev),
        u=t((scale * rng.standard_normal((n, r))).astype(np.float32)),
        v=t((scale * rng.standard_normal((n, r))).astype(np.float32)),
        su=torch.zeros((n,), dtype=torch.float32, device=dev),
        sv=torch.zeros((n,), dtype=torch.float32, device=dev),
        mu=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _zeros_like(params) -> tuple:
    return type(params)(*(torch.zeros_like(p) for p in params))


class TopologyModel:
    """Topology estimator + ring buffer + confidence/residual state.

    One instance is sized to ``cfg.max_nodes`` and indexed by ENCODER
    node slot (the orchestrator resolves names before calling
    :meth:`observe`), so slot reuse after node removal flows through
    :meth:`reset_node`.  The parameters live on ``device``."""

    def __init__(self, cfg: SchedulerConfig, seed: int = 0,
                 device="cuda") -> None:
        cap = cfg.netmodel_ring
        n = cfg.max_nodes
        self.cfg = cfg
        self.seed = int(seed)
        self.enabled = cfg.enable_netmodel
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._params = _init_params(cfg, seed, self.device)
        self._opt_m = _zeros_like(self._params)
        self._opt_v = _zeros_like(self._params)
        self._opt_t = torch.zeros((), dtype=torch.float32,
                                  device=self.device)
        self._ema = _zeros_like(self._params)

        # Observation ring buffer (host): each probe inserts BOTH
        # directed entries (i, j) and (j, i) so every node trains in
        # both the row-factor and col-factor role.
        self._ring_i = np.zeros((cap,), np.int32)
        self._ring_j = np.zeros((cap,), np.int32)
        self._ring_lat = np.zeros((cap,), np.float32)
        self._ring_y = np.zeros((cap,), np.float32)
        self._ring_wlat = np.zeros((cap,), np.float32)
        self._ring_wbw = np.zeros((cap,), np.float32)
        self._ring_pos = 0
        self._ring_count = 0
        self._batch_rng = np.random.default_rng(seed + 1)

        # Confidence bookkeeping: per-node observation counts, the
        # per-pair clock of the last direct probe (-inf = never), and
        # the per-pair last measured log-bandwidth (NaN = never).
        self._node_obs = np.zeros((n,), np.float32)
        self._last_obs = np.full((n, n), -np.inf, np.float32)
        self._last_y = np.full((n, n), np.nan, np.float32)
        self._clock = 0.0
        self.pairs_observed = 0     # distinct unordered pairs ever probed
        self.steps_total = 0        # Adam steps dispatched
        self.fits_total = 0         # fit() calls that ran >= 1 step
        self._mu_init = False

        # Observed value range: predictions are clipped to it in
        # predict() (a completion model, not an extrapolator).
        self._y_lo = np.inf         # min/max observed log1p(bw)
        self._y_hi = -np.inf
        self._lat_hi = 0.0          # max observed latency (ms)

        # Residual monitor: recent |log-space bw residuals| feed the
        # p50/p99 self-metrics; confident sharp divergences become
        # link-degradation records drained by serve.py into Events.
        self._residuals: deque = deque(maxlen=512)
        self._pending_degraded: list[tuple[int, int, float, float, float]] = []
        self.degradations_total = 0

        # Host-side caches: numpy params for per-observation residual
        # checks, and the dense prediction for blend() (recomputed only
        # when the parameter version moves).
        self._np_params: TopoParams | None = None
        self._dense_cache: tuple[np.ndarray, np.ndarray] | None = None
        self._dense_version = -1
        self._version = 0

    # -- ingest -------------------------------------------------------

    def observe(self, i: int, j: int, lat_ms: float | None,
                bw_bps: float | None, t: float) -> None:
        """Ingest one probe measurement between encoder slots ``i`` and
        ``j`` taken at orchestrator clock ``t``."""
        if i == j:
            return
        with self._lock:
            self._clock = max(self._clock, float(t))
            has_lat = lat_ms is not None and np.isfinite(lat_ms) \
                and lat_ms >= 0
            has_bw = bw_bps is not None and np.isfinite(bw_bps) \
                and bw_bps > 0
            if not has_lat and not has_bw:
                return
            if has_bw:
                self._check_residual_locked(i, j, float(bw_bps))
            y = float(np.log1p(bw_bps)) if has_bw else 0.0
            lat = float(lat_ms) if has_lat else 0.0
            if has_bw:
                self._y_lo = min(self._y_lo, y)
                self._y_hi = max(self._y_hi, y)
            if has_lat:
                self._lat_hi = max(self._lat_hi, lat)
            for a, b in ((i, j), (j, i)):
                p = self._ring_pos
                self._ring_i[p] = a
                self._ring_j[p] = b
                self._ring_lat[p] = lat
                self._ring_y[p] = y
                self._ring_wlat[p] = 1.0 if has_lat else 0.0
                self._ring_wbw[p] = 1.0 if has_bw else 0.0
                self._ring_pos = (p + 1) % self._ring_i.shape[0]
                self._ring_count = min(self._ring_count + 1,
                                       self._ring_i.shape[0])
            if not np.isfinite(self._last_obs[i, j]):
                self.pairs_observed += 1
            self._last_obs[i, j] = self._last_obs[j, i] = self._clock
            if has_bw:
                self._last_y[i, j] = self._last_y[j, i] = y
            self._node_obs[i] += 1.0
            self._node_obs[j] += 1.0

    def _check_residual_locked(self, i: int, j: int,
                               bw_bps: float) -> None:
        """Degradation detection, two channels: a pair measured BEFORE
        whose new measurement moved more than
        ``netmodel_resid_threshold`` in log space flags on that delta
        alone; a FIRST measurement is judged against the model, must
        clear a doubled threshold, and the monitor must be calibrated
        (:meth:`_calibrated_locked`)."""
        y_obs = float(np.log1p(bw_bps))
        prev_y = float(self._last_y[i, j])
        npp = self._np_params
        resid = None
        if npp is not None:
            y_hat = float(npp.mu + npp.su[i] + npp.sv[j]
                          + np.dot(npp.u[i], npp.v[j]))
            resid = abs(y_hat - y_obs)
            self._residuals.append(resid)
        cfg = self.cfg
        if np.isfinite(prev_y):
            if abs(y_obs - prev_y) > cfg.netmodel_resid_threshold:
                self.degradations_total += 1
                self._pending_degraded.append(
                    (int(i), int(j), float(np.expm1(prev_y)), bw_bps,
                     self._clock))
            return
        if resid is None:
            return
        ci = 1.0 - np.exp(-self._node_obs[i] / cfg.netmodel_conf_k)
        cj = 1.0 - np.exp(-self._node_obs[j] / cfg.netmodel_conf_k)
        if ci * cj >= cfg.netmodel_resid_conf \
                and resid > 2.0 * cfg.netmodel_resid_threshold \
                and self._calibrated_locked():
            self.degradations_total += 1
            self._pending_degraded.append(
                (int(i), int(j), float(np.expm1(np.clip(y_hat, 0.0, 60.0))),
                 bw_bps, self._clock))

    def _calibrated_locked(self) -> bool:
        """The model-vs-measurement channel is a signal only once the
        median recent residual sits under half the flag threshold."""
        if len(self._residuals) < 128:
            return False
        return (float(np.median(self._residuals))
                < 0.5 * self.cfg.netmodel_resid_threshold)

    def advance_clock(self, dt_s: float) -> None:
        with self._lock:
            self._clock += float(dt_s)

    # -- training -----------------------------------------------------

    def fit(self, steps: int | None = None) -> int:
        """Run ``steps`` (default ``cfg.netmodel_steps``) mini-batch
        Adam steps over the ring buffer; returns steps dispatched.

        Each step's indices are drawn on the host (one
        ``integers(0, count, size=netmodel_batch)`` per step, the JAX
        package's stream); the batches of the whole fit are gathered
        from the ring and go to the device in one copy per field.  The
        learning rate follows an inverse-sqrt decay in ``steps_total``
        (halving scale 500 steps), floored at ``netmodel_lr / 8``."""
        cfg = self.cfg
        if steps is None:
            steps = cfg.netmodel_steps
        with self._lock:
            count = self._ring_count
            if count == 0 or steps <= 0:
                return 0
            if not self._mu_init:
                # One-time data-driven init of the global level.
                wb = self._ring_wbw[:count] > 0
                if wb.any():
                    mu0 = float(np.mean(self._ring_y[:count][wb]))
                    self._params = self._params._replace(
                        mu=torch.tensor(mu0, dtype=torch.float32,
                                        device=self.device))
                    self._mu_init = True
            lr = max(cfg.netmodel_lr
                     / float(np.sqrt(1.0 + self.steps_total / 500.0)),
                     cfg.netmodel_lr / 8.0)
            idx = np.stack([self._batch_rng.integers(
                0, count, size=cfg.netmodel_batch) for _ in range(steps)])
            dev = self.device
            ii, jj = (torch.from_numpy(r[idx].astype(np.int64)).to(dev)
                      for r in (self._ring_i, self._ring_j))
            lat, y, wl, wb = (torch.from_numpy(r[idx]).to(dev)
                              for r in (self._ring_lat, self._ring_y,
                                        self._ring_wlat, self._ring_wbw))
            params, m, v, t, ema = (self._params, self._opt_m,
                                    self._opt_v, self._opt_t, self._ema)
            for s in range(steps):
                params, m, v, t, ema = _sgd_step(
                    params, m, v, t, ema, ii[s], jj[s], lat[s], y[s],
                    wl[s], wb[s], lr)
            self._params = params
            self._opt_m, self._opt_v, self._opt_t = m, v, t
            self._ema = ema
            self.steps_total += steps
            self.fits_total += 1
            self._version += 1
            self._refresh_np_locked()
        return steps

    def _eval_params_locked(self) -> TopoParams:
        """Bias-corrected prediction parameters: the EMA of the Adam
        iterates, or the raw parameters before the first step."""
        t = float(self._opt_t)
        if t <= 0:
            return self._params
        c = 1.0 - _EMA_DECAY ** t
        return TopoParams(*(e / c for e in self._ema))

    def _refresh_np_locked(self) -> None:
        self._np_params = TopoParams(
            *(p.cpu().numpy() for p in self._eval_params_locked()))

    # -- prediction / blending ---------------------------------------

    def predict(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense host-side ``(lat_hat, bw_hat, confidence)[N, N]``.
        The dense planes are computed on the model's device and cached
        on the host per parameter version (a snapshot with no
        intervening fit() pays no device work)."""
        with self._lock:
            if self._dense_version != self._version:
                with torch.no_grad():
                    lat_hat, bw_hat = _predict_dense(
                        self._eval_params_locked())
                lat_hat = lat_hat.cpu().numpy()
                bw_hat = bw_hat.cpu().numpy()
                # Clip to the observed range: completion, not
                # extrapolation.
                if np.isfinite(self._y_hi):
                    bw_hat = np.clip(bw_hat, float(np.expm1(self._y_lo)),
                                     float(np.expm1(self._y_hi)))
                if self._lat_hi > 0.0:
                    lat_hat = np.clip(lat_hat, 0.0, self._lat_hi)
                self._dense_cache = (lat_hat, bw_hat)
                self._dense_version = self._version
            lat_hat, bw_hat = self._dense_cache
            return lat_hat, bw_hat, self._confidence_locked()

    def _confidence_locked(self) -> np.ndarray:
        c = 1.0 - np.exp(-self._node_obs / self.cfg.netmodel_conf_k)
        return (c[:, None] * c[None, :]).astype(np.float32)

    def blend(self, lat_probe: np.ndarray, bw_probe: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        """Confidence-weighted merge of probe planes and model
        predictions, in numpy on the host.

        Per pair: weight ``w_p = exp(-age/tau)`` for the direct probe
        (0 where never probed) and ``w_m = (1 - w_p) * confidence`` for
        the model; where both vanish the raw probe value is kept.  The
        diagonal is always the probe layer's."""
        lat_hat, bw_hat, conf = self.predict()
        with self._lock:
            age = self._clock - self._last_obs  # +inf where never
            w_p = np.exp(-np.maximum(age, 0.0)
                         / self.cfg.netmodel_tau_s).astype(np.float32)
        w_m = (1.0 - w_p) * conf
        denom = w_p + w_m
        safe = denom > 1e-9
        denom = np.where(safe, denom, 1.0)
        lat = np.where(safe, (w_p * lat_probe + w_m * lat_hat) / denom,
                       lat_probe)
        bw = np.where(safe, (w_p * bw_probe + w_m * bw_hat) / denom,
                      bw_probe)
        np.fill_diagonal(lat, np.diag(lat_probe))
        np.fill_diagonal(bw, np.diag(bw_probe))
        return lat.astype(np.float32), bw.astype(np.float32)

    # -- observability ------------------------------------------------

    def coverage_fraction(self, num_active: int) -> float:
        """Fraction of unordered active-node pairs ever directly
        probed."""
        total = num_active * (num_active - 1) // 2
        if total <= 0:
            return 0.0
        return min(1.0, self.pairs_observed / total)

    def residual_quantiles(self) -> tuple[float, float]:
        """(p50, p99) of recent |log-space bandwidth residuals|
        (NaN, NaN before any confident observation)."""
        with self._lock:
            if not self._residuals:
                return float("nan"), float("nan")
            arr = np.asarray(self._residuals, dtype=np.float64)
        return (float(np.quantile(arr, 0.5)),
                float(np.quantile(arr, 0.99)))

    def drain_degradations(self) -> list[tuple[int, int, float, float,
                                               float]]:
        """Pop pending link-degradation records:
        ``(i, j, predicted_bps, measured_bps, clock)``."""
        with self._lock:
            out, self._pending_degraded = self._pending_degraded, []
            return out

    # -- lifecycle ----------------------------------------------------

    def reset_node(self, idx: int) -> None:
        """A node slot was removed/reused: forget its observations and
        re-initialize its parameter rows (deterministically from the
        model seed + slot, so restored replicas agree)."""
        with self._lock:
            self._node_obs[idx] = 0.0
            self._last_obs[idx, :] = -np.inf
            self._last_obs[:, idx] = -np.inf
            self._last_y[idx, :] = np.nan
            self._last_y[:, idx] = np.nan
            self.pairs_observed = int(
                np.isfinite(self._last_obs).sum() // 2)
            rng = np.random.default_rng(self.seed * 1_000_003 + idx)
            d, r = self.cfg.netmodel_dim, self.cfg.netmodel_rank
            rows = {
                "x": 0.1 * rng.standard_normal(d).astype(np.float32),
                "u": (rng.standard_normal(r) / np.sqrt(r)).astype(np.float32),
                "v": (rng.standard_normal(r) / np.sqrt(r)).astype(np.float32),
            }

            def set_row(tree, values):
                out = []
                for name, p in zip(TopoParams._fields, tree):
                    if name == "mu":
                        out.append(p)
                        continue
                    p = p.clone()
                    val = values.get(name)
                    p[idx] = (torch.from_numpy(val).to(p.device)
                              if val is not None else 0.0)
                    out.append(p)
                return TopoParams(*out)

            self._params = set_row(self._params, rows)
            for attr in ("_opt_m", "_opt_v", "_ema"):
                setattr(self, attr, set_row(getattr(self, attr), {}))
            self._version += 1
            self._refresh_np_locked()

    # -- persistence --------------------------------------------------

    def save(self, path: str) -> None:
        """Atomically persist parameters + confidence state + ring
        buffer to a single ``.npz`` with the JAX package's keys, dtypes
        and shapes (a file either package saves loads in the other)."""
        with self._lock:
            arrays = {}
            for prefix, tree in (("param", self._params),
                                 ("opt_m", self._opt_m),
                                 ("opt_v", self._opt_v)):
                arrays.update({f"{prefix}_{name}": val.cpu().numpy()
                               for name, val in zip(TopoParams._fields,
                                                    tree)})
            arrays["opt_t"] = self._opt_t.cpu().numpy()
            arrays.update({f"ema_{name}": val.cpu().numpy()
                           for name, val in zip(TopoParams._fields,
                                                self._ema)})
            arrays.update(
                node_obs=self._node_obs.copy(),
                last_obs=self._last_obs.copy(),
                last_y=self._last_y.copy(),
                ring_i=self._ring_i.copy(), ring_j=self._ring_j.copy(),
                ring_lat=self._ring_lat.copy(),
                ring_y=self._ring_y.copy(),
                ring_wlat=self._ring_wlat.copy(),
                ring_wbw=self._ring_wbw.copy(),
                scalars=np.asarray(
                    [self._clock, self._ring_pos, self._ring_count,
                     1.0 if self._mu_init else 0.0,
                     self.steps_total, self.pairs_observed,
                     self.degradations_total,
                     self._y_lo, self._y_hi, self._lat_hi],
                    np.float64))
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, cfg: SchedulerConfig, seed: int = 0,
             device="cuda") -> "TopologyModel":
        model = cls(cfg, seed=seed, device=device)
        dev = model.device

        def tree(prefix, data):
            return TopoParams(*(torch.from_numpy(np.asarray(
                data[f"{prefix}_{name}"], np.float32)).to(dev)
                for name in TopoParams._fields))

        with np.load(path) as data:
            for name, init in zip(TopoParams._fields, model._params):
                stored = data[f"param_{name}"]
                if stored.shape != tuple(init.shape):
                    raise ValueError(
                        f"netmodel checkpoint param {name} has shape "
                        f"{stored.shape}, config expects "
                        f"{tuple(init.shape)} (dims/rank/max_nodes "
                        "changed — start fresh)")
            model._params = tree("param", data)
            if "opt_m_x" in data:
                model._opt_m = tree("opt_m", data)
                model._opt_v = tree("opt_v", data)
                model._opt_t = torch.from_numpy(np.asarray(
                    data["opt_t"], np.float32)).to(dev)
            if "ema_x" in data:
                model._ema = tree("ema", data)
            model._node_obs = data["node_obs"].astype(np.float32)
            model._last_obs = data["last_obs"].astype(np.float32)
            if "last_y" in data:
                model._last_y = data["last_y"].astype(np.float32)
            for ring in ("ring_i", "ring_j", "ring_lat", "ring_y",
                         "ring_wlat", "ring_wbw"):
                stored = data[ring]
                target = getattr(model, f"_{ring}")
                if stored.shape != target.shape:
                    raise ValueError(
                        f"netmodel checkpoint {ring} has shape "
                        f"{stored.shape}, config ring is {target.shape}")
                target[...] = stored
            sc = data["scalars"]
            model._clock = float(sc[0])
            model._ring_pos = int(sc[1])
            model._ring_count = int(sc[2])
            model._mu_init = bool(sc[3])
            model.steps_total = int(sc[4])
            model.pairs_observed = int(sc[5])
            model.degradations_total = int(sc[6])
            if len(sc) >= 10:
                model._y_lo = float(sc[7])
                model._y_hi = float(sc[8])
                model._lat_hi = float(sc[9])
        model._version += 1
        model._refresh_np_locked()
        return model
