"""The port's dense score path against the JAX package's, on the CPU.

Bars are the JAX tests' own: infeasible masks identical, feasible scores
allclose at rtol=atol=1e-4, winners identical.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import score as jscore
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

# K=6 takes the peer-gather form (6 * 16 <= 160); K=12 the dense product.
GATHER = dict(max_nodes=160, max_pods=24, max_peers=6, use_bfloat16=False)
DENSE = dict(GATHER, max_peers=12)


def _both(seed, kw, n_nodes=150, n_pods=20, mutate=None):
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=n_nodes,
                                            n_pods=n_pods)
    if mutate is not None:
        mutate(rng, state_np, pods_np)
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    ts = tstate.state_from_numpy(tcfg, state_np, "cpu")
    tp = tstate.pods_from_numpy(tcfg, pods_np, "cpu")
    return jcfg, tcfg, js, jp, ts, tp


def _assert_scores(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    mask_w = want <= jscore.NEG_INF / 2
    np.testing.assert_array_equal(got <= jscore.NEG_INF / 2, mask_w)
    np.testing.assert_allclose(got[~mask_w], want[~mask_w], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kw", [GATHER, DENSE], ids=["gather", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_pods_matches_jax(seed, kw):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, kw)
    _assert_scores(tscore.score_pods(ts, tp, tcfg),
                   jscore.score_pods(js, jp, jcfg))


@pytest.mark.parametrize("seed", [0, 1])
def test_winner_matches_jax(seed):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, GATHER)
    wb, wn = jscore.score_winner(js, jp, jcfg)
    tb, tn = tscore.score_winner(ts, tp, tcfg)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(tb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-4)


def test_winner_tie_break_lowest_index():
    scores = np.full((3, 5), jscore.NEG_INF, np.float32)
    scores[0, [1, 3]] = 2.0
    scores[1, 4] = 1.0
    want = jscore.winner_from_scores(jnp.asarray(scores))[1]
    got = tscore.winner_from_scores(torch.from_numpy(scores))[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 4, -1])


@pytest.mark.parametrize("seed", [0, 3])
def test_masks_and_terms_match_jax(seed):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, GATHER)
    pairs = [
        (tscore.static_feasibility(ts, tp),
         jscore.static_feasibility(js, jp)),
        (tscore.static_feasibility_t(ts, tp),
         jscore.static_feasibility_t(js, jp)),
        (tscore.feasibility_mask(ts, tp), jscore.feasibility_mask(js, jp)),
        (tscore.ns_affinity_ok(ts, tp), jscore.ns_affinity_ok(js, jp)),
        (tscore.zone_affinity_ok(ts, tp), jscore.zone_affinity_ok(js, jp)),
        (tscore.spread_active(tp), jscore.spread_active(jp)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sok_t = tscore.static_feasibility(ts, tp)
    sok_j = jscore.static_feasibility(js, jp)
    pen_t, ok_t = tscore.spread_terms(ts, tp, tcfg, static_ok=sok_t)
    pen_j, ok_j = jscore.spread_terms(js, jp, jcfg, static_ok=sok_j)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(pen_t.numpy(), np.asarray(pen_j), rtol=1e-6)
    pen_t, ok_t = tscore.spread_terms(ts, tp, tcfg)
    pen_j, ok_j = jscore.spread_terms(js, jp, jcfg)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    for fn_t, fn_j in ((tscore.metric_scores, jscore.metric_scores),
                       (tscore.soft_affinity_scores,
                        jscore.soft_affinity_scores),
                       (tscore.soft_zone_scores, jscore.soft_zone_scores)):
        args_t = (ts, tcfg) if fn_t is tscore.metric_scores else (ts, tp,
                                                                   tcfg)
        args_j = (js, jcfg) if fn_j is jscore.metric_scores else (js, jp,
                                                                   jcfg)
        np.testing.assert_allclose(fn_t(*args_t).numpy(),
                                   np.asarray(fn_j(*args_j)), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tscore.balance_penalty(ts, tp).numpy(),
                               np.asarray(jscore.balance_penalty(js, jp)),
                               rtol=1e-6)


def test_net_desirability_pins_loopback_diagonal():
    jcfg, tcfg, js, jp, ts, tp = _both(4, GATHER)
    c_t = tscore.net_cost_matrix(ts, tcfg).numpy()
    c_j = np.asarray(jscore.net_cost_matrix(js, jcfg))
    np.testing.assert_allclose(c_t, c_j, rtol=1e-6, atol=1e-6)
    n = 150
    np.testing.assert_array_equal(np.diag(c_t)[:n],
                                  np.float32(tcfg.weights.peer_bw))
    np.testing.assert_array_equal(np.diag(c_t)[n:], 0.0)


def _numeric_terms(rng, state_np, pods_np):
    """Numeric Gt/Lt nodeAffinity terms over a partly-NaN label column:
    NaN (absent) must fail every comparison."""
    n_total = state_np["lat"].shape[0]
    numeric = np.full((n_total, 8), np.nan, np.float32)
    numeric[:, 0] = np.where(rng.random(n_total) < 0.7,
                             rng.uniform(0, 10, n_total), np.nan)
    state_np["node_numeric"] = numeric
    p = pods_np["req"].shape[0]
    used = pods_np["ns_term_used"].copy()
    used[:6, 0] = True
    col = np.full((p, used.shape[1], 2), -1, np.int32)
    col[:6, 0, 0] = 0
    lo = np.full(col.shape, -np.inf, np.float32)
    hi = np.full(col.shape, np.inf, np.float32)
    lo[:6, 0, 0] = 3.0
    hi[:3, 0, 0] = 8.0
    pods_np.update(ns_term_used=used, ns_num_col=col, ns_num_lo=lo,
                   ns_num_hi=hi)


def test_numeric_node_affinity_matches_jax():
    jcfg, tcfg, js, jp, ts, tp = _both(6, GATHER, mutate=_numeric_terms)
    np.testing.assert_array_equal(tscore.ns_affinity_ok(ts, tp).numpy(),
                                  np.asarray(jscore.ns_affinity_ok(js, jp)))
    _assert_scores(tscore.score_pods(ts, tp, tcfg),
                   jscore.score_pods(js, jp, jcfg))
