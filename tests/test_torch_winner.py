"""The port's fused winner against the JAX package's, on the CPU.

``score_winner_auto`` on the same ``tests/gen.py`` instances through both
packages, both backends, with and without constraints: winning nodes
identical, best scores within rtol=atol=1e-4 (the Pallas path runs in
``interpret=True`` with small blocks, as tests/test_winner_fusion.py
runs it).  Then the JAX package's winner contracts, ported: lowest-index
tie-break, all-infeasible rows, a single candidate, the fallback on live
out-of-kernel joins, and the fusion flag.  On CPU tensors the winner
wrapper takes its plain version; tests/test_torch_cuda.py and
``chip_smoke.py`` hold the CUDA kernel against it on a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import pallas_score as jpallas
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import kernels, tiled_score
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core.score import NEG_HALF

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=64, max_pods=16, max_peers=4, use_bfloat16=False)
BLOCKS = dict(block_p=8, block_n=32, block_k=32, interpret=True)


def _both(seed, backend="pallas", n_nodes=48, n_pods=12, **kw):
    cfg_kw = dict(KW, score_backend=backend)
    jcfg, tcfg = JCfg(**cfg_kw), TCfg(**cfg_kw)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=n_nodes,
                                            n_pods=n_pods, **kw)
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    return (jcfg, tcfg, js, jp,
            tstate.state_from_numpy(tcfg, state_np, "cpu"),
            tstate.pods_from_numpy(tcfg, pods_np, "cpu"))


def _jax_winner(js, jp, jcfg):
    if jcfg.score_backend == "pallas":
        return jpallas.score_winner_tiled(js, jp, jcfg, **BLOCKS)
    return jpallas.score_winner_auto(js, jp, jcfg)


def _oracle(scores: torch.Tensor):
    """The contract re-derived in numpy: max per row, the smallest
    column holding it, -1 for all-infeasible rows."""
    s = scores.numpy()
    best = s.max(axis=1)
    node = np.array([np.nonzero(r == b)[0].min() for r, b in zip(s, best)],
                    np.int32)
    return best, np.where(best > NEG_HALF, node, -1).astype(np.int32)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("with_constraints", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_winner_auto_matches_jax(seed, with_constraints, backend):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, backend,
                                       with_constraints=with_constraints)
    want_best, want_node = (np.asarray(x) for x in _jax_winner(js, jp, jcfg))
    best, node = tiled_score.score_winner_auto(ts, tp, tcfg)
    assert best.dtype == torch.float32 and node.dtype == torch.int32
    np.testing.assert_array_equal(node.numpy(), want_node)
    feas = want_node >= 0
    assert feas.any()
    np.testing.assert_allclose(best.numpy()[feas], want_best[feas],
                               rtol=1e-4, atol=1e-4)
    assert np.all(best.numpy()[~feas] <= NEG_HALF)


@pytest.mark.parametrize("with_constraints", [True, False])
def test_fused_winner_equals_two_stage(with_constraints):
    _, tcfg, _, _, ts, tp = _both(4, with_constraints=with_constraints)
    best, node = tiled_score.score_winner_tiled(ts, tp, tcfg)
    want_best, want_node = _oracle(tiled_score.score_pods_tiled(ts, tp,
                                                                tcfg))
    np.testing.assert_array_equal(node.numpy(), want_node)
    feas = want_node >= 0
    np.testing.assert_array_equal(best.numpy()[feas], want_best[feas])


def test_fallback_engages_on_live_joins(monkeypatch):
    """A batch with a live out-of-kernel join takes the two-stage path
    (the winner kernel would skip the join) and still meets the
    contract; a clean batch takes the winner kernel."""
    calls = []
    real = kernels.winner_tile_scores
    monkeypatch.setattr(tiled_score, "winner_tile_scores",
                        lambda *a: calls.append(1) or real(*a))
    _, tcfg, _, _, ts, tp = _both(5, with_constraints=True)
    assert tiled_score.winner_joins_active(ts, tp)
    best, node = tiled_score.score_winner_tiled(ts, tp, tcfg)
    _, want_node = _oracle(tiled_score.score_pods_tiled(ts, tp, tcfg))
    np.testing.assert_array_equal(node.numpy(), want_node)
    assert calls == []
    _, tcfg, _, _, ts, tp = _both(5, with_constraints=False)
    assert not tiled_score.winner_joins_active(ts, tp)
    tiled_score.score_winner_tiled(ts, tp, tcfg)
    assert calls == [1]


def test_tie_break_is_lowest_index():
    """Peer-free pods over identical nodes: every valid node scores the
    same, so every path must pick node 0."""
    _, tcfg, _, _, ts, tp = _both(9, n_nodes=32, n_pods=8,
                                  with_constraints=False)
    n = tcfg.max_nodes
    ts = ts.replace(
        metrics=ts.metrics[:1].repeat(n, 1),
        metrics_age=ts.metrics_age[:1].repeat(n),
        cap=ts.cap[:1].repeat(n, 1), used=ts.used[:1].repeat(n, 1),
        label_bits=ts.label_bits[:1].repeat(n, 1),
        taint_bits=torch.zeros_like(ts.taint_bits),
        group_bits=ts.group_bits[:1].repeat(n, 1),
        resident_anti=torch.zeros_like(ts.resident_anti),
        node_zone=torch.where(ts.node_valid, 0, -1).to(torch.int32),
        az_anti=torch.zeros_like(ts.az_anti))
    tp = tp.replace(peers=torch.full_like(tp.peers, -1),
                    req=torch.full_like(tp.req, 0.01))
    scores = tscore.score_pods(ts, tp, tcfg)
    row = scores[0][ts.node_valid]
    assert bool((row == row[0]).all()) and float(row[0]) > NEG_HALF
    for backend in ("xla", "pallas"):
        cfg = dataclasses.replace(tcfg, score_backend=backend)
        _, node = tiled_score.score_winner_auto(ts, tp, cfg)
        assert bool((node[tp.pod_valid] == 0).all()), backend


def test_all_infeasible_rows_return_minus_one():
    for backend in ("xla", "pallas"):
        _, tcfg, _, _, ts, tp = _both(11, backend, n_nodes=32, n_pods=8)
        tp = tp.replace(req=torch.full_like(tp.req, 1e9))
        best, node = tiled_score.score_winner_auto(ts, tp, tcfg)
        assert bool((node == -1).all()) and bool((best <= NEG_HALF).all())


def test_single_candidate_row():
    """One node with headroom and requests that fit only there."""
    for backend in ("xla", "pallas"):
        _, tcfg, _, _, ts, tp = _both(13, backend, n_nodes=32, n_pods=8,
                                      with_constraints=False)
        cap = torch.ones_like(ts.cap)
        used = torch.full_like(ts.used, 0.9)
        cap[5], used[5] = 1e4, 0.0
        ts = ts.replace(cap=cap, used=used)
        tp = tp.replace(req=torch.full_like(tp.req, 2.0))
        _, want_node = _oracle(tscore.score_pods(ts, tp, tcfg))
        assert bool((torch.from_numpy(want_node)[tp.pod_valid] == 5).all())
        _, node = tiled_score.score_winner_auto(ts, tp, tcfg)
        np.testing.assert_array_equal(node.numpy(), want_node)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fusion_flag_off_is_bit_identical(backend):
    _, tcfg, _, _, ts, tp = _both(3, backend)
    on = dataclasses.replace(tcfg, enable_winner_fusion=True)
    off = dataclasses.replace(tcfg, enable_winner_fusion=False)
    b_on, n_on = tiled_score.score_winner_auto(ts, tp, on)
    b_off, n_off = tiled_score.score_winner_auto(ts, tp, off)
    np.testing.assert_array_equal(n_on.numpy(), n_off.numpy())
    np.testing.assert_array_equal(b_on.numpy(), b_off.numpy())


@pytest.mark.parametrize("bf16", [False, True])
def test_winner_wrapper_takes_plain_version_on_cpu(bf16):
    _, tcfg, _, _, ts, tp = _both(6, with_constraints=False)
    pack = tiled_score.static_replay_pack(ts, tcfg)
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    args = (pack, ts.used, ts.cap, ts.group_bits, ts.resident_anti, pods,
            bf16)
    kernels.reset_launch_counts()
    best, node = kernels.winner_tile_scores(*args)
    want = tscore.winner_from_scores(kernels.masked_tile_scores_plain(*args))
    assert torch.equal(best, want[0]) and torch.equal(node, want[1])
    assert kernels.winner_tile_scores.launches == 0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seed", [6, 7])
def test_winner_wrapper_with_given_peers_on_cpu(seed, bf16):
    """``peers=`` (the compaction a caller may pass in) leaves the CPU
    answer as it is without them."""
    _, tcfg, _, _, ts, tp = _both(seed, with_constraints=False)
    pack = tiled_score.static_replay_pack(ts, tcfg)
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    args = (pack, ts.used, ts.cap, ts.group_bits, ts.resident_anti, pods,
            bf16)
    peers = kernels.peer_columns_plain(pods.t)
    assert 0 < int(peers[1]) < pods.t.shape[1]
    kernels.reset_launch_counts()
    best, node = kernels.winner_tile_scores(*args, peers=peers)
    want_best, want_node = kernels.winner_tile_scores(*args)
    assert torch.equal(best, want_best) and torch.equal(node, want_node)
    assert bool((node >= 0).any())
    assert kernels.winner_tile_scores.launches == 0
    assert kernels.peer_columns.launches == 0
