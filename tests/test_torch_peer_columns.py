"""The peer-column compaction and the peer walk's arithmetic, on the CPU.

The static and the masked kernel accumulate ``T·Cᵀ`` over the batch's
peer columns only (``kernels.peer_columns``: the ascending columns with
any non-zero ``T``).  Here the compaction's plain version is held to the
traffic matrices that ``pack_pods`` builds from ``tests/gen.py``
instances, the column-restricted product to the dense one, and a batch
without peers (``count == 0``) to the JAX package's Pallas kernels (in
``interpret=True``, as tests/test_pallas_score.py runs them).  The CUDA
compaction and kernels are held to these plain versions on a card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
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
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core.score import NEG_HALF

from tests import gen

torch.set_num_threads(1)

KW = dict(max_nodes=160, max_pods=24, max_peers=6, use_bfloat16=False)


def _instance(seed, kw=KW, n_nodes=150, n_pods=20, no_peers=False):
    cfg = JCfg(**kw)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, cfg, n_nodes=n_nodes,
                                            n_pods=n_pods)
    if no_peers:
        pods_np["peers"] = np.full_like(pods_np["peers"], -1)
    tcfg = TCfg(**kw)
    ts = tstate.state_from_numpy(tcfg, state_np, "cpu")
    tp = tstate.pods_from_numpy(tcfg, pods_np, "cpu")
    return cfg, tcfg, state_np, pods_np, ts, tp


def _assert_columns(cols, count, want):
    want = np.asarray(want, np.int32)
    n_k = cols.shape[0]
    assert cols.dtype == torch.int32 and count.dtype == torch.int32
    assert tuple(count.shape) == (1,) and int(count) == want.size
    got = cols.numpy()
    np.testing.assert_array_equal(got[:want.size], want)
    assert np.all(np.diff(got[:want.size]) > 0)
    np.testing.assert_array_equal(got[want.size:],
                                  np.full(n_k - want.size, -1, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peer_columns_are_the_batch_peers(seed):
    """The columns are exactly the nodes some valid pod names as a peer
    (its traffic is positive), ascending, and ``count`` counts them."""
    _, _, _, pods_np, ts, tp = _instance(seed)
    t = tiled_score.pack_pods(tp, ts.num_nodes).t
    valid = (pods_np["pod_valid"][:, None] & (pods_np["peers"] >= 0)
             & (pods_np["peer_traffic"] != 0))
    want = np.unique(pods_np["peers"][valid])
    assert 0 < want.size < ts.num_nodes
    cols, count = kernels.peer_columns_plain(t)
    _assert_columns(cols, count, want)
    np.testing.assert_array_equal(
        want, np.flatnonzero((t.numpy() != 0).any(axis=0)))
    # On CPU tensors the wrapper is the plain version and launches
    # nothing.
    kernels.reset_launch_counts()
    cols_w, count_w = kernels.peer_columns(t)
    assert torch.equal(cols_w, cols) and torch.equal(count_w, count)
    assert kernels.peer_columns.launches == 0


@pytest.mark.parametrize("n_k", [77, 160])
def test_peer_columns_dense_zero_and_ragged(n_k):
    rng = np.random.default_rng(n_k)
    dense = torch.from_numpy(rng.uniform(0.5, 1.0, (13, n_k))
                             .astype(np.float32))
    _assert_columns(*kernels.peer_columns_plain(dense), np.arange(n_k))
    _assert_columns(*kernels.peer_columns_plain(torch.zeros(13, n_k)), [])
    # One entry per chosen column, in a random row; a NaN counts.
    pick = np.sort(rng.choice(n_k, 9, replace=False))
    t = np.zeros((13, n_k), np.float32)
    t[rng.integers(0, 13, 9), pick] = rng.uniform(-2.0, 2.0, 9)
    t[rng.integers(0, 13), pick[4]] = np.nan
    _assert_columns(*kernels.peer_columns_plain(torch.from_numpy(t)), pick)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_product_over_peer_columns_is_the_dense_product(seed):
    """``T[:, K] @ C[:, K]ᵀ`` over the compacted columns equals the
    dense ``net_accum_plain`` (in f64, where both sums are exact to
    1e-12): the columns left out carry no traffic."""
    _, tcfg, _, _, ts, tp = _instance(seed)
    pack = tiled_score.static_replay_pack(ts, tcfg)
    t = tiled_score.pack_pods(tp, ts.num_nodes).t
    cols, count = kernels.peer_columns_plain(t)
    k = cols[:int(count)].long()
    f64 = dataclasses.replace(pack, bw=pack.bw.double(),
                              lat=pack.lat.double(),
                              validk=pack.validk.double(),
                              params=pack.params.double())
    c = kernels.desirability_plain(f64)
    t64 = t.double()
    dense = kernels.net_accum_plain(f64, t64, False)
    np.testing.assert_allclose((t64[:, k] @ c[:, k].T).numpy(),
                               dense.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bf16", [False, True])
def test_no_peers_gives_base_plus_soft(bf16):
    """``count == 0``: the static raw score is ``base + wsoft·soft`` and
    the masked score the rest of its epilogue, with the masks of a batch
    that has peers."""
    _, tcfg, _, _, ts, tp = _instance(4)
    pack = tiled_score.static_replay_pack(ts, tcfg)
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    zero = dataclasses.replace(pods, t=torch.zeros_like(pods.t))
    assert int(kernels.peer_columns_plain(zero.t)[1]) == 0
    groups = ts.group_bits
    raw, ok = kernels.static_tile_scores_plain(pack, groups, zero, bf16)
    _, ok_peers = kernels.static_tile_scores_plain(pack, groups, pods, bf16)
    soft = kernels.soft_bonus_plain(pack.label, groups, zero)
    assert torch.equal(ok, ok_peers)
    assert torch.equal(raw, pack.base[None, :] + pack.params[6] * soft)
    args = (pack, ts.used, ts.cap, groups, ts.resident_anti)
    out = kernels.masked_tile_scores_plain(*args, zero, bf16)
    out_peers = kernels.masked_tile_scores_plain(*args, pods, bf16)
    m = out > NEG_HALF
    assert torch.equal(m, out_peers > NEG_HALF) and bool(m.any())
    net = kernels.net_accum_plain(pack, pods.t, bf16)
    np.testing.assert_allclose(out[m].numpy(), (out_peers - net)[m].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_no_peers_matches_pallas():
    """A batch whose pods name no peer, through both packages' tiled
    paths: the JAX kernels walk all-zero traffic, the port's plain
    versions stand for a peer walk of zero steps."""
    jcfg, tcfg, state_np, pods_np, ts, tp = _instance(5, no_peers=True)
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    assert int(kernels.peer_columns_plain(
        tiled_score.pack_pods(tp, ts.num_nodes).t)[1]) == 0
    raw_j, ok_j = jpallas.static_scores_tiled(js, jp, jcfg, block_p=8,
                                              block_n=64, block_k=64,
                                              interpret=True)
    raw_t, ok_t = tiled_score.static_scores_tiled(ts, tp, tcfg)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_allclose(raw_t.numpy()[ok_j], np.asarray(raw_j)[ok_j],
                               rtol=1e-4, atol=1e-4)
    want = np.asarray(jpallas.score_pods_tiled(js, jp, jcfg, block_p=8,
                                               block_n=64, block_k=64,
                                               interpret=True))
    got = tiled_score.score_pods_tiled(ts, tp, tcfg).numpy()
    mask = want <= NEG_HALF
    np.testing.assert_array_equal(got <= NEG_HALF, mask)
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-4,
                               atol=1e-4)
