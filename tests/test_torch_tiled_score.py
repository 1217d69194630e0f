"""The port's tile-kernel host side and plain kernels against the JAX
package's Pallas kernels (run in ``interpret=True`` mode, as
tests/test_pallas_score.py runs them on the CPU).

On CPU tensors the kernel wrappers take their plain PyTorch versions, so
these tests hold the plain versions and everything around them (packing,
joins, dispatch) against the reference.  The CUDA kernels themselves are
held against the plain versions on a card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import pallas_score as jpallas
from kubernetesnetawarescheduler_tpu.core import score as jscore
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import kernels
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core import tiled_score

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=160, max_pods=24, max_peers=6, use_bfloat16=False)


def _both(seed, kw=KW, n_nodes=150, n_pods=20):
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=n_nodes,
                                            n_pods=n_pods)
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_pods_tiled_matches_pallas(seed):
    jcfg, tcfg, js, jp, ts, tp = _both(seed)
    want = jpallas.score_pods_tiled(js, jp, jcfg, block_p=8, block_n=64,
                                    block_k=64, interpret=True)
    _assert_scores(tiled_score.score_pods_tiled(ts, tp, tcfg), want)


def test_score_pods_tiled_ragged_and_wide():
    # P and N not multiples of any tile, and R=4 resources.
    kw = dict(max_nodes=100, max_pods=13, max_peers=3, num_resources=4,
              use_bfloat16=False)
    jcfg, tcfg, js, jp, ts, tp = _both(7, kw, n_nodes=77, n_pods=9)
    want = jpallas.score_pods_tiled(js, jp, jcfg, block_p=8, block_n=32,
                                    block_k=32, interpret=True)
    _assert_scores(tiled_score.score_pods_tiled(ts, tp, tcfg), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_static_scores_tiled_matches_pallas(seed):
    jcfg, tcfg, js, jp, ts, tp = _both(seed)
    raw_j, ok_j = jpallas.static_scores_tiled(js, jp, jcfg, block_p=8,
                                              block_n=64, block_k=64,
                                              interpret=True)
    raw_t, ok_t = tiled_score.static_scores_tiled(ts, tp, tcfg)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_allclose(raw_t.numpy()[ok_j], np.asarray(raw_j)[ok_j],
                               rtol=1e-4, atol=1e-4)
    raw_tt, ok_tt = tiled_score.static_scores_tiled(ts, tp, tcfg,
                                                    transposed=True)
    np.testing.assert_array_equal(ok_tt.numpy(), ok_j.T)
    np.testing.assert_array_equal(raw_tt.numpy(), raw_t.numpy().T)


def test_score_pods_auto_dispatch_matches_dense():
    kw = dict(max_nodes=64, max_pods=8, use_bfloat16=False)
    jcfg, tcfg, js, jp, ts, tp = _both(3, kw, n_nodes=64, n_pods=8)
    dense = tiled_score.score_pods_auto(ts, tp, tcfg)
    tiled = tiled_score.score_pods_auto(
        ts, tp, dataclasses.replace(tcfg, score_backend="pallas"))
    _assert_scores(dense, jscore.score_pods(js, jp, jcfg))
    _assert_scores(tiled, jscore.score_pods(js, jp, jcfg))
    with pytest.raises(ValueError):
        TCfg(score_backend="cuda")


def test_row_shard_with_offset_matches_full():
    """``params[7]`` and a non-square ``[n_out, n_k]`` bw/lat: a row shard
    scores exactly the matching columns of the full output (the diagonal
    pin follows the global row index)."""
    _, tcfg, _, _, ts, tp = _both(5)
    full = tiled_score.static_replay_pack(ts, tcfg)
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    groups = ts.group_bits
    raw_full, ok_full = kernels.static_tile_scores(full, groups, pods, False)
    lo, hi = 48, 112
    shard = dataclasses.replace(
        full, bw=full.bw[lo:hi].contiguous(), lat=full.lat[lo:hi].contiguous(),
        base=full.base[lo:hi], node_valid=full.node_valid[lo:hi],
        taint=full.taint[lo:hi], label=full.label[lo:hi],
        params=torch.cat([full.params[:7], torch.tensor([float(lo)])]))
    raw_s, ok_s = kernels.static_tile_scores(shard, groups[lo:hi], pods,
                                             False)
    np.testing.assert_array_equal(ok_s.numpy(), ok_full[:, lo:hi].numpy())
    np.testing.assert_allclose(raw_s.numpy(), raw_full[:, lo:hi].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_empty_soft_terms_add_no_weight():
    """Soft weights are pre-zeroed where a term's bits are empty — the
    kernels' trivially-true subset match must not add phantom weight."""
    _, tcfg, _, _, ts, tp = _both(2)
    tp = tp.replace(soft_sel_bits=torch.zeros_like(tp.soft_sel_bits),
                    soft_grp_bits=torch.zeros_like(tp.soft_grp_bits),
                    soft_sel_w=torch.full_like(tp.soft_sel_w, 50.0))
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    assert not pods.soft_sel_w.any()
    soft = kernels.soft_bonus_plain(ts.label_bits, ts.group_bits, pods)
    assert not soft.any()


def test_wrappers_take_plain_version_on_cpu():
    _, tcfg, _, _, ts, tp = _both(1)
    pack = tiled_score.static_replay_pack(ts, tcfg)
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    kernels.reset_launch_counts()
    for bf16 in (False, True):
        got = kernels.masked_tile_scores(pack, ts.used, ts.cap,
                                         ts.group_bits, ts.resident_anti,
                                         pods, bf16)
        want = kernels.masked_tile_scores_plain(
            pack, ts.used, ts.cap, ts.group_bits, ts.resident_anti, pods,
            bf16)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        raw, ok = kernels.static_tile_scores(pack, ts.group_bits, pods, bf16)
        raw_p, ok_p = kernels.static_tile_scores_plain(pack, ts.group_bits,
                                                       pods, bf16)
        np.testing.assert_array_equal(raw.numpy(), raw_p.numpy())
        np.testing.assert_array_equal(ok.numpy(), ok_p.numpy())
    assert kernels.static_tile_scores.launches == 0
    assert kernels.masked_tile_scores.launches == 0


def test_bf16_plain_rounds_both_operands():
    """In bf16 mode the plain product takes bf16-rounded T and C and
    accumulates in f32, returning f32."""
    _, tcfg, _, _, ts, tp = _both(0)
    pack = tiled_score.static_replay_pack(ts, tcfg)
    pods = tiled_score.pack_pods(tp, ts.num_nodes)
    got = kernels.net_accum_plain(pack, pods.t, True)
    c = kernels.desirability_plain(pack).to(torch.bfloat16).float()
    t = pods.t.to(torch.bfloat16).float()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), (t @ c.T).numpy(), rtol=1e-6,
                               atol=1e-6)
