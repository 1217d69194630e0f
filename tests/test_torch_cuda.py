"""The CUDA tile kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built with nvcc on first use; they have no CPU mode), carries the ``gpu``
marker and skips without a card.  The file imports neither JAX nor the
JAX package, so on a machine with the card and no JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu_torch.bench.density import (
    synthetic_density,
)
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import kernels, tiled_score
from kubernetesnetawarescheduler_tpu_torch.core.replay import (
    batch_from_stream,
    replay_stream,
)
from kubernetesnetawarescheduler_tpu_torch.core.score import (
    NEG_HALF,
    winner_from_scores,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import exact_matmul

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, nodes=300, max_nodes=320, pods=100, seed=0):
    """A density batch with peers resolved against a seeded placement, on
    a state with seeded usage and group residency.  ``pods`` and the node
    count are deliberately not tile multiples."""
    cfg = SchedulerConfig(max_nodes=max_nodes, max_pods=pods, max_peers=4)
    state, stream = synthetic_density(nodes, 4 * pods, cfg, seed=seed,
                                      device=dev)
    rng = np.random.default_rng(seed)
    node_of = torch.from_numpy(
        rng.integers(0, nodes, stream.num_pods).astype(np.int32)).to(dev)
    batch = batch_from_stream(stream.slice(2 * pods, 3 * pods), node_of)
    groups = rng.integers(0, 1 << 20, (max_nodes, cfg.mask_words))
    state = state.replace(
        used=state.cap * torch.from_numpy(
            rng.uniform(0, 0.8, state.cap.shape).astype(np.float32)).to(dev),
        group_bits=torch.from_numpy(groups.astype(np.int32)).to(dev))
    pack = tiled_score.static_replay_pack(state, cfg)
    return cfg, state, pack, tiled_score.pack_pods(batch, state.num_nodes)


@pytest.mark.parametrize("bf16", [False, True])
def test_static_kernel_matches_plain(cuda, bf16):
    _, state, pack, pods = _inputs(cuda)
    raw, ok = kernels.static_tile_scores(pack, state.group_bits, pods, bf16)
    raw_p, ok_p = kernels.static_tile_scores_plain(pack, state.group_bits,
                                                   pods, bf16)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p)
    assert torch.allclose(raw, raw_p, rtol=1e-4, atol=1e-4)
    raw_t, ok_t = kernels.static_tile_scores(pack, state.group_bits, pods,
                                             bf16, transposed=True)
    assert torch.equal(raw_t, raw.T) and torch.equal(ok_t, ok.T)


@pytest.mark.parametrize("bf16", [False, True])
def test_masked_kernel_matches_plain(cuda, bf16):
    _, state, pack, pods = _inputs(cuda, seed=1)
    args = (pack, state.used, state.cap, state.group_bits,
            state.resident_anti, pods, bf16)
    out = kernels.masked_tile_scores(*args)
    out_p = kernels.masked_tile_scores_plain(*args)
    m = out_p > NEG_HALF
    assert torch.equal(out > NEG_HALF, m)
    assert bool(m.any()) and bool((~m).any())
    assert torch.allclose(out[m], out_p[m], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain_on_dense_traffic(cuda, bf16):
    """A stream batch's T is sparse, so most staged tiles multiply zeros;
    a dense seeded T at the main path's shape (P=128, N=5120) drives
    every product term and every bf16 rounding of T."""
    _, state, pack, pods = _inputs(cuda, nodes=5120, max_nodes=5120,
                                   pods=128, seed=5)
    rng = np.random.default_rng(5)
    pods = dataclasses.replace(pods, t=torch.from_numpy(
        rng.uniform(0.0, 1.0, tuple(pods.t.shape)).astype(np.float32)).to(
            cuda))
    raw, ok = kernels.static_tile_scores(pack, state.group_bits, pods, bf16)
    raw_p, ok_p = kernels.static_tile_scores_plain(pack, state.group_bits,
                                                   pods, bf16)
    assert torch.equal(ok, ok_p)
    assert torch.allclose(raw, raw_p, rtol=1e-4, atol=1e-4)
    args = (pack, state.used, state.cap, state.group_bits,
            state.resident_anti, pods, bf16)
    out = kernels.masked_tile_scores(*args)
    out_p = kernels.masked_tile_scores_plain(*args)
    m = out_p > NEG_HALF
    assert torch.equal(out > NEG_HALF, m) and bool(m.any())
    assert torch.allclose(out[m], out_p[m], rtol=1e-4, atol=1e-4)


def _dense_walk(t):
    """``peers`` that walk every column of ``t``: the dense walk."""
    n_k = t.shape[1]
    return (torch.arange(n_k, dtype=torch.int32, device=t.device),
            torch.tensor([n_k], dtype=torch.int32, device=t.device))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", [(100, 320), (128, 5120), (7, 301)])
def test_peer_columns_kernel_matches_plain(cuda, shape):
    """All-zero, dense and sparse traffic (a NaN counts as traffic),
    including a column count that is not a multiple of 32."""
    p, n_k = shape
    rng = np.random.default_rng(n_k)
    sparse = np.zeros(shape, np.float32)
    pick = rng.choice(n_k, 40, replace=False)
    sparse[rng.integers(0, p, 40), pick] = rng.uniform(0.1, 5.0, 40)
    sparse[0, pick[0]] = np.nan
    cases = [np.zeros(shape, np.float32),
             rng.uniform(0.5, 1.0, shape).astype(np.float32), sparse]
    kernels.reset_launch_counts()
    for t_np in cases:
        t = torch.from_numpy(t_np).to(cuda)
        cols, count = kernels.peer_columns(t)
        cols_p, count_p = kernels.peer_columns_plain(t)
        torch.cuda.synchronize()
        assert torch.equal(cols, cols_p) and torch.equal(count, count_p)
    assert kernels.peer_columns.launches == 3


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("traffic", ["stream", "dense", "none"])
@pytest.mark.parametrize("n_pods", [99, 150])
def test_peer_walk_is_bit_identical_to_dense_walk(cuda, bf16, traffic,
                                                  n_pods):
    """The static and the masked kernel over the compacted peer columns
    give the same bits as the same kernels over every column, with P and
    N not tile multiples (P not a multiple of 4; one and two pod tiles);
    without traffic (``count == 0``) they still run the epilogue."""
    _, state, pack, pods = _inputs(cuda, nodes=290, max_nodes=301,
                                   pods=n_pods, seed=10)
    if traffic == "dense":
        rng = np.random.default_rng(10)
        pods = dataclasses.replace(pods, t=torch.from_numpy(
            rng.uniform(0.0, 1.0, tuple(pods.t.shape)).astype(np.float32))
            .to(cuda))
    elif traffic == "none":
        pods = dataclasses.replace(pods, t=torch.zeros_like(pods.t))
    n_k = pods.t.shape[1]
    count = int(kernels.peer_columns(pods.t)[1])
    assert (count == 0) if traffic == "none" else (0 < count <= n_k)
    assert (count == n_k) == (traffic == "dense")
    groups, walk = state.group_bits, _dense_walk(pods.t)
    raw, ok = kernels.static_tile_scores(pack, groups, pods, bf16)
    raw_d, ok_d = kernels.static_tile_scores(pack, groups, pods, bf16,
                                             peers=walk)
    raw_t, ok_t = kernels.static_tile_scores(pack, groups, pods, bf16,
                                             transposed=True)
    args = (pack, state.used, state.cap, groups, state.resident_anti, pods,
            bf16)
    out = kernels.masked_tile_scores(*args)
    out_d = kernels.masked_tile_scores(*args, peers=walk)
    torch.cuda.synchronize()
    assert torch.equal(_bits(raw), _bits(raw_d)) and torch.equal(ok, ok_d)
    assert torch.equal(_bits(out), _bits(out_d))
    assert torch.equal(_bits(raw_t), _bits(raw.T)) and torch.equal(ok_t,
                                                                   ok.T)
    raw_p, ok_p = kernels.static_tile_scores_plain(pack, groups, pods, bf16)
    out_p = kernels.masked_tile_scores_plain(*args)
    assert torch.equal(ok, ok_p)
    assert torch.allclose(raw, raw_p, rtol=1e-4, atol=1e-4)
    m = out_p > NEG_HALF
    assert torch.equal(out > NEG_HALF, m) and bool(m.any())
    assert torch.allclose(out[m], out_p[m], rtol=1e-4, atol=1e-4)


def _same_winner(a, b):
    """Two ``(best, node)`` answers identical: ``node``, and ``best``
    bits once -0.0 is read as +0.0."""
    return (torch.equal(a[1], b[1])
            and torch.equal((a[0] + 0.0).view(torch.int32),
                            (b[0] + 0.0).view(torch.int32)))


def _check_winner(args, tol=1e-4):
    """The winner kernel against its plain version (``best`` within tol,
    ``node`` identical wherever the plain top-two gap exceeds the allclose
    bar at the best's magnitude) and against ``winner_from_scores`` of the
    masked kernel on the card (identical)."""
    best, node = kernels.winner_tile_scores(*args)
    best_p, node_p = kernels.winner_tile_scores_plain(*args)
    assert torch.allclose(best, best_p, rtol=tol, atol=tol)
    top2 = kernels.masked_tile_scores_plain(*args).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol + tol * top2[:, 0].abs()
    assert torch.equal(node[clear], node_p[clear])
    assert _same_winner((best, node),
                        winner_from_scores(kernels.masked_tile_scores(*args)))
    return best, node


@pytest.mark.parametrize("bf16", [False, True])
def test_winner_kernel_matches_plain(cuda, bf16):
    _, state, pack, pods = _inputs(cuda, seed=6)
    # Two invalid pods: their rows are all-infeasible and answer -1.
    pods = dataclasses.replace(pods, pod_valid=pods.pod_valid.clone())
    pods.pod_valid[[3, 57]] = 0.0
    args = (pack, state.used, state.cap, state.group_bits,
            state.resident_anti, pods, bf16)
    _, node = _check_winner(args)
    assert int(node[3]) == -1 and int(node[57]) == -1
    assert bool((node >= 0).sum() > 90)


@pytest.mark.parametrize("bf16", [False, True])
def test_winner_kernel_on_dense_traffic(cuda, bf16):
    _, state, pack, pods = _inputs(cuda, nodes=5120, max_nodes=5120,
                                   pods=128, seed=7)
    rng = np.random.default_rng(7)
    pods = dataclasses.replace(pods, t=torch.from_numpy(
        rng.uniform(0.0, 1.0, tuple(pods.t.shape)).astype(np.float32)).to(
            cuda))
    _check_winner((pack, state.used, state.cap, state.group_bits,
                   state.resident_anti, pods, bf16))


def test_winner_kernel_ties_go_to_the_lowest_node(cuda):
    """No traffic, one metric vote, one capacity: every feasible node of
    a row scores the same, across node tiles, and the lowest feasible
    index must win."""
    _, state, pack, pods = _inputs(cuda, seed=8)
    pack = dataclasses.replace(pack, base=torch.full_like(pack.base, 0.25))
    pods = dataclasses.replace(
        pods, t=torch.zeros_like(pods.t),
        soft_sel_w=torch.zeros_like(pods.soft_sel_w),
        soft_grp_w=torch.zeros_like(pods.soft_grp_w))
    cap = torch.full_like(state.cap, 64.0)
    used = torch.zeros_like(state.used)
    args = (pack, used, cap, state.group_bits, state.resident_anti, pods,
            False)
    _, node = _check_winner(args)
    ok = kernels.masked_tile_scores_plain(*args) > NEG_HALF
    first = torch.where(ok.any(dim=1), ok.int().argmax(dim=1), -1)
    assert torch.equal(node, first.to(torch.int32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("traffic", ["stream", "dense", "none"])
@pytest.mark.parametrize("n_pods", [99, 130])
def test_winner_peer_walk_is_bit_identical_to_dense_walk(cuda, bf16,
                                                         traffic, n_pods):
    """The winner over the compacted peer columns gives the same answer
    as its own walk over every column and as ``winner_from_scores`` of
    the masked kernel, with P not a multiple of 4 (one and two pod
    tiles) and without traffic (``count == 0``)."""
    _, state, pack, pods = _inputs(cuda, nodes=290, max_nodes=301,
                                   pods=n_pods, seed=12)
    if traffic == "dense":
        rng = np.random.default_rng(12)
        pods = dataclasses.replace(pods, t=torch.from_numpy(
            rng.uniform(0.0, 1.0, tuple(pods.t.shape)).astype(np.float32))
            .to(cuda))
    elif traffic == "none":
        pods = dataclasses.replace(pods, t=torch.zeros_like(pods.t))
    n_k = pods.t.shape[1]
    count = int(kernels.peer_columns(pods.t)[1])
    assert (count == 0) if traffic == "none" else (0 < count <= n_k)
    assert (count == n_k) == (traffic == "dense")
    args = (pack, state.used, state.cap, state.group_bits,
            state.resident_anti, pods, bf16)
    win = _check_winner(args)
    win_d = kernels.winner_tile_scores(*args, peers=_dense_walk(pods.t))
    torch.cuda.synchronize()
    assert _same_winner(win, win_d)
    assert bool((win[1] >= 0).any())


def test_winner_row_shard_with_offset_on_card(cuda):
    """A row shard (``params[7]`` = its first global row) pins the
    diagonal by global index: its winner equals ``winner_from_scores`` of
    the full masked plane's columns, and its own dense walk."""
    _, state, full, pods = _inputs(cuda, seed=13)
    lo, hi = 70, 250

    def rows(x):
        return x[lo:hi].contiguous()

    shard = dataclasses.replace(
        full, bw=rows(full.bw), lat=rows(full.lat), base=rows(full.base),
        node_valid=rows(full.node_valid), taint=rows(full.taint),
        label=rows(full.label),
        params=torch.cat([full.params[:7],
                          torch.tensor([float(lo)], device=cuda)]))
    scores = kernels.masked_tile_scores(
        full, state.used, state.cap, state.group_bits, state.resident_anti,
        pods, False)
    args = (shard, rows(state.used), rows(state.cap), rows(state.group_bits),
            rows(state.resident_anti), pods, False)
    win = kernels.winner_tile_scores(*args)
    win_d = kernels.winner_tile_scores(*args, peers=_dense_walk(pods.t))
    torch.cuda.synchronize()
    assert _same_winner(win, winner_from_scores(scores[:, lo:hi]))
    assert _same_winner(win, win_d)
    assert bool((win[1] >= 0).any())


def test_winner_wrapper_rejects_bad_peers_and_counts_launches(cuda):
    _, state, pack, pods = _inputs(cuda, seed=14)
    args = (pack, state.used, state.cap, state.group_bits,
            state.resident_anti, pods, False)
    kernels.reset_launch_counts()
    kernels.winner_tile_scores(*args)
    assert kernels.winner_tile_scores.launches == 1
    assert kernels.peer_columns.launches == 1
    cols, count = kernels.peer_columns(pods.t)
    kernels.winner_tile_scores(*args, peers=(cols, count))
    assert kernels.winner_tile_scores.launches == 2
    assert kernels.peer_columns.launches == 2
    with pytest.raises(TypeError):
        kernels.winner_tile_scores(*args, peers=(cols.long(), count))
    with pytest.raises(ValueError):
        kernels.winner_tile_scores(*args, peers=(cols[:-1], count))
    with pytest.raises(ValueError):
        kernels.winner_tile_scores(*args, peers=(cols, count.repeat(2)))
    with pytest.raises(ValueError):
        kernels.winner_tile_scores(*args, peers=(cols.cpu(), count))
    assert kernels.winner_tile_scores.launches == 2
    assert kernels.peer_columns.launches == 2


def test_fused_winner_takes_the_kernel_unless_a_join_is_live(cuda):
    cfg, state, _, _ = _inputs(cuda, seed=9)
    _, stream = synthetic_density(300, 400, cfg, seed=9, device=cuda)
    pods = batch_from_stream(stream.slice(0, 100),
                             torch.zeros(400, dtype=torch.int32,
                                         device=cuda))
    kernels.reset_launch_counts()
    best, node = tiled_score.score_winner_tiled(state, pods, cfg)
    assert kernels.winner_tile_scores.launches == 1
    assert kernels.masked_tile_scores.launches == 0
    best_2, node_2 = winner_from_scores(
        tiled_score.score_pods_tiled(state, pods, cfg))
    assert torch.equal(node, node_2) and torch.equal(best, best_2)
    live = dataclasses.replace(pods, ns_term_used=torch.ones_like(
        pods.ns_term_used))
    tiled_score.score_winner_tiled(state, live, cfg)
    assert kernels.winner_tile_scores.launches == 1
    assert kernels.masked_tile_scores.launches == 2


def test_exact_matmul_restores_callers_tf32(cuda):
    # TF32 keeps ten mantissa bits and would round 1 + 2^-12 to 1.
    a = torch.full((64, 64), 1.0 + 2.0 ** -12, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = exact_matmul(a, a)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert bool((got == 64.0 + 2.0 ** -5).all())


def test_row_shard_with_offset_on_card(cuda):
    _, state, full, pods = _inputs(cuda, seed=2)
    raw_full, ok_full = kernels.static_tile_scores(full, state.group_bits,
                                                   pods, False)
    lo, hi = 70, 250
    shard = dataclasses.replace(
        full, bw=full.bw[lo:hi].contiguous(),
        lat=full.lat[lo:hi].contiguous(), base=full.base[lo:hi].contiguous(),
        node_valid=full.node_valid[lo:hi].contiguous(),
        taint=full.taint[lo:hi].contiguous(),
        label=full.label[lo:hi].contiguous(),
        params=torch.cat([full.params[:7],
                          torch.tensor([float(lo)], device=cuda)]))
    raw, ok = kernels.static_tile_scores(
        shard, state.group_bits[lo:hi].contiguous(), pods, False)
    assert torch.equal(ok, ok_full[:, lo:hi])
    assert torch.allclose(raw, raw_full[:, lo:hi], rtol=1e-5, atol=1e-5)


def _row_shard(pack, groups, tp_index: int, tp: int):
    """The static kernel's inputs for node shard ``tp_index`` of ``tp``,
    as ``parallel.sharding.pallas_static_builder`` forms them: the
    shard's rows of every node plane, full peer columns, ``params[7]``
    its global row offset."""
    rows = pack.bw.shape[0] // tp
    lo, hi = tp_index * rows, (tp_index + 1) * rows
    params = pack.params.clone()
    params[7] = float(lo)
    shard = dataclasses.replace(
        pack, params=params, bw=pack.bw[lo:hi].contiguous(),
        lat=pack.lat[lo:hi].contiguous(), base=pack.base[lo:hi].contiguous(),
        node_valid=pack.node_valid[lo:hi].contiguous(),
        taint=pack.taint[lo:hi].contiguous(),
        label=pack.label[lo:hi].contiguous())
    return shard, groups[lo:hi].contiguous(), slice(lo, hi)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_tp_row_shard_launch_matches_plain_and_solo_columns(cuda, tp, bf16):
    """Each tp rank's launch (its ``[N/tp, N]`` rows, its offset) against
    its plain version (mask identical, raw within 1e-4) and against the
    matching columns of the solo launch, bit for bit: the per-entry peer
    walk does not depend on the output rows."""
    _, state, pack, pods = _inputs(cuda, nodes=500, max_nodes=512, pods=64,
                                   seed=4)
    raw_solo, ok_solo = kernels.static_tile_scores(pack, state.group_bits,
                                                   pods, bf16,
                                                   transposed=True)
    for t in range(tp):
        shard, groups, cols = _row_shard(pack, state.group_bits, t, tp)
        raw, ok = kernels.static_tile_scores(shard, groups, pods, bf16,
                                             transposed=True)
        raw_p, ok_p = kernels.static_tile_scores_plain(shard, groups, pods,
                                                       bf16)
        torch.cuda.synchronize()
        assert torch.equal(ok.T, ok_p)
        assert torch.allclose(raw.T[ok_p], raw_p[ok_p], rtol=1e-4,
                              atol=1e-4)
        assert torch.equal(raw.view(torch.int32),
                           raw_solo[cols].contiguous().view(torch.int32))
        assert torch.equal(ok, ok_solo[cols])


def test_wrapper_rejects_bad_inputs_and_counts_launches(cuda):
    _, state, pack, pods = _inputs(cuda, seed=3)
    kernels.reset_launch_counts()
    kernels.static_tile_scores(pack, state.group_bits, pods, False)
    assert kernels.static_tile_scores.launches == 1
    assert kernels.peer_columns.launches == 1
    cols, count = kernels.peer_columns(pods.t)
    with pytest.raises(TypeError):
        kernels.static_tile_scores(pack, state.group_bits, pods, False,
                                   peers=(cols.long(), count))
    with pytest.raises(ValueError):
        kernels.static_tile_scores(pack, state.group_bits, pods, False,
                                   peers=(cols[:-1], count))
    with pytest.raises(TypeError):
        kernels.static_tile_scores(pack, state.group_bits.float(), pods,
                                   False)
    with pytest.raises(ValueError):
        kernels.static_tile_scores(
            dataclasses.replace(pack, bw=pack.bw.T), state.group_bits,
            pods, False)
    with pytest.raises(ValueError):
        kernels.static_tile_scores(pack, state.group_bits.cpu(), pods,
                                   False)
    assert kernels.static_tile_scores.launches == 1


def test_kernel_and_dense_replays_agree(cuda):
    cfg = SchedulerConfig(max_nodes=512, max_pods=64, max_peers=4,
                          use_bfloat16=False)
    state, stream = synthetic_density(500, 1024, cfg, seed=4, device=cuda)
    kernels.reset_launch_counts()
    a_k, final = replay_stream(
        state, stream, dataclasses.replace(cfg, score_backend="pallas"))
    assert kernels.static_tile_scores.launches == 16
    a_d, _ = replay_stream(state, stream,
                           dataclasses.replace(cfg, score_backend="xla"))
    assert torch.equal(a_k, a_d)
    assert bool((final.used <= final.cap + 1e-9).all())


def _loop_drive(dev, nodes=256, pods=384, **over):
    """Drain one seeded backlog through a fresh ``SchedulerLoop`` on a
    ``nodes``-node fake cluster; the bindings, final ``used``, counters
    and static-kernel launches."""
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop

    loop_kw = {k: over.pop(k) for k in ("burst_batches", "pipelined")
               if k in over}
    cfg = SchedulerConfig(max_nodes=nodes, max_pods=32, max_peers=4,
                          queue_capacity=pods + 32, **over)
    cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=nodes,
                                                      seed=11))
    loop = SchedulerLoop(cluster, cfg, device=dev, **loop_kw)
    try:
        loop.encoder.set_network(lat, bw)
        feed_metrics(cluster, loop.encoder, np.random.default_rng(12))
        cluster.add_pods(generate_workload(
            WorkloadSpec(num_pods=pods, seed=13, services=8,
                         peer_fraction=0.5, affinity_fraction=0.1,
                         anti_fraction=0.1),
            scheduler_name=cfg.scheduler_name))
        kernels.reset_launch_counts()
        loop.run_until_drained()
        loop.flush_binds()
        torch.cuda.synchronize()
    finally:
        loop.stop_bind_worker()
    snap = loop.encoder.snapshot()
    return {"bindings": {b.pod_name: b.node_name for b in cluster.bindings},
            "used": snap.used.cpu(),
            "counts": (loop.scheduled, loop.unschedulable),
            "static_launches": kernels.static_tile_scores.launches,
            "burst_cycles": loop.burst_cycles}


def test_loop_pallas_drive_matches_xla_on_card(cuda):
    """A 256-node loop drive at f32: the static kernel's bindings equal
    the dense torch path's."""
    k = _loop_drive(cuda, score_backend="pallas", use_bfloat16=False)
    d = _loop_drive(cuda, score_backend="xla", use_bfloat16=False)
    assert k["bindings"] and k["static_launches"] >= 384 // 32
    assert d["static_launches"] == 0
    assert k["bindings"] == d["bindings"] and k["counts"] == d["counts"]


def test_loop_serial_and_burst_identical_on_card(cuda):
    serial = _loop_drive(cuda, score_backend="pallas", burst_batches=1)
    burst = _loop_drive(cuda, score_backend="pallas", burst_batches=4)
    assert serial["bindings"] and burst["burst_cycles"] > 0
    assert burst["bindings"] == serial["bindings"]
    assert burst["counts"] == serial["counts"]
    assert torch.equal(burst["used"], serial["used"])


_WEBHOOK: dict = {}


def _webhook_encoder(dev):
    """A 5,120-node encoder at deploy/scorer.yaml's config (``max_pods``
    256, ``max_peers`` 8) with 256 seeded pods whose peers sit on seeded
    nodes; built once per process."""
    if "enc" not in _WEBHOOK:
        from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
            ClusterSpec,
            WorkloadSpec,
            build_fake_cluster,
            feed_metrics,
            generate_workload,
        )
        from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder

        cfg = SchedulerConfig(max_nodes=5120, max_pods=256, max_peers=8,
                              score_backend="pallas")
        cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=5120,
                                                          seed=0))
        enc = Encoder(cfg, device=dev)
        for node in cluster.list_nodes():
            enc.upsert_node(node)
        enc.set_network(lat, bw)
        rng = np.random.default_rng(1)
        feed_metrics(cluster, enc, rng)
        pods = generate_workload(WorkloadSpec(num_pods=512, seed=2,
                                              services=8, peer_fraction=0.9))
        names = enc.known_node_names()
        home = {p.name: names[int(rng.integers(0, len(names)))]
                for p in pods[:256]}
        _WEBHOOK.update(cfg=cfg, enc=enc, pods=pods[256:],
                        node_of=lambda n: home.get(n, ""))
    return _WEBHOOK


@pytest.mark.parametrize("p", [8, 16, 32, 64, 128, 256])
def test_masked_kernel_at_each_webhook_pod_pad(cuda, p):
    """The batcher pads a wave's pod axis to a power of two in [8,
    max_pods]: the masked kernel equals its plain version at each size,
    at N=5,120 with up to 8 peers per pod."""
    w = _webhook_encoder(cuda)
    batch = w["enc"].encode_pods(w["pods"][:p], node_of=w["node_of"],
                                 lenient=True, pad_to=p)
    assert int((batch.peers >= 0).sum()) > 0
    state = w["enc"].snapshot()
    args = tiled_score._masked_kernel_args(state, batch, w["cfg"])
    out = kernels.masked_tile_scores(*args)
    out_p = kernels.masked_tile_scores_plain(*args)
    assert out.shape == (p, 5120)
    m = out_p > NEG_HALF
    assert torch.equal(out > NEG_HALF, m)
    assert bool(m.any())
    assert torch.allclose(out[m], out_p[m], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_pipelined_feeds_equal_monolithic_replay_on_card(cuda, backend):
    """The chunked replays on the card (a worker thread runs the chunks,
    each assignment comes back through the pinned side-stream copy)
    give the monolithic replay's assignments and rounds."""
    from kubernetesnetawarescheduler_tpu_torch.core.replay import (
        pad_stream,
        replay_stream_pipelined,
        replay_stream_pipelined_feed,
    )

    cfg = SchedulerConfig(max_nodes=512, max_pods=64, max_peers=4,
                          score_backend=backend)
    state, stream = synthetic_density(500, 64 * 13 - 5, cfg, seed=3,
                                      device=cuda)
    want, _final, want_r = replay_stream(state, stream, cfg,
                                         with_stats=True)
    want = want.cpu().numpy()
    chunks = [pad_stream(stream.slice(a, a + 3 * 64), 64)
              for a in range(0, stream.num_pods, 3 * 64)]
    for gen in (replay_stream_pipelined(state, stream, cfg,
                                        chunk_batches=3, dispatch_window=2),
                replay_stream_pipelined_feed(state, iter(chunks),
                                             stream.num_pods, cfg)):
        got = np.full(stream.num_pods, -9, np.int32)
        rounds = []
        for s0, a, r in gen:
            got[s0:s0 + len(a)] = a
            rounds.extend(int(x) for x in r)
        np.testing.assert_array_equal(got, want)
        assert rounds == list(want_r)


def test_prefetch_copy_is_exact(cuda):
    from kubernetesnetawarescheduler_tpu_torch.core.replay import (
        _prefetch_to_host,
    )

    gen = torch.Generator(device=cuda).manual_seed(5)
    for n in (1, 127, 4096, 1 << 20):
        src = torch.randint(-1, 5120, (n,), device=cuda, dtype=torch.int32,
                            generator=gen)
        # Work queued on the compute stream after the source is written:
        # the copy must wait for the write, not race it.
        torch.cuda._sleep(100_000)
        src.add_(1)
        host, event = _prefetch_to_host(src)
        assert host.is_pinned() and host.device.type == "cpu"
        event.synchronize()
        np.testing.assert_array_equal(host.numpy(), src.cpu().numpy())


def _robust_encoder(dev, n=40):
    from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
    from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node

    enc = Encoder(SchedulerConfig(max_nodes=48, max_pods=8, max_peers=2),
                  device=dev)
    rng = np.random.default_rng(0)
    for i in range(n):
        enc.upsert_node(Node(name=f"n{i}",
                             capacity={"cpu": 8.0, "memory": 32.0},
                             labels={"zone": f"z{i % 3}"}))
        enc.update_metrics(f"n{i}", {"cpu_util": float(rng.uniform(0, 1))})
    lat = rng.uniform(0.1, 5.0, (n, n))
    enc.set_network((lat + lat.T) / 2, rng.uniform(1e9, 1e10, (n, n)))
    return enc


@pytest.mark.parametrize("kind", ["delta_dup", "delta_reorder",
                                  "nan_poison", "bit_flip"])
def test_state_chaos_writes_out_of_place_on_card(cuda, kind):
    """The injector's device write lands in a NEW tensor on the card: a
    snapshot taken before it keeps its bits, and the auditor repairs the
    fault at its cheapest rung."""
    from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
        PLANE_NAMES,
        IntegrityAuditor,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state_chaos import (
        StateChaosInjector,
    )

    for seed in (11, 63, 105, 151):
        enc = _robust_encoder(cuda)
        before = enc.snapshot()
        held = {n: getattr(before, n).clone() for n in PLANE_NAMES}
        desc = StateChaosInjector(enc, seed=seed).inject(kind)
        plane = desc["plane"]
        assert enc._cache[plane].device.type == "cuda"
        for n in PLANE_NAMES:
            assert torch.equal(getattr(before, n).cpu().view(torch.uint8)
                               if held[n].dtype != torch.bool
                               else getattr(before, n).cpu(),
                               held[n].cpu().view(torch.uint8)
                               if held[n].dtype != torch.bool
                               else held[n].cpu()), n
        out = IntegrityAuditor(enc).audit_once()
        assert not out["clean"] and out["repaired"]
        assert out["rung"] == "repatch_rows"


def test_rebalance_scan_on_card_equals_cpu(cuda):
    from kubernetesnetawarescheduler_tpu_torch.core.rebalance import _scan

    rng = np.random.default_rng(3)
    n, b, k, r = 5120, 512, 4, 3
    lat = rng.uniform(0.1, 5.0, (n, n)).astype(np.float32)
    bw = rng.uniform(1e9, 1e10, (n, n)).astype(np.float32)
    valid = rng.random(n) < 0.95
    free = rng.uniform(0, 4, (n, r)).astype(np.float32)
    chosen = rng.integers(0, n, b).astype(np.int32)
    peers = rng.integers(-1, n, (b, k)).astype(np.int32)
    traffic = rng.uniform(0.5, 9.0, (b, k)).astype(np.float32)
    req = rng.uniform(0, 3, (b, r)).astype(np.float32)
    args = (lat, bw, valid, free, chosen, peers, traffic, req)
    w = SchedulerConfig().weights
    cpu = _scan(*(torch.from_numpy(a) for a in args), w.peer_bw, w.peer_lat)
    dev = _scan(*(torch.from_numpy(a).to(cuda) for a in args), w.peer_bw,
                w.peer_lat)
    torch.cuda.synchronize()
    assert torch.equal(dev[2].cpu(), cpu[2])
    assert torch.allclose(dev[0].cpu(), cpu[0], rtol=1e-4, atol=1e-4)
    assert torch.allclose(dev[1].cpu(), cpu[1], rtol=1e-4, atol=1e-4)


def _netmodel_params(dev, n=5120, seed=4):
    """Seeded topology-model parameters (a trained model's magnitudes)."""
    from kubernetesnetawarescheduler_tpu_torch.netmodel.model import (
        TopoParams,
    )

    rng = np.random.default_rng(seed)

    def t(shape, scale, loc=0.0):
        return torch.from_numpy(np.asarray(
            loc + scale * rng.standard_normal(shape), np.float32)).to(dev)

    return TopoParams(x=t((n, 4), 1.0), h=t((n,), 0.2), u=t((n, 8), 0.5),
                      v=t((n, 8), 0.5), su=t((n,), 0.3), sv=t((n,), 0.3),
                      mu=t((), 0.0, 22.0))


def test_netmodel_predict_dense_on_card_equals_cpu(cuda):
    from kubernetesnetawarescheduler_tpu_torch.netmodel.model import (
        _predict_dense,
    )

    dev_lat, dev_bw = _predict_dense(_netmodel_params(cuda))
    cpu_lat, cpu_bw = _predict_dense(_netmodel_params("cpu"))
    torch.cuda.synchronize()
    assert torch.allclose(dev_lat.cpu(), cpu_lat, rtol=1e-5, atol=0.0)
    assert torch.allclose(dev_bw.cpu(), cpu_bw, rtol=1e-5, atol=0.0)


def test_netmodel_adam_step_on_card_equals_cpu(cuda):
    from kubernetesnetawarescheduler_tpu_torch.netmodel.model import (
        TopoParams,
        _sgd_step,
    )

    rng = np.random.default_rng(5)
    b = 256
    batch = (rng.integers(0, 5120, b), rng.integers(0, 5120, b),
             rng.uniform(0.1, 3.0, b).astype(np.float32),
             rng.uniform(20.0, 24.0, b).astype(np.float32),
             (rng.random(b) > 0.1).astype(np.float32),
             (rng.random(b) > 0.1).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = _netmodel_params(dev)
        zeros = TopoParams(*(torch.zeros_like(x) for x in p))
        t = torch.zeros((), dtype=torch.float32, device=dev)
        args = [torch.from_numpy(np.asarray(a)).to(dev) for a in batch]
        outs.append(_sgd_step(p, zeros, zeros, t, zeros, *args, 0.05))
    torch.cuda.synchronize()
    for dev_tree, cpu_tree in zip(outs[0][:3] + outs[0][4:],
                                  outs[1][:3] + outs[1][4:]):
        for a, c in zip(dev_tree, cpu_tree):
            assert torch.allclose(a.cpu(), c, rtol=1e-4, atol=1e-6)
    assert float(outs[0][3]) == float(outs[1][3]) == 1.0


def test_policy_adam_step_on_card_equals_cpu(cuda):
    from kubernetesnetawarescheduler_tpu_torch.policy.model import (
        NUM_TERMS,
        PolicyParams,
        _sgd_step,
    )

    rng = np.random.default_rng(6)
    b, k = 128, 8
    comps = rng.normal(size=(b, k, NUM_TERMS)).astype(np.float32)
    feas = (rng.random((b, k)) > 0.2).astype(np.float32)
    feas[:, 0] = 1.0
    target = np.zeros(b, np.int32)
    cls = rng.integers(-1, 32, (b, k)).astype(np.int32)
    theta = (0.3 * rng.normal(size=NUM_TERMS)).astype(np.float32)
    adj = rng.normal(size=32).astype(np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = PolicyParams(torch.from_numpy(theta).to(dev),
                         torch.from_numpy(adj).to(dev))
        zeros = PolicyParams(*(torch.zeros_like(x) for x in p))
        t = torch.zeros((), dtype=torch.float32, device=dev)
        args = [torch.from_numpy(a).to(dev)
                for a in (comps, feas, target, cls)]
        outs.append(_sgd_step(p, zeros, zeros, t, zeros, *args, 0.05))
    torch.cuda.synchronize()
    for i in (0, 1, 2, 4):
        for a, c in zip(outs[0][i], outs[1][i]):
            assert torch.allclose(a.cpu(), c, rtol=1e-4, atol=1e-6)


def test_quality_harvest_on_card_equals_cpu(cuda):
    from kubernetesnetawarescheduler_tpu_torch.obs.quality import _evaluate

    rng = np.random.default_rng(7)
    n, b, k = 5120, 2048, 4
    lat = rng.uniform(0.1, 5.0, (n, n)).astype(np.float32)
    bw = rng.uniform(1e9, 1e10, (n, n)).astype(np.float32)
    valid = rng.random(n) < 0.95
    chosen = rng.integers(0, n, b).astype(np.int32)
    peers = rng.integers(-1, n, (b, k)).astype(np.int32)
    traffic = rng.uniform(0.5, 9.0, (b, k)).astype(np.float32)
    pred_lat = rng.uniform(0.1, 5.0, (b, k)).astype(np.float32)
    pred_bw = rng.uniform(1e9, 1e10, (b, k)).astype(np.float32)
    args = (lat, bw, valid, chosen, peers, traffic, pred_lat, pred_bw)
    w = SchedulerConfig().weights
    cpu = _evaluate(*(torch.from_numpy(a) for a in args), w.peer_bw,
                    w.peer_lat)
    dev = _evaluate(*(torch.from_numpy(a).to(cuda) for a in args),
                    w.peer_bw, w.peer_lat)
    torch.cuda.synchronize()
    for d, c in zip(dev[:-1], cpu[:-1]):
        assert torch.allclose(d.cpu(), c, rtol=1e-5, atol=1e-6)
    assert torch.equal(dev[-1].cpu(), cpu[-1])


def _lanes(dev, seeds=(0, 1, 2)):
    """Stacked lanes of :func:`_inputs` (one shape, different seeds)."""
    from kubernetesnetawarescheduler_tpu_torch.core.state import stack_trees

    lanes = [_inputs(dev, seed=s) for s in seeds]
    return (lanes, stack_trees([pk for _, _, pk, _ in lanes]),
            torch.stack([st.group_bits for _, st, _, _ in lanes]),
            stack_trees([pp for _, _, _, pp in lanes]))


@pytest.mark.parametrize("bf16", [False, True])
def test_static_lanes_kernel_matches_solo_kernel_per_lane(cuda, bf16):
    """The lane launch gives each lane the solo launch's bits, and its
    plain version's mask and scores within the static bar."""
    lanes, pack, groups, pods = _lanes(cuda)
    kernels.reset_launch_counts()
    raw, ok = kernels.static_tile_scores_lanes(pack, groups, pods, bf16)
    raw_t, ok_t = kernels.static_tile_scores_lanes(pack, groups, pods, bf16,
                                                   transposed=True)
    assert kernels.static_tile_scores_lanes.launches == 2
    raw_p, ok_p = kernels.static_tile_scores_lanes_plain(pack, groups, pods,
                                                         bf16)
    for k, (_, st, pk, pp) in enumerate(lanes):
        raw_s, ok_s = kernels.static_tile_scores(pk, st.group_bits, pp, bf16)
        torch.cuda.synchronize()
        assert torch.equal(raw[k].view(torch.int32), raw_s.view(torch.int32))
        assert torch.equal(ok[k], ok_s)
        assert torch.equal(raw_t[k], raw[k].T) and torch.equal(ok_t[k],
                                                               ok[k].T)
        assert torch.equal(ok[k], ok_p[k])
        assert torch.allclose(raw[k], raw_p[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lanes_assign_and_commit_match_solo_on_card(cuda, backend):
    """On the card each lane of the lane-batched loop and of the fleet's
    fused step equals the solo loop and the solo fused step: the
    assignment, the rounds and every committed plane (``used`` bit for
    bit: the usage update runs the solo product per lane)."""
    from kubernetesnetawarescheduler_tpu_torch.core.assign import (
        assign_parallel,
        fused_schedule_step,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state import stack_trees
    from kubernetesnetawarescheduler_tpu_torch.fleet import fleet_fused_step

    lanes = []
    for seed in (0, 1, 2, 3):
        cfg = SchedulerConfig(max_nodes=320, max_pods=100, max_peers=4,
                              score_backend=backend)
        state, stream = synthetic_density(300, 400, cfg, seed=seed,
                                          device=cuda)
        rng = np.random.default_rng(seed)
        node_of = torch.from_numpy(
            rng.integers(0, 300, stream.num_pods).astype(np.int32)).to(cuda)
        # Tight capacity: contended nodes and several rounds.
        state = state.replace(cap=state.cap * 0.05)
        lanes.append((state, batch_from_stream(stream.slice(0, 100),
                                               node_of)))
    states = stack_trees([s for s, _ in lanes])
    pods = stack_trees([b for _, b in lanes])
    new, asg, rounds = fleet_fused_step(states, pods, None, cfg)
    for k, (s, b) in enumerate(lanes):
        a, r = assign_parallel(s, b, cfg, with_stats=True)
        s_new, _, _ = fused_schedule_step(s, b, cfg)
        assert torch.equal(asg[k], a) and int(rounds[k]) == r
        for f in ("used", "group_bits", "resident_anti", "gz_counts",
                  "az_anti"):
            assert torch.equal(getattr(new, f)[k], getattr(s_new, f)), f
    assert len(set(rounds.tolist())) >= 1 and int(rounds.max()) > 1


def test_round_graph_replays_the_eager_rounds(cuda, monkeypatch):
    """On the card ``assign_parallel`` replays each round as a CUDA graph
    (``core/round_graph.py``): batches of one shape in turn, a batch of a
    second shape, and batches of the first shape with zone work (its own
    capture: no second chance, the zone overlay) give the eager round
    body's assignments, rounds and committed planes bit for bit.  Each
    shape captures once (span ``assign.capture``), every round is one
    replay (``assign.replay``, no ``assign.eager``), and a returned
    assignment is the caller's own: the next batch leaves it
    unchanged.  Batches without zone work are held to the round body's
    graph here (``fused_round`` off); the round kernels' graph has tests
    of its own below."""
    import collections

    from kubernetesnetawarescheduler_tpu_torch.core import (
        assign as assign_lib,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import round_graph
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        commit_assignments,
    )
    from kubernetesnetawarescheduler_tpu_torch.utils import tracing
    from kubernetesnetawarescheduler_tpu_torch.utils.flight import NULL_SPAN

    def drive(pods_per_batch, batches, seed, zone=False):
        cfg = SchedulerConfig(max_nodes=320, max_pods=pods_per_batch,
                              max_peers=4, score_backend="pallas")
        state, stream = synthetic_density(300, batches * pods_per_batch,
                                          cfg, seed=seed, device=cuda)
        # Tight capacity: contended nodes and several rounds.
        state = state.replace(cap=state.cap * 0.05)
        if zone:
            zones = torch.arange(cfg.max_nodes, device=cuda) % 3
            state = state.replace(node_zone=torch.where(
                state.node_valid, zones, -1).to(torch.int32))
        node_of = torch.full((stream.num_pods,), -1, dtype=torch.int32,
                             device=cuda)
        out = []
        for i in range(batches):
            lo, hi = i * pods_per_batch, (i + 1) * pods_per_batch
            pods = batch_from_stream(stream.slice(lo, hi), node_of)
            if zone:
                pods = pods.replace(
                    group_idx=(torch.arange(pods_per_batch, device=cuda)
                               % 2).to(torch.int32),
                    spread_maxskew=pods.pod_valid.to(torch.int32))
            a, r = assign_lib.assign_parallel(state, pods, cfg,
                                              with_stats=True)
            out.append((a, a.clone(), r))
            state = commit_assignments(state, pods, a)
            node_of[lo:hi] = a
        return out, state

    monkeypatch.setattr(assign_lib, "fused_round", lambda *args: False)
    plan = ((100, 4, 0, False), (64, 2, 1, False), (100, 2, 2, True))
    with monkeypatch.context() as eager:
        # The batch's own tensors, the body run eagerly.
        eager.setattr(round_graph, "acquire",
                      lambda key, ins, carry, build: build(ins))
        want = [drive(*args) for args in plan]
    monkeypatch.setattr(round_graph, "_ENTRIES", collections.OrderedDict())
    timer = tracing.PhaseTimer()
    with tracing.cycle(timer, NULL_SPAN):
        got = [drive(*args) for args in plan]
    torch.cuda.synchronize()
    rounds = 0
    for (w_out, w_state), (g_out, g_state) in zip(want, got):
        for (wa, _, wr), (ga, ga0, gr) in zip(w_out, g_out):
            assert torch.equal(ga, wa) and gr == wr
            assert torch.equal(ga, ga0)
            rounds += gr
        for f in ("used", "group_bits", "resident_anti", "gz_counts",
                  "az_anti"):
            assert torch.equal(getattr(g_state, f), getattr(w_state, f)), f
    assert rounds > len(plan) * 2
    assert timer.count("assign.capture") == len(plan)
    assert timer.count("assign.replay") == rounds
    assert timer.count("assign.round") == rounds
    assert timer.count("assign.eager") == 0


# ---------------------------------------------------------------------------
# The conflict round's kernels (csrc/conflict_round.cu).
# ---------------------------------------------------------------------------

ROUND_KINDS = ("mixed", "infeasible", "ties", "hot", "conflict")
ROUND_NAMES = ("core", "used", "group_bits", "resident_anti", "gz_counts",
               "az_anti", "assignment")


def _words(rng, rows: int, w: int, density: float, bits: int):
    """``i32[rows, w]`` masks: with probability ``density`` a row carries
    one of the low ``bits`` bits of word 0, and a fifth of those rows
    also bit 31 of the last word (the sign bit of an int32 word)."""
    out = np.zeros((rows, w), np.uint32)
    on = rng.random(rows) < density
    out[on, 0] = np.uint32(1) << rng.integers(0, bits, int(on.sum())).astype(
        np.uint32)
    top = on & (rng.random(rows) < 0.2)
    out[top, w - 1] |= np.uint32(1 << 31)
    return torch.from_numpy(out.view(np.int32))


def round_case(dev, n: int, p: int, seed: int, kind: str, w: int = 4):
    """``(cfg, t, carry)`` of ``assign._parallel_setup`` for a seeded
    batch of ``w`` mask words without zone work, whose raw score and
    static mask come in through the ``{"raw", "ok"}`` seam:

    - ``mixed``: scores on a coarse grid (ties), 80% of pairs feasible,
      scattered group, anti and affinity bits;
    - ``infeasible``: no pod fits anywhere;
    - ``ties``: every node scores the same for a pod;
    - ``hot``: one node is every pod's best and holds about a third of
      the batch, so its capacity prefix is cut inside its segment and
      pass B places rejected pods elsewhere;
    - ``conflict``: ``hot`` with dense anti-affinity against the groups
      of the hot node's own contenders."""
    from kubernetesnetawarescheduler_tpu_torch.core.assign import (
        _parallel_setup,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        init_cluster_state,
        init_pod_batch,
    )

    cfg = SchedulerConfig(max_nodes=n, max_pods=p, max_peers=1,
                          mask_words=w)
    rng = np.random.default_rng(seed)
    r = cfg.num_resources
    cap = rng.uniform(2.0, 8.0, (n, r))
    used = cap * rng.uniform(0.0, 0.5, (n, r))
    req = rng.uniform(0.1, 1.5, (p, r))
    raw = rng.integers(0, 8, (p, n)) / 4.0
    ok = rng.random((p, n)) < 0.8
    anti = 0.6 if kind == "conflict" else 0.2
    if kind == "infeasible":
        ok[:] = False
    if kind == "ties":
        raw = np.repeat(raw[:, :1], n, axis=1)
    if kind in ("hot", "conflict"):
        hot = int(rng.integers(0, n))
        raw[:, hot] += 100.0
        ok[:, hot] = True
        used[hot] = 0.0
        cap[hot] = req.sum(axis=0) / 3.0 + 1e-3
    f32 = torch.float32
    state = init_cluster_state(
        cfg, dev, cap=torch.tensor(cap, dtype=f32),
        used=torch.tensor(used, dtype=f32),
        node_valid=torch.ones(n, dtype=torch.bool),
        group_bits=_words(rng, n, w, 0.3, 6),
        resident_anti=_words(rng, n, w, 0.1, 6),
        node_zone=torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)))
    valid = rng.random(p) < 0.9
    valid[0] = True
    pods = init_pod_batch(
        cfg, dev, req=torch.tensor(req, dtype=f32),
        group_bit=_words(rng, p, w, 1.0, 6),
        anti_bits=_words(rng, p, w, anti, 6),
        affinity_bits=_words(rng, p, w, 0.1, 6),
        priority=torch.from_numpy(rng.integers(0, 5, p).astype(np.float32)),
        pod_valid=torch.from_numpy(valid))
    static = {"raw": torch.tensor(raw, dtype=f32, device=dev),
              "ok": torch.from_numpy(ok).to(dev)}
    t, carry, zone_work, _ = _parallel_setup(state, pods, cfg, static)
    assert not zone_work
    # The seam hands transposed views over; a round graph holds
    # contiguous copies, as the kernels take them.
    return (cfg, {k: v.contiguous() for k, v in t.items()},
            tuple(c.contiguous() for c in carry))


def assert_round_parity(want, got, where) -> None:
    """The parity bar of a kernel round against the PyTorch body from one
    carry: assignment, masks, zone planes and the continue flag
    identical, ``used`` within 1e-6, the core's feasibility identical
    and its feasible values within 1e-4."""
    *w_carry, w_cont = want
    *g_carry, g_cont = got
    for name, a, b in zip(ROUND_NAMES, w_carry, g_carry):
        if name == "core":
            feas = a > NEG_HALF
            assert torch.equal(feas, b > NEG_HALF), (where, name)
            assert torch.allclose(a[feas], b[feas], rtol=0, atol=1e-4), (
                where, name, float((a[feas] - b[feas]).abs().max()))
        elif name == "used":
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-6), (
                where, name, float((a - b).abs().max()))
        else:
            assert torch.equal(a, b), (where, name)
    assert bool(w_cont) == bool(g_cont), (where, "cont")


@pytest.mark.parametrize("kind", ROUND_KINDS)
@pytest.mark.parametrize("n", [37, 5120])
@pytest.mark.parametrize("p", [1, 3, 64, 256, 512, 1024])
def test_round_kernels_match_the_round_body(cuda, monkeypatch, p, n, kind):
    """Every round of a batch, run once by the kernels and once by the
    PyTorch round body from the same carry, meets the parity bar; the
    body's carry goes on to the next round.  Where pods contend for a
    hot node, pass B places pods in some round.  Batches above 256 pods
    carry the kernels' largest shape, 8 mask words: several argmax
    column tiles, a resolve block of up to 1,024 threads and its shared
    memory above 48 KB."""
    from kubernetesnetawarescheduler_tpu_torch.core import assign

    cfg, t, carry = round_case(cuda, n, p, seed=1000 * p + n, kind=kind,
                               w=8 if p > 256 else 4)
    placed = []
    add = assign.scatter_add_rows

    def counted(base, idx, vals, mask):
        placed.append(int(mask.sum()))
        return add(base, idx, vals, mask)

    monkeypatch.setattr(assign, "scatter_add_rows", counted)
    plain = assign._round_body(t, cfg, False)
    fused = kernels.conflict_round(t, cfg)
    launches = kernels.conflict_round.launches
    rounds, cont = 0, True
    while cont and rounds < 64:
        want = plain(*carry)
        got = fused(*(c.contiguous().clone() for c in carry))
        torch.cuda.synchronize()
        assert_round_parity(want, got, (kind, n, p, rounds))
        carry, cont = tuple(want[:-1]), bool(want[-1])
        rounds += 1
    assert not cont
    assert kernels.conflict_round.launches - launches == (
        kernels.ROUND_LAUNCHES * rounds)
    assert len(placed) == 2 * rounds
    if kind == "infeasible":
        assert sum(placed) == 0
    if kind == "hot" and p >= 64:
        assert sum(placed[1::2]) > 0


def _drain(dev, nodes, pods_per_batch, batches, seed, words=4):
    """Batches of one density stream on tight capacity, each assigned by
    ``assign_parallel`` and committed: per batch ``(assignment,
    rounds)``, and the final state."""
    from kubernetesnetawarescheduler_tpu_torch.core import assign
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        commit_assignments,
    )

    cfg = SchedulerConfig(max_nodes=nodes + 7, max_pods=pods_per_batch,
                          max_peers=4, score_backend="pallas",
                          mask_words=words)
    state, stream = synthetic_density(nodes, batches * pods_per_batch, cfg,
                                      seed=seed, device=dev)
    state = state.replace(cap=state.cap * 0.05)
    node_of = torch.full((stream.num_pods,), -1, dtype=torch.int32,
                         device=dev)
    out = []
    for i in range(batches):
        lo, hi = i * pods_per_batch, (i + 1) * pods_per_batch
        pods = batch_from_stream(stream.slice(lo, hi), node_of)
        a, rounds = assign.assign_parallel(state, pods, cfg,
                                           with_stats=True)
        out.append((a, rounds))
        state = commit_assignments(state, pods, a)
        node_of[lo:hi] = a
    return out, state


@pytest.mark.parametrize("nodes,pods_per_batch,batches",
                         [(300, 64, 4), (5113, 256, 3), (2000, 1024, 2)])
def test_round_kernels_drain_as_the_pytorch_graph(cuda, monkeypatch, nodes,
                                                  pods_per_batch, batches):
    """Whole drains through ``assign_parallel``: the round kernels' graph
    and the PyTorch body's graph give identical assignments and round
    counts and the same committed state (``used`` within 1e-6).  Every
    kernel round is one replay marked ``assign.fused``, and the launch
    count is seven for each replay and each capture's warm-up.  The
    1,024-pod drain carries 8 mask words, the kernels' largest shape."""
    import collections

    from kubernetesnetawarescheduler_tpu_torch.core import (
        assign,
        round_graph,
    )
    from kubernetesnetawarescheduler_tpu_torch.utils import tracing
    from kubernetesnetawarescheduler_tpu_torch.utils.flight import NULL_SPAN

    words = 8 if pods_per_batch > 256 else 4
    monkeypatch.setattr(round_graph, "_ENTRIES", collections.OrderedDict())
    with monkeypatch.context() as graph:
        graph.setattr(assign, "fused_round", lambda *args: False)
        want, want_state = _drain(cuda, nodes, pods_per_batch, batches, 5,
                                  words)
    timer = tracing.PhaseTimer()
    launches = kernels.conflict_round.launches
    with tracing.cycle(timer, NULL_SPAN):
        got, got_state = _drain(cuda, nodes, pods_per_batch, batches, 5,
                                words)
    torch.cuda.synchronize()
    for (wa, wr), (ga, gr) in zip(want, got):
        assert torch.equal(ga, wa) and gr == wr
    for f in ("group_bits", "resident_anti", "gz_counts", "az_anti"):
        assert torch.equal(getattr(got_state, f), getattr(want_state, f)), f
    assert torch.allclose(got_state.used, want_state.used, rtol=1e-6,
                          atol=1e-6)
    rounds = sum(r for _, r in got)
    assert rounds > batches
    assert timer.count("assign.fused") == rounds
    assert timer.count("assign.replay") == rounds
    # Each round's replay and each capture's warm-up ran the seven.
    assert kernels.conflict_round.launches - launches == (
        kernels.ROUND_LAUNCHES * (rounds + timer.count("assign.capture")))
