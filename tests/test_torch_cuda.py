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
