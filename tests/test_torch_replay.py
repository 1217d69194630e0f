"""The whole slice: the port's replay against the JAX package's.

A stream built by the JAX encoder (the stream of
tests/test_pallas_score.py::test_replay_matches_across_backends) is
handed over as numpy and replayed by both packages under both score
backends: the assignments must be identical.  The port's own seeded
density workload is replayed by both packages too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetesnetawarescheduler_tpu.bench.fakecluster import (
    ClusterSpec,
    WorkloadSpec,
    build_fake_cluster,
    feed_metrics,
    generate_workload,
)
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import replay as jreplay
from kubernetesnetawarescheduler_tpu.core import state as jstate
from kubernetesnetawarescheduler_tpu.core.loop import SchedulerLoop
from kubernetesnetawarescheduler_tpu_torch.bench.density import (
    synthetic_density,
)
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import replay as treplay
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core import tiled_score

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

# The JAX package's u32 mask fields (i32 with the same bits in the port).
STATE_U32 = {"label_bits", "taint_bits", "group_bits", "resident_anti",
             "az_anti"}
POD_U32 = {"tol_bits", "sel_bits", "affinity_bits", "anti_bits",
           "group_bit", "soft_sel_bits", "soft_grp_bits", "soft_zone_bits",
           "ns_anyof", "ns_forbid", "zaff_bits", "zanti_bits"}
KW = dict(max_nodes=128, max_pods=16, max_peers=4, queue_capacity=200,
          use_bfloat16=False)


def _leaves(tree) -> dict:
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


@pytest.fixture(scope="module")
def encoder_stream():
    """(state_np, stream_np) from the JAX encoder, as numpy dicts."""
    cfg = JCfg(**KW)
    cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=48, seed=3))
    loop = SchedulerLoop(cluster, cfg, method="parallel")
    loop.encoder.set_network(lat, bw)
    feed_metrics(cluster, loop.encoder, np.random.default_rng(4))
    pods = generate_workload(
        WorkloadSpec(num_pods=64, soft_zone_fraction=0.3, seed=3),
        scheduler_name=cfg.scheduler_name)
    cluster.add_pods(pods)
    queued = loop.queue.pop_batch(len(pods), timeout=0.0)
    stream = jreplay.pad_stream(
        loop.encoder.encode_stream(queued, node_of=lambda n: ""),
        cfg.max_pods)
    return _leaves(loop.encoder.snapshot()), _leaves(stream)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_replay_matches_jax(encoder_stream, backend):
    state_np, stream_np = encoder_stream
    jcfg = JCfg(**KW, score_backend=backend)
    tcfg = TCfg(**KW, score_backend=backend)
    js = jstate.ClusterState(**{k: jnp.asarray(v)
                                for k, v in state_np.items()})
    jst = jreplay.PodStream(**{k: jnp.asarray(v)
                               for k, v in stream_np.items()})
    want, want_state, want_rounds = jreplay.replay_stream(
        js, jst, jcfg, "parallel", with_stats=True)
    ts = tstate.state_from_numpy(tcfg, state_np, "cpu")
    tst = treplay.stream_from_numpy(tcfg, stream_np, "cpu")
    got, got_state, rounds = treplay.replay_stream(ts, tst, tcfg,
                                                   with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == np.asarray(want_rounds).tolist()
    np.testing.assert_allclose(got_state.used.numpy(),
                               np.asarray(want_state.used), rtol=1e-6,
                               atol=1e-6)
    for name in ("group_bits", "resident_anti", "az_anti"):
        np.testing.assert_array_equal(
            getattr(got_state, name).numpy().view(np.uint32),
            np.asarray(getattr(want_state, name)), err_msg=name)
    np.testing.assert_array_equal(got_state.gz_counts.numpy(),
                                  np.asarray(want_state.gz_counts))


def test_density_replay_matches_jax():
    """The port's seeded density backlog (in-stream peers, affinity,
    anti-affinity, taints) through both packages' replays."""
    kw = dict(max_nodes=64, max_pods=32, max_peers=4, use_bfloat16=False)
    tcfg = TCfg(**kw)
    ts, tst = synthetic_density(60, 256, tcfg, seed=5, device="cpu")
    state_np = {k: v.view(np.uint32) if k in STATE_U32 else v
                for k, v in ts.numpy().items()}
    stream_np = {k: v.view(np.uint32) if k in POD_U32 else v
                 for k, v in tst.numpy().items()}
    jcfg = JCfg(**kw)
    js = jstate.ClusterState(**{k: jnp.asarray(v)
                                for k, v in state_np.items()})
    jst = jreplay.PodStream(**{k: jnp.asarray(v)
                               for k, v in stream_np.items()})
    want, _ = jreplay.replay_stream(js, jst, jcfg, "parallel")
    got, final = treplay.replay_stream(ts, tst, tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got >= 0).sum()) > 200
    assert bool((final.used <= final.cap + 1e-9).all())
    dense = dataclasses.replace(tcfg, score_backend="xla")
    tiled = dataclasses.replace(tcfg, score_backend="pallas")
    a_d, _ = treplay.replay_stream(ts, tst, dense)
    a_t, _ = treplay.replay_stream(ts, tst, tiled)
    np.testing.assert_array_equal(a_d.numpy(), a_t.numpy())
    # The same replay with the static prep computed once by the caller.
    a_s, _ = treplay.replay_stream_static(
        ts, tst, tiled_score.compute_assign_static(ts, tiled), tiled)
    np.testing.assert_array_equal(a_s.numpy(), a_t.numpy())


def test_pad_and_fold_stream():
    tcfg = TCfg(max_nodes=64, max_pods=32, max_peers=4)
    _, stream = synthetic_density(40, 70, tcfg, seed=1, device="cpu")
    assert stream.num_pods == 96
    assert int(stream.pod_valid.sum()) == 70
    assert (stream.peer_pods[70:] == -1).all()
    assert torch.isinf(stream.ns_num_lo[70:]).all()
    folded = treplay.fold_stream(stream, tcfg)
    assert [b.num_pods for b in folded] == [32, 32, 32]
    with pytest.raises(ValueError):
        treplay.fold_stream(stream.slice(0, 40), tcfg)
    with pytest.raises(ValueError):
        treplay.replay_stream(*synthetic_density(40, 64, tcfg, device="cpu"),
                              tcfg, method="nope")
