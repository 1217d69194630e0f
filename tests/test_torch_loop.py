"""The port's ``SchedulerLoop`` against the JAX package's, on the CPU.

The same seeded fake cluster and backlog (each package's own
``bench/fakecluster.py`` generators, from one seed) drain through both
loops on the serial, burst, pipelined, multicycle and async-bind paths.
Bindings, the ``scheduled``/``unschedulable`` counters, the conflict-round
samples and every pod's event reasons must be identical; ``used`` agrees
at rtol=atol=1e-6 (co-located pods add into ``used`` through a one-hot
product in the port, a scatter in JAX).  The shapes are the JAX tests':
``tests/test_burst.py`` (48 nodes, ``max_nodes=64``, ``max_pods=16``, 96
pods, seeds 51-53), ``tests/test_pipeline.py`` and
``tests/test_multicycle.py`` (K=2).  Also: the loop refuses unported
layers at construction and builds the rebalancer when asked,
``run_density(mode="host")`` places what the JAX run places, and the
queue, histogram and flight recorder units behave alike.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import density as jdensity
from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.k8s import informer as jinformer
from kubernetesnetawarescheduler_tpu.utils import flight as jflight
from kubernetesnetawarescheduler_tpu.utils import timeseries as jts
from kubernetesnetawarescheduler_tpu_torch.bench import density as tdensity
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.k8s import informer as tinformer
from kubernetesnetawarescheduler_tpu_torch.utils import flight as tflight
from kubernetesnetawarescheduler_tpu_torch.utils import timeseries as tts

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(fc=jfc, cfg=JCfg, loop=jloop.SchedulerLoop,
                            kw={})
TORCH = types.SimpleNamespace(fc=tfc, cfg=TCfg, loop=tloop.SchedulerLoop,
                              kw={"device": "cpu"})

# (cluster seed, metrics seed, workload seed, nodes, cfg, workload, loop
# kwargs) per drive, from the JAX tests that pin each path.
BURST_CFG = dict(max_nodes=64, max_pods=16, max_peers=4, queue_capacity=112)
BURST_WL = dict(num_pods=96, seed=53, services=8, peer_fraction=0.5,
                affinity_fraction=0.1, anti_fraction=0.1)
MC_CFG = dict(max_nodes=32, max_pods=16, max_peers=4, queue_capacity=4096)
DRIVES = {
    "serial": (51, 52, 48, BURST_CFG, BURST_WL, dict(burst_batches=1)),
    "burst": (51, 52, 48, BURST_CFG, BURST_WL, dict(burst_batches=4)),
    "serial_unschedulable": (51, 52, 48, BURST_CFG, BURST_WL,
                             dict(burst_batches=1), "huge"),
    "burst_unschedulable": (51, 52, 48, BURST_CFG, BURST_WL,
                            dict(burst_batches=4), "huge"),
    "pipelined": (61, 62, 48, BURST_CFG, dict(BURST_WL, seed=63),
                  dict(burst_batches=4, pipelined=True)),
    "multicycle": (3, 4, 24, MC_CFG, dict(num_pods=96, seed=7),
                   dict(burst_batches=8, multicycle=2)),
    "multicycle_coalesced": (3, 4, 24,
                             dict(MC_CFG, bind_coalesce_window=4,
                                  bind_max_inflight=2),
                             dict(num_pods=96, seed=7),
                             dict(burst_batches=8, multicycle=4,
                                  async_bind=True)),
    "async_bind": (51, 52, 48, BURST_CFG, BURST_WL,
                   dict(burst_batches=1, async_bind=True)),
    "async_burst": (51, 52, 48, BURST_CFG, BURST_WL,
                    dict(burst_batches=4, async_bind=True)),
}


def _drain(pkg, drive: str, **cfg_over):
    seed, mseed, nodes, cfg_kw, wl_kw, loop_kw, *extra = DRIVES[drive]
    cfg = pkg.cfg(**{**cfg_kw, **cfg_over})
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=nodes, seed=seed))
    loop = pkg.loop(cluster, cfg, method="parallel", **loop_kw, **pkg.kw)
    try:
        loop.encoder.set_network(lat, bw)
        pkg.fc.feed_metrics(cluster, loop.encoder,
                            np.random.default_rng(mseed))
        pods = pkg.fc.generate_workload(pkg.fc.WorkloadSpec(**wl_kw),
                                        scheduler_name=cfg.scheduler_name)
        if extra and extra[0] == "huge":
            pods[5] = dataclasses.replace(
                pods[5], requests={"cpu": 1e6, "mem": 1e6})
        cluster.add_pods(pods)
        loop.run_until_drained()
        loop.flush_binds()
    finally:
        loop.stop_bind_worker()
    return loop, cluster


def _outcome(loop, cluster) -> dict:
    events: dict[str, list[str]] = {}
    for e in cluster.events:
        events.setdefault(e.involved_pod, []).append(e.reason)
    return {
        "bindings": {b.pod_name: b.node_name for b in cluster.bindings},
        "scheduled": loop.scheduled,
        "unschedulable": loop.unschedulable,
        "rounds": list(loop.round_samples),
        "events": {k: sorted(v) for k, v in events.items()},
        "burst_cycles": loop.burst_cycles,
        "multicycle_windows": loop.multicycle_windows,
    }


def _used(loop) -> np.ndarray:
    used = loop.encoder.snapshot().used
    return used.numpy() if isinstance(used, torch.Tensor) else np.asarray(
        used)


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_loop_drive_matches_jax(drive):
    jl, jc = _drain(JAX, drive)
    tl, tc = _drain(TORCH, drive)
    want, got = _outcome(jl, jc), _outcome(tl, tc)
    assert want["bindings"], "the drive bound nothing"
    assert got == want
    np.testing.assert_allclose(_used(tl), _used(jl), rtol=1e-6, atol=1e-6)
    if "burst" in drive or drive == "pipelined":
        assert got["burst_cycles"] > 0
    if drive.startswith("multicycle"):
        assert got["multicycle_windows"] > 0
    if "unschedulable" in drive:
        assert got["unschedulable"] >= 1


def test_loop_paths_agree_with_each_other():
    """The four cycle paths of the port on one backlog: identical
    bindings and usage (the burst, pipelined and multicycle paths are
    transport changes, not semantics changes)."""
    outs = {}
    for name, kw in (("serial", dict(burst_batches=1)),
                     ("burst", dict(burst_batches=4)),
                     ("pipelined", dict(burst_batches=4, pipelined=True)),
                     ("multicycle", dict(burst_batches=4, multicycle=4))):
        DRIVES["_paths"] = (51, 52, 48, BURST_CFG, BURST_WL, kw)
        try:
            loop, cluster = _drain(TORCH, "_paths")
        finally:
            del DRIVES["_paths"]
        outs[name] = ({b.pod_name: b.node_name for b in cluster.bindings},
                      _used(loop))
    base_b, base_used = outs.pop("serial")
    for name, (b, used) in outs.items():
        assert b == base_b, name
        np.testing.assert_array_equal(used, base_used, err_msg=name)


def test_pallas_backend_serial_drive_matches_jax():
    """``score_backend="pallas"``: the JAX loop's static kernel runs in
    interpret mode, the port's wrapper takes its plain version on CPU
    tensors; the drive places every pod alike."""
    jl, jc = _drain(JAX, "serial", score_backend="pallas",
                    use_bfloat16=False)
    tl, tc = _drain(TORCH, "serial", score_backend="pallas",
                    use_bfloat16=False)
    assert _outcome(tl, tc) == _outcome(jl, jc)
    np.testing.assert_allclose(_used(tl), _used(jl), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flag", ["enable_quality_obs", "enable_slo",
                                  "enable_learned_score", "enable_netmodel",
                                  "mesh"])
def test_unported_layer_refused_at_construction(flag):
    """The mesh (ROADMAP item 15) is refused when the loop is built.  The
    learning layers (item 12) are built with the loop, and the promotion
    gate's replay trace (item 14) is stored when it is set."""
    cfg_kw = dict(max_nodes=8, max_pods=4, max_peers=2)
    loop_kw = {}
    if flag == "mesh":
        loop_kw["mesh"] = object()
    else:
        cfg_kw[flag] = True
    cluster = tfc.build_fake_cluster(tfc.ClusterSpec(num_nodes=4,
                                                     seed=1))[0]
    if flag == "mesh":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A item 15"):
            tloop.SchedulerLoop(cluster, TCfg(**cfg_kw), device="cpu",
                                **loop_kw)
        return
    loop = tloop.SchedulerLoop(cluster, TCfg(**cfg_kw), device="cpu")
    try:
        layer = {"enable_quality_obs": loop.quality,
                 "enable_slo": loop.slo,
                 "enable_learned_score": loop.policy,
                 "enable_netmodel": loop.encoder}[flag]
        assert layer is not None
        assert loop.policy_eval_trace is None
        loop.policy_eval_trace = "trace.jsonl"
        assert loop.policy_eval_trace == "trace.jsonl"
    finally:
        loop.stop_bind_worker()


def test_rebalance_layer_built_at_construction():
    """``enable_rebalance`` builds the port's rebalancer on the loop's
    encoder and client, as the JAX loop does; off, there is none."""
    from kubernetesnetawarescheduler_tpu_torch.core.rebalance import (
        Rebalancer,
    )

    cluster = tfc.build_fake_cluster(tfc.ClusterSpec(num_nodes=4,
                                                     seed=1))[0]
    on = tloop.SchedulerLoop(cluster, TCfg(max_nodes=8, max_pods=4,
                                           max_peers=2,
                                           enable_rebalance=True),
                             device="cpu")
    off = tloop.SchedulerLoop(cluster, TCfg(max_nodes=8, max_pods=4,
                                            max_peers=2), device="cpu")
    try:
        assert isinstance(on.rebalance, Rebalancer)
        assert on.rebalance.encoder is on.encoder
        assert on.rebalance.client is cluster
        assert off.rebalance is None
        on.maintain()
        assert on.rebalance.scans_total == 1
    finally:
        on.stop_bind_worker()
        off.stop_bind_worker()


def test_loop_builds_on_cuda_by_default():
    cluster = tfc.build_fake_cluster(tfc.ClusterSpec(num_nodes=4,
                                                     seed=1))[0]
    cfg = TCfg(max_nodes=8, max_pods=4, max_peers=2)
    if torch.cuda.is_available():
        assert tloop.SchedulerLoop(cluster, cfg).encoder.device.type == \
            "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.SchedulerLoop(cluster, cfg)


def test_run_density_host_matches_jax():
    kw = dict(num_nodes=48, num_pods=96, batch_size=16, seed=4,
              warmup=False, churn_links=2)
    want = jdensity.run_density(**kw)
    got = tdensity.run_density(device="cpu", **kw)
    for field in ("pods_submitted", "pods_bound", "pods_unschedulable",
                  "score_samples", "static_refresh_count"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.pods_per_sec > 0 and got.rounds_max >= 1
    assert got.trace_provenance["spans"] > 0
    # The device modes run (tests/test_torch_replay_feed.py); a mesh is
    # still refused, naming its ROADMAP item.
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 15"):
        tdensity.run_density(num_nodes=8, num_pods=8, batch_size=4,
                             mode="device", mesh=object(), device="cpu")


# -- units: the same operations give the same outputs --------------------


def _pods(pkg, n: int):
    return pkg.fc.generate_workload(pkg.fc.WorkloadSpec(num_pods=n, seed=9))


def test_pod_queue_matches_jax():
    out = []
    for pkg, mod in ((JAX, jinformer), (TORCH, tinformer)):
        q = mod.PodQueue(capacity=5)
        pods = _pods(pkg, 8)
        pushed = [q.push(p) for p in pods[:6]]
        dup = q.push(pods[0])
        first = [p.name for p in q.pop_batch(3, timeout=0.0)]
        again = q.push(pods[0])
        rest = [p.name for p in q.pop_batch(10, timeout=0.0)]
        out.append((pushed, dup, first, again, rest, len(q)))
    assert out[0] == out[1]


def test_log_histogram_matches_jax():
    rng = np.random.default_rng(3)
    samples = rng.lognormal(0.0, 2.0, 500)
    out = []
    for mod in (jts, tts):
        h = mod.LogHistogram(lo=1e-2, hi=1e4, window=64)
        for i, v in enumerate(samples):
            h.record(float(v), count=1 + i % 3)
        timer = mod.HistogramPhaseTimer()
        for v in samples[:50]:
            timer.record("encode", float(v) / 1e3)
        out.append((list(h), h.count, [h.percentile(q) for q in (50, 99)],
                    mod.prom_histogram_lines("x", "help", h.snapshot()),
                    timer.percentile("encode", 99)))
    assert out[0] == out[1]


def test_flight_recorder_matches_jax():
    docs = []
    for mod in (jflight, tflight):
        rec = mod.FlightRecorder(capacity=3, explain_retain=2)
        for i, path in enumerate(("serial", "burst", "pipelined",
                                  "multicycle", "gang")):
            sb = rec.begin(path)
            sb.add_phase("encode", 0.0, 0.001 * (i + 1))
            span = sb.finish(n_pods=i, pod_uids=(f"p{i}",), queue_depth=i,
                             rounds=i, scan_window_k=2 if i == 3 else None)
            rec.commit(span)
            rec.put_explain({"pod_uid": f"p{i}", "node": f"n{i}"})
        # Wall-clock fields differ run to run; compare the structure.
        spans = [dataclasses.replace(s, t_wall=0.0, t_mono=0.0, dur_s=0.0,
                                     phases=tuple((n, 0.0, d)
                                                  for n, _, d in s.phases))
                 for s in rec.spans()]
        docs.append((len(rec), rec.dropped, [s.path for s in spans],
                     [s.cycle_id for s in spans],
                     [(s.n_pods, s.rounds, s.scan_window_k, s.phases)
                      for s in spans],
                     rec.explains(), rec.get_explain("p1"),
                     rec.explains_dropped, mod.NULL_SPAN.finish()))
    assert docs[0] == docs[1]
