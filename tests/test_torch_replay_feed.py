"""The port's chunked device-replay feeds against the JAX package's.

On ``tests/test_replay_feed.py``'s shapes (96 nodes, ``max_nodes=128``,
``max_pods=16``, its constraint-rich workload), one config for every
drive of the file, and 192 pods in chunks of 3 batches, so the JAX side
compiles one chunk program (the port's short final chunk is held
against its own monolithic replay):

- ``Encoder.encode_stream_chunks`` concatenates to the one-shot encode,
  and to the JAX encoder's stream, field for field;
- the feed replay, the whole-stream pipelined replay and the monolithic
  replay give the same assignments and rounds, equal to the JAX feed's;
- an error in the feed's producer or on the chunk worker is re-raised in
  the consumer after the chunks before it, never hung or truncated;
- ``run_density`` in ``device`` and ``pipeline`` mode binds what the
  JAX pipeline run binds at the same seed (the JAX package pins its own
  device run to its host loop, ``tests/test_replay.py``), and ``host``
  binds what ``device`` binds.
"""

from __future__ import annotations

import threading
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import density as jdensity
from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.core import replay as jreplay
from kubernetesnetawarescheduler_tpu_torch.bench import density as tdensity
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.core import replay as treplay

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(fc=jfc, cfg=JCfg, loop=jloop.SchedulerLoop,
                            replay=jreplay, kw={})
TORCH = types.SimpleNamespace(fc=tfc, cfg=TCfg, loop=tloop.SchedulerLoop,
                              replay=treplay, kw={"device": "cpu"})

RICH = dict(services=12, peer_fraction=0.7, affinity_fraction=0.2,
            anti_fraction=0.15, tolerate_fraction=0.1,
            soft_zone_fraction=0.2, soft_spread_fraction=0.2,
            spread_fraction=0.25, zone_aff_fraction=0.15)
# run_density's own default cfg at 96 nodes and batch 16 (queue 300),
# shared by every drive here.
CFG = dict(max_nodes=128, max_pods=16, max_peers=4, queue_capacity=300)
NODES, PODS, CHUNK_BATCHES = 96, 192, 3
U32 = {"tol_bits", "sel_bits", "affinity_bits", "anti_bits", "group_bit",
       "soft_sel_bits", "soft_grp_bits", "soft_zone_bits", "ns_anyof",
       "ns_forbid", "zaff_bits", "zanti_bits"}


def _loop_and_queue(pkg):
    cfg = pkg.cfg(**CFG)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=NODES, seed=7))
    loop = pkg.loop(cluster, cfg, method="parallel", **pkg.kw)
    _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(8))
    pods = pkg.fc.generate_workload(
        pkg.fc.WorkloadSpec(num_pods=PODS, seed=9, **RICH),
        scheduler_name=cfg.scheduler_name)
    cluster.add_pods(pods)
    return cfg, loop, loop.queue.pop_batch(PODS, timeout=0.0)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(stream) -> dict:
    out = {}
    for f in stream.__dataclass_fields__:
        v = _np(getattr(stream, f))
        out[f] = v.view(np.uint32) if f in U32 and v.dtype == np.int32 else v
    return out


@pytest.fixture(scope="module")
def jax_feed():
    """The JAX feed replay of the workload: its stream, state and
    ``(assignment, rounds)``."""
    cfg, loop, queued = _loop_and_queue(JAX)
    chunks = [jreplay.pad_stream(c, cfg.max_pods)
              for c in loop.encoder.encode_stream_chunks(
                  queued, node_of=loop._peer_node,
                  chunk_pods=CHUNK_BATCHES * cfg.max_pods)]
    s_total = sum(c.num_pods for c in chunks)
    assignment = np.full(s_total, -9, np.int32)
    rounds = []
    for s0, a, r in jreplay.replay_stream_pipelined_feed(
            loop.encoder.snapshot(), iter(chunks), s_total, cfg,
            "parallel"):
        assignment[s0:s0 + len(a)] = a
        rounds.extend(int(x) for x in r)
    stream = jreplay.pad_stream(
        loop.encoder.encode_stream(queued, node_of=loop._peer_node),
        cfg.max_pods)
    return {"stream": _fields(stream), "assignment": assignment,
            "rounds": rounds}


@pytest.mark.parametrize("chunk_pods", [1, 48, 56, 10_000])
def test_encode_stream_chunks_equal_one_shot_and_jax(jax_feed, chunk_pods):
    _cfg, loop, queued = _loop_and_queue(TORCH)
    one = _fields(loop.encoder.encode_stream(queued,
                                             node_of=loop._peer_node))
    chunks = list(loop.encoder.encode_stream_chunks(
        queued, node_of=loop._peer_node, chunk_pods=chunk_pods))
    assert sum(c.num_pods for c in chunks) == len(queued)
    for f, want in one.items():
        got = np.concatenate([_fields(c)[f] for c in chunks])
        assert np.array_equal(got, want), f"chunk_pods={chunk_pods}: {f}"
        jwant = jax_feed["stream"][f][:len(queued)]
        assert np.array_equal(got, jwant.astype(got.dtype)), f"jax: {f}"


def _port_feed(cfg, loop, queued, chunk_pods, **kw):
    chunks = [treplay.pad_stream(c, cfg.max_pods)
              for c in loop.encoder.encode_stream_chunks(
                  queued, node_of=loop._peer_node, chunk_pods=chunk_pods)]
    s_total = sum(c.num_pods for c in chunks)
    return treplay.replay_stream_pipelined_feed(
        loop.encoder.snapshot(), iter(chunks), s_total, cfg, "parallel",
        **kw), s_total


def _collect(gen, s_total: int, batch: int):
    assignment = np.full(s_total, -9, np.int32)
    rounds = []
    for s0, a, r in gen:
        assert isinstance(a, np.ndarray) and isinstance(r, np.ndarray)
        assert len(r) * batch == len(a)
        assignment[s0:s0 + len(a)] = a
        rounds.extend(int(x) for x in r)
    return assignment, rounds


@pytest.mark.parametrize("window,chunk_batches", [(1, CHUNK_BATCHES),
                                                 (4, CHUNK_BATCHES),
                                                 (2, 5)])
def test_feed_equals_pipelined_equals_monolithic_equals_jax(
        jax_feed, window, chunk_batches):
    cfg, loop, queued = _loop_and_queue(TORCH)
    gen, s_total = _port_feed(cfg, loop, queued,
                              chunk_batches * cfg.max_pods,
                              dispatch_window=window)
    feed_a, feed_r = _collect(gen, s_total, cfg.max_pods)
    stream = treplay.pad_stream(
        loop.encoder.encode_stream(queued, node_of=loop._peer_node),
        cfg.max_pods)
    state = loop.encoder.snapshot()
    pipe_a, pipe_r = _collect(
        treplay.replay_stream_pipelined(state, stream, cfg, "parallel",
                                        chunk_batches=chunk_batches,
                                        dispatch_window=window),
        stream.num_pods, cfg.max_pods)
    mono, _final, mono_r = treplay.replay_stream(state, stream, cfg,
                                                 "parallel",
                                                 with_stats=True)
    assert np.array_equal(feed_a, jax_feed["assignment"])
    assert feed_r == jax_feed["rounds"]
    assert np.array_equal(pipe_a, feed_a) and pipe_r == feed_r
    assert np.array_equal(mono.numpy(), feed_a) and list(mono_r) == feed_r


def _drain_in_thread(gen) -> dict:
    """Consume ``gen`` on a helper thread; the result records the chunks
    seen and the error raised, and whether the drain ended at all."""
    out = {"chunks": 0, "error": None}

    def run():
        try:
            for _ in gen:
                out["chunks"] += 1
        except BaseException as exc:  # noqa: BLE001 — recorded for the test
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    out["ended"] = not t.is_alive()
    return out


def test_producer_error_is_reraised_after_earlier_chunks():
    cfg, loop, queued = _loop_and_queue(TORCH)
    chunks = [treplay.pad_stream(c, cfg.max_pods)
              for c in loop.encoder.encode_stream_chunks(
                  queued, node_of=loop._peer_node, chunk_pods=48)]

    def producer():
        yield from chunks[:2]
        raise RuntimeError("encode failed")

    gen = treplay.replay_stream_pipelined_feed(
        loop.encoder.snapshot(), producer(),
        sum(c.num_pods for c in chunks), cfg, "parallel")
    out = _drain_in_thread(gen)
    assert out["ended"]
    assert out["chunks"] == 2
    assert isinstance(out["error"], RuntimeError)
    assert "encode failed" in str(out["error"])


@pytest.mark.parametrize("fault", ["short_chunk", "early_end", "overrun"])
def test_worker_error_is_reraised_not_hung(fault):
    cfg, loop, queued = _loop_and_queue(TORCH)
    chunks = [treplay.pad_stream(c, cfg.max_pods)
              for c in loop.encoder.encode_stream_chunks(
                  queued, node_of=loop._peer_node, chunk_pods=48)]
    s_total = sum(c.num_pods for c in chunks)
    if fault == "short_chunk":
        chunks[1] = chunks[1].slice(0, 5)
    elif fault == "early_end":
        chunks = chunks[:-1]
    else:
        s_total -= chunks[-1].num_pods
    gen = treplay.replay_stream_pipelined_feed(
        loop.encoder.snapshot(), iter(chunks), s_total, cfg, "parallel")
    out = _drain_in_thread(gen)
    assert out["ended"]
    assert isinstance(out["error"], ValueError)
    assert out["chunks"] == {"short_chunk": 1, "early_end": len(chunks),
                             "overrun": len(chunks) - 1}[fault]


def test_stream_length_is_checked_at_call_time():
    cfg, loop, queued = _loop_and_queue(TORCH)
    stream = loop.encoder.encode_stream(queued, node_of=loop._peer_node)
    state = loop.encoder.snapshot()
    with pytest.raises(ValueError, match="multiple"):
        treplay.replay_stream_pipelined(state, stream.slice(0, 17), cfg)
    with pytest.raises(ValueError, match="multiple"):
        treplay.replay_stream_pipelined_feed(state, iter(()), 17, cfg)


def test_closing_the_drain_early_stops_the_worker():
    cfg, loop, queued = _loop_and_queue(TORCH)
    gen, _ = _port_feed(cfg, loop, queued, cfg.max_pods, dispatch_window=2)
    before = {t.name for t in threading.enumerate()}
    assert "replay-chunks" in before
    next(gen)
    gen.close()
    assert "replay-chunks" not in {t.name for t in threading.enumerate()}


def _density(pkg, mode: str, monkeypatch, overlap: str = "0") -> dict:
    """``run_density`` at the workload's shapes; its bindings come from
    the measured cluster (the first one ``run_density`` builds)."""
    monkeypatch.setenv("BENCH_ENCODE_OVERLAP", overlap)
    mod = jdensity if pkg is JAX else tdensity
    clusters = []
    build = mod.build_fake_cluster

    def capture(spec):
        out = build(spec)
        clusters.append(out[0])
        return out

    monkeypatch.setattr(mod, "build_fake_cluster", capture)
    res = mod.run_density(num_nodes=NODES, num_pods=PODS,
                          batch_size=CFG["max_pods"], mode=mode,
                          chunk_batches=CHUNK_BATCHES, seed=9,
                          cfg=pkg.cfg(**CFG), **pkg.kw)
    return {"bindings": {b.pod_name: b.node_name
                         for b in clusters[0].bindings},
            "bound": res.pods_bound, "unschedulable": res.pods_unschedulable,
            "rounds": (res.rounds_p50, res.rounds_p99, res.rounds_max),
            "overlap": getattr(res, "encode_overlap", None)}


@pytest.fixture(scope="module")
def jax_density(jax_feed):
    """The JAX pipeline run, encoding on a producer thread so that it
    reuses the feed replay's compiled chunk program."""
    with pytest.MonkeyPatch.context() as mp:
        return _density(JAX, "pipeline", mp, overlap="1")


@pytest.mark.parametrize("mode,overlap", [("device", "0"),
                                          ("pipeline", "0"),
                                          ("pipeline", "1")])
def test_run_density_device_modes_match_jax(jax_density, monkeypatch, mode,
                                            overlap):
    got = _density(TORCH, mode, monkeypatch, overlap)
    want = jax_density
    assert got["bindings"] == want["bindings"]
    assert (got["bound"], got["unschedulable"]) == (want["bound"],
                                                    want["unschedulable"])
    assert got["bound"] + got["unschedulable"] == PODS
    assert got["rounds"] == want["rounds"]
    assert got["overlap"] == (mode == "pipeline" and overlap == "1")


def test_run_density_host_binds_what_device_binds(monkeypatch):
    host = _density(TORCH, "host", monkeypatch)
    device = _density(TORCH, "device", monkeypatch)
    assert host["bindings"] == device["bindings"]
    assert (host["bound"], host["unschedulable"]) == (device["bound"],
                                                      device["unschedulable"])


def test_failed_pipeline_drain_raises_and_stops_its_threads(monkeypatch):
    """A chunk that fails mid-drain fails ``run_density``: the binder and
    the encode producer (which may be blocked on its full queue) stop,
    and the error reaches the caller."""
    def failing_feed(state, chunks, s_total, cfg, method):
        next(iter(chunks))
        raise RuntimeError("chunk failed")
        yield  # a generator, as the real feed

    monkeypatch.setattr(tdensity, "replay_stream_pipelined_feed",
                        failing_feed)
    monkeypatch.setenv("BENCH_ENCODE_OVERLAP", "1")
    out = {}

    def run():
        try:
            tdensity.run_density(num_nodes=NODES, num_pods=PODS,
                                 batch_size=CFG["max_pods"], mode="pipeline",
                                 chunk_batches=1, seed=9, warmup=False,
                                 cfg=TCfg(**CFG), device="cpu")
        except RuntimeError as exc:
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert "chunk failed" in str(out["error"])
    names = {th.name for th in threading.enumerate()}
    assert not names & {"density-bind", "density-encode"}
