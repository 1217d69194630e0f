"""The port's quality observer and SLO engine against the JAX package's,
on the CPU, on ``tests/test_quality.py``'s shapes (24 nodes,
``max_nodes=32``, ``max_pods=16``, ``max_peers=4``).

The same seeded cluster and backlog drain through both packages' loops
with the observer attached; ``harvest`` then gives the same outcomes
(float fields at rtol 1e-5; ``peer_samples``, the counters, the stale
drops and the ring identical), before and after the staging planes
drift.  ``_evaluate`` (one batched torch expression in the port, a
vmapped jit in JAX) agrees on seeded inputs.  The SLO engine's burn
states, events and snapshots are identical on a scripted series, and the
burn-rate math equals the JAX functions'.  Observation moves no binding:
a drive with quality and SLO on and off binds alike in both packages.
Records are keyed by ``namespace/name`` (pod uids come from each
process-wide counter).
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.obs import quality as jq
from kubernetesnetawarescheduler_tpu.obs import slo as jslo
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.obs import quality as tq
from kubernetesnetawarescheduler_tpu_torch.obs import slo as tslo

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(cfg=JCfg, fc=jfc, q=jq, slo=jslo,
                            loop=jloop.SchedulerLoop, kw={})
TORCH = types.SimpleNamespace(cfg=TCfg, fc=tfc, q=tq, slo=tslo,
                              loop=tloop.SchedulerLoop,
                              kw={"device": "cpu"})

# The one JAX static config of this file.
CFG = dict(max_nodes=32, max_pods=16, max_peers=4)
FLOAT_KEYS = ("realized_lat_ms", "realized_bw_bps", "net_score",
              "best_net_score", "regret", "bw_residual_log1p",
              "lat_residual_ms")
COUNTERS = ("noted_total", "no_peer_total", "pending_dropped",
            "ring_evicted", "harvested_total", "calibration_samples",
            "stale_dropped", "pending", "ring_depth")


def _loop(pkg, observe=False, slo=False, ring=2048, seed=3):
    cfg = pkg.cfg(**CFG, quality_ring_size=ring)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=24, seed=seed))
    loop = pkg.loop(cluster, cfg, **pkg.kw)
    _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(0))
    # Attached, not switched on in cfg: one JAX config (one compile)
    # serves every drive of the file.
    if observe:
        loop.quality = pkg.q.QualityObserver(cfg)
    if slo:
        loop.slo = pkg.slo.SLOEngine(dataclasses.replace(
            cfg, slo_eval_interval_s=1e-6))
    return cluster, loop


def _workload(pkg, num_pods=48, seed=21, peer_fraction=0.6):
    return pkg.fc.generate_workload(pkg.fc.WorkloadSpec(
        num_pods=num_pods, seed=seed, services=6,
        peer_fraction=peer_fraction))


def _drain(loop, cluster, pods, batch=16):
    for start in range(0, len(pods), batch):
        cluster.add_pods(pods[start:start + batch])
        loop.run_once()
    loop.run_until_drained()
    loop.flush_binds()
    return sorted((b.namespace, b.pod_name, b.node_name)
                  for b in cluster.bindings)


def _by_name(obs, pods) -> dict:
    names = {p.uid: f"{p.namespace}/{p.name}" for p in pods}
    return {names[o["pod_uid"]]: o for o in obs.outcomes()}


def _counters(obs) -> dict:
    s = obs.summary()
    return {k: s[k] for k in COUNTERS}


def _assert_outcomes(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and got
    for name, w in want.items():
        g = got[name]
        assert g["node"] == w["node"] and g["score_pred"] == w["score_pred"]
        assert g["peer_samples"] == w["peer_samples"], name
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")


def _harvest_drive(pkg):
    cluster, loop = _loop(pkg, observe=True)
    pods = _workload(pkg)
    binds = _drain(loop, cluster, pods)
    obs, enc = loop.quality, loop.encoder
    first_n = obs.harvest(enc)
    clean = _by_name(obs, pods)
    # Re-note the same placements, let the probes "learn" the links are
    # 2x slower, harvest again: the residuals wake.
    obs.note_commit(loop, pods)
    with enc._lock:
        lat0 = np.array(enc._lat[:24, :24])
        bw0 = np.array(enc._bw[:24, :24])
    enc.set_network(lat0 * 2.0, bw0 / 2.0)
    second_n = obs.harvest(enc)
    return (binds, first_n, second_n, clean, _by_name(obs, pods),
            _counters(obs))


def test_harvest_outcomes_match_jax_clean_and_under_drift():
    j, t = _harvest_drive(JAX), _harvest_drive(TORCH)
    assert t[0] == j[0]
    assert (t[1], t[2]) == (j[1], j[2]) and t[1] > 0
    _assert_outcomes(t[3], j[3])
    _assert_outcomes(t[4], j[4])
    assert t[5] == j[5]
    assert all(o["bw_residual_log1p"] == 0.0 for o in t[3].values())
    assert any(o["bw_residual_log1p"] > 0.0 for o in t[4].values())


def test_evaluate_matches_jax_on_seeded_inputs():
    rng = np.random.default_rng(4)
    n, b, k = 32, 19, 4
    lat = rng.uniform(0.05, 3.0, (n, n)).astype(np.float32)
    bw = rng.uniform(1e9, 4e10, (n, n)).astype(np.float32)
    valid = rng.random(n) > 0.15
    chosen = rng.integers(0, n, b).astype(np.int32)
    peers = np.where(rng.random((b, k)) > 0.3,
                     rng.integers(0, n, (b, k)), -1).astype(np.int32)
    traffic = rng.uniform(0.1, 3.0, (b, k)).astype(np.float32)
    pred_lat = rng.uniform(0.05, 3.0, (b, k)).astype(np.float32)
    pred_bw = rng.uniform(1e9, 4e10, (b, k)).astype(np.float32)
    args = (lat, bw, valid, chosen, peers, traffic, pred_lat, pred_bw)
    import jax

    want = [np.asarray(x) for x in jax.jit(jq._evaluate)(
        *args, np.float32(2.0), np.float32(1.0))]
    got = [x.numpy() for x in tq._evaluate(
        *(torch.from_numpy(a) for a in args), 2.0, 1.0)]
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got[-1], want[-1])


def test_pending_and_ring_bounds_match_jax():
    outs = []
    for pkg in (JAX, TORCH):
        cluster, loop = _loop(pkg, observe=True, ring=4)
        pods = _workload(pkg, peer_fraction=0.9)
        _drain(loop, cluster, pods)
        before = _counters(loop.quality)
        loop.quality.harvest(loop.encoder)
        outs.append((before, _counters(loop.quality),
                     sorted(_by_name(loop.quality, pods))))
    assert outs[0] == outs[1]
    assert outs[1][0]["pending_dropped"] > 0
    assert outs[1][1]["ring_depth"] <= 4


def test_stale_and_vanished_bindings_dropped_alike():
    outs = []
    for pkg in (JAX, TORCH):
        cluster, loop = _loop(pkg, observe=True)
        pods = _workload(pkg, num_pods=12)
        _drain(loop, cluster, pods)
        obs, enc = loop.quality, loop.encoder
        pend = list(obs._pending)
        assert len(pend) >= 2
        for uid in pend:
            assert obs._pending[uid].bind_stamp == enc._committed[uid].stamp
        with enc._lock:
            rec = enc._committed[pend[0]]
            enc._committed[pend[0]] = rec._replace(stamp=rec.stamp + 1e3)
            del enc._committed[pend[1]]
        outs.append((obs.harvest(enc), obs.stale_dropped,
                     obs.outcome(pend[0]), obs.outcome(pend[1]),
                     len(pend)))
    assert outs[0] == outs[1]
    assert outs[1][1] == 2 and outs[1][0] == outs[1][4] - 2


def test_quality_summary_and_empty_harvest():
    _, loop = _loop(TORCH)
    obs = tq.QualityObserver(loop.cfg)
    assert obs.harvest(loop.encoder) == 0
    assert set(obs.summary()) == set(jq.QualityObserver(
        JCfg(**CFG)).summary())


def test_observation_moves_no_binding_in_either_package():
    """Quality and SLO on or off: identical bindings, and the two
    packages bind alike."""
    drives = {}
    for pkg in (JAX, TORCH):
        for on in (False, True):
            cluster, loop = _loop(pkg, observe=on, slo=on, seed=5)
            binds = _drain(loop, cluster, _workload(pkg, seed=23))
            if on:
                loop.maintain()
                assert loop.quality.harvested_total > 0
                assert loop.slo.evaluations_total > 0
            drives[(pkg is TORCH, on)] = binds
    assert len(set(map(tuple, drives.values()))) == 1


# -- the SLO engine on a scripted series ------------------------------


class _Timer:
    def __init__(self):
        self.p99 = {}

    def count(self, phase):
        return 1 if phase in self.p99 else 0

    def percentile(self, phase, q):
        return self.p99[phase]


class _Hist:
    def __init__(self):
        self.v = 0.0

    def percentile(self, q):
        return self.v


class _Client:
    def __init__(self):
        self.events = []

    def create_event(self, ev):
        self.events.append((ev.reason, ev.message, ev.type,
                            ev.component))


def _scripted(pkg):
    cfg = pkg.cfg(**CFG, slo_fast_window_s=30.0, slo_slow_window_s=120.0,
                  slo_error_budget=0.1)
    eng = pkg.slo.SLOEngine(cfg)
    loop = types.SimpleNamespace(
        timer=_Timer(),
        quality=types.SimpleNamespace(harvested_total=0,
                                      regret_hist=_Hist()),
        integrity=types.SimpleNamespace(unrepaired_total=0),
        client=_Client())
    trail = []
    rng = np.random.default_rng(11)
    for step in range(90):
        now = 1000.0 + 5.0 * step
        loop.timer.p99["score_assign"] = float(
            rng.uniform(1e-3, 4e-3) if step < 30 or step > 60
            else rng.uniform(6e-3, 9e-3))
        if step % 3 == 0:
            loop.timer.p99["bind_net"] = float(rng.uniform(0.1, 2.0))
        if step >= 20:
            loop.quality.harvested_total = step
            loop.quality.regret_hist.v = float(rng.uniform(0.0, 0.8))
        if step == 70:
            loop.integrity.unrepaired_total = 1
        trail.append((sorted(eng.evaluate(loop, now=now)),
                      eng.burning()))
    snap = eng.snapshot(now=1000.0 + 5.0 * 90)
    return trail, loop.client.events, snap, (eng.evaluations_total,
                                            eng.burn_events_total)


def test_slo_burn_states_and_events_match_jax():
    j, t = _scripted(JAX), _scripted(TORCH)
    assert t[0] == j[0]
    assert t[1] == j[1] and t[1]
    assert t[2] == j[2]
    assert t[3] == j[3]
    assert any(b for b, _ in t[0])


@pytest.mark.parametrize("case", ["edges", "empty", "burn", "and"])
def test_burn_rate_math_matches_jax(case):
    now = 100.0
    if case == "edges":
        samples = [(90.0, True), (90.1, True), (100.0, False),
                   (100.1, True)]
        assert (tslo.breach_fraction(samples, now, 10.0)
                == jslo.breach_fraction(samples, now, 10.0) == (0.5, 2))
    elif case == "empty":
        for samples in ([], [(1.0, True)]):
            assert (tslo.breach_fraction(samples, now, 10.0)
                    == jslo.breach_fraction(samples, now, 10.0)
                    == (0.0, 0))
    elif case == "burn":
        samples = [(99.0, True), (98.0, False), (97.0, False),
                   (96.0, False)]
        for s, budget in ((samples, 0.05), ([], 0.05),
                          ([(99.0, False)], 0.0)):
            assert (tslo.burn_rate(s, now, 10.0, budget)
                    == jslo.burn_rate(s, now, 10.0, budget))
        assert tslo.burn_rate(samples, now, 10.0, 0.05) == 5.0
        assert math.isinf(tslo.burn_rate([(99.0, True)], now, 10.0, 0.0))
    else:
        for fast, slow in ((2.0, 1.5), (2.0, 0.5), (0.5, 2.0), (1.0, 1.0)):
            assert (tslo.is_burning(fast, slow, 1.0)
                    == jslo.is_burning(fast, slow, 1.0))


def test_quality_prediction_reads_raw_staging():
    """With a topology model blending the net planes, ``note_commit``
    records the raw staging values, not the blended planes the scorer
    read, in both packages (ROADMAP Queue C item 6: a reference fault
    kept so the packages compare)."""
    from kubernetesnetawarescheduler_tpu.netmodel import (
        TopologyModel as JModel,
    )
    from kubernetesnetawarescheduler_tpu_torch.netmodel import (
        TopologyModel as TModel,
    )

    outs = []
    for pkg, make in ((JAX, lambda c: JModel(c, seed=1)),
                      (TORCH, lambda c: TModel(c, seed=1, device="cpu"))):
        cluster, loop = _loop(pkg, observe=True)
        enc = loop.encoder
        model = make(pkg.cfg(**CFG, enable_netmodel=True,
                             netmodel_ring=4096, netmodel_batch=128))
        rng = np.random.default_rng(2)
        for k in range(60):
            i, j = (int(x) for x in rng.integers(0, 24, 2))
            model.observe(i, j, float(enc._lat[i, j]),
                          float(enc._bw[i, j]), float(k))
        model.fit(8)
        enc.attach_netmodel(model)
        _drain(loop, cluster, _workload(pkg, num_pods=16))
        snap_bw = np.asarray(enc.snapshot().bw)
        raw = blended = 0
        for e in loop.quality._pending.values():
            for p, pred in zip(e.peer_idx, e.pred_bw_bps):
                assert pred == float(enc._bw[e.node_idx, p])
                raw += 1
                blended += pred != float(snap_bw[e.node_idx, p])
        outs.append((raw, blended))
    assert outs[0][0] == outs[1][0] > 0
    assert outs[0][1] > 0 and outs[1][1] > 0
