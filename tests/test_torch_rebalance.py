"""The port's continuous rebalancer against the JAX package's, on the
CPU.

``_scan`` (one batched torch expression in the port, a vmapped jit in
JAX) gives identical targets and ``mine``/``best`` within
rtol=atol=1e-4 on seeded inputs.  On ``tests/test_rebalance.py``'s
shapes (24 nodes, ``max_nodes=32``, ``max_pods=16``, a 32-pod backlog)
both loops then give the same placements, ``used`` (1e-6) and summary
counters: the disabled and zero-budget ticks are no-ops, the link and
drain triggers move the same pods, the eviction budget and the
per-cycle cap hold alike.  A crash mid-move restores fully reverted
through a checkpoint, the chaos drill leaves no half-moved gang, the
``summary()`` key set is JAX's, ``evaluate_reshape`` gives JAX's plans
and a gang reshaped after a node loss binds whole.  A fault of the
device scan propagates out of ``maintain()``; an API error mid-tick does
not.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import checkpoint as jck
from kubernetesnetawarescheduler_tpu.core import gang as jgang
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.core import rebalance as jrb
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import checkpoint as tck
from kubernetesnetawarescheduler_tpu_torch.core import gang as tgang
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.core import rebalance as trb
from kubernetesnetawarescheduler_tpu_torch.core import state_chaos as tsc
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes
from kubernetesnetawarescheduler_tpu_torch.k8s.kubeclient import (
    ApiServerError,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(cfg=JCfg, fc=jfc, ck=jck, gang=jgang, rb=jrb,
                            types=jtypes, loop=jloop.SchedulerLoop,
                            kw={})
TORCH = types.SimpleNamespace(cfg=TCfg, fc=tfc, ck=tck, gang=tgang, rb=trb,
                              types=ttypes,
                              loop=tloop.SchedulerLoop,
                              kw={"device": "cpu"})

AGGRESSIVE = dict(
    enable_rebalance=True,
    rebalance_interval_s=1e-4,
    rebalance_min_gain=0.02,
    rebalance_min_age_s=0.0,
    rebalance_cooldown_s=0.0,
    rebalance_max_moves_per_cycle=8,
    rebalance_evictions_per_hour=1000.0,
)


def make_loop(pkg, num_nodes=24, seed=3, **cfg_overrides):
    cfg = pkg.cfg(max_nodes=32, max_pods=16, max_peers=4)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=num_nodes, seed=seed))
    loop = pkg.loop(cluster, cfg, method="parallel", **pkg.kw)
    _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(0))
    return cluster, loop


def drain(loop, cluster, pods, batch=16):
    for start in range(0, len(pods), batch):
        cluster.add_pods(pods[start:start + batch])
        loop.run_once()
    loop.run_until_drained()
    loop.flush_binds()


def placements(cluster) -> dict[str, str]:
    out: dict[str, str] = {}
    for b in cluster.bindings:
        out[b.pod_name] = b.node_name
    return out


def workload(pkg, num_pods=32, seed=21, peer_fraction=0.7):
    return pkg.fc.generate_workload(pkg.fc.WorkloadSpec(
        num_pods=num_pods, seed=seed, services=6,
        peer_fraction=peer_fraction))


def tick(loop, n=1):
    rb = loop.rebalance
    moved = 0
    for _ in range(n):
        rb._last_tick = 0.0
        moved += rb.tick(loop)
        loop.run_until_drained()
        loop.flush_binds()
    return moved


def degrade_node(enc, node_name, factor=100.0):
    with enc._lock:
        lat = np.array(enc._lat, dtype=np.float64)
        bw = np.array(enc._bw, dtype=np.float64)
    idx = enc.node_slot(node_name)
    lat[idx, :] *= factor
    lat[:, idx] *= factor
    bw[idx, :] /= factor
    bw[:, idx] /= factor
    np.fill_diagonal(lat, 0.0)
    enc.set_network(lat, bw)
    return idx


def summary(loop) -> dict:
    return loop.rebalance.summary()


# ---------------------------------------------------------------------------
# The scan.
# ---------------------------------------------------------------------------


def _scan_inputs(seed: int, n: int = 40, b: int = 24, k: int = 4,
                 r: int = 3):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.1, 5.0, (n, n)).astype(np.float32)
    lat = (lat + lat.T) / 2
    np.fill_diagonal(lat, 0.0)
    bw = rng.uniform(1e9, 1e10, (n, n)).astype(np.float32)
    valid = rng.random(n) < 0.9
    free = rng.uniform(0, 4, (n, r)).astype(np.float32)
    chosen = rng.integers(0, n, b).astype(np.int32)
    peers = rng.integers(-1, n, (b, k)).astype(np.int32)
    # Rows with no peers at all: a flat cost and the lowest-index tie.
    peers[:3] = -1
    traffic = rng.uniform(0.5, 9.0, (b, k)).astype(np.float32)
    req = rng.uniform(0, 3, (b, r)).astype(np.float32)
    req[-2:] = 100.0   # fits nowhere but its own node
    return lat, bw, valid, free, chosen, peers, traffic, req


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scan_matches_jax(seed):
    import jax
    import jax.numpy as jnp

    args = _scan_inputs(seed)
    w = JCfg().weights
    jm, jb, jt = (np.asarray(x) for x in jax.jit(jrb._scan)(
        *(jnp.asarray(a) for a in args), jnp.float32(w.peer_bw),
        jnp.float32(w.peer_lat)))
    tm, tb, tt = trb._scan(*(torch.from_numpy(a) for a in args),
                           w.peer_bw, w.peer_lat)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Ticks on one loop per package.
# ---------------------------------------------------------------------------


def test_disabled_and_zero_budget_are_bitwise_noops():
    def run(pkg, mode):
        cluster, loop = (make_loop(pkg) if mode == "off" else make_loop(
            pkg, enable_rebalance=True, rebalance_interval_s=1e-4,
            rebalance_min_age_s=0.0, rebalance_cooldown_s=0.0,
            rebalance_max_moves_per_cycle=0))
        if mode == "off":
            assert loop.rebalance is None
        drain(loop, cluster, workload(pkg))
        if mode == "budget0":
            assert tick(loop, n=3) == 0
            s = summary(loop)
            assert s["scans_total"] == 0 and s["moves_total"] == 0
            if pkg is TORCH:
                assert loop.rebalance.last_scan_ms == {}
        return placements(cluster), np.array(loop.encoder._used)

    off, used_off = run(TORCH, "off")
    b0, used_b0 = run(TORCH, "budget0")
    ref, used_ref = run(JAX, "budget0")
    assert off == b0 == ref
    assert np.array_equal(used_off, used_b0)
    np.testing.assert_allclose(used_b0, used_ref, rtol=1e-6, atol=1e-6)


def _link_drive(pkg):
    cluster, loop = make_loop(pkg, enable_rebalance=True,
                              rebalance_interval_s=1e-4)
    pods = workload(pkg)
    drain(loop, cluster, pods)
    before = placements(cluster)
    hot = next(
        before[p.name] for p in pods
        if p.name in before and any(
            before.get(peer) and before[peer] != before[p.name]
            for peer in p.peers))
    degrade_node(loop.encoder, hot)
    loop.rebalance.note_link_event(hot, "", "degraded", streak=3)
    moved = tick(loop, n=2)
    return (moved, hot, before, placements(cluster), summary(loop),
            np.array(loop.encoder._used))


def test_link_trigger_matches_jax():
    got, want = _link_drive(TORCH), _link_drive(JAX)
    assert got[:5] == want[:5]
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6, atol=1e-6)
    moved, hot, before, after, s, _ = got
    assert moved >= 1 and s["triggers_link"] >= 1
    for name, node in before.items():
        if after.get(name) != node:
            assert node == hot
    assert s["half_moved_gangs"] == 0


def _drain_drive(pkg):
    cluster, loop = make_loop(pkg, enable_rebalance=True,
                              rebalance_interval_s=1e-4)
    pods = workload(pkg)
    drain(loop, cluster, pods)
    before = placements(cluster)
    victim = next(before[p.name] for p in pods
                  if p.peers and p.name in before)
    enc = loop.encoder
    with enc._lock:
        enc._node_valid[enc.node_slot(victim)] = False
    tick(loop, n=1)
    return placements(cluster), summary(loop)


def test_drain_trigger_matches_jax():
    got = _drain_drive(TORCH)
    assert got == _drain_drive(JAX)
    assert got[1]["triggers_drain"] >= 1


@pytest.mark.parametrize("knobs", [
    dict(rebalance_evictions_per_hour=2.0),
    dict(rebalance_max_moves_per_cycle=1),
])
def test_budget_and_cycle_cap_match_jax(knobs):
    def run(pkg):
        cluster, loop = make_loop(pkg, **dict(AGGRESSIVE, **knobs))
        drain(loop, cluster, workload(pkg))
        rb = loop.rebalance
        moves = []
        for _ in range(3):
            rb._last_tick = 0.0
            moves.append(rb.tick(loop))
            loop.run_until_drained()
            loop.flush_binds()
        return moves, placements(cluster), summary(loop)

    got = run(TORCH)
    assert got == run(JAX)
    moves, _, s = got
    if "rebalance_evictions_per_hour" in knobs:
        assert s["pods_evicted_total"] <= 2 and s["skipped_budget"] >= 1
    else:
        assert max(moves) <= 1 and sum(moves) >= 1


def test_crash_mid_single_move_restores_fully_reverted(tmp_path):
    cluster, loop = make_loop(TORCH, **AGGRESSIVE)
    drain(loop, cluster, workload(TORCH))
    enc = loop.encoder
    rb = loop.rebalance
    rb._last_tick = 0.0
    assert rb.tick(loop) >= 1          # evict + pin staged, NO pump
    assert set(rb.last_scan_ms) == {"upload", "device", "host"}
    staged = enc.migrations_inflight()
    assert staged
    moved_uids = [e[0] for entries in staged.values() for e in entries]
    assert any(uid in enc._committed for uid in moved_uids)
    for mv in rb._inflight.values():
        assert mv.gain > 0.0
    ck = str(tmp_path / "ck")
    tck.save_checkpoint(ck, enc)       # ...and the process dies here.
    for load in (tck.load_checkpoint, jck.load_checkpoint):
        enc2 = (load(ck, device="cpu") if load is tck.load_checkpoint
                else load(ck))
        assert enc2._inflight_migrations == {}
        for uid in moved_uids:
            assert uid not in enc2._committed


def _gang_pods(pkg, group, n, cpu=33.0):
    names = [f"{group}-w{i}" for i in range(n)]
    return [pkg.types.Pod(
        name=names[i], requests={"cpu": cpu, "mem": 1.0},
        peers={other: 5.0 for other in names if other != names[i]},
        pod_group=group, gang_min_member=n, priority=5.0)
        for i in range(n)]


def test_chaos_drill_no_half_moved_gangs(tmp_path):
    """``tests/test_rebalance.py``'s drill on the port: checkpoint chaos
    + a crash mid-move (one gang moving through the real path, one
    hand-staged mid-eviction) restores every gang fully placed or fully
    pending, never split."""
    cluster, loop = make_loop(TORCH, enable_rebalance=True,
                              rebalance_interval_s=1e-4)
    gangs = {f"g{i}": _gang_pods(TORCH, f"g{i}", 3) for i in range(2)}
    drain(loop, cluster, [p for ps in gangs.values() for p in ps], batch=3)
    enc = loop.encoder
    ck = str(tmp_path / "ck")
    tck.save_checkpoint(ck, enc)
    before = placements(cluster)
    hot = before["g0-w0"]
    degrade_node(enc, hot)
    loop.rebalance.note_link_event(hot, "", "quarantine", streak=5)
    loop.rebalance._last_tick = 0.0
    assert loop.rebalance.tick(loop) >= 1
    staged = enc.migrations_inflight()
    # The gang stages all its members as one move.
    assert [sorted(e[2] for e in entries) for entries in staged.values()
            ] == [["g0-w0", "g0-w1", "g0-w2"]]
    g1 = gangs["g1"]
    enc.note_migration_inflight(
        "mv-crash", [[p.uid, p.namespace, p.name, before[p.name], ""]
                     for p in g1])
    cluster.delete_pod(g1[0].name, g1[0].namespace)
    tck.save_checkpoint(ck, enc)       # mid-move set; clean rotated
    enc2 = tck.load_checkpoint(ck, device="cpu")
    assert enc2._inflight_migrations == {}
    by_gang: dict[str, int] = {}
    for rec in enc2._committed.values():
        if rec.gang_key:
            by_gang[rec.gang_key] = by_gang.get(rec.gang_key, 0) + 1
    assert all(n == 3 for n in by_gang.values())
    assert not any("g0" in gk or "g1" in gk for gk in by_gang)
    tsc.StateChaosInjector(enc, seed=7, checkpoint_dir=ck).inject(
        "checkpoint_corrupt")
    enc3 = tck.load_checkpoint(ck, device="cpu")
    assert enc3._inflight_migrations == {}
    counts: dict[str, int] = {}
    for rec in enc3._committed.values():
        if rec.gang_key:
            counts[rec.gang_key] = counts.get(rec.gang_key, 0) + 1
    assert counts and all(n == 3 for n in counts.values())
    assert loop.rebalance.half_moved_gangs == 0


def test_summary_key_set_matches_jax():
    _, tl = make_loop(TORCH, enable_rebalance=True)
    _, jl = make_loop(JAX, enable_rebalance=True)
    ts, js = tl.rebalance.summary(), jl.rebalance.summary()
    assert set(ts) == set(js)
    assert set(ts["reshape"]) == set(js["reshape"])
    assert ts == js


# ---------------------------------------------------------------------------
# Gang reshaping.
# ---------------------------------------------------------------------------


def _shaped_pods(pkg, group, n, shapes, cpu=0.25, spread=False):
    fam = pkg.gang.parse_gang_shapes(shapes)
    kw = ({"group": group, "anti_groups": frozenset({group})}
          if spread else {})
    return [pkg.types.Pod(name=f"{group}-w{i}",
                          requests={"cpu": cpu, "mem": 0.25},
                          pod_group=group, gang_min_member=n,
                          gang_shapes=fam, **kw)
            for i in range(n)]


def _cordon(cluster, node_name):
    node = next(n for n in cluster.list_nodes() if n.name == node_name)
    cluster.add_node(dataclasses.replace(node, unschedulable=True))


def _reshape_rb(pkg, loop, **kw):
    cfg = dataclasses.replace(
        loop.cfg, enable_rebalance=True, enable_gang_reshaping=True,
        rebalance_interval_s=1e-4, rebalance_max_moves_per_cycle=0,
        rebalance_evictions_per_hour=1000.0,
        rebalance_move_timeout_s=60.0, **kw)
    rb = pkg.rb.Rebalancer(cfg, loop.encoder, loop.client)
    loop.rebalance = rb
    return rb


@pytest.mark.parametrize("spread,min_gain", [(True, 0.0), (False, 0.05)])
def test_evaluate_reshape_plans_match_jax(spread, min_gain):
    plans = {}
    for pkg in (JAX, TORCH):
        cluster, loop = make_loop(pkg, enable_gang_reshaping=True)
        pods = _shaped_pods(pkg, "slice-e", 4, "4,2:0.5", spread=spread)
        cluster.add_pods(pods)
        assert loop.run_until_drained() == 4
        rb = _reshape_rb(pkg, loop, reshape_min_gain=min_gain)
        if spread:
            _cordon(cluster, cluster.node_of(pods[0].name))
        units = rb._gang_units(loop)
        assert "default/slice-e" in units
        plans[pkg is TORCH] = rb.evaluate_reshape(
            loop, "default/slice-e", units["default/slice-e"],
            time.monotonic())
    got, want = plans[True], plans[False]
    if not spread:
        assert got is None and want is None
        return
    assert got is not None and want is not None
    for key in ("gang_key", "new_count", "old_count", "declared",
                "family", "kind"):
        assert got[key] == want[key], key
    assert got["new_key"] > got["cur_key"]
    for a, b in ((got["gain"], want["gain"]),
                 (got["new_key"][2], want["new_key"][2]),
                 (got["cur_key"][2], want["cur_key"][2])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert got["new_key"][:2] == want["new_key"][:2]
    assert got["cur_key"][:2] == want["cur_key"][:2]


def test_reshape_recovers_gang_after_node_loss():
    got = {}
    for pkg in (JAX, TORCH):
        cluster, loop = make_loop(pkg, enable_gang_reshaping=True)
        pods = _shaped_pods(pkg, "slice-z", 4, "4,2:0.5", spread=True)
        cluster.add_pods(pods)
        assert loop.run_until_drained() == 4
        rb = _reshape_rb(pkg, loop)
        dead = cluster.node_of(pods[0].name)
        _cordon(cluster, dead)
        for _ in range(4):
            rb._last_tick = 0.0
            rb.tick(loop)
            loop.run_until_drained()
            loop.flush_binds()
            if rb.reshapes_completed and not rb._inflight_reshapes:
                break
        placed = {}
        for p in pods:
            node = cluster.node_of(p.name)
            if node:
                placed[p.name] = node
        assert dead not in placed.values()
        real = loop.encoder.gang_realizations().get("default/slice-z")
        got[pkg is TORCH] = (placed, rb.summary()["reshape"], real)
    assert got[True] == got[False]
    placed, resh, real = got[True]
    assert resh["reshapes_total"] >= 1 and resh["half_shaped_gangs"] == 0
    assert len(placed) in {2, 4} and real[0] == len(placed)


# ---------------------------------------------------------------------------
# Errors on the maintain path.
# ---------------------------------------------------------------------------


def test_device_fault_in_tick_propagates_api_error_does_not(monkeypatch):
    cluster, loop = make_loop(TORCH, **AGGRESSIVE)
    drain(loop, cluster, workload(TORCH))
    rb = loop.rebalance

    def api_down():
        raise ApiServerError("injected 503 on list all pods", status=503)

    monkeypatch.setattr(cluster, "list_all_pods", api_down)
    rb._last_tick = 0.0
    loop.maintain()                    # swallowed, retried next tick
    assert rb.scans_total == 0
    monkeypatch.undo()

    def cuda_fault(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(trb, "_scan", cuda_fault)
    rb._last_tick = 0.0
    with pytest.raises(RuntimeError, match="CUDA error"):
        loop.maintain()
    assert rb.scans_total == 1


def test_spans_carry_rebalance_deltas():
    cluster, loop = make_loop(TORCH, **AGGRESSIVE)
    drain(loop, cluster, workload(TORCH))
    rb = loop.rebalance
    rb._last_tick = 0.0
    moved = rb.tick(loop)
    assert moved >= 1
    loop.run_until_drained()
    spans = [s for s in loop.flight.spans()
             if s.rebalance_moves]
    assert sum(s.rebalance_moves for s in spans) == rb.moves_total
