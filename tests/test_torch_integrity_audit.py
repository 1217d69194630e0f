"""The port's anti-entropy auditor, repair ladder and state-fault
injector against the JAX package's, on the CPU.

Both packages build the same encoder (``tests/test_integrity.py``'s
shape: 12 nodes, ``max_nodes=16``) from one numpy seed.  Per seed, each
runtime fault class gives the same descriptor, the same device plane
bits after injection, the same detection and the same repair rung; the
fault matrix, ``compare_row_digests`` and ``staging_sanity`` give the
same lists; staging poison escalates to the checkpoint rung; unrepairable
drift fires the watchdog dump; the counters accumulate alike.  Then the
port on its own terms: a snapshot taken before an injection keeps its
bits (the injector writes out of place), a clean drive places the same
pods with and without the auditor (and as the JAX loop does), a corrupt
checkpoint is refused across packages, and a fault of the device
propagates out of the audit instead of escalating the ladder.
Digests, bits and lists are compared exactly.
"""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import checkpoint as jck
from kubernetesnetawarescheduler_tpu.core import encode as jencode
from kubernetesnetawarescheduler_tpu.core import integrity as jint
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.core import state_chaos as jsc
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import checkpoint as tck
from kubernetesnetawarescheduler_tpu_torch.core import encode as tencode
from kubernetesnetawarescheduler_tpu_torch.core import integrity as tint
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.core import state_chaos as tsc
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(
    cfg=JCfg, fc=jfc, int=jint, sc=jsc, ck=jck, types=jtypes,
    encoder=lambda cfg: jencode.Encoder(cfg),
    loop=lambda *a, **k: jloop.SchedulerLoop(*a, **k))
TORCH = types.SimpleNamespace(
    cfg=TCfg, fc=tfc, int=tint, sc=tsc, ck=tck, types=ttypes,
    encoder=lambda cfg: tencode.Encoder(cfg, device="cpu"),
    loop=lambda *a, **k: tloop.SchedulerLoop(*a, device="cpu", **k))
RUNTIME = [k for k in tsc.STATE_FAULT_CLASSES if k != "checkpoint_corrupt"]
FLIP_SEEDS = (0, 1, 14, 63, 105, 151)
# One loop config for every loop drive of the file: the JAX package
# compiles it once.
LOOP_CFG = dict(max_nodes=32, max_pods=16, max_peers=4)


def make_encoder(pkg, n: int = 12, seed: int = 0):
    """``tests/test_integrity.py``'s encoder in either package."""
    enc = pkg.encoder(pkg.cfg(max_nodes=16, max_pods=8, max_peers=2))
    rng = np.random.default_rng(seed)
    for i in range(n):
        enc.upsert_node(pkg.types.Node(
            name=f"n{i}", capacity={"cpu": 8.0, "memory": 32.0},
            labels={"zone": f"z{i % 3}"}))
        enc.update_metrics(f"n{i}", {
            "cpu_util": float(rng.uniform(0, 1)),
            "net_bw_bps": float(rng.uniform(1e9, 1e11))})
    for i in range(n):
        for j in range(i + 1, n):
            enc.update_link(f"n{i}", f"n{j}",
                            lat_ms=float(rng.uniform(0.1, 5.0)),
                            bw_bps=float(rng.uniform(1e9, 1e10)))
    return enc


def make_loop(pkg, num_nodes: int = 24, seed: int = 3):
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=num_nodes, seed=seed))
    loop = pkg.loop(cluster, pkg.cfg(**LOOP_CFG))
    _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(0))
    return cluster, loop


def cache_bits(enc) -> dict[str, np.ndarray]:
    """Every device plane of the encoder's cache as raw u32 words (bool
    planes as 0/1)."""
    out = {}
    for name, arr in enc._cache.items():
        a = (arr.numpy() if isinstance(arr, torch.Tensor)
             else np.asarray(arr))
        out[name] = (a.astype(np.uint32) if a.dtype == np.bool_
                     else np.ascontiguousarray(a).view(np.uint32))
    return out


# ---------------------------------------------------------------------------
# Each fault class: descriptor, bits, detection, rung.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed", [
    *[(k, 11) for k in RUNTIME],
    # bit_flip over every flip plane, each with the sign bit too.
    *[("bit_flip", s) for s in FLIP_SEEDS],
])
def test_fault_class_matches_jax(kind, seed):
    out = {}
    for pkg in (JAX, TORCH):
        enc = make_encoder(pkg)
        auditor = pkg.int.IntegrityAuditor(enc)
        assert auditor.audit_once()["clean"]
        desc = pkg.sc.StateChaosInjector(enc, seed=seed).inject(kind)
        bits = cache_bits(enc)
        staging = {k: v.copy()
                   for k, v in enc.expected_device_arrays().items()}
        res = auditor.audit_once()
        out[pkg is TORCH] = (desc, bits, staging, res, auditor)
    (jd, jb, js, jr, ja), (td, tb, ts, tr, ta) = out[False], out[True]
    assert td == jd
    assert set(tb) == set(jb)
    for name in jb:
        np.testing.assert_array_equal(tb[name], jb[name], err_msg=name)
    for name in js:
        np.testing.assert_array_equal(
            np.ascontiguousarray(ts[name]).view(np.uint8),
            np.ascontiguousarray(js[name]).view(np.uint8), err_msg=name)
    assert not tr["clean"] and not jr["clean"]
    assert (tr["rung"], tr["repaired"]) == (jr["rung"], jr["repaired"])
    assert tr["repaired"]
    assert ta.last_drift == ja.last_drift
    assert ta.repairs == ja.repairs


def test_bit_flip_seeds_cover_every_flip_plane_and_the_sign_bit():
    seen = set()
    for s in FLIP_SEEDS:
        desc = tsc.StateChaosInjector(make_encoder(TORCH), seed=s).inject(
            "bit_flip")
        seen.add((desc["plane"], desc["bit"] == 31))
    assert seen == {(p, top) for p in ("cap", "group_bits", "node_zone")
                    for top in (False, True)}


def test_fault_matrix_matches_jax():
    got = {}
    for pkg in (JAX, TORCH):
        enc = make_encoder(pkg)
        auditor = pkg.int.IntegrityAuditor(enc)
        got[pkg is TORCH] = (pkg.sc.run_state_fault_matrix(
            enc, auditor, seed=11), dict(auditor.repairs),
            auditor.unrepaired_total)
    assert got[True] == got[False]
    matrix = got[True][0]
    assert sorted(matrix) == sorted(RUNTIME)
    for kind, result in matrix.items():
        assert (result["detected"], result["repaired"]) == (1, 1), kind


def test_random_injection_is_seed_deterministic_across_packages():
    for seed in range(6):
        descs = [pkg.sc.StateChaosInjector(make_encoder(pkg),
                                           seed=seed).inject_random()
                 for pkg in (JAX, TORCH)]
        assert descs[0] == descs[1]


def test_compare_and_sanity_lists_match_jax():
    rng = np.random.default_rng(5)
    dev, host, staging = {}, {}, {}
    for name in tint.PLANE_NAMES[:8]:
        d = rng.integers(0, 2 ** 32, 16, dtype=np.uint32)
        h = d.copy()
        h[rng.choice(16, int(rng.integers(0, 4)), replace=False)] ^= 1
        dev[name], host[name] = d, h
    for name in ("metrics", "lat", "cap", "node_numeric"):
        a = rng.uniform(0, 1, (16, 4)).astype(np.float32)
        a[rng.choice(16, 3, replace=False),
          rng.integers(0, 4)] = rng.choice([np.nan, np.inf, -np.inf])
        staging[name] = a
    assert (tint.compare_row_digests(dev, host)
            == jint.compare_row_digests(dev, host))
    assert tint.staging_sanity(staging) == jint.staging_sanity(staging)
    assert "node_numeric" not in tint.staging_sanity(staging)
    assert tint.REPAIR_RUNGS == jint.REPAIR_RUNGS
    assert tint._FINITE_PLANES == jint._FINITE_PLANES


# ---------------------------------------------------------------------------
# Ladder escalation, watchdog, counters.
# ---------------------------------------------------------------------------


def test_staging_poison_escalates_to_checkpoint_rung(tmp_path):
    """NaN in STAGING is invisible to the device-vs-staging compare
    (both sides agree on the poison): only the checkpoint rung heals."""
    got = {}
    for pkg in (JAX, TORCH):
        enc = make_encoder(pkg)
        ck = str(tmp_path / f"ck{pkg is TORCH}")
        pkg.ck.save_checkpoint(ck, enc)
        auditor = pkg.int.IntegrityAuditor(enc, checkpoint_dir=ck)
        enc._metrics[2, 0] = np.nan
        enc._mark_rows("metrics", 2)
        out = auditor.audit_once()
        assert np.isfinite(enc._metrics).all()
        assert auditor.audit_once()["clean"]
        got[pkg is TORCH] = (out["rung"], out["repaired"],
                             auditor.last_drift, dict(auditor.repairs))
    assert got[True] == got[False]
    assert got[True][0] == "checkpoint_restore"
    assert got[True][2]["staging:metrics"] == [2]


def test_unrepairable_drift_fires_watchdog_dump(tmp_path):
    got = {}
    for pkg in (JAX, TORCH):
        cluster, loop = make_loop(pkg)
        dump = str(tmp_path / f"dump{pkg is TORCH}.json")
        auditor = pkg.int.IntegrityAuditor(loop.encoder, loop,
                                           watchdog_failures=2,
                                           crash_dump_path=dump)
        loop.encoder._metrics[1, 0] = np.nan
        outs = [auditor.audit_once() for _ in range(3)]
        with open(dump) as fh:
            doc = json.load(fh)
        got[pkg is TORCH] = (
            [(o["repaired"], o["rung"]) for o in outs],
            auditor.watchdog_dumps, auditor.unrepaired_total,
            doc["reason"], doc["extra"]["drift"],
            doc["extra"]["unrepaired_streak"],
            sorted(e.reason for e in cluster.events))
    assert got[True] == got[False]
    assert got[True][1] == 1 and got[True][3] == "stuck_audit"
    assert "StateIntegrity" in got[True][6]


def test_audit_counters_accumulate_alike():
    got = {}
    for pkg in (JAX, TORCH):
        enc = make_encoder(pkg)
        auditor = pkg.int.IntegrityAuditor(enc)
        auditor.audit_once()
        inj = pkg.sc.StateChaosInjector(enc, seed=2)
        inj.inject("bit_flip")
        auditor.audit_once()
        inj.inject("delta_drop")
        inj.inject("delta_reorder")
        auditor.audit_once()
        assert auditor.last_audit_ms > 0.0
        assert len(auditor.audit_ms) == 3
        got[pkg is TORCH] = (auditor.audits_total,
                             auditor.drift_detected_total,
                             auditor.drift_rows_total,
                             dict(auditor.repairs),
                             auditor.unrepaired_total, dict(inj.injected))
    assert got[True] == got[False]
    assert got[True][:2] == (3, 2)


# ---------------------------------------------------------------------------
# The port on its own terms.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["delta_dup", "delta_reorder",
                                  "nan_poison", "bit_flip"])
def test_snapshot_before_injection_keeps_its_bits(kind):
    """The injector puts a NEW tensor in the cache: a snapshot a
    pipelined cycle may still be scoring keeps the bits it had."""
    enc = make_encoder(TORCH)
    before = enc.snapshot()
    held = {name: getattr(before, name).clone() for name in tint.PLANE_NAMES}
    desc = tsc.StateChaosInjector(enc, seed=11).inject(kind)
    for name in tint.PLANE_NAMES:
        assert torch.equal(
            getattr(before, name).view(torch.uint8)
            if getattr(before, name).dtype != torch.bool
            else getattr(before, name),
            held[name].view(torch.uint8)
            if held[name].dtype != torch.bool else held[name]), name
    plane = desc["plane"]
    assert enc._cache[plane] is not getattr(before, plane)
    assert not torch.equal(enc._cache[plane].view(torch.uint8),
                           held[plane].view(torch.uint8))


def test_clean_run_placements_identical_with_auditor():
    def drain(pkg, audited: bool):
        cluster, loop = make_loop(pkg)
        auditor = (pkg.int.IntegrityAuditor(loop.encoder, loop)
                   if audited else None)
        pods = pkg.fc.generate_workload(
            pkg.fc.WorkloadSpec(num_pods=48, seed=21))
        for start in range(0, len(pods), 16):
            cluster.add_pods(pods[start:start + 16])
            loop.run_once()
            if auditor is not None:
                assert auditor.audit_once()["clean"]
        loop.run_until_drained()
        loop.flush_binds()
        return sorted((b.namespace, b.pod_name, b.node_name)
                      for b in cluster.bindings), np.array(
            loop.encoder._used)

    plain, used_plain = drain(TORCH, False)
    audited, used_audited = drain(TORCH, True)
    reference, used_ref = drain(JAX, True)
    assert plain == audited == reference
    assert np.array_equal(used_plain, used_audited)
    np.testing.assert_allclose(used_audited, used_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_checkpoint_corrupt_refused_across_packages(tmp_path, seed):
    """The same seed corrupts the same byte in both packages; a
    checkpoint saved by either and corrupted by the other's injector is
    never loaded as garbage: both loaders refuse it, or both restore the
    verified set."""
    outcome = {}
    for saver, corrupter, loader in ((JAX, TORCH, TORCH),
                                     (TORCH, JAX, JAX),
                                     (JAX, JAX, JAX)):
        enc = make_encoder(saver)
        ck = str(tmp_path / f"ck{len(outcome)}")
        saver.ck.save_checkpoint(ck, enc)
        desc = corrupter.sc.StateChaosInjector(
            make_encoder(corrupter), seed=seed,
            checkpoint_dir=ck).inject("checkpoint_corrupt")
        try:
            enc2 = loader.ck.load_checkpoint(ck)
        except ValueError:
            result = "refused"
        else:
            assert not jint.compare_row_digests(
                jint.host_row_digests({"metrics": enc2._metrics,
                                       "lat": enc2._lat}),
                jint.host_row_digests({"metrics": enc._metrics,
                                       "lat": enc._lat}))
            result = "restored"
        desc.pop("file")
        outcome[len(outcome)] = (desc, result)
    assert outcome[0] == outcome[1] == outcome[2]


def _cuda_fault(*_a, **_k):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def test_device_fault_propagates_instead_of_escalating():
    """A rung's host failure escalates; a fault of the flush does not."""
    enc = make_encoder(TORCH)
    auditor = tint.IntegrityAuditor(enc)
    tsc.StateChaosInjector(enc, seed=11).inject("delta_dup")
    enc.snapshot = _cuda_fault
    with pytest.raises(RuntimeError, match="CUDA error"):
        auditor.audit_once()
    assert auditor.repairs == {r: 0 for r in tint.REPAIR_RUNGS}
    assert auditor.unrepaired_total == 0


def test_device_fault_ends_audit_thread_and_stop_raises():
    enc = make_encoder(TORCH)
    auditor = tint.IntegrityAuditor(enc, interval_s=0.01)
    auditor.start()
    deadline = time.monotonic() + 10.0
    while auditor.audits_total < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert auditor.audits_total >= 2
    enc.snapshot_versioned = _cuda_fault
    thread = auditor._thread
    thread.join(10.0)
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="CUDA error"):
        auditor.stop()
    auditor.stop()  # idempotent once stopped


def test_refused_checkpoint_rung_escalates_alike(tmp_path):
    """A loop-attached auditor whose checkpoint directory holds nothing
    loadable: the checkpoint rung fails on the host, the ladder goes on
    to the relist rung, and staging poison stays unrepaired, in both
    packages alike."""
    got = {}
    for pkg in (JAX, TORCH):
        cluster, loop = make_loop(pkg)
        ck = str(tmp_path / f"ck{pkg is TORCH}")
        os.makedirs(ck)
        auditor = pkg.int.IntegrityAuditor(loop.encoder, loop,
                                           checkpoint_dir=ck)
        loop.encoder._metrics[4, 1] = np.inf
        out = auditor.audit_once()
        got[pkg is TORCH] = (out["rung"], out["repaired"], out["staging"],
                             dict(auditor.repairs), loop.relists,
                             [e.message for e in cluster.events
                              if e.reason == "StateIntegrity"])
    assert got[True] == got[False]
    assert got[True][1] is False and got[True][4] == 1
