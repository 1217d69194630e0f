"""Checkpoints across the two packages, on the CPU.

A checkpoint is the ``Encoder``'s numpy staging and ledger, which the port
keeps as they are, so a directory saved by either package loads in the
other with every staging array, the node table, the interners and the
usage ledger equal.  The decision log of the same drive is byte-identical,
``replay_decisions`` replays alike, and a loop resumed from one
checkpoint places the same pods in both packages.  The shapes are
``tests/test_checkpoint.py``'s (40 nodes, ``max_nodes=64``,
``max_pods=16``).  The learned layers that ride beside a checkpoint
(``netmodel.npz``, ``policy.npz``) load across packages too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import checkpoint as jck
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import checkpoint as tck
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

# Every loop a test builds is stopped at teardown (bind worker and static
# refresher), so no thread outlives its test.
_LOOPS: list = []


def _tracked(cls):
    def build(*args, **kwargs):
        loop = cls(*args, **kwargs)
        _LOOPS.append(loop)
        return loop
    return build


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(fc=jfc, cfg=JCfg, loop=_tracked(jloop.SchedulerLoop),
                            ck=jck, kw={}, load_kw={})
TORCH = types.SimpleNamespace(fc=tfc, cfg=TCfg, loop=_tracked(tloop.SchedulerLoop),
                              ck=tck, kw={"device": "cpu"},
                              load_kw={"device": "cpu"})
CFG = dict(max_nodes=64, max_pods=16, max_peers=4, queue_capacity=400)


def _pods(pkg, n: int, seed: int) -> list:
    """A seeded workload with uids equal to names, so both packages'
    ledgers key alike (default uids come from per-package counters)."""
    pods = pkg.fc.generate_workload(
        pkg.fc.WorkloadSpec(num_pods=n, seed=seed, services=6,
                            peer_fraction=0.5, affinity_fraction=0.1,
                            anti_fraction=0.1))
    return [dataclasses.replace(p, uid=p.name) for p in pods]


def _drained(pkg, tmp, seed=5, log=False):
    """A warm 40-node loop that drained a seeded backlog (with the
    decision log on when asked)."""
    cfg = pkg.cfg(**CFG)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=40, seed=seed))
    loop = pkg.loop(cluster, cfg, **pkg.kw)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder,
                        np.random.default_rng(seed + 1))
    if log:
        loop.decision_log = pkg.ck.DecisionLog(str(tmp / "decisions.jsonl"))
    cluster.add_pods(_pods(pkg, 48, seed + 6))
    loop.run_until_drained()
    if log:
        loop.decision_log.close()
    return cluster, loop


def _assert_same_encoder(a, b):
    for name in jck._STATE_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a._node_names == b._node_names
    for attr in ("labels", "taints", "groups"):
        assert getattr(a, attr)._bits == getattr(b, attr)._bits, attr
    assert a._zone_index == b._zone_index
    assert a._selector_defs == b._selector_defs
    assert a._numeric_keys == b._numeric_keys
    assert sorted(a._committed) == sorted(b._committed)
    for uid, rec in a._committed.items():
        other = b._committed[uid]
        assert rec._replace(req=None, stamp=0.0) == \
            other._replace(req=None, stamp=0.0), uid
        np.testing.assert_array_equal(rec.req, other.req, err_msg=uid)
    np.testing.assert_array_equal(a._group_refs, b._group_refs)
    np.testing.assert_array_equal(a._anti_refs, b._anti_refs)
    np.testing.assert_array_equal(a._group_member_counts,
                                  b._group_member_counts)


@pytest.mark.parametrize("saver,loader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, saver, loader):
    _, loop = _drained(saver, tmp_path)
    # A gang inside its assume->bind window: restore rolls it back.
    enc = loop.encoder
    uid = next(iter(enc._committed))
    rec = enc._committed[uid]
    enc.note_gang_inflight("default/g", [[uid, rec.namespace, rec.name,
                                          enc.node_name(rec.node)]])
    path = str(tmp_path / "ckpt")
    saver.ck.save_checkpoint(path, enc)
    assert loader.ck.verify_manifest(path) == []
    restored = loader.ck.load_checkpoint(path, **loader.load_kw)
    same_side = saver.ck.load_checkpoint(path, **saver.load_kw)
    _assert_same_encoder(same_side, restored)
    assert uid not in restored._committed
    # Pristine read: the ledger exactly as written.
    pristine = loader.ck.load_checkpoint(path, settle_inflight=False,
                                         **loader.load_kw)
    assert uid in pristine._committed
    # What the restored encoder uploads is the staging it loaded.
    snap = restored.snapshot()
    used = snap.used.numpy() if isinstance(snap.used, torch.Tensor) \
        else np.asarray(snap.used)
    np.testing.assert_array_equal(used, restored._used)


def test_meta_and_manifest_match_across_packages(tmp_path):
    dirs = {}
    for name, pkg in (("jax", JAX), ("torch", TORCH)):
        _, loop = _drained(pkg, tmp_path / name)
        dirs[name] = str(tmp_path / name / "ckpt")
        pkg.ck.save_checkpoint(dirs[name], loop.encoder)
    metas = []
    for d in dirs.values():
        with open(os.path.join(d, "meta.json"), encoding="utf-8") as fh:
            metas.append(json.load(fh))
        with open(os.path.join(d, jck.MANIFEST), encoding="utf-8") as fh:
            manifest = json.load(fh)
        assert sorted(manifest["files"]) == ["meta.json", "state.npz"]
    assert metas[1] == metas[0]
    with np.load(os.path.join(dirs["jax"], "state.npz")) as a, \
            np.load(os.path.join(dirs["torch"], "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_decision_log_byte_identical(tmp_path):
    logs = []
    for name, pkg in (("jax", JAX), ("torch", TORCH)):
        (tmp_path / name).mkdir()
        _drained(pkg, tmp_path / name, log=True)
        logs.append((tmp_path / name / "decisions.jsonl").read_bytes())
    assert logs[0] and logs[1] == logs[0]
    loaded = tck.DecisionLog.load(str(tmp_path / "torch" /
                                      "decisions.jsonl"))
    assert loaded.same_as(jck.DecisionLog.load(str(
        tmp_path / "jax" / "decisions.jsonl")))


def test_replay_and_resume_from_one_checkpoint_match(tmp_path):
    """One JAX checkpoint: ``replay_decisions`` of a fresh stream gives
    the same log in both packages, and a loop resumed on the restored
    encoder binds the same pods to the same nodes."""
    cluster, loop = _drained(JAX, tmp_path, seed=9)
    path = str(tmp_path / "ckpt")
    jck.save_checkpoint(path, loop.encoder)
    replays, binds = [], []
    for pkg in (JAX, TORCH):
        enc = pkg.ck.load_checkpoint(path, **pkg.load_kw)
        cfg = pkg.cfg(**CFG)
        replays.append([(d.pod, d.node) for d in pkg.ck.replay_decisions(
            enc, _pods(pkg, 32, 21), cfg)])
        enc = pkg.ck.load_checkpoint(path, **pkg.load_kw)
        fresh, lat, bw = pkg.fc.build_fake_cluster(
            pkg.fc.ClusterSpec(num_nodes=40, seed=9))
        resumed = pkg.loop(fresh, cfg, encoder=enc)
        fresh.add_pods(_pods(pkg, 24, 33))
        resumed.run_until_drained()
        binds.append({b.pod_name: b.node_name for b in fresh.bindings})
    assert replays[1] == replays[0] and any(n for _, n in replays[0])
    assert binds[1] == binds[0] and binds[0]


def test_learned_layers_raise(tmp_path):
    """The learned layers ride beside the checkpoint in the JAX files'
    layout: a saved policy and topology model load back exactly, in
    either package.  A stored model or policy whose shapes no longer
    match the config raises in its own loader, and the restore starts
    that layer fresh instead of failing."""
    from kubernetesnetawarescheduler_tpu.netmodel import (
        TopologyModel as JModel,
    )
    from kubernetesnetawarescheduler_tpu.policy import (
        ScoringPolicy as JPolicy,
    )
    from kubernetesnetawarescheduler_tpu_torch.netmodel import (
        TopologyModel,
    )
    from kubernetesnetawarescheduler_tpu_torch.policy import ScoringPolicy

    _, loop = _drained(TORCH, tmp_path)
    path = str(tmp_path / "ckpt")
    tcfg = TCfg(**CFG, enable_learned_score=True, enable_netmodel=True)
    policy = ScoringPolicy(tcfg, device="cpu")
    model = TopologyModel(tcfg, seed=3, device="cpu")
    for k in range(20):
        model.observe(k % 7, k % 5 + 8, 0.4, 2e10, float(k))
    model.fit(4)
    loop.encoder.attach_netmodel(model)
    tck.save_checkpoint(path, loop.encoder, policy=policy)
    assert tck.load_policy(path, TCfg(**CFG)) is None
    back = tck.load_policy(path, tcfg, device="cpu")
    assert back.version == policy.version
    enc = tck.load_checkpoint(path, tcfg, device="cpu")
    assert enc.netmodel is not None and enc.netmodel.steps_total == 4
    for a, b in zip(model.predict(), enc.netmodel.predict()):
        np.testing.assert_array_equal(a, b)
    jcfg = JCfg(**CFG, enable_learned_score=True, enable_netmodel=True)
    jenc = jck.load_checkpoint(path, jcfg)
    assert isinstance(jenc.netmodel, JModel)
    assert isinstance(jck.load_policy(path, jcfg), JPolicy)
    np.testing.assert_array_equal(jenc.netmodel.predict()[1],
                                  model.predict()[1])
    skew = TCfg(**CFG, explain_top_k=9, enable_learned_score=True,
                enable_netmodel=True, netmodel_rank=3)
    with pytest.raises(ValueError):
        TopologyModel.load(os.path.join(path, "netmodel.npz"), skew,
                           device="cpu")
    with pytest.raises(ValueError):
        ScoringPolicy.load(os.path.join(path, "policy.npz"), skew,
                           device="cpu")
    fresh = tck.load_checkpoint(path, skew, device="cpu")
    assert fresh.netmodel is not None and fresh.netmodel.steps_total == 0
    assert tck.load_policy(path, skew, device="cpu").version == 0
    # A save without the layers drops their files.
    tck.save_checkpoint(path, tck.load_checkpoint(path, device="cpu"))
    assert not os.path.exists(os.path.join(path, "netmodel.npz"))
    assert tck.load_policy(path, tcfg, device="cpu") is None
