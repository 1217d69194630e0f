"""The port's gang scheduling against the JAX package's, on the CPU.

The gate (``GangRegistry``), the joint-scoring helpers (``gang_bias``,
``intra_gang_pair_score``, ``realization_scores``) and the two-pass
placements (``place_gang``, ``place_gang_shaped``) run on the same
encoder state in both packages and must choose the same nodes; whole
gangs drain through both ``SchedulerLoop``s with identical bindings.
The shapes are the JAX tests': ``tests/test_gang.py`` and
``tests/test_gang_reshape.py`` (24 nodes, ``max_nodes=32``,
``max_pods=16``, cluster seed 3).  Also the ``{"raw", "ok"}`` static
seam of ``assign.py::_static_parts`` that the gang path re-enters the
assigner through: the same precomputed pair gives the same assignment
in both packages.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import assign as jassign
from kubernetesnetawarescheduler_tpu.core import gang as jgang
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import assign as tassign
from kubernetesnetawarescheduler_tpu_torch.core import gang as tgang
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes

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
                            gang=jgang, assign=jassign, types=jtypes,
                            kw={})
TORCH = types.SimpleNamespace(fc=tfc, cfg=TCfg, loop=_tracked(tloop.SchedulerLoop),
                              gang=tgang, assign=tassign, types=ttypes,
                              kw={"device": "cpu"})


def _loop(pkg, num_nodes=24, seed=3, **cfg_kw):
    cfg = pkg.cfg(max_nodes=32, max_pods=16, max_peers=4, **cfg_kw)
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=num_nodes, seed=seed))
    loop = pkg.loop(cluster, cfg, method="parallel", **pkg.kw)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(0))
    return cluster, loop


def _gang_pods(pkg, group, n, cpu=0.25, shapes=None, spread=False):
    kw = {}
    if shapes is not None:
        kw["gang_shapes"] = pkg.gang.parse_gang_shapes(shapes)
    if spread:
        kw.update(group=group, anti_groups=frozenset({group}))
    return [pkg.types.Pod(name=f"{group}-w{i}",
                          requests={"cpu": cpu, "mem": 0.25},
                          pod_group=group, gang_min_member=n, **kw)
            for i in range(n)]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outcome(cluster, loop) -> dict:
    return {"bindings": {b.pod_name: b.node_name for b in cluster.bindings},
            "scheduled": loop.scheduled,
            "unschedulable": loop.unschedulable,
            "gangs_bound": loop.gangs_bound,
            "gangs_rolled_back": loop.gangs_rolled_back,
            "gangs_shaped_degraded": loop.gangs_shaped_degraded,
            "realizations": loop.encoder.gang_realizations(),
            "gang_counters": loop.gangs.snapshot()["counters"],
            "events": sorted((e.involved_pod, e.reason, e.message)
                             for e in cluster.events)}


DRIVES = {
    # test_gang.py: a complete gang binds whole and co-locates.
    "rigid": dict(gangs=[("slice-a", 4, {})]),
    # An incomplete gang binds nothing; a complete one beside it binds.
    "incomplete": dict(gangs=[("slice-b", 4, {"arrive": 3}),
                              ("slice-c", 3, {})]),
    # test_gang_reshape.py: ample capacity picks the full shape.
    "shaped_full": dict(gangs=[("slice-f", 4, {"shapes": "4,2:0.5"})],
                        cfg=dict(enable_gang_reshaping=True)),
    # Scarce capacity: self-anti-affine members on 3 nodes degrade to
    # the declared 2-shape (place_gang_shaped's realization choice).
    "shaped_scarce": dict(gangs=[("slice-d", 4, {"shapes": "4,2:0.5",
                                                 "spread": True})],
                          cfg=dict(enable_gang_reshaping=True),
                          num_nodes=3),
    # The same without reshaping: all-or-nothing binds nothing.
    "rigid_scarce": dict(gangs=[("slice-n", 4, {"shapes": "4,2:0.5",
                                                "spread": True})],
                         num_nodes=3),
}


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_gang_drive_matches_jax(drive):
    spec = DRIVES[drive]
    outs = []
    for pkg in (JAX, TORCH):
        cluster, loop = _loop(pkg, num_nodes=spec.get("num_nodes", 24),
                              **spec.get("cfg", {}))
        for group, n, opt in spec["gangs"]:
            pods = _gang_pods(pkg, group, n, shapes=opt.get("shapes"),
                              spread=opt.get("spread", False))
            cluster.add_pods(pods[:opt.get("arrive", n)])
        loop.run_until_drained()
        outs.append(_outcome(cluster, loop))
    assert outs[1] == outs[0]


def test_gang_workload_drive_matches_jax():
    """``generate_gang_workload`` (gangs of 4 and 8 among filler pods,
    interleaved) through both loops on a 32-node cluster at the other
    drives' config (so the JAX loop reuses their compiled steps): every
    gang is bound whole or not at all, alike in both packages."""
    outs = []
    for pkg in (JAX, TORCH):
        cluster, loop = _loop(pkg, num_nodes=32, seed=21)
        pods = pkg.fc.generate_gang_workload(
            num_gangs=5, member_counts=(4, 8), filler_pods=24, seed=23,
            cpu=2.0, mem=4.0, scheduler_name=pkg.cfg().scheduler_name)
        cluster.add_pods(pods)
        loop.run_until_drained()
        out = _outcome(cluster, loop)
        bound = out["bindings"]
        for g in range(5):
            members = [p.name for p in pods
                       if p.pod_group == f"slice-{g:03d}"]
            placed = sum(m in bound for m in members)
            assert placed in (0, len(members)), (g, placed)
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[0]["gangs_bound"] > 0


def test_generate_gang_workload_matches_jax():
    kw = dict(num_gangs=4, member_counts=(2, 3), filler_pods=5, seed=8)
    want = jfc.generate_gang_workload(**kw)
    got = tfc.generate_gang_workload(**kw)
    fields = ("name", "requests", "pod_group", "gang_min_member",
              "priority", "scheduler_name")
    assert ([tuple(getattr(p, f) for f in fields) for p in got]
            == [tuple(getattr(p, f) for f in fields) for p in want])


def test_registry_matches_jax():
    out = []
    for pkg in (JAX, TORCH):
        clock = [0.0]
        reg = pkg.gang.GangRegistry(pkg.cfg(gang_timeout_s=5.0),
                                    now=lambda: clock[0])
        pods = _gang_pods(pkg, "slice", 3) + _gang_pods(pkg, "late", 2)
        admitted = [None if (m := reg.admit(p)) is None
                    else sorted(x.name for x in m) for p in pods[:4]]
        phases = [reg.phase_of(k) for k in ("default/slice", "default/late",
                                            "default/none")]
        reg.note_assumed("default/slice")
        reg.note_bound("default/slice")
        reg.pod_gone(pods[4])
        clock[0] = 10.0
        expired = [(k, sorted(p.name for p in m))
                   for k, m in reg.flush_timeouts()]
        snap = reg.snapshot()
        out.append((admitted, phases, expired, snap["recent"],
                    snap["counters"], snap["gated"]))
    assert out[1] == out[0]
    with pytest.raises(ValueError):
        tgang.GangRegistry(TCfg()).admit(ttypes.Pod(name="solo"))


def test_shape_grammar_matches_jax():
    for raw in ("8,4:0.5,2:0.2", "4,4:0.3,2", "", "x", "0", "3:1.5",
                "2:0.5, 6"):
        assert tgang.parse_gang_shapes(raw) == jgang.parse_gang_shapes(raw)
    pods_j = _gang_pods(JAX, "g", 4, shapes="2:0.5,3:0.25,9")
    pods_t = _gang_pods(TORCH, "g", 4, shapes="2:0.5,3:0.25,9")
    assert tgang.gang_shapes_of(pods_t) == jgang.gang_shapes_of(pods_j)
    for args in ((4, 4, 1.0, 3.5), (4, 3, 0.5, 9.0), (2, 2, 0.2, -1.0)):
        assert tgang.realization_key(*args) == jgang.realization_key(*args)
    assert tgang.mean_intra_gang_bw(np.eye(4) + 1, [0, 1, 3, -1]) == \
        jgang.mean_intra_gang_bw(np.eye(4) + 1, [0, 1, 3, -1])


def _states():
    """The same encoder state in both packages: the gang test cluster
    with a batch of 6 gang members encoded."""
    out = []
    for pkg in (JAX, TORCH):
        cluster, loop = _loop(pkg)
        batch = loop.encoder.encode_pods(_gang_pods(pkg, "s", 6),
                                         node_of=lambda n: "",
                                         lenient=True)
        out.append((pkg, loop, loop.encoder.snapshot(), batch))
    return out


def test_joint_scoring_helpers_match_jax():
    (_, jl, js, _), (_, tl, ts, _) = _states()
    cfg_j, cfg_t = jl.cfg, tl.cfg
    members = [3, 7, 7, 12, -1]
    np.testing.assert_allclose(
        _np(tgang.gang_bias(ts, [3, 7, 12], cfg_t)),
        _np(jgang.gang_bias(js, [3, 7, 12], cfg_j)), rtol=1e-6, atol=1e-6)
    assert tgang.intra_gang_pair_score(ts, members, cfg_t) == \
        pytest.approx(jgang.intra_gang_pair_score(js, members, cfg_j),
                      rel=1e-6)
    nodes = np.array([[3, 7, 12, -1], [0, 0, 5, 9], [1, -1, -1, -1]],
                     np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    got = tgang.realization_scores(ts, nodes, valid, cfg_t)
    want = jgang.realization_scores(js, nodes, valid, cfg_j)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The batched rows are the single-placement objective, row by row.
    for row, ok, score in zip(nodes, valid, got):
        assert score == pytest.approx(tgang.intra_gang_pair_score(
            ts, np.where(ok, row, -1), cfg_t), rel=1e-6)


def _random_net(seed: int, n: int = 40):
    """One random network, as a duck-typed state of each package."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    bw = rng.uniform(1.0, 100.0, (n, n)).astype(np.float32)
    lat = rng.uniform(0.1, 5.0, (n, n)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-4:] = False
    js = types.SimpleNamespace(bw=jnp.asarray(bw), lat=jnp.asarray(lat),
                               node_valid=jnp.asarray(valid))
    ts = types.SimpleNamespace(bw=torch.from_numpy(bw),
                               lat=torch.from_numpy(lat),
                               node_valid=torch.from_numpy(valid))
    return rng, js, ts


@pytest.mark.parametrize("m", [2, 3, 4, 5, 7, 8, 12, 16, 32])
def test_gang_objective_has_the_jax_bits(m):
    """The gang objective sums its pair terms in XLA's order: the same
    bits as the JAX package for every placement, a member permutation
    included (the two passes of ``place_gang`` tie on such permutations,
    and the tie goes one way or the other by the last bit), and for
    ``realization_scores`` at every batch of candidates."""
    rng, js, ts = _random_net(m)
    kw = dict(max_nodes=64, max_pods=16, max_peers=4)
    cfg_j, cfg_t = JCfg(**kw), TCfg(**kw)
    for _ in range(6):
        members = rng.integers(0, 36, m)
        members[rng.random(m) < 0.1] = -1
        for order in (members, rng.permutation(members)):
            assert tgang.intra_gang_pair_score(ts, order, cfg_t) == \
                jgang.intra_gang_pair_score(js, order, cfg_j)
    for s in (1, 2, 3, 5, 9):
        nodes = rng.integers(-1, 36, (s, m)).astype(np.int32)
        valid = rng.random((s, m)) < 0.9
        np.testing.assert_array_equal(
            tgang.realization_scores(ts, nodes, valid, cfg_t),
            jgang.realization_scores(js, nodes, valid, cfg_j))


@pytest.mark.parametrize("shaped", [False, True])
def test_place_gang_matches_jax(shaped):
    answers = []
    for pkg, loop, state, batch in _states():
        cfg = loop.cfg
        fn = pkg.assign.assign_parallel
        if shaped:
            a, chosen, info = pkg.gang.place_gang_shaped(
                state, batch, cfg, None, fn, 6, ((6, 1.0), (4, 0.5),
                                                 (2, 0.25)))
            answers.append((np.asarray(a).tolist(), chosen,
                            info["candidates"], info["rigid"]))
        else:
            a = pkg.gang.place_gang(state, batch, cfg, None, fn, 6)
            answers.append(np.asarray(a).tolist())
    assert answers[1] == answers[0]


def test_static_seam_matches_jax():
    """``_static_parts`` hands back a caller's ``{"raw", "ok"}`` pair
    (transposed when asked), and ``assign_parallel`` given the same pair
    assigns alike in both packages — here a biased raw score and an ok
    mask with rows and nodes cut out."""
    res = []
    for pkg, loop, state, batch in _states():
        raw, ok = pkg.assign._static_parts(state, batch, loop.cfg, None)
        raw_np, ok_np = _np(raw), _np(ok)
        rng = np.random.default_rng(5)
        bias = rng.uniform(-0.5, 0.5, raw_np.shape[1]).astype(np.float32)
        ok_cut = ok_np.copy()
        ok_cut[4:] = False
        ok_cut[:, 2:6] = False
        as_t = (torch.from_numpy if pkg is TORCH else np.asarray)
        seam = {"raw": as_t(raw_np + bias[None, :]), "ok": as_t(ok_cut)}
        r_t, o_t = pkg.assign._static_parts(state, batch, loop.cfg, seam,
                                            transposed=True)
        assert np.array_equal(_np(r_t), (raw_np + bias[None, :]).T)
        assert np.array_equal(_np(o_t), ok_cut.T)
        a = pkg.assign.assign_parallel(state, batch, loop.cfg, seam)
        res.append(_np(a).tolist())
    assert res[1] == res[0]
    assert all(x < 0 for x in res[0][4:])
    assert not set(res[0]) & {2, 3, 4, 5}
