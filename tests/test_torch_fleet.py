"""Fleet-of-clusters serving: the port against its own solo path and the
JAX package on the CPU.

Batching tenants along a lane axis must change WHERE the dispatch runs,
never WHAT any tenant decides.  The lane-batched conflict loop
(``assign_parallel_lanes``) is held lane by lane to the port's solo
``assign_parallel`` (itself held to JAX in ``test_torch_assign.py``)
under both backends, with lanes that do and do not have zone work, lanes
that stop on different rounds and filler lanes; the static kernel's lane
launch to its solo plain version per lane.  Against the JAX package
directly, at the JAX test's one config (``tests/test_fleet.py``'s
``CFG``): ``fleet_fused_step`` on the same instance, the FleetServer's
placements (3 tenants x 16 pods, the JAX drive's seeds), the same drive
under a neighbour's ``bit_flip`` state chaos, the fleet's summary,
``/debug/fleet`` body and ``render_fleet_metrics`` text, and the
suite's ``fleet`` leg at ``SMALL`` (bindings of every cluster, every
value that is not a clock, ``tools/bench_check.py``'s verdicts).  The
transfer leg is not compared here: its JAX run recompiles the fused step
for every candidate the gate evaluates, over 30 s on the CPU even at a
reduced shape; the card runs it at its default shape.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import assign as tassign
from kubernetesnetawarescheduler_tpu_torch.core import kernels
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
from kubernetesnetawarescheduler_tpu_torch.fleet import (
    FleetServer,
    TransferRegistry,
    fleet_assign_lanes,
    fleet_fused_step,
    node_bucket,
    stack_statics,
)
from kubernetesnetawarescheduler_tpu_torch.fleet.server import _Bucket
from kubernetesnetawarescheduler_tpu_torch.policy.model import ScoringPolicy

from tests import gen
from tests.test_torch_suite_baseline import (
    JAX as JAX_SUITE,
    TORCH as TORCH_SUITE,
    check_bindings,
    mismatches,
    run_leg,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_TOOL = REPO / "tools" / "bench_check.py"
_spec = importlib.util.spec_from_file_location("bench_check", _TOOL)
bench_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_check)

#: The JAX test's one config (tests/test_fleet.py), for every drive.
CFG_KW = dict(max_nodes=16, max_pods=4, max_peers=2, fleet_bucket_min=16,
              enable_explain=False)
CFG = SchedulerConfig(**CFG_KW)


def _pkg(root: str, kw: dict) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    fc = mod("bench.fakecluster")
    return types.SimpleNamespace(
        name=root, kw=kw, cfg=mod("config").SchedulerConfig(**CFG_KW),
        fc=fc, loop=mod("core.loop"), assign=mod("core.assign"),
        state=mod("core.state"), chaos=mod("core.state_chaos"),
        fleet=mod("fleet"), batch=mod("fleet.batch"),
        extender=mod("api.extender"), metrics=mod("utils.selfmetrics"))


TORCH = _pkg("kubernetesnetawarescheduler_tpu_torch", {"device": "cpu"})
JAX = _pkg("kubernetesnetawarescheduler_tpu", {})


def _cluster(pkg, seed, num_nodes=12):
    return pkg.fc.build_fake_cluster(pkg.fc.ClusterSpec(
        num_nodes=num_nodes, seed=seed))


def _workload(pkg, n, seed):
    return pkg.fc.generate_workload(pkg.fc.WorkloadSpec(
        num_pods=n, seed=seed, services=3, peer_fraction=0.5))


def _placements(loop):
    return sorted((b.namespace, b.pod_name, b.node_name)
                  for b in loop.client.bindings)


def _drive_solo(seed, wseed, n_pods, chunk=4):
    cluster, lat, bw = _cluster(TORCH, seed)
    loop = TORCH.loop.SchedulerLoop(cluster, CFG, method="parallel",
                                    device="cpu")
    try:
        loop.encoder.set_network(lat, bw)
        TORCH.fc.feed_metrics(cluster, loop.encoder,
                              np.random.default_rng(seed + 1))
        pods = _workload(TORCH, n_pods, wseed)
        i = 0
        while i < len(pods) or len(loop.queue):
            if i < len(pods):
                loop.client.add_pods(pods[i:i + chunk])
                i += chunk
            loop.run_once()
        return _placements(loop)
    finally:
        loop.stop_bind_worker()


def _drive_fleet(pkg, seeds, wseeds, n_pods, chunk=4, chaos_on=None):
    """The JAX test's ``_drive_fleet`` in ``pkg``: every tenant served
    through one FleetServer, the state-chaos injector flipping bits of
    tenant ``chaos_on`` every third step.  Returns the placements, the
    injector, the closed fleet and its tenants."""
    fleet = pkg.fleet.FleetServer(**pkg.kw)
    tenants = []
    try:
        for k, (seed, wseed) in enumerate(zip(seeds, wseeds)):
            cluster, lat, bw = _cluster(pkg, seed)
            t = fleet.add_tenant(f"t{k}", cluster, pkg.cfg, n_nodes=12)
            t.loop.encoder.set_network(lat, bw)
            pkg.fc.feed_metrics(cluster, t.loop.encoder,
                                np.random.default_rng(seed + 1))
            tenants.append((t, _workload(pkg, n_pods, wseed)))
        chaos = None
        if chaos_on is not None:
            victim = tenants[chaos_on][0].loop
            chaos = pkg.chaos.StateChaosInjector(victim.encoder, seed=5,
                                                 loop=victim)
        i = step = 0
        while True:
            fed = False
            for t, pods in tenants:
                if pods[i:i + chunk]:
                    t.loop.client.add_pods(pods[i:i + chunk])
                    fed = True
            i += chunk
            if not fed and not any(len(t.loop.queue) for t, _ in tenants):
                break
            while any(len(t.loop.queue) for t, _ in tenants):
                fleet.step()
                step += 1
                if chaos is not None and step % 3 == 0:
                    chaos.inject("bit_flip")
    finally:
        fleet.close()
    return ([_placements(t.loop) for t, _ in tenants], chaos, fleet,
            [t for t, _ in tenants])


SEEDS, WSEEDS = [11, 22, 33], [101, 202, 303]


@pytest.fixture(scope="module")
def drives():
    """Each package's fleet drive, plain and with tenant 1 under chaos,
    built once for the module."""
    cache: dict = {}

    def get(pkg, chaos_on=None):
        key = (pkg.name, chaos_on)
        if key not in cache:
            cache[key] = _drive_fleet(pkg, SEEDS, WSEEDS, 16,
                                      chaos_on=chaos_on)
        return cache[key]

    return get


# -- the lane axis over trees ------------------------------------------


def test_stack_trees_stacks_indexes_and_writes_lanes():
    a = tstate.init_cluster_state(CFG, "cpu")
    b = a.replace(used=torch.ones_like(a.used))
    st = tstate.stack_trees([a, b])
    assert st.used.shape == (2,) + a.used.shape
    assert torch.equal(tstate.index_tree(st, 1).used, b.used)
    # index_tree is a view: a write through it lands in the stack.
    tstate.index_tree(st, 0).used[0, 0] = 7.0
    assert float(st.used[0, 0, 0]) == 7.0
    out = tstate.set_tree_row(st, 0, b)
    assert out is st and torch.equal(st.used[0], b.used)
    assert torch.equal(st.lat[1], a.lat)
    sc = tstate.stack_trees([(torch.ones(3), 2.0), (torch.zeros(3), 5.0)])
    assert torch.equal(sc[1], torch.tensor([2.0, 5.0]))


def test_stack_trees_refuses_mismatched_lanes():
    a = tstate.init_cluster_state(CFG, "cpu")
    big = tstate.init_cluster_state(dataclasses.replace(CFG, max_nodes=32),
                                    "cpu")
    with pytest.raises(ValueError, match="padding bucket"):
        tstate.stack_trees([a, big])
    with pytest.raises(ValueError, match="padding bucket"):
        tstate.stack_trees([a, a.replace(used=a.used.double())])
    with pytest.raises(ValueError):
        tstate.stack_trees([])
    with pytest.raises(ValueError, match="does not fit"):
        tstate.set_tree_row(tstate.stack_trees([a, a]), 0, big)


# -- padding buckets ----------------------------------------------------


def test_node_bucket_rounds_to_power_of_two():
    assert node_bucket(1, 64) == 64
    assert node_bucket(64, 64) == 64
    assert node_bucket(65, 64) == 128
    assert node_bucket(48, 32) == 64
    assert node_bucket(200, 64) == 256
    assert node_bucket(5120, 64) == 8192
    with pytest.raises(ValueError):
        node_bucket(0, 64)


def test_bucket_lane_capacity_is_power_of_two():
    fleet = FleetServer(device="cpu")
    caps = []
    try:
        for k in range(5):
            cluster, _, _ = _cluster(TORCH, seed=k)
            t = fleet.add_tenant(f"t{k}", cluster, CFG, n_nodes=12)
            assert t.bucket_nodes == 16
            caps.append(next(iter(fleet._buckets.values())).capacity)
    finally:
        fleet.close()
    assert caps == [1, 2, 4, 4, 8]
    assert len(fleet._buckets) == 1


def test_add_tenant_rounds_config_into_bucket():
    fleet = FleetServer(device="cpu")
    cluster, _, _ = _cluster(TORCH, seed=1)
    small = SchedulerConfig(max_nodes=8, max_pods=4, max_peers=2,
                            fleet_bucket_min=16)
    try:
        t = fleet.add_tenant("a", cluster, small, n_nodes=6)
        assert t.bucket_nodes == 16 and t.loop.cfg.max_nodes == 16
        assert t.loop.cluster_id == "a" and t.loop.fleet is fleet
        assert t.loop.encoder.device.type == "cpu"
        with pytest.raises(ValueError):
            fleet.add_tenant("a", cluster, small, n_nodes=6)
    finally:
        fleet.close()


def test_tenant_on_another_device_is_refused():
    fleet = FleetServer(device="cpu")
    cluster, _, _ = _cluster(TORCH, seed=2)
    try:
        fleet.add_tenant("a", cluster, CFG, n_nodes=12)
        with pytest.raises(ValueError, match="bucket serves on cpu"):
            fleet.add_tenant("b", cluster, CFG, n_nodes=12,
                             device="meta")
        with pytest.raises(ValueError, match="fleet serves on cpu"):
            fleet.add_tenant("c", cluster, dataclasses.replace(
                CFG, max_pods=8), n_nodes=12, device="meta")
    finally:
        fleet.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetServer()


# -- the lane-batched conflict loop against the solo loop ---------------

KW = dict(max_nodes=16, max_pods=12, max_peers=4, use_bfloat16=False)


def _instance(seed, n_nodes, n_pods, constraints, cfg):
    rng = np.random.default_rng(seed)
    s, p = gen.random_instance(rng, cfg, n_nodes=n_nodes, n_pods=n_pods,
                               with_constraints=constraints)
    state = tstate.state_from_numpy(cfg, s, "cpu")
    if not constraints:
        # Tight capacity: contended nodes, multi-accept prefixes and
        # second chances, more rounds.
        state = state.replace(cap=state.cap * 0.5)
    return state, tstate.pods_from_numpy(cfg, p, "cpu")


def _zone_work(state, pods) -> bool:
    return bool(tscore.spread_active(pods).any()
                | (pods.zaff_bits != 0).any() | (pods.zanti_bits != 0).any()
                | (state.az_anti != 0).any())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lanes_equal_solo_assign_parallel(seed, backend):
    """Each lane equals the solo loop on it: assignment and rounds.  The
    lanes mix zone work and none, contended and loose instances, and
    a filler; they stop on different rounds."""
    cfg = SchedulerConfig(**KW, score_backend=backend)
    lanes = [_instance(seed * 10 + k, 12, 10, constraints=k % 2 == 0,
                       cfg=cfg) for k in range(4)]
    lanes.append((tstate.init_cluster_state(cfg, "cpu"),
                  tstate.init_pod_batch(cfg, "cpu")))
    asg, rounds = tassign.assign_parallel_lanes(
        tstate.stack_trees([s for s, _ in lanes]),
        tstate.stack_trees([p for _, p in lanes]), cfg)
    assert asg.dtype == torch.int32 and rounds.dtype == torch.int32
    solo_rounds = []
    for k, (s, p) in enumerate(lanes):
        want, r = tassign.assign_parallel(s, p, cfg, with_stats=True)
        assert torch.equal(asg[k], want), k
        assert int(rounds[k]) == r, k
        solo_rounds.append(r)
    assert (asg[-1] == tassign.UNASSIGNED).all()
    assert len(set(solo_rounds)) > 1
    works = [_zone_work(s, p) for s, p in lanes]
    assert any(works) and not all(works)


def test_lanes_sync_once_per_round():
    """One host flag per round for every lane (plus the zone gate),
    against a solo loop's flag per round and per gate per tenant."""
    cfg = SchedulerConfig(**KW)
    lanes = [_instance(40 + k, 12, 10, constraints=False, cfg=cfg)
             for k in range(3)]
    states = tstate.stack_trees([s for s, _ in lanes])
    pods = tstate.stack_trees([p for _, p in lanes])
    before = tstate.host_flag.syncs
    tassign._static_parts_lanes(states, pods, cfg, None)
    static_syncs = tstate.host_flag.syncs - before
    before = tstate.host_flag.syncs
    _, rounds = tassign.assign_parallel_lanes(states, pods, cfg)
    assert (tstate.host_flag.syncs - before - static_syncs
            == int(rounds.max()) + 2)
    assert int(rounds.max()) > 1


def test_filler_lanes_are_inert():
    """Padding with filler lanes changes not one bit of a real lane,
    the fillers place nothing, and their commit is the identity."""
    lanes = [_encoded_lane(TORCH, seed) for seed in (31, 43)]
    triples = [(ln[1], ln[2], ln[3]) for ln in lanes]
    asg2, rounds2 = fleet_assign_lanes(*zip(*triples), CFG)
    filler = _Bucket(CFG, torch.device("cpu")).filler()
    asg4, rounds4 = fleet_assign_lanes(*zip(*(triples + [filler] * 2)),
                                       CFG)
    assert torch.equal(asg4[:2], asg2) and torch.equal(rounds4[:2], rounds2)
    assert (asg4[2:] < 0).all()
    st = tstate.stack_trees([filler[0], filler[0]])
    new, asg, _ = fleet_fused_step(st, tstate.stack_trees([filler[1]] * 2),
                                   stack_statics([filler[2]] * 2), CFG)
    assert (asg < 0).all()
    for f in dataclasses.fields(new):
        np.testing.assert_array_equal(getattr(new, f.name).numpy(),
                                      getattr(st, f.name).numpy(), f.name)


@pytest.mark.parametrize("bf16", [False, True])
def test_static_lanes_plain_is_solo_plain_per_lane(bf16):
    """``static_tile_scores_lanes`` on CPU tensors is its plain version,
    and that is the solo plain version on each lane."""
    cfg = SchedulerConfig(**KW)
    lanes = [_instance(60 + k, 12, 10, constraints=True, cfg=cfg)
             for k in range(3)]
    packs = [tiled_score.static_replay_pack(s, cfg) for s, _ in lanes]
    pods = [tiled_score.pack_pods(p, s.num_nodes) for s, p in lanes]
    groups = torch.stack([s.group_bits for s, _ in lanes])
    kernels.reset_launch_counts()
    raw, ok = kernels.static_tile_scores_lanes(
        tstate.stack_trees(packs), groups, tstate.stack_trees(pods), bf16)
    raw_t, ok_t = kernels.static_tile_scores_lanes(
        tstate.stack_trees(packs), groups, tstate.stack_trees(pods), bf16,
        transposed=True)
    assert kernels.static_tile_scores_lanes.launches == 0
    for k, (pk, pp) in enumerate(zip(packs, pods)):
        want_raw, want_ok = kernels.static_tile_scores_plain(
            pk, groups[k], pp, bf16)
        assert torch.equal(raw[k], want_raw) and torch.equal(ok[k], want_ok)
        assert torch.equal(raw_t[k], want_raw.T)
        assert torch.equal(ok_t[k], want_ok.T)


# -- against the JAX package --------------------------------------------


def _encoded_lane(pkg, seed, n_pods=4):
    """The JAX test's ``_encoded_lane`` in ``pkg``: one tenant's
    (state, batch, static) as the fleet stacks them per cycle."""
    cluster, lat, bw = _cluster(pkg, seed)
    loop = pkg.loop.SchedulerLoop(cluster, pkg.cfg, method="parallel",
                                  **pkg.kw)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder,
                        np.random.default_rng(seed + 100))
    pods = _workload(pkg, n_pods, seed + 200)
    batch = loop.encoder.encode_pods(pods, node_of=lambda *_: None,
                                     lenient=True)
    state, version = loop.encoder.snapshot_versioned()
    static = loop._static_for(state, version)
    loop.stop_bind_worker()
    return loop, state, batch, static


def test_fleet_fused_step_matches_solo_and_jax():
    """Each lane of ``fleet_fused_step`` equals the solo
    ``fused_schedule_step`` on it and the JAX vmapped step on the same
    instance: assignment, rounds and every committed plane."""
    import jax

    jl = [_encoded_lane(JAX, seed) for seed in (7, 19)]
    tl = [_encoded_lane(TORCH, seed) for seed in (7, 19)]
    jnew, jasg, jrounds = JAX.fleet.fleet_fused_step(
        JAX.state.stack_trees([jax.tree_util.tree_map(jax.numpy.copy, ln[1])
                               for ln in jl]),
        JAX.state.stack_trees([ln[2] for ln in jl]),
        JAX.batch.stack_statics([ln[3] for ln in jl]), JAX.cfg)
    new, asg, rounds = fleet_fused_step(
        tstate.stack_trees([ln[1] for ln in tl]),
        tstate.stack_trees([ln[2] for ln in tl]),
        stack_statics([ln[3] for ln in tl]), CFG)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(jasg))
    np.testing.assert_array_equal(rounds.numpy(), np.asarray(jrounds))
    for k, (_, state, batch, static) in enumerate(tl):
        s_new, s_asg, s_rounds = tassign.fused_schedule_step(
            state, batch, CFG, static)
        assert torch.equal(asg[k], s_asg) and int(rounds[k]) == s_rounds
        for f in dataclasses.fields(new):
            np.testing.assert_array_equal(getattr(new, f.name)[k].numpy(),
                                          getattr(s_new, f.name).numpy(),
                                          f.name)
            want = np.asarray(getattr(jnew, f.name))[k]
            if want.dtype == np.uint32:
                want = want.view(np.int32)
            np.testing.assert_array_equal(getattr(new, f.name)[k].numpy(),
                                          want, err_msg=f.name)


def test_fleet_placements_match_jax_and_solo(drives):
    """The tentpole property: each tenant served from the lane-batched
    dispatch places every pod where solo serving and the JAX fleet
    do."""
    got, _, fleet, _ = drives(TORCH)
    want, _, _, _ = drives(JAX)
    assert got == want
    for k, (s, w) in enumerate(zip(SEEDS, WSEEDS)):
        assert got[k] == _drive_solo(s, w, 16), k
    assert all(len(p) > 0 for p in got)
    s = fleet.summary()
    assert s["dispatches_total"] < sum(
        t["scheduled"] for t in s["tenants"].values())


def test_fleet_isolation_under_neighbor_state_chaos(drives):
    """One tenant's planes are bit-flipped mid-serving: the others
    place as solo serving does, and every tenant places as in the JAX
    fleet under the same faults."""
    got, chaos, _, _ = drives(TORCH, chaos_on=1)
    want, jchaos, _, _ = drives(JAX, chaos_on=1)
    assert chaos.injected["bit_flip"] == jchaos.injected["bit_flip"] > 0
    assert got == want
    for k in (0, 2):
        assert got[k] == _drive_solo(SEEDS[k], WSEEDS[k], 16), k


def test_fleet_summary_debug_page_and_metrics_equal_jax(drives):
    """After the same drive, the fleet's summary, a tenant's
    ``/debug/fleet`` body and ``render_fleet_metrics`` text equal the
    JAX package's; a solo loop's page says the fleet is off."""
    _, _, tfleet, tten = drives(TORCH)
    _, _, jfleet, jten = drives(JAX)
    assert tfleet.summary() == jfleet.summary()
    assert tfleet.summary()["cycles_total"] > 0
    for t, j in zip(tten, jten):
        body = _debug_fleet(TORCH, t.loop)
        assert body == _debug_fleet(JAX, j.loop)
        assert body["tenants"][t.name]["bucket_nodes"] == 16
    assert (TORCH.metrics.render_fleet_metrics(tfleet)
            == JAX.metrics.render_fleet_metrics(jfleet))
    loop, *_ = _encoded_lane(TORCH, 9)
    assert _debug_fleet(TORCH, loop) == {"enabled": False}


def _debug_fleet(pkg, loop) -> dict:
    handlers = pkg.extender.ExtenderHandlers(loop)
    try:
        return json.loads(handlers.handle("/debug/fleet", b""))
    finally:
        handlers.close()


def test_save_tenant_stamps_the_tenant(tmp_path):
    from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
        verify_manifest,
    )

    fleet = FleetServer(device="cpu")
    cluster, lat, bw = _cluster(TORCH, seed=3)
    try:
        t = fleet.add_tenant("blue", cluster, CFG, n_nodes=12,
                             checkpoint_dir=str(tmp_path / "blue"))
        t.loop.encoder.set_network(lat, bw)
        fleet.add_tenant("green", cluster, CFG, n_nodes=12)
        fleet.save_tenant("blue")
        with pytest.raises(ValueError, match="no checkpoint_dir"):
            fleet.save_tenant("green")
    finally:
        fleet.close()
    assert verify_manifest(str(tmp_path / "blue")) == []
    meta = json.loads((tmp_path / "blue" / "meta.json").read_text())
    assert meta["fleet"] == {"cluster_id": "blue"}


# -- the transfer registry ----------------------------------------------

_PCFG = SchedulerConfig(max_nodes=16, max_pods=4, max_peers=2)


def _promoted_policy(seed, theta):
    pol = ScoringPolicy(_PCFG, seed=seed, device="cpu")
    pol.warm_start_from(np.asarray(theta, np.float32),
                        np.zeros_like(pol.export_params()["class_adj"]))
    pol._version = 1
    pol.note_promotion({"promote": True, "reason": "test"}, _PCFG.weights)
    return pol


def test_registry_refuses_unpromoted_donor():
    reg = TransferRegistry()
    pol = ScoringPolicy(_PCFG, seed=0, device="cpu")
    assert reg.register("a", {"nodes": 16.0}, pol) is None
    assert reg.summary()["donors"] == {}
    assert reg.closest({"nodes": 16.0}) is None


def test_registry_picks_closest_donor_and_excludes_self():
    reg = TransferRegistry()
    reg.register("small", {"nodes": 16.0, "zones": 2.0, "lat_mean": 1.0,
                           "bw_mean": 1.0}, _promoted_policy(1, [0.1] * 5))
    reg.register("big", {"nodes": 512.0, "zones": 8.0, "lat_mean": 4.0,
                         "bw_mean": 10.0}, _promoted_policy(2, [0.9] * 5))
    near_small = {"nodes": 24.0, "zones": 2.0, "lat_mean": 1.1,
                  "bw_mean": 0.9}
    assert reg.closest(near_small).cluster_id == "small"
    assert reg.closest({"nodes": 480.0, "zones": 8.0, "lat_mean": 4.2,
                        "bw_mean": 9.0}).cluster_id == "big"
    assert reg.closest(near_small, exclude="small").cluster_id == "big"


def test_warm_start_seeds_exact_donor_parameters():
    reg = TransferRegistry()
    theta = [0.3, 1.2, -0.4, 0.05, 0.7]
    reg.register("donor", {"nodes": 16.0, "zones": 2.0, "lat_mean": 1.0,
                           "bw_mean": 1.0}, _promoted_policy(3, theta))
    recip = ScoringPolicy(_PCFG, seed=9, device="cpu")
    rec = reg.warm_start(recip, {"nodes": 20.0, "zones": 2.0,
                                 "lat_mean": 1.1, "bw_mean": 1.0})
    assert rec is not None and rec.cluster_id == "donor"
    np.testing.assert_array_equal(recip.export_params()["theta"],
                                  np.asarray(theta, np.float32))
    assert recip.promoted_version == 0
    assert reg.transfers_total == 1


def test_fleet_registers_donor_only_on_new_promotion():
    fleet = FleetServer(device="cpu")
    cluster, lat, bw = _cluster(TORCH, seed=2)
    cfg = dataclasses.replace(CFG, enable_learned_score=True)
    try:
        t = fleet.add_tenant("a", cluster, cfg, n_nodes=12)
        t.loop.encoder.set_network(lat, bw)
        TORCH.fc.feed_metrics(cluster, t.loop.encoder,
                              np.random.default_rng(3))
        assert fleet.register_donor("a") is False
        t.loop.policy._version = 1
        t.loop.policy.note_promotion({"promote": True}, cfg.weights)
        assert fleet.register_donor("a") is True
        assert fleet.register_donor("a") is False
        assert "a" in fleet.registry.summary()["donors"]
    finally:
        fleet.close()


def test_new_tenant_warm_starts_from_fleet_registry():
    reg = TransferRegistry()
    theta = [0.2, 0.8, 0.1, 0.0, 0.4]
    reg.register("elder", {"nodes": 12.0, "zones": 2.0, "lat_mean": 1.0,
                           "bw_mean": 1.0}, _promoted_policy(5, theta))
    fleet = FleetServer(registry=reg, device="cpu")
    cluster, lat, bw = _cluster(TORCH, seed=4)
    cfg = dataclasses.replace(CFG, enable_learned_score=True)
    try:
        t = fleet.add_tenant("young", cluster, cfg, n_nodes=12)
        t.loop.encoder.set_network(lat, bw)
        TORCH.fc.feed_metrics(cluster, t.loop.encoder,
                              np.random.default_rng(5))
        fleet.maintain()
    finally:
        fleet.close()
    assert t.transfer_donor["cluster_id"] == "elder"
    np.testing.assert_array_equal(t.loop.policy.export_params()["theta"],
                                  np.asarray(theta, np.float32))
    assert t.loop.policy.promoted_version == 0


# -- the suite's fleet leg against the JAX leg --------------------------

#: Values read off a clock (the SLO blocks judge clock percentiles, and
#: a donor's registration time is a wall clock).
CLOCKS = frozenset({
    "value", "score_p99_ms", "slo", "aggregate_pods_per_sec",
    "single_tenant_pods_per_sec", "speedup", "speedup_over_4x",
    "solo_aggregate_pods_per_sec", "speedup_vs_solo", "wall_s",
    "solo_wall_s", "fleet_wall_s", "solo_chain_pods_per_sec",
    "registered_t", "bench_env", "methodology"})


def _drop(x):
    if isinstance(x, dict):
        return {k: _drop(v) for k, v in x.items() if k not in CLOCKS}
    if isinstance(x, list):
        return [_drop(v) for v in x]
    return x


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    return {pkg.name: run_leg(pkg, "fleet",
                              tmp_path_factory.mktemp(f"fleet_{pkg.name}"))
            for pkg in (JAX_SUITE, TORCH_SUITE)}


def test_fleet_leg_binds_as_the_jax_leg(legs):
    check_bindings(legs["jax"], legs["torch"])


def test_fleet_leg_metrics_equal_the_jax_leg(legs):
    j, t = legs["jax"].result, legs["torch"].result
    assert t.config == j.config == "fleet"
    fl = t.metrics["detail"]["fleet"]
    assert fl["isolation_bit_identical"] is True
    assert fl["transfer"] == {"skipped": "transfer leg is full-shape-only"}
    assert mismatches(_drop(j.metrics), _drop(t.metrics)) == []


def test_fleet_leg_artifact_passes_bench_check_as_the_jax_one(legs):
    docs = [json.loads((legs[name].out_dir / "fleet.json").read_text())
            for name in ("jax", "torch")]
    assert mismatches(_drop(docs[0]), _drop(docs[1])) == []
    assert docs[1]["detail"]["bench_env"]["platform"] == "cpu"
    verdicts = [bench_check.check_doc("fleet.json", d) for d in docs]
    assert verdicts[1] == verdicts[0] == []

