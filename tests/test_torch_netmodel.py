"""The port's learned topology model, its EIG probe planner and the probe
orchestrator's hooks, against the JAX package's on the CPU.

Bit-identical: the initial parameters (same numpy generator), the ring,
``_node_obs``, ``_last_obs`` and ``pairs_observed`` after the same
observations, the planner's selections, the orchestrator's probed pairs
over 20 cycles, ``blend`` given the same dense prediction, and the
stalest-first walk against ``heapq.nsmallest``.  With tolerance:
``_predict_dense`` at the same parameters (rtol 1e-5: its products
follow XLA's fused multiply-add chain, the elementwise tail may round
differently) and the parameters after three ``fit(8)`` (rtol 1e-4, atol
1e-6; the gradients' scatter-adds sum in another order).  ``netmodel.npz`` loads
across packages both ways, the encoder's blended snapshot equals
``expected_device_arrays()``, and a reused node slot resets its rows as
the JAX model does.  The JAX package's own netmodel cases run on the
port too.
"""

from __future__ import annotations

import heapq
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import encode as jencode
from kubernetesnetawarescheduler_tpu.ingest import probe as jprobe
from kubernetesnetawarescheduler_tpu.k8s import types as jtypes
from kubernetesnetawarescheduler_tpu.netmodel import model as jmodel
from kubernetesnetawarescheduler_tpu.netmodel import planner as jplanner
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import checkpoint as tck
from kubernetesnetawarescheduler_tpu_torch.core import encode as tencode
from kubernetesnetawarescheduler_tpu_torch.ingest import probe as tprobe
from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes
from kubernetesnetawarescheduler_tpu_torch.netmodel import model as tmodel
from kubernetesnetawarescheduler_tpu_torch.netmodel import (
    planner as tplanner,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

# One config for every JAX drive of this file (one compile of the step).
CFG = dict(max_nodes=32, max_pods=4, max_peers=2, enable_netmodel=True,
           netmodel_ring=4096, netmodel_batch=128)

JAX = types.SimpleNamespace(
    cfg=JCfg, model=lambda cfg, seed: jmodel.TopologyModel(cfg, seed=seed),
    load=lambda path, cfg: jmodel.TopologyModel.load(path, cfg),
    planner=jplanner.EIGProbePlanner, probe=jprobe, fc=jfc,
    enc=lambda cfg: jencode.Encoder(cfg), Node=jtypes.Node)
TORCH = types.SimpleNamespace(
    cfg=TCfg,
    model=lambda cfg, seed: tmodel.TopologyModel(cfg, seed=seed,
                                                 device="cpu"),
    load=lambda path, cfg: tmodel.TopologyModel.load(path, cfg,
                                                     device="cpu"),
    planner=tplanner.EIGProbePlanner, probe=tprobe, fc=tfc,
    enc=lambda cfg: tencode.Encoder(cfg, device="cpu"), Node=ttypes.Node)


def _params(model) -> dict[str, np.ndarray]:
    return {name: np.asarray(p.cpu() if torch.is_tensor(p) else p)
            for name, p in zip(tmodel.TopoParams._fields, model._params)}


def _host(model) -> dict[str, np.ndarray]:
    """The host bookkeeping that must be bit-identical."""
    out = {name: getattr(model, f"_{name}").copy() for name in (
        "ring_i", "ring_j", "ring_lat", "ring_y", "ring_wlat", "ring_wbw",
        "node_obs", "last_obs", "last_y")}
    out["scalars"] = np.asarray([model._clock, model._ring_pos,
                                 model._ring_count, model.pairs_observed,
                                 model._y_lo, model._y_hi, model._lat_hi])
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _observe_stream(model, seed: int, n: int = 24, count: int = 300):
    """A seeded probe stream with missing and repeated measurements."""
    rng = np.random.default_rng(seed)
    for k in range(count):
        i, j = (int(x) for x in rng.integers(0, n, 2))
        lat = float(rng.uniform(0.05, 3.0)) if rng.random() > 0.1 else None
        bw = float(rng.uniform(1e9, 4e10)) if rng.random() > 0.1 else None
        model.observe(i, j, lat, bw, float(k))


def _two_rack(pkg, seed: int, num_nodes: int = 32):
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=num_nodes, zones=1, racks_per_zone=2,
                           jitter=0.05, seed=seed))
    return [n.name for n in cluster.list_nodes()], lat, bw


def _encoder(pkg, cfg, names):
    enc = pkg.enc(cfg)
    for name in names:
        enc.upsert_node(pkg.Node(name=name, capacity={"cpu": 4.0}))
    return enc


def test_initial_params_are_bit_identical():
    jm, tm = JAX.model(JCfg(**CFG), 11), TORCH.model(TCfg(**CFG), 11)
    _assert_same(_params(jm), _params(tm))
    assert tm._params.x.device.type == "cpu"


def test_observe_ring_and_confidence_are_bit_identical():
    jm, tm = JAX.model(JCfg(**CFG), 3), TORCH.model(TCfg(**CFG), 3)
    for m in (jm, tm):
        _observe_stream(m, seed=5)
        m.advance_clock(17.5)
    _assert_same(_host(jm), _host(tm))
    assert tm.pairs_observed > 0


def test_fit_tracks_jax_adam_trajectory():
    jm, tm = JAX.model(JCfg(**CFG), 2), TORCH.model(TCfg(**CFG), 2)
    for m in (jm, tm):
        _observe_stream(m, seed=9)
    for _ in range(3):
        assert jm.fit(8) == tm.fit(8) == 8
        jp, tp = _params(jm), _params(tm)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert float(tm._opt_t) == float(jm._opt_t) == 24.0
    for name in tmodel.TopoParams._fields:
        np.testing.assert_allclose(
            getattr(tm._ema, name).numpy(),
            np.asarray(getattr(jm._ema, name)), rtol=1e-4, atol=1e-6)
    assert (tm.steps_total, tm.fits_total) == (jm.steps_total,
                                               jm.fits_total)
    # The residual monitor reads the EMA parameters on the host.
    _assert_same(_host(jm), _host(tm))


def test_predict_dense_matches_jax_at_the_same_params():
    jm = JAX.model(JCfg(**CFG), 4)
    _observe_stream(jm, seed=4)
    jm.fit(8)
    p = jm._eval_params_locked()
    tp = tmodel.TopoParams(*(torch.from_numpy(np.asarray(x).copy())
                             for x in p))
    j_lat, j_bw = (np.asarray(x) for x in jmodel._predict_dense(p))
    t_lat, t_bw = (x.numpy() for x in tmodel._predict_dense(tp))
    np.testing.assert_allclose(t_lat, j_lat, rtol=1e-5)
    np.testing.assert_allclose(t_bw, j_bw, rtol=1e-5)


def test_blend_is_bit_identical_given_the_same_prediction():
    jm, tm = JAX.model(JCfg(**CFG), 6), TORCH.model(TCfg(**CFG), 6)
    for m in (jm, tm):
        _observe_stream(m, seed=6)
        m.advance_clock(300.0)
    rng = np.random.default_rng(1)
    n = CFG["max_nodes"]
    lat_hat = rng.uniform(0.1, 2.0, (n, n)).astype(np.float32)
    bw_hat = rng.uniform(1e9, 3e10, (n, n)).astype(np.float32)
    lat_p = rng.uniform(0.0, 2.0, (n, n)).astype(np.float32)
    bw_p = rng.uniform(0.0, 3e10, (n, n)).astype(np.float32)
    outs = []
    for m in (jm, tm):
        m._dense_cache = (lat_hat, bw_hat)
        m._dense_version = m._version
        outs.append(m.blend(lat_p, bw_p))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_planner_selections_are_bit_identical():
    picks = []
    for pkg in (JAX, TORCH):
        cfg = pkg.cfg(**CFG)
        m = pkg.model(cfg, 7)
        _observe_stream(m, seed=7, n=20, count=120)
        m.advance_clock(400.0)
        pl = pkg.planner(m, explore_frac=0.25, seed=7)
        stalest = iter(range(1000))
        out = []
        for cyc in range(6):
            pl.note_placements([cyc % 5, 7, 11])
            out.append(pl.select_pairs(
                20, 12, lambda k: [(0, next(stalest) % 19 + 1)
                                   for _ in range(k)]))
            out.append(pl.last_entropy_bits)
            m.advance_clock(60.0)
        out.append(pl.selections_total)
        picks.append(out)
    assert picks[0] == picks[1]


def _orchestrate(pkg, cycles: int = 20):
    names, lat, bw = _two_rack(pkg, seed=8, num_nodes=24)
    cfg = pkg.cfg(**CFG)
    enc = _encoder(pkg, cfg, names)
    model = pkg.model(cfg, 8)
    enc.attach_netmodel(model)
    planner = pkg.planner(model, explore_frac=0.25, seed=8)
    prober = pkg.probe.FakeProber(names, lat, bw, seed=8)
    probed = []
    real = prober.probe

    def probe(a, b):
        probed.append((a, b))
        return real(a, b)

    prober.probe = probe
    orch = pkg.probe.ProbeOrchestrator(enc, prober, names,
                                       planner=planner, model=model)
    for _ in range(cycles):
        orch.run_cycle(budget=10, fit=False)
        orch.advance_clock(60.0)
    return probed, model, orch


def test_orchestrator_probes_the_same_pairs_over_20_cycles():
    (jp, jm, jo), (tp, tm, to) = _orchestrate(JAX), _orchestrate(TORCH)
    assert jp == tp and len(tp) == 200
    _assert_same(_host(jm), _host(tm))
    assert jo.staleness() == to.staleness()


def test_stalest_walk_equals_heapq_selection():
    names = [f"n{i}" for i in range(12)]
    enc = _encoder(TORCH, TCfg(max_nodes=16, max_pods=4, max_peers=2),
                   names)
    orch = tprobe.ProbeOrchestrator(enc, None, names)
    rng = np.random.default_rng(3)
    pairs = [(i, j) for i in range(12) for j in range(i + 1, 12)]
    for step in range(8):
        for idx in rng.choice(len(pairs), size=9, replace=False):
            orch._last_probe[pairs[idx]] = float(step)
        for budget in (1, 5, 30, 66):
            want = heapq.nsmallest(budget, pairs, key=lambda p:
                                   orch._last_probe.get(p, -np.inf))
            assert orch._stalest_pairs(budget) == want


def test_netmodel_npz_loads_across_packages(tmp_path):
    jm, tm = JAX.model(JCfg(**CFG), 12), TORCH.model(TCfg(**CFG), 12)
    for m in (jm, tm):
        _observe_stream(m, seed=12)
        m.fit(8)
    for src, dst_pkg, name in ((jm, TORCH, "j.npz"), (tm, JAX, "t.npz")):
        path = str(tmp_path / name)
        src.save(path)
        back = dst_pkg.load(path, dst_pkg.cfg(**CFG))
        _assert_same(_params(src), _params(back))
        _assert_same(_host(src), _host(back))
        for attr in ("_opt_m", "_opt_v", "_ema"):
            for a, b in zip(getattr(src, attr), getattr(back, attr)):
                np.testing.assert_array_equal(
                    np.asarray(a.cpu() if torch.is_tensor(a) else a),
                    np.asarray(b.cpu() if torch.is_tensor(b) else b))
        assert float(back._opt_t) == float(src._opt_t) == 8.0
        assert (back.steps_total, back.pairs_observed) == (
            src.steps_total, src.pairs_observed)
        with np.load(path) as data:
            assert data["opt_t"].dtype == np.float32
            assert data["param_mu"].shape == ()


def test_blended_snapshot_equals_expected_device_arrays():
    names, lat, bw = _two_rack(TORCH, seed=13, num_nodes=24)
    cfg = TCfg(**CFG)
    enc = _encoder(TORCH, cfg, names)
    model = TORCH.model(cfg, 13)
    enc.attach_netmodel(model)
    orch = tprobe.ProbeOrchestrator(
        enc, tprobe.FakeProber(names, lat, bw, seed=13), names,
        model=model)
    for _ in range(3):
        orch.run_cycle(budget=20)
        orch.advance_clock(60.0)
    snap = enc.snapshot()
    want = enc.expected_device_arrays()
    np.testing.assert_array_equal(snap.lat.numpy(), want["lat"])
    np.testing.assert_array_equal(snap.bw.numpy(), want["bw"])
    # The blend moved unprobed pairs off the raw staging planes.
    assert not np.array_equal(want["bw"], enc._bw)
    # A blended net group always goes up whole.
    enc.update_link(names[0], names[1], lat_ms=0.3, bw_bps=1e10)
    v = enc.static_version
    enc.snapshot()
    assert enc.static_delta_since(v)["net_pairs"] is None


def test_reset_node_on_slot_reuse_matches_jax():
    outs = []
    for pkg in (JAX, TORCH):
        names = [f"n{i}" for i in range(10)]
        cfg = pkg.cfg(**CFG)
        enc = _encoder(pkg, cfg, names)
        model = pkg.model(cfg, 14)
        enc.attach_netmodel(model)
        _observe_stream(model, seed=14, n=10, count=80)
        model.fit(8)
        enc.remove_node("n3")
        enc.upsert_node(pkg.Node(name="n10", capacity={"cpu": 4.0}))
        slot = enc.node_slot("n10")
        outs.append((slot, _params(model), _host(model), model._version))
    (js, jp, jh, jv), (ts, tp, th, tv) = outs
    assert js == ts == 3 and jv == tv
    _assert_same(jh, th)
    for k in jp:
        if jp[k].ndim:
            # The reused slot's rows are re-drawn from the same seed.
            np.testing.assert_array_equal(tp[k][3], jp[k][3])
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-6)


# -- the JAX package's own netmodel cases, on the port ----------------


def test_blend_fresh_probe_wins_and_unknown_keeps_raw():
    cfg = TCfg(**CFG)
    model = TORCH.model(cfg, 2)
    for k in range(30):
        model.observe(0, 1, 0.2, 20e9, float(k))
    model.fit(50)
    n = cfg.max_nodes
    lat_p = np.zeros((n, n), np.float32)
    bw_p = np.zeros((n, n), np.float32)
    lat_p[0, 1] = lat_p[1, 0] = 7.0
    bw_p[0, 1] = bw_p[1, 0] = 5e9
    lat_b, bw_b = model.blend(lat_p, bw_p)
    assert abs(lat_b[0, 1] - 7.0) < 1e-3
    assert abs(bw_b[0, 1] - 5e9) / 5e9 < 1e-3
    assert bw_b[30, 31] == bw_p[30, 31] == 0.0
    for k in range(30):
        model.observe(2, 3, 0.2, 20e9, float(k))
        model.observe(0, 3, 0.2, 20e9, float(k))
        model.observe(1, 2, 0.2, 20e9, float(k))
    model.fit(100)
    lat_b, bw_b = model.blend(lat_p, bw_p)
    assert bw_b[0, 2] > 0.0
    assert bw_b[5, 5] == bw_p[5, 5]


def test_disabled_model_is_bit_identical():
    names = [f"n{i}" for i in range(8)]
    cfg = TCfg(max_nodes=16, max_pods=4, max_peers=2)
    enc_plain = _encoder(TORCH, cfg, names)
    enc_model = _encoder(TORCH, cfg, names)
    model = TORCH.model(cfg, 3)
    assert not model.enabled
    enc_model.attach_netmodel(model)
    rng = np.random.default_rng(0)
    for _ in range(20):
        i, j = rng.integers(0, 8, 2)
        if i == j:
            continue
        lat, bw = float(rng.uniform(0.1, 2)), float(rng.uniform(1e9, 2e10))
        for enc in (enc_plain, enc_model):
            enc.update_link(names[i], names[j], lat_ms=lat, bw_bps=bw)
    s_plain, s_model = enc_plain.snapshot(), enc_model.snapshot()
    assert torch.equal(s_plain.lat, s_model.lat)
    assert torch.equal(s_plain.bw, s_model.bw)


def test_checkpoint_roundtrip_predicts_exactly(tmp_path):
    names, lat, bw = _two_rack(TORCH, seed=4)
    cfg = TCfg(**CFG)
    enc = _encoder(TORCH, cfg, names)
    model = TORCH.model(cfg, 4)
    enc.attach_netmodel(model)
    orch = tprobe.ProbeOrchestrator(
        enc, tprobe.FakeProber(names, lat, bw, seed=4), names, model=model)
    for _ in range(4):
        orch.run_cycle(budget=24)
        orch.advance_clock(60.0)
    path = str(tmp_path / "ckpt")
    tck.save_checkpoint(path, enc)
    enc2 = tck.load_checkpoint(path, cfg, device="cpu")
    model2 = enc2.netmodel
    assert model2 is not None and model2 is not model
    for a, b in zip(model.predict(), model2.predict()):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(enc.snapshot().bw, enc2.snapshot().bw)
    assert model2.pairs_observed == model.pairs_observed
    assert model2.steps_total == model.steps_total


def test_checkpoint_shape_mismatch_starts_fresh(tmp_path):
    cfg = TCfg(**CFG)
    npz = str(tmp_path / "netmodel.npz")
    TORCH.model(cfg, 0).save(npz)
    with pytest.raises(ValueError):
        TORCH.load(npz, TCfg(**{**CFG,
                                "netmodel_rank": cfg.netmodel_rank + 1}))


def test_residual_monitor_flags_divergence():
    cfg = TCfg(**CFG, netmodel_resid_threshold=0.7,
               netmodel_resid_conf=0.5)
    model = TORCH.model(cfg, 5)
    for k in range(40):
        for i, j in ((0, 1), (1, 2), (2, 3), (0, 3)):
            model.observe(i, j, 0.2, 20e9, float(k))
    model.fit(200)
    assert model.drain_degradations() == []
    model.observe(1, 3, 0.2, 20e9 / 8.0, 40.5)
    assert model.drain_degradations() == []
    for k in range(43):
        t = 41.0 + k
        for i, j in ((0, 1), (1, 2), (2, 3)):
            model.observe(i, j, 0.2, 20e9, t)
        model.fit(5)
    assert model.drain_degradations() == []
    before = model.degradations_total
    model.observe(0, 1, 0.2, 20e9 / 50.0, 90.0)
    records = model.drain_degradations()
    assert len(records) == 1 and records[0][:2] == (0, 1)
    assert records[0][2] > records[0][3]
    assert model.degradations_total == before + 1
    model.observe(0, 2, 0.2, 20e9 / 50.0, 91.0)
    records = model.drain_degradations()
    assert len(records) == 1 and records[0][:2] == (0, 2)
    p50, p99 = model.residual_quantiles()
    assert np.isfinite(p50) and p99 >= p50


def test_planner_prefers_uncertain_nodes():
    model = TORCH.model(TCfg(**CFG, netmodel_explore_frac=0.25), 6)
    for k in range(60):
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3)):
            model.observe(i, j, 0.2, 1e9, float(k))
    model.advance_clock(600.0)
    planner = tplanner.EIGProbePlanner(model, explore_frac=0.25, seed=6)
    pairs = planner.select_pairs(8, 4, lambda k: [(0, 1)][:k])
    assert len(set(pairs)) == 4 and (0, 1) in pairs
    assert all(i >= 4 and j >= 4 for i, j in pairs if (i, j) != (0, 1))
    assert planner.last_entropy_bits > 0.0
    assert planner.selections_total == 4


def test_planner_relevance_steers_selection():
    model = TORCH.model(TCfg(**CFG, netmodel_explore_frac=0.0), 7)
    model.advance_clock(600.0)
    planner = tplanner.EIGProbePlanner(model, explore_frac=0.0, seed=7)
    for _ in range(20):
        planner.note_placements([8, 9])
    assert planner.select_pairs(12, 1, lambda k: []) == [(8, 9)]


def test_orchestrator_planner_path_covers_budget():
    names, lat, bw = _two_rack(TORCH, seed=8, num_nodes=16)
    cfg = TCfg(**CFG)
    enc = _encoder(TORCH, cfg, names)
    model = TORCH.model(cfg, 8)
    enc.attach_netmodel(model)
    orch = tprobe.ProbeOrchestrator(
        enc, tprobe.FakeProber(names, lat, bw, seed=8), names,
        planner=tplanner.EIGProbePlanner(model, seed=8), model=model)
    assert orch.run_cycle(budget=10) == 10
    orch.advance_clock(60.0)
    assert orch.run_cycle(budget=10) == 10
    stats = orch.staleness()
    assert stats["tracked_pairs"] >= 10.0
    assert 0.0 < stats["coverage_fraction"] <= 1.0
    assert model.fits_total == 2


def test_selfmetrics_exports_netmodel_series():
    from kubernetesnetawarescheduler_tpu.core.loop import (
        SchedulerLoop as JLoop,
    )
    from kubernetesnetawarescheduler_tpu.utils.selfmetrics import (
        render_metrics as jrender,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import (
        SchedulerLoop as TLoop,
    )
    from kubernetesnetawarescheduler_tpu_torch.ingest.prometheus import (
        parse_prometheus_text,
    )
    from kubernetesnetawarescheduler_tpu_torch.utils.selfmetrics import (
        render_metrics as trender,
    )

    bodies = []
    for pkg, loop_cls, render, kw in (
            (JAX, JLoop, jrender, {}), (TORCH, TLoop, trender,
                                        {"device": "cpu"})):
        names, lat, bw = _two_rack(pkg, seed=9)
        cluster, _, _ = pkg.fc.build_fake_cluster(
            pkg.fc.ClusterSpec(num_nodes=len(names), seed=9))
        cfg = pkg.cfg(**CFG)
        loop = loop_cls(cluster, cfg, **kw)
        pkg.fc.feed_metrics(cluster, loop.encoder,
                            np.random.default_rng(9))
        model = pkg.model(cfg, 9)
        loop.encoder.attach_netmodel(model)
        planner = pkg.planner(model, seed=9)
        orch = pkg.probe.ProbeOrchestrator(
            loop.encoder, pkg.probe.FakeProber(names, lat, bw, seed=9),
            names, planner=planner, model=model)
        loop.probe_planner = planner
        loop.probe_orchestrator = orch
        orch.run_cycle(budget=12)
        bodies.append(render(loop))
        loop.stop_bind_worker()
    jflat, tflat = ({n: next(iter(s.values()))
                     for n, s in parse_prometheus_text(b).items()
                     if n.startswith("netaware_netmodel")} for b in bodies)
    assert jflat.keys() == tflat.keys() and len(tflat) == 6
    assert tflat["netaware_netmodel_pair_coverage_fraction"] > 0.0
    assert (tflat["netaware_netmodel_sgd_steps_total"]
            == jflat["netaware_netmodel_sgd_steps_total"] > 0)
    for name in ("netaware_netmodel_pair_coverage_fraction",
                 "netaware_netmodel_probe_selection_entropy_bits",
                 "netaware_netmodel_link_degradations_total"):
        assert tflat[name] == jflat[name]
    jhelp, thelp = ([ln for ln in b.splitlines()
                     if ln.startswith(("# HELP netaware_netmodel",
                                       "# TYPE netaware_netmodel"))]
                    for b in bodies)
    assert jhelp == thelp
