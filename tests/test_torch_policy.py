"""The port's learned scoring policy, its dataset join, the records leg of
the promotion gate and the dense scorers' ``wvec`` seam, against the JAX
package's on the CPU.

``_candidate_scores`` and the loss agree at rtol 1e-6 and the Adam
parameters after 4 steps at rtol 1e-4 (same numpy batch draws).  Given
the same parameters, ``shadow_rank``, ``to_score_weights``,
``PolicyDataset.collect``, ``rescore_records`` and the gate's decisions
are identical.  ``weights_vector(cfg.weights)`` gives the same bits as
``wvec=None`` in the port's dense scorer, and a non-default ``wvec``
agrees with JAX at 1e-4.  ``policy.npz`` loads across packages both
ways.  The gate's scenario replay leg (``_replay_ratio``) gives the
same ratio and scorecard as JAX on one small trace, and every decision
(``replay_win``, ``replay_below_margin``, ``replay_no_oracle_sample``,
``records_regression``) equals JAX's; the loop's eval tick replays its
trace on the loop's device, and the daemon accepts
``--policy-eval-trace``.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.config import ScoreWeights as JW
from kubernetesnetawarescheduler_tpu.core import score as jscore
from kubernetesnetawarescheduler_tpu.policy import dataset as jds
from kubernetesnetawarescheduler_tpu.policy import model as jpm
from kubernetesnetawarescheduler_tpu.policy import replay_eval as jre
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.config import ScoreWeights as TW
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.policy import dataset as tds
from kubernetesnetawarescheduler_tpu_torch.policy import model as tpm
from kubernetesnetawarescheduler_tpu_torch.policy import replay_eval as tre
from kubernetesnetawarescheduler_tpu_torch.scenario import generate as tgen
from kubernetesnetawarescheduler_tpu_torch.scenario import replay as trep
from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

W = dict(cpu=0.5, mem=0.5, net_tx=0.0, net_rx=0.0, bandwidth=1.0,
         disk=0.0, peer_bw=3.0, peer_lat=2.0, balance=0.5)
POLICY = dict(max_nodes=32, max_pods=16, max_peers=4,
              queue_capacity=128, enable_learned_score=True,
              enable_explain=True, policy_ring=256, policy_batch=32,
              policy_steps=2, policy_min_examples=8)

JAX = types.SimpleNamespace(
    cfg=lambda **kw: JCfg(**{**POLICY, **kw}, weights=JW(**W)), W=JW,
    pm=jpm, ds=jds, re=jre,
    policy=lambda cfg, seed=7: jpm.ScoringPolicy(cfg, seed=seed),
    load=lambda path, cfg: jpm.ScoringPolicy.load(path, cfg, seed=7))
TORCH = types.SimpleNamespace(
    cfg=lambda **kw: TCfg(**{**POLICY, **kw}, weights=TW(**W)), W=TW,
    pm=tpm, ds=tds, re=tre,
    policy=lambda cfg, seed=7: tpm.ScoringPolicy(cfg, seed=seed,
                                                 device="cpu"),
    load=lambda path, cfg: tpm.ScoringPolicy.load(path, cfg, seed=7,
                                                  device="cpu"))


def _examples(k_pad: int, b: int = 24, seed: int = 11):
    rng = np.random.default_rng(seed)
    comps = rng.normal(size=(b, k_pad, tpm.NUM_TERMS)).astype(np.float32)
    feas = (rng.random((b, k_pad)) > 0.2).astype(np.float32)
    feas[:, 0] = 1.0
    target = np.argmax(feas * rng.random((b, k_pad)), axis=1).astype(
        np.int32)
    cls = rng.integers(-1, 40, size=(b, k_pad)).astype(np.int32)
    return comps, feas, target, cls


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def test_candidate_scores_and_loss_match_jax():
    k_pad = 8
    comps, feas, target, cls = _examples(k_pad)
    rng = np.random.default_rng(3)
    theta = (0.3 * rng.normal(size=tpm.NUM_TERMS)).astype(np.float32)
    adj = rng.normal(size=32).astype(np.float32)
    jp = jpm.PolicyParams(jnp.asarray(theta), jnp.asarray(adj))
    tp = tpm.PolicyParams(torch.from_numpy(theta), torch.from_numpy(adj))
    want = np.asarray(jpm._candidate_scores(jp, comps, cls))
    got = tpm._candidate_scores(tp, torch.from_numpy(comps),
                                torch.from_numpy(cls)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jl = float(jpm._loss(jp, comps, feas, target, cls))
    tl = float(tpm._loss(tp, *(torch.from_numpy(a) for a in (
        comps, feas, target, cls))))
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def _trained(pkg, steps=4):
    cfg = pkg.cfg()
    pol = pkg.policy(cfg)
    pol.add_examples(*_examples(pol.k_pad))
    assert pol.train(steps) == steps
    return cfg, pol


def test_adam_parameters_after_4_steps_match_jax():
    (_, jp), (_, tp) = _trained(JAX), _trained(TORCH)
    for name in tpm.PolicyParams._fields:
        for attr in ("_params", "_ema", "_opt_m", "_opt_v"):
            np.testing.assert_allclose(
                _np(getattr(getattr(tp, attr), name)),
                _np(getattr(getattr(jp, attr), name)), rtol=1e-4,
                atol=1e-7, err_msg=f"{attr}.{name}")
    assert float(tp._opt_t) == float(jp._opt_t) == 4.0
    assert tp.version == jp.version and tp.steps_total == jp.steps_total
    np.testing.assert_allclose(tp.multipliers(), jp.multipliers(),
                               rtol=1e-4)


def _record(i: int, rng) -> dict:
    cands = []
    for j in range(int(rng.integers(1, 9))):
        comp = {t: float(rng.normal()) for t in tpm.TERMS}
        cands.append({"node": f"n{j}", "node_index": int(rng.integers(0, 32)),
                      "zone": int(rng.integers(-1, 4)),
                      "total": float(sum(comp.values())),
                      "feasible": bool(rng.random() > 0.2),
                      "components": comp, "gates": {}})
    return {"pod_uid": f"u{i}", "node_index": cands[0]["node_index"],
            "t_wall": float(i + 1), "candidates": cands}


def _seeded_policy(pkg):
    """Both packages' policies at the same parameters (warm start)."""
    cfg = pkg.cfg()
    pol = pkg.policy(cfg)
    rng = np.random.default_rng(5)
    pol.warm_start_from((0.4 * rng.normal(size=5)).astype(np.float32),
                        rng.normal(size=40).astype(np.float32))
    return cfg, pol


def test_shadow_rank_and_to_score_weights_are_identical():
    outs = []
    for pkg in (JAX, TORCH):
        cfg, pol = _seeded_policy(pkg)
        rng = np.random.default_rng(8)
        picks = [pol.shadow_rank(_record(i, rng)) for i in range(40)]
        w = pol.to_score_weights(cfg.weights)
        outs.append((picks, dataclasses.asdict(w), pol.summary(),
                     pol.disagreement_rate(), pol.export_params()))
    (jpk, jw, js, jd, je), (tpk, tw, ts, td, te) = outs
    assert tpk == jpk and tw == jw and td == jd
    assert ts == js
    for k in je:
        np.testing.assert_array_equal(te[k], je[k])


def _stores(pkg, seed=9):
    rng = np.random.default_rng(seed)
    recs = {f"u{i}": _record(i, rng) for i in range(30)}
    outcomes = [{"pod_uid": f"u{i}", "t_harvest": 100.0 + i,
                 "regret": float(rng.uniform(0.0, 0.1))}
                for i in range(0, 36, 1)]
    flight = types.SimpleNamespace(get_explain=recs.get)
    quality = types.SimpleNamespace(outcomes=lambda: list(outcomes))
    return flight, quality, list(recs.values())


def test_dataset_collect_is_identical():
    outs = []
    for pkg in (JAX, TORCH):
        cfg = pkg.cfg(policy_regret_margin=0.05)
        ds = pkg.ds.PolicyDataset(cfg, k_pad=8)
        flight, quality, _ = _stores(pkg)
        first = ds.collect(flight, quality)
        again = ds.collect(flight, quality)
        outs.append((first, again, ds.summary()))
    (jb, ja, js), (tb, ta, ts) = outs
    assert ja is None and ta is None and ts == js
    assert tb.uids == jb.uids and tb.uids
    for name in ("comps", "feas", "target", "cls"):
        g, w = getattr(tb, name), getattr(jb, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _decision(d) -> dict:
    out = d.to_dict()
    out.pop("t_wall")
    return out


def test_records_leg_and_gate_decisions_are_identical():
    outs = []
    for pkg in (JAX, TORCH):
        cfg = pkg.cfg()
        _, _, records = _stores(pkg, seed=4)
        inc = cfg.weights
        cands = [inc, dataclasses.replace(inc, peer_bw=0.0, peer_lat=0.0),
                 dataclasses.replace(inc, cpu=2.0, balance=0.1),
                 dataclasses.replace(inc, net_tx=1.5)]
        row = []
        for cand in cands:
            mult = pkg.re.term_multipliers(cand, inc)
            row.append((mult.tolist(),
                        pkg.re.rescore_records(records, mult, k_pad=8),
                        _decision(pkg.re.evaluate_candidate(
                            cfg, cand, inc, records, k_pad=8))))
        # A candidate that regresses the recorded evidence is refused
        # by the records leg before any replay.
        row.append(_decision(pkg.re.evaluate_candidate(
            cfg, cands[1], inc, [_blind_record(i) for i in range(4)],
            trace_path="never-replayed.jsonl")))
        outs.append(row)
    assert outs[0] == outs[1]
    assert outs[1][0][2]["reason"] == "no_replay_trace"
    assert outs[1][-1]["reason"] == "records_regression"


def _blind_record(i: int) -> dict:
    """The shipped winner n0 carries the high net term; n1 wins on base
    alone — the decision a net-blind candidate flips."""
    def cand(idx, total, base, net):
        return {"node": f"n{idx}", "node_index": idx, "zone": idx,
                "total": total, "feasible": True,
                "components": {"base": base, "net": net, "soft": 0.0,
                               "balance": 0.0, "spread": 0.0},
                "gates": {}}
    return {"pod_uid": f"b{i}", "node_index": 0, "t_wall": 1.0,
            "candidates": [cand(0, 10.0, 2.0, 8.0),
                           cand(1, 9.0, 8.5, 0.5)]}


def test_replay_leg_names_item_14():
    """The gate's replay leg is ported (ROADMAP item 14): a candidate
    the records leg lets through reaches ``_replay_ratio``, whose replay
    opens the trace."""
    cfg = TORCH.cfg()
    with pytest.raises(FileNotFoundError):
        tre.evaluate_candidate(cfg, cfg.weights, cfg.weights, [],
                               trace_path="missing-trace.jsonl",
                               replay_kwargs={"device": "cpu"})


# -- the gate's replay leg ------------------------------------------------


@pytest.fixture(scope="module")
def gate_trace(tmp_path_factory):
    """The suite's policy trace (a std half and an edge half with
    degraded links, link bursts) at 32 nodes and 8 virtual seconds."""
    from kubernetesnetawarescheduler_tpu_torch.bench import suite as tsuite

    spec = tsuite.policy_trace_spec(num_nodes=32, duration_s=8.0,
                                    base_rate=12.0, seed=3)
    path = str(tmp_path_factory.mktemp("gate") / "trace.jsonl.gz")
    tgen.generate_trace(spec, path)
    return path


_GATE_KW = dict(batch=16, oracle_sample=48, rebalance=False,
                state_faults=False)


def _memo_replays(monkeypatch):
    """Each package's ``_replay_ratio`` runs a distinct replay once per
    test (the decision logic is still each package's own)."""
    for mod in (jre, tre):
        real = mod._replay_ratio
        seen: dict = {}

        def memo(path, weights, cfg, kw, real=real, seen=seen):
            key = (path, repr(dataclasses.asdict(weights)),
                   repr(sorted((kw or {}).items())))
            if key not in seen:
                seen[key] = real(path, weights, cfg, kw)
            return seen[key]

        monkeypatch.setattr(mod, "_replay_ratio", memo)


def test_replay_ratio_and_gate_decisions_match_jax(gate_trace, monkeypatch):
    _memo_replays(monkeypatch)
    outs = []
    for pkg, dev in ((JAX, {}), (TORCH, {"device": "cpu"})):
        cfg = pkg.cfg()
        aware = pkg.W(**W)
        blind = dataclasses.replace(aware, peer_bw=0.0, peer_lat=0.0)
        kw = {**_GATE_KW, **dev}
        ratio, card = pkg.re._replay_ratio(gate_trace, aware, cfg, kw)
        row = [ratio, sorted(card), card["bandwidth"], card["pods"]]
        for cand, inc, margin, extra, records in (
                (aware, blind, 0.005, {}, []),            # replay_win
                (aware, blind, 10.0, {}, []),             # below margin
                (aware, aware, None, {"oracle_sample": 0}, []),
                (blind, aware, None, {},                  # records leg
                 [_blind_record(i) for i in range(4)])):
            row.append(_decision(pkg.re.evaluate_candidate(
                cfg, cand, inc, records, trace_path=gate_trace,
                margin=margin, k_pad=8,
                replay_kwargs={**kw, **extra})))
        outs.append(row)
    assert outs[1] == outs[0]
    reasons = [d["reason"] for d in outs[1][4:]]
    assert reasons == ["replay_win", "replay_below_margin",
                       "replay_no_oracle_sample", "records_regression"]
    assert 0.0 <= outs[1][0]


def test_loop_eval_tick_replays_its_trace(gate_trace):
    """With a trace the loop's eval tick runs both legs of the gate, the
    replays on the loop's device: a fresh policy's candidate equals the
    incumbent, so the replay leg refuses it below the margin."""
    from kubernetesnetawarescheduler_tpu_torch.bench import (
        fakecluster as tfc,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop

    cluster = tfc.build_fake_cluster(tfc.ClusterSpec(num_nodes=16,
                                                     seed=1))[0]
    loop = tloop.SchedulerLoop(cluster, TORCH.cfg(), device="cpu")
    seen = []
    real = tre._replay_ratio

    def spy(path, weights, cfg, kw):
        seen.append((path, dict(kw or {})))
        return real(path, weights, cfg, {**(kw or {}), **_GATE_KW})

    try:
        loop.policy_eval_trace = gate_trace
        assert loop.policy_eval_trace == gate_trace
        tre._replay_ratio = spy
        loop._policy_eval_tick()
    finally:
        tre._replay_ratio = real
        loop.stop_bind_worker()
    assert [p for p, _ in seen] == [gate_trace, gate_trace]
    assert all(str(kw["device"]) == "cpu" for _, kw in seen)
    pol = loop.policy
    assert pol.evals_total == 1 and pol.rejections_total == 1
    assert pol.promotions_total == 0


@pytest.mark.parametrize("with_trace", [False, True])
def test_serve_accepts_the_policy_eval_trace(tmp_path, capsys, gate_trace,
                                             with_trace):
    """``--policy-eval-trace`` reaches the loop; learned scoring without
    it starts with the JAX daemon's WARN."""
    from kubernetesnetawarescheduler_tpu_torch import serve

    argv = ["--cluster", "fake:16", "--uds", str(tmp_path / "s.sock"),
            "--device", "cpu", "--learned-score", "--once"]
    if with_trace:
        argv += ["--policy-eval-trace", gate_trace]
    assert serve.main(argv) == 0
    err = capsys.readouterr().err
    assert "learned scoring policy enabled" in err
    assert ("NEVER be promoted" in err) is not with_trace


def test_policy_npz_loads_across_packages(tmp_path):
    (jcfg, jp), (tcfg, tp) = _trained(JAX), _trained(TORCH)
    for pol in (jp, tp):
        pol.note_promotion({"reason": "replay_win", "promote": True},
                           pol.to_score_weights())
    for src, dst, name in ((jp, TORCH, "j.npz"), (tp, JAX, "t.npz")):
        path = str(tmp_path / name)
        src.save(path)
        back = dst.load(path, dst.cfg())
        for attr in ("_params", "_opt_m", "_opt_v", "_ema"):
            for a, b in zip(getattr(src, attr), getattr(back, attr)):
                np.testing.assert_array_equal(_np(a), _np(b))
        assert float(back._opt_t) == float(src._opt_t) == 4.0
        for field in ("examples_total", "steps_total", "trains_total",
                      "promotions_total", "promoted_version", "version"):
            assert getattr(back, field) == getattr(src, field), field
        assert (dataclasses.asdict(back.promoted_weights)
                == dataclasses.asdict(src.promoted_weights))
        np.testing.assert_array_equal(back._ring_comps, src._ring_comps)
        comps, feas, _, cls = _examples(src.k_pad, b=4, seed=12)
        np.testing.assert_array_equal(back.predict(comps, feas, cls),
                                      src.predict(comps, feas, cls))
        with np.load(path) as data:
            assert data["opt_t"].dtype == np.float32
            assert data["param_theta"].shape == (tpm.NUM_TERMS,)


def test_load_rejects_shape_skew(tmp_path):
    _, pol = _trained(TORCH)
    path = str(tmp_path / "policy.npz")
    pol.save(path)
    with pytest.raises(ValueError, match="max_zones"):
        TORCH.load(path, TORCH.cfg(max_zones=8))


# -- the wvec seam of the dense scorers -------------------------------


SCORE = dict(max_nodes=64, max_pods=12, max_peers=3, use_bfloat16=False)


def _instance(seed):
    jcfg, tcfg = JCfg(**SCORE), TCfg(**SCORE)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=60,
                                            n_pods=10)
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    ts = tstate.state_from_numpy(tcfg, state_np, "cpu")
    tp = tstate.pods_from_numpy(tcfg, pods_np, "cpu")
    return jcfg, tcfg, js, jp, ts, tp


@pytest.mark.parametrize("seed", [0, 1])
def test_weights_vector_of_cfg_weights_gives_wvec_none_bits(seed):
    _, tcfg, _, _, ts, tp = _instance(seed)
    wvec = torch.from_numpy(tscore.weights_vector(tcfg.weights))
    assert torch.equal(tscore.score_pods(ts, tp, tcfg, wvec=wvec),
                       tscore.score_pods(ts, tp, tcfg))
    got = tscore.explain_scores(ts, tp, tcfg, wvec=wvec)
    want = tscore.explain_scores(ts, tp, tcfg)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tscore.WVEC_FIELDS == jscore.WVEC_FIELDS
    np.testing.assert_array_equal(
        tscore.weights_vector(tcfg.weights),
        jscore.weights_vector(JCfg(**SCORE).weights))


@pytest.mark.parametrize("seed", [0, 1])
def test_non_default_wvec_matches_jax(seed):
    jcfg, tcfg, js, jp, ts, tp = _instance(seed)
    w = dict(cpu=0.7, mem=1.3, net_tx=0.2, net_rx=0.4, bandwidth=2.0,
             disk=0.1, peer_bw=4.5, peer_lat=0.3, balance=1.7,
             soft_affinity=2.5, spread=0.6)
    vec = jscore.weights_vector(JW(**w))
    want = np.asarray(jax.jit(lambda s, p, v: jscore.score_pods(
        s, p, jcfg, wvec=v))(js, jp, jnp.asarray(vec)))
    got = tscore.score_pods(ts, tp, tcfg,
                            wvec=torch.from_numpy(vec)).numpy()
    mask = want <= jscore.NEG_INF / 2
    np.testing.assert_array_equal(got <= jscore.NEG_INF / 2, mask)
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-4,
                               atol=1e-4)
    # The weights really moved the scores.
    base = tscore.score_pods(ts, tp, tcfg).numpy()
    assert not np.allclose(got[~mask], base[~mask])
