"""The port's bench suite: its frame and its scenario and policy legs on
the CPU.

``run_suite(["scenario", "policy"], small=True, device="cpu")`` runs
the campaign and the policy gate at the JAX suite's small shapes: the
scorecard lints clean (the repository's ``tools/scenario_check.py``
included), the disabled policy is bit-identical, the seeded loser is
refused by the records leg and the seeded winner promoted by the replay
leg.  Every ported leg keeps the JAX leg's defaults and ``SMALL`` shape
(the nine BASELINE and audit legs are held against the JAX legs in
``test_torch_suite_baseline.py`` and ``test_torch_suite_audits.py``, the
layer legs in ``test_torch_suite_layers.py``, the fleet leg in
``test_torch_fleet.py``).  ``--config all`` runs every leg in the JAX
suite's order, and an unknown leg is refused before any leg runs.
``bench_env`` and ``write_artifact`` keep the JAX helpers' shape.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import artifact as jart
from kubernetesnetawarescheduler_tpu.bench import envinfo as jenv
from kubernetesnetawarescheduler_tpu.bench import suite as jsuite
from kubernetesnetawarescheduler_tpu_torch.bench import artifact as tart
from kubernetesnetawarescheduler_tpu_torch.bench import envinfo as tenv
from kubernetesnetawarescheduler_tpu_torch.bench import suite as tsuite

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_TOOL = REPO / "tools" / "scenario_check.py"
_spec = importlib.util.spec_from_file_location("scenario_check", _TOOL)
scenario_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(scenario_check)


@pytest.fixture(scope="module")
def small_run():
    return tsuite.run_suite(["scenario", "policy"], small=True,
                            device="cpu")


def test_scenario_leg_small(small_run):
    res = small_run[0]
    assert res.config == "scenario" and res.artifacts == []
    doc = res.metrics
    d = doc["detail"]
    assert doc["metric"] == "scenario_campaign" and doc["value"] > 0
    assert d["scorecard_problems"] == []
    assert scenario_check.check_artifact(json.loads(json.dumps(doc))) == []
    assert d["pods_streamed"] == d["gen_stats"]["pods"] > 0
    assert d["queue_dropped"] == 0 and d["half_moved_gangs"] == 0
    assert d["scorecard"]["repair_events"]["integrity"]["unrepaired"] == 0
    assert d["device"] == "cpu"
    assert d["bench_env"]["platform"] == "cpu"


def test_policy_leg_small(small_run):
    doc = small_run[1].metrics
    pol = doc["detail"]["policy"]
    assert doc["metric"] == "policy_gate"
    assert pol["disabled_bit_identical"]
    assert pol["gate_rejects_loser"]
    assert pol["rejection"]["reason"] == "records_regression"
    assert pol["promoted"] and pol["promotion"]["reason"] == "replay_win"
    assert (pol["candidate_bw_ratio_vs_oracle"]
            > pol["incumbent_bw_ratio_vs_oracle"] >= 0.0)
    assert doc["value"] == pytest.approx(
        pol["oracle_gain_recovered_fraction"], abs=1e-6)
    assert pol["summary"]["promotions_total"] == 1


def test_legs_keep_the_jax_suites_shapes():
    assert tsuite.SMALL == {k: jsuite.SMALL[k] for k in tsuite.CONFIGS}
    assert tsuite.ALL == tuple(jsuite.CONFIGS)
    assert set(tsuite.CONFIGS) == set(jsuite.CONFIGS)
    assert tsuite.BW_LAT.__dict__ == jsuite.BW_LAT.__dict__
    assert tsuite.LATENCY_ONLY.__dict__ == jsuite.LATENCY_ONLY.__dict__
    for name, leg in tsuite.CONFIGS.items():
        assert leg.__defaults__[:-1] == jsuite.CONFIGS[name].__defaults__, \
            name
        assert leg.__defaults__[-1] == "cuda", name


def test_config_all_runs_every_leg_in_the_jax_order(monkeypatch, tmp_path):
    ran = []
    for name in tsuite.CONFIGS:
        def fake(out_dir=None, device="cuda", _name=name, **kw):
            ran.append((_name, device))
            return tsuite.SuiteResult(_name, {"metric": _name}, [])
        monkeypatch.setitem(tsuite.CONFIGS, name, fake)
    tsuite.main(["--config", "all", "--device", "cpu",
                 "--out", str(tmp_path)])
    assert ran == [(name, "cpu") for name in jsuite.CONFIGS]


def test_unknown_leg_is_refused_before_any_leg_runs(monkeypatch):
    ran = []
    monkeypatch.setitem(tsuite.CONFIGS, "scenario",
                        lambda **kw: ran.append(kw))
    with pytest.raises(ValueError, match="unknown suite leg"):
        tsuite.run_suite(["scenario", "no_such_leg"], device="cpu")
    assert ran == []


def test_main_writes_the_artifact_under_out(tmp_path, capsys,
                                            monkeypatch):
    def fake(out_dir=None, device="cuda", **kw):
        doc = {"metric": "policy_gate", "value": 1.0,
               "detail": {"device": device, "kw": kw}}
        arts: list = []
        tart.write_artifact(out_dir, "policy.json", doc, arts)
        return tsuite.SuiteResult("policy", doc, arts)

    monkeypatch.setitem(tsuite.CONFIGS, "policy", fake)
    tsuite.main(["--config", "policy", "--small", "--device", "cpu",
                 "--out", str(tmp_path / "o")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = tmp_path / "o" / "policy.json"
    assert line["artifacts"] == [str(path)]
    doc = json.loads(path.read_text())
    assert doc["detail"]["device"] == "cpu"
    assert doc["detail"]["kw"] == tsuite.SMALL["policy"]
    assert doc["detail"]["bench_env"]["platform"] == "cpu"


def test_default_out_is_ignored_by_git():
    assert tsuite.DEFAULT_OUT != "bench_artifacts"
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert f"/{tsuite.DEFAULT_OUT}/" in lines


def test_bench_env_and_artifact_keep_the_jax_shape(tmp_path):
    got, want = tenv.bench_env(), jenv.bench_env()
    assert sorted(got) == sorted(want)
    assert got["git_sha"] == want["git_sha"]
    assert tenv.accel_platform() == "cpu"
    for mod in (tart, jart):
        doc = {"metric": "m", "detail": {"bench_env": {"host": "x"}}}
        assert mod.stamp_provenance(doc)["detail"]["bench_env"] == {
            "host": "x"}
        arts: list = []
        path = mod.write_artifact(str(tmp_path / mod.__name__), "a.json",
                                  {"metric": "m"}, arts)
        assert arts == [path] and os.path.exists(path)
        assert sorted(json.loads(open(path).read())["detail"]) == [
            "bench_env"]
        assert mod.write_artifact(None, "a.json", {"metric": "m"}) is None
