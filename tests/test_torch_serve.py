"""The port's daemon (``serve.py``) on the CPU, on the shapes of
``tests/test_serve.py``: ``--once`` with checkpoint save and restore, a
checkpoint of another cluster ignored, the UDS server answering while the
daemon runs, a ``kube:<url>`` drive against the port's fake API server,
each flag of an unported layer refused with its ROADMAP item, the
learning layers' flags and config fields starting their layers, the
robustness flags starting the auditor, the state-fault injector and the
rebalancer, their ``/metrics`` families equal to the JAX package's
(names, labels, HELP and TYPE), and ``--device`` defaulting to the
card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from kubernetesnetawarescheduler_tpu_torch import serve
from kubernetesnetawarescheduler_tpu_torch.api.server import call_uds
from kubernetesnetawarescheduler_tpu_torch.bench.fakeapi import FakeApiServer
from kubernetesnetawarescheduler_tpu_torch.core import kernels

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _argv(tmp_path, *extra, cluster="fake:16"):
    return ["--cluster", cluster, "--uds", str(tmp_path / "scorer.sock"),
            "--device", "cpu", *extra]


def test_once_saves_checkpoint_and_restart_restores(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert serve.main(_argv(tmp_path, "--checkpoint-dir", ckpt,
                            "--decision-log", str(tmp_path / "dec.jsonl"),
                            "--once")) == 0
    assert os.path.exists(os.path.join(ckpt, "meta.json"))
    assert os.path.exists(os.path.join(ckpt, "state.npz"))
    assert os.path.exists(os.path.join(ckpt, "flight_dump.json"))
    capsys.readouterr()
    assert serve.main(_argv(tmp_path, "--checkpoint-dir", ckpt,
                            "--once")) == 0
    assert "restored checkpoint" in capsys.readouterr().err


def test_restored_checkpoint_reaches_the_rebalancer(tmp_path, monkeypatch,
                                                   capsys):
    """A restart with ``--rebalance`` restores the checkpoint into the
    loop AND its rebalancer, which was built on the replaced encoder."""
    from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop

    loops = []
    real_init = tloop.SchedulerLoop.__init__

    def keep(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        loops.append(self)

    monkeypatch.setattr(tloop.SchedulerLoop, "__init__", keep)
    ckpt = str(tmp_path / "ckpt")
    assert serve.main(_argv(tmp_path, "--checkpoint-dir", ckpt,
                            "--once")) == 0
    assert serve.main(_argv(tmp_path, "--checkpoint-dir", ckpt, "--once",
                            "--rebalance")) == 0
    assert "restored checkpoint" in capsys.readouterr().err
    loop = loops[-1]
    assert loop.checkpoint_state == "restored"
    assert loop.rebalance.encoder is loop.encoder


def test_checkpoint_of_another_cluster_is_ignored(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert serve.main(_argv(tmp_path, "--checkpoint-dir", ckpt,
                            "--once")) == 0
    assert serve.main(_argv(tmp_path, "--checkpoint-dir", ckpt, "--once",
                            cluster="fake:32")) == 0
    assert "IGNORING checkpoint" in capsys.readouterr().err


def test_daemon_answers_uds_requests_and_stops(tmp_path):
    uds = str(tmp_path / "scorer.sock")
    stop = threading.Event()
    result = {}
    th = threading.Thread(
        target=lambda: result.setdefault("rc", serve.main(
            _argv(tmp_path), stop)), daemon=True)
    th.start()
    try:
        for _ in range(200):
            if os.path.exists(uds):
                break
            stop.wait(0.05)
        assert json.loads(call_uds(uds, "/health", b"")) == {"ok": True}
        assert json.loads(call_uds(uds, "/readyz", b""))["ready"] is True
        names = [f"node-{i:04d}" for i in range(16)]
        args = {"pod": {"metadata": {"name": "w"}, "spec": {
            "containers": [{"resources": {"requests": {"cpu": "1"}}}]}},
            "nodenames": names}
        prio = json.loads(call_uds(uds, "/prioritize",
                                   json.dumps(args).encode()))
        assert [p["host"] for p in prio] == names
        metrics = call_uds(uds, "/metrics", b"").decode()
        types_ = [ln.split()[2] for ln in metrics.splitlines()
                  if ln.startswith("# TYPE ")]
        assert "netaware_nodes_ready" in types_
        assert len(types_) == len(set(types_))
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive() and result["rc"] == 0
    assert not os.path.exists(uds)


def test_kube_apiserver_drive_binds_the_pending_pod(tmp_path):
    api = FakeApiServer()
    try:
        assert serve.main(_argv(tmp_path, "--kube-token", "t", "--once",
                                cluster=f"kube:{api.url}")) == 0
        assert api.bindings
        assert api.bindings[0]["body"]["target"]["kind"] == "Node"
    finally:
        api.stop()


@pytest.mark.parametrize("extra,item", [
    (["--mesh"], 15),
    (["--multihost"], 15), (["--coordinator", "h:1"], 15),
    (["--num-processes", "2"], 15), (["--process-id", "0"], 15),
])
def test_unported_layer_is_refused_before_anything_starts(tmp_path, capsys,
                                                          extra, item):
    if isinstance(extra, dict):
        cfgp = tmp_path / "cfg.json"
        cfgp.write_text(json.dumps(extra))
        extra = ["--config", str(cfgp)]
    assert serve.main(_argv(tmp_path, *extra, "--once")) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1
    assert f"ROADMAP Queue A item {item}" in err[0]
    assert not os.path.exists(tmp_path / "scorer.sock")


@pytest.mark.parametrize("extra,families", [
    (["--quality-obs"], ("netaware_quality_outcomes_total",)),
    (["--slo"], ("netaware_slo_evaluations_total",)),
    (["--learned-score"], ("netaware_policy_train_steps_total",)),
    ({"enable_netmodel": True}, ("netaware_netmodel_sgd_steps_total",)),
    ({"enable_quality_obs": True, "enable_slo": True,
      "enable_learned_score": True, "enable_netmodel": True,
      "enable_explain": True},
     ("netaware_quality_outcomes_total", "netaware_slo_evaluations_total",
      "netaware_policy_train_steps_total",
      "netaware_netmodel_sgd_steps_total")),
])
def test_learning_layers_start_from_flags_and_config(tmp_path, extra,
                                                     families):
    """The learning layers' flags and config fields start their layers:
    each family shows once on ``/metrics``, ``/debug/slo`` and
    ``/debug/policy`` answer, and the daemon stops cleanly."""
    if isinstance(extra, dict):
        cfgp = tmp_path / "cfg.json"
        cfgp.write_text(json.dumps(extra))
        extra = ["--config", str(cfgp)]
    uds = str(tmp_path / "scorer.sock")
    stop = threading.Event()
    result = {}
    th = threading.Thread(
        target=lambda: result.setdefault("rc", serve.main(
            _argv(tmp_path, *extra, "--probe-period-s", "0.05"), stop)),
        daemon=True)
    th.start()
    try:
        body = ""
        for _ in range(400):
            if os.path.exists(uds):
                body = call_uds(uds, "/metrics", b"").decode()
                if all(f"# TYPE {f} " in body for f in families):
                    break
            stop.wait(0.05)
        types_ = [ln.split()[2] for ln in body.splitlines()
                  if ln.startswith("# TYPE ")]
        for family in families:
            assert types_.count(family) == 1, family
        assert len(types_) == len(set(types_))
        slo = json.loads(call_uds(uds, "/debug/slo", b""))
        policy = json.loads(call_uds(uds, "/debug/policy", b""))
        assert set(slo) == {"slo", "quality"}
        assert policy["enabled"] is (
            "netaware_policy_train_steps_total" in families)
    finally:
        stop.set()
        th.join(60.0)
    assert not th.is_alive()
    assert result.get("rc") == 0


def _metric(body: str, name: str, label: str = "") -> float:
    """Sum of a family's samples (those carrying ``label`` if given)."""
    total = 0.0
    for ln in body.splitlines():
        if ln.startswith(name) and ln[len(name):len(name) + 1] in " {":
            if label in ln:
                total += float(ln.rsplit(" ", 1)[1])
    return total


@pytest.mark.parametrize("extra,family", [
    (["--rebalance"], "netaware_rebalance_scans_total"),
    (["--audit-interval", "0.05"], "netaware_integrity_audits_total"),
    (["--state-chaos", "0.05"], "netaware_state_faults_injected_total"),
    ({"audit_interval_s": 0.05}, "netaware_integrity_audits_total"),
])
def test_robustness_flags_start_their_layers(tmp_path, extra, family):
    """Each flag (or config field) starts its layer: the family shows on
    ``/metrics`` with a count above 0 while the daemon runs, and the
    daemon stops cleanly."""
    if isinstance(extra, dict):
        cfgp = tmp_path / "cfg.json"
        cfgp.write_text(json.dumps(extra))
        extra = ["--config", str(cfgp)]
    uds = str(tmp_path / "scorer.sock")
    stop = threading.Event()
    result = {}
    th = threading.Thread(
        target=lambda: result.setdefault("rc", serve.main(
            _argv(tmp_path, *extra), stop)), daemon=True)
    th.start()
    try:
        body = ""
        for _ in range(400):
            if os.path.exists(uds):
                body = call_uds(uds, "/metrics", b"").decode()
                if _metric(body, family) > 0:
                    break
            stop.wait(0.05)
        assert _metric(body, family) > 0, family
        rb = json.loads(call_uds(uds, "/debug/rebalance", b""))
        assert rb["enabled"] is (extra == ["--rebalance"])
        if family == "netaware_integrity_audits_total":
            assert _metric(body, "netaware_integrity_unrepaired_total") == 0
    finally:
        stop.set()
        th.join(60.0)
    assert not th.is_alive()
    assert result.get("rc") == 0


def _robust_metric_headers(pkg) -> list[str]:
    """The ``# HELP``/``# TYPE`` lines and sample label sets of the
    robustness families, after one audit, injections and a rebalancer
    tick in either package."""
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=12, seed=3))
    cfg = pkg.cfg(max_nodes=16, max_pods=8, max_peers=2,
                  enable_rebalance=True, enable_gang_reshaping=True)
    loop = pkg.loop(cluster, cfg, **pkg.kw)
    try:
        loop.encoder.set_network(lat, bw)
        loop.integrity = pkg.integrity.IntegrityAuditor(loop.encoder, loop)
        loop.state_chaos = pkg.chaos.StateChaosInjector(loop.encoder,
                                                        seed=2, loop=loop)
        loop.state_chaos.inject("delta_drop")
        loop.integrity.audit_once()
        loop.maintain()
        body = pkg.metrics.render_metrics(loop)
    finally:
        loop.stop_bind_worker()
    prefixes = ("netaware_integrity_", "netaware_state_faults_",
                "netaware_rebalance_", "netaware_gang_reshape")
    out = []
    for ln in body.splitlines():
        name = ln.split()[2] if ln.startswith("#") else ln.split("{")[0]
        if not name.split()[0].startswith(prefixes):
            continue
        out.append(ln if ln.startswith("#") else ln.rsplit(" ", 1)[0])
    return out


def test_robustness_metric_families_match_jax():
    from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
    from kubernetesnetawarescheduler_tpu.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu.core import integrity as jint
    from kubernetesnetawarescheduler_tpu.core import loop as jloop
    from kubernetesnetawarescheduler_tpu.core import state_chaos as jsc
    from kubernetesnetawarescheduler_tpu.utils import selfmetrics as jsm
    from kubernetesnetawarescheduler_tpu_torch.bench import (
        fakecluster as tfc,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import (
        SchedulerConfig as TCfg,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import integrity as tint
    from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
    from kubernetesnetawarescheduler_tpu_torch.core import state_chaos as tsc
    from kubernetesnetawarescheduler_tpu_torch.utils import (
        selfmetrics as tsm,
    )

    want = _robust_metric_headers(types.SimpleNamespace(
        fc=jfc, cfg=SchedulerConfig, loop=jloop.SchedulerLoop, kw={},
        integrity=jint, chaos=jsc, metrics=jsm))
    got = _robust_metric_headers(types.SimpleNamespace(
        fc=tfc, cfg=TCfg, loop=tloop.SchedulerLoop, kw={"device": "cpu"},
        integrity=tint, chaos=tsc, metrics=tsm))
    assert got == want
    types_ = [ln.split()[2] for ln in got if ln.startswith("# TYPE ")]
    assert len(types_) == len(set(types_)) >= 20
    assert "# TYPE netaware_gang_reshape_total counter" in got


def test_device_defaults_to_the_card(tmp_path):
    argv = ["--cluster", "fake:16", "--uds", str(tmp_path / "s.sock"),
            "--once"]
    assert serve._parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    assert not os.path.exists(tmp_path / "s.sock")


def test_cache_and_profile_flags(tmp_path, monkeypatch):
    """``--compilation-cache-dir`` moves the kernel build directory;
    ``--jax-profile-dir`` writes a torch.profiler Chrome trace."""
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    cache, prof = tmp_path / "kcache", tmp_path / "prof"
    assert serve.main(_argv(tmp_path, "--compilation-cache-dir", str(cache),
                            "--jax-profile-dir", str(prof), "--once")) == 0
    assert kernels.BUILD_DIR == cache and cache.is_dir()
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_module_entry_point_runs_once(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "kubernetesnetawarescheduler_tpu_torch",
         "--cluster", "fake:16", "--uds", str(tmp_path / "s.sock"),
         "--device", "cpu", "--once"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "scorer serving on uds://" in out.stderr
