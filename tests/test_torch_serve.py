"""The port's daemon (``serve.py``) on the CPU, on the shapes of
``tests/test_serve.py``: ``--once`` with checkpoint save and restore, a
checkpoint of another cluster ignored, the UDS server answering while the
daemon runs, a ``kube:<url>`` drive against the port's fake API server,
each flag or config field of an unported layer refused with its ROADMAP
item, and ``--device`` defaulting to the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
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
    (["--quality-obs"], 12), (["--slo"], 12), (["--learned-score"], 12),
    (["--policy-eval-trace", "t.jsonl"], 12), (["--rebalance"], 11),
    (["--audit-interval", "5"], 11), (["--state-chaos", "1"], 11),
    (["--mesh"], 15), (["--multihost"], 15),
    (["--coordinator", "h:1"], 15), (["--num-processes", "2"], 15),
    (["--process-id", "0"], 15),
    ({"enable_netmodel": True}, 12), ({"enable_quality_obs": True}, 12),
    ({"audit_interval_s": 3.0}, 11),
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
