"""The harness: its last line, its data-driven lookup, its guards."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import run, trace
from benchmark.tests.conftest import ROOT, cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_has_the_five_keys_then_the_checks(tiny):
    root, bench = tiny
    name = "k8s5000-standalone.saturation"
    out = run.measure(bench, cell(bench, name), 5, 1.0, False, "cpu",
                      time.perf_counter(), root=root)
    out.pop("reference_s")
    out.pop("diag")
    line = json.loads(json.dumps(out))
    assert list(line) == KEYS + ["checks"]
    assert set(line["metrics"]) == {"pods_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_run_reports_the_per_layer_metrics(tiny):
    root, bench = tiny
    name = "k8s5000-standalone.saturation"
    out = run.measure(bench, cell(bench, name), 6, 1.5, True, "cpu",
                      time.perf_counter(), root=root)
    assert {"encode_ms.drain", "score_assign_ms.drain",
            "rounds_per_batch.drain", "bind_ms.drain"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_latency_cell_reports_its_share_then_its_traced_p99(tiny):
    root, bench = tiny
    w = cell(bench, "k8s5000-standalone.latency-pods")
    out = run.measure(bench, w, 7, 1.0, False, "cpu", time.perf_counter(),
                      root=root)
    assert set(out["metrics"]) == {"pods_bound_in_100ms_pct", "setup_s"}
    assert 0 <= out["metrics"]["pods_bound_in_100ms_pct"]["value"] <= 100
    out = run.measure(bench, w, 7, 1.0, True, "cpu", time.perf_counter(),
                      root=root)
    assert out["metrics"]["pod_latency_p99_ms.latency"]["value"] > 0


def test_latency_readers():
    """The share counts unbound pods as late; the traced p99 reads only
    the pods due before the profiled stretch."""
    rec = {"latency_s": [0.01, 0.05, 0.2, 0.02],
           "latency_due_s": [0.0, 1.0, 2.0, 3.0], "attempted": 5,
           "failed": 1}
    share = run.reader("pods_bound_in_100ms_pct").read(rec, None)
    assert share == pytest.approx(60.0)
    p99 = run.reader("pod_latency_p99_ms.latency")
    assert p99.read(rec, None) is None
    rec["failed"] = 0
    assert p99.read(rec, None) == pytest.approx(200.0)
    rec["stretch_at_s"] = 1.5
    assert p99.read(rec, None) == pytest.approx(50.0)


def test_new_config_traffic_and_metric_are_found_by_name(tiny):
    """A cell added by files and entries alone, with no edit to the
    harness's code."""
    root, bench = tiny
    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "tiny.json").read_text())
    cfg["cluster"]["nodes"] = 64
    (here / "configs" / "other.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "saturation.json").read_text())
    mix["pods"] = 2000
    (here / "traffic" / "small-backlog.json").write_text(json.dumps(mix))
    (here / "limits" / "other.small-backlog.json").write_text(
        (here / "limits" / "k8s5000-standalone.saturation.json")
        .read_text())
    (here / "metrics" / "cycles_seen.py").write_text(
        '"""Cycles the window served."""\n\n\n'
        'def read(rec, ctx):\n    return rec["cycles"]\n')
    bench["configs"].append({"name": "other", "source": "https://x",
                             "file": "benchmark/configs/other.json",
                             "reduced": [], "why": "a test"})
    new = {"name": "other.small-backlog", "config": "other",
           "traffic": "small-backlog", "chips": 1, "why": "a test"}
    bench["workloads"].append(new)
    bench["end_to_end"].append({"name": "cycles_seen", "unit": "cycles",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["other.small-backlog"]})
    out = run.measure(bench, new, 9, 1.0, False, "cpu", time.perf_counter(),
                      root=root)
    assert out["correct"]
    assert out["metrics"]["cycles_seen"]["value"] > 0


def test_main_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "k8s5000-standalone.saturation", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    """Import every module of the benchmark (and through it the port) in
    a fresh process; no top-level module name may be jax, jaxlib, flax or
    the JAX package, each compared whole (the port's own name begins
    with the JAX package's)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import benchmark\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "import benchmark.drivers.standalone as d\n"
        "d._api_server_class()\n"
        "from benchmark.spans import Recorder\n"
        "r = Recorder(); r.install(); r.undo()\n"
        "from benchmark import run\n"
        "print(','.join(run.loaded_forbidden()))\n"
        "print('kubernetesnetawarescheduler_tpu_torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                               "TMPDIR": os.environ.get("TMPDIR", str(tmp_path))})
    assert proc.returncode == 0, proc.stderr
    forbidden, port = proc.stdout.split("\n")[:2]
    assert forbidden == ""
    assert port == "True"


def test_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import benchmark.reference.scheduler, benchmark.generate\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0].startswith("
            "'kubernetesnetaware')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kubernetesnetawarescheduler_tpu_x",
                        sys)
    assert "kubernetesnetawarescheduler_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.loaded_forbidden()


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "bench.encode",
         "ts": 0.0, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "ts": 40.0, "dur": 10.0,
         "name": "(anonymous namespace)::static_scores_kernel(NetIn)"},
        {"ph": "X", "cat": "kernel", "ts": 45.0, "dur": 10.0,
         "name": "void at::native::reduce_kernel<512, 1>(float)"},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 60.0, "dur": 1.0},
    ]
    out = trace.reduce_events(ev)
    assert out["busy_s"] == pytest.approx(15e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["kernels"] == pytest.approx(
        {"static_scores_kernel": 10e-6, "reduce_kernel": 10e-6})
    assert out["idle"] == pytest.approx({"encode": 40e-6, "host": 45e-6})
    assert out["host_syncs"] == 1


@pytest.mark.gpu
def test_saturation_on_the_card(cuda):
    """A short window of the real cell on the card comes out correct and
    reads every metric its BENCHMARK.json entries name."""
    bench = run.load_json(ROOT / "BENCHMARK.json")
    w = cell(bench, "k8s5000-standalone.saturation")
    out = run.measure(bench, w, 2**31 + 77, 10.0, False, cuda,
                      time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}
    assert out["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_latency_pods_on_the_card(cuda):
    bench = run.load_json(ROOT / "BENCHMARK.json")
    w = cell(bench, "k8s5000-standalone.latency-pods")
    out = run.measure(bench, w, 2**31 + 78, 10.0, False, cuda,
                      time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"pods_bound_in_100ms_pct", "setup_s"}
