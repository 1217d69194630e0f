"""Fixtures of the benchmark's own tests.

    python3 -m pytest benchmark/tests -q            # CPU; gpu tests skip
    python3 -m pytest benchmark/tests -q -m gpu     # on the card

The ``gpu`` marker is registered here, since ``tests/conftest.py`` is not
loaded for this folder; whether a card is present is decided inside the
``cuda`` fixture, never while a module is imported.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def pytest_configure(config) -> None:
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def tiny_config() -> dict:
    """A configuration at a size a CPU test holds: 96 nodes, batches of
    16."""
    with open(HERE / "configs" / "k8s5000-standalone.json",
              encoding="utf-8") as fh:
        cfg = json.load(fh)
    cfg["cluster"]["nodes"] = 96
    cfg["scheduler"].update(max_nodes=128, max_pods=16, queue_capacity=5000)
    return cfg


# Cells whose files are here and whose entries are not in BENCHMARK.json
# (PERF.md, Open questions): the tests drive them all the same.
LATENCY = {"name": "k8s5000-standalone.latency-pods",
           "config": "k8s5000-standalone", "traffic": "latency-pods",
           "chips": 1, "why": "a test"}


TINY_TRAFFIC = {
    "saturation": {"pods": 3000, "peer_lag": 128, "trace_at_s": 0.3,
                   "trace_s": 0.3},
    "latency-pods": {"bound_per_node": 5, "rate_per_s": 20.0, "warm_s": 0.5,
                     "trace_at_s": 0.3, "trace_s": 0.3, "grace_s": 5.0},
}


@pytest.fixture
def tiny(tmp_path):
    """``(root, bench)``: a copy of the benchmark's data files under
    ``root`` with a tiny configuration and tiny mixes in place of the
    real ones, and the ``BENCHMARK.json`` that names them."""
    dst = tmp_path / "benchmark"
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(HERE / sub, dst / sub)
    (dst / "configs").mkdir()
    with open(dst / "configs" / "tiny.json", "w", encoding="utf-8") as fh:
        json.dump(tiny_config(), fh)
    for mix, over in TINY_TRAFFIC.items():
        path = dst / "traffic" / f"{mix}.json"
        data = json.loads(path.read_text())
        data.update(over)
        path.write_text(json.dumps(data))
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as fh:
        bench = copy.deepcopy(json.load(fh))
    for c in bench["configs"]:
        c["file"] = "benchmark/configs/tiny.json"
    if not any(w["name"] == LATENCY["name"] for w in bench["workloads"]):
        bench["workloads"].append(dict(LATENCY))
    return tmp_path, bench


def cell(bench: dict, name: str) -> dict:
    return next(w for w in bench["workloads"] if w["name"] == name)
