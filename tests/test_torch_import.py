"""Package rules of the PyTorch port: it imports without JAX and without
the JAX package, its entry points default to CUDA and never fall back to
the CPU silently, its kernel wrappers take the plain version only for CPU
tensors, and its density generator is deterministic for a seed."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu_torch.bench.density import (
    synthetic_density,
)
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import kernels, tiled_score
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    init_cluster_state,
    init_pod_batch,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import pkgutil, sys, importlib
sys.modules["jax"] = None
sys.modules["kubernetesnetawarescheduler_tpu"] = None
import kubernetesnetawarescheduler_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m.startswith("kubernetesnetawarescheduler_tpu.")
             if sys.modules[m] is not None)
assert not bad, bad
print(" ".join(names))
"""

# Every module of the port, the scheduling loop's included: the walk above
# must find (and so import) each of them.
_MODULES = {
    "config", "bench.density", "bench.fakecluster", "bench.profile_replay",
    "core.assign", "core.checkpoint", "core.encode", "core.gang",
    "core.integrity", "core.kernels", "core.loop", "core.preempt",
    "core.replay", "core.score", "core.state", "core.tiled_score",
    "k8s.client", "k8s.informer", "k8s.types", "utils.flight",
    "utils.timeseries", "utils.tracing",
    # The webhook and the daemon.
    "api", "api.extender", "api.server", "api.grpc_server",
    "utils.selfmetrics", "bench.extender_qps", "bench.daemon_smoke",
    "bench.fakeapi", "ingest", "ingest.prometheus", "ingest.iperf",
    "ingest.native", "ingest.scraper", "ingest.probe", "k8s.kubeclient",
    "k8s.conformance", "serve", "__main__",
    # Robustness: the auditor, the injectors and the rebalancer.
    "core.rebalance", "core.state_chaos", "k8s.chaos",
    # The learning layers: the topology model and its planner, the
    # quality observer and the SLO engine, the learned scoring policy.
    "netmodel", "netmodel.model", "netmodel.planner", "obs",
    "obs.quality", "obs.slo", "policy", "policy.model", "policy.dataset",
    "policy.replay_eval",
    # The scenario engine and the bench suite's frame and legs.
    "scenario", "scenario.generate", "scenario.replay", "scenario.scorecard",
    "bench.suite", "bench.envinfo", "bench.artifact",
}


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    prefix = "kubernetesnetawarescheduler_tpu_torch."
    walked = {name[len(prefix):] for name in out.stdout.split()}
    assert _MODULES <= walked, sorted(_MODULES - walked)


def test_entry_points_default_to_cuda():
    cfg = SchedulerConfig(max_nodes=8, max_pods=4, max_peers=2)
    if torch.cuda.is_available():
        assert init_cluster_state(cfg).metrics.device.type == "cuda"
        return
    for fn in (init_cluster_state, init_pod_batch):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_density(8, 4, cfg, seed=0)


def test_kernel_wrappers_take_plain_version_for_cpu_tensors():
    cfg = SchedulerConfig(max_nodes=64, max_pods=16, max_peers=4,
                          use_bfloat16=False)
    state, stream = synthetic_density(50, 16, cfg, seed=3, device="cpu")
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.uniform(0, 5, (16, 64)).astype(np.float32))
    pack = tiled_score.static_replay_pack(state, cfg)
    pods = tiled_score.pack_pods(
        init_pod_batch(cfg, device="cpu", req=stream.req,
                       pod_valid=stream.pod_valid), state.num_nodes)
    pods = dataclasses.replace(pods, t=t)
    kernels.reset_launch_counts()
    raw, ok = kernels.static_tile_scores(pack, state.group_bits, pods, False)
    raw_p, ok_p = kernels.static_tile_scores_plain(pack, state.group_bits,
                                                   pods, False)
    assert torch.equal(raw, raw_p) and torch.equal(ok, ok_p)
    out = kernels.masked_tile_scores(pack, state.used, state.cap,
                                     state.group_bits, state.resident_anti,
                                     pods, False)
    assert out.shape == (16, 64)
    assert kernels.static_tile_scores.launches == 0
    assert kernels.masked_tile_scores.launches == 0


def test_synthetic_density_is_deterministic():
    cfg = SchedulerConfig(max_nodes=64, max_pods=32, max_peers=4)
    a_state, a_stream = synthetic_density(60, 200, cfg, seed=11,
                                          device="cpu")
    b_state, b_stream = synthetic_density(60, 200, cfg, seed=11,
                                          device="cpu")
    for x, y in ((a_state, b_state), (a_stream, b_stream)):
        for name, arr in x.numpy().items():
            np.testing.assert_array_equal(arr, y.numpy()[name],
                                          err_msg=name)
    c_state, _ = synthetic_density(60, 200, cfg, seed=12, device="cpu")
    assert not torch.equal(a_state.bw, c_state.bw)
    # Shapes of the bench's density defaults.
    assert a_stream.num_pods == 224
    assert int(a_stream.pod_valid.sum()) == 200
    assert bool((a_stream.peer_pods < 200).all())
    placed_before = a_stream.peer_pods // cfg.max_pods
    batch_of = (torch.arange(224) // cfg.max_pods)[:, None]
    assert bool(((a_stream.peer_pods < 0) | (placed_before < batch_of))
                .all())
