"""Profile the density replay on the card: where a batch's time goes.

    python3 -m kubernetesnetawarescheduler_tpu_torch.bench.profile_replay \
        [--backend pallas|xla]

Replays ``WARMUP`` batches of the density backlog (5,120 nodes, batches
of 128, bench.py's shape) so in-stream peers resolve as they would
mid-run, then profiles the next ``BATCHES`` with ``torch.profiler``.
Prints one JSON object: per-batch wall time, the device's busy and idle
share, kernel launches and host syncs per batch, conflict rounds, the
device time of each hand-written kernel, and the top operators by device
time and by host time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from kubernetesnetawarescheduler_tpu_torch.bench.density import (
    synthetic_density,
)
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import kernels
from kubernetesnetawarescheduler_tpu_torch.core.replay import (
    UNASSIGNED,
    _make_step,
    fold_stream,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import host_flag
from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
    compute_assign_static,
)

NODES, BATCH = 5120, 128  # bench.py's density shape
WARMUP, BATCHES = 40, 24
# The CUDA kernels of csrc/tiled_score.cu, as the profiler names them.
TILE_KERNELS = ("peer_flags_kernel", "peer_scan_kernel",
                "peer_traffic_kernel", "static_scores_kernel",
                "masked_scores_kernel", "winner_scores_kernel",
                "winner_finalize_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="pallas", choices=("pallas", "xla"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay needs a CUDA device")
    cfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=4,
                          score_backend=args.backend)
    total = WARMUP + BATCHES
    state, stream = synthetic_density(NODES, total * BATCH, cfg, seed=0,
                                      device="cuda")
    folded = fold_stream(stream, cfg)
    step = _make_step(state, cfg, "parallel", compute_assign_static(state,
                                                                     cfg))
    carry = (state.used, state.group_bits, state.resident_anti,
             state.gz_counts, state.az_anti,
             torch.full((stream.num_pods,), UNASSIGNED, dtype=torch.int32,
                        device="cuda"))
    for i in range(WARMUP):
        carry, _, _ = step(carry, i, folded[i])
    torch.cuda.synchronize()
    host_flag.syncs = 0
    kernels.reset_launch_counts()
    rounds = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(WARMUP, total):
            carry, _, r = step(carry, i, folded[i])
            rounds.append(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    nb = BATCHES
    avg = prof.key_averages()
    # Kernel rows (device_type CUDA) hold the device time; operator rows
    # also carry the device time of the kernels they launched.
    gpu = [e for e in avg if e.self_device_time_total > 0
           and str(e.device_type).endswith("CUDA")]
    kernel_us = sum(e.self_device_time_total for e in gpu)
    launches = sum(int(e.count) for e in gpu)
    top_dev = sorted(avg, key=lambda e: e.self_device_time_total,
                     reverse=True)[:15]
    top_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(json.dumps({
        "card": smi, "backend": args.backend,
        "use_bfloat16": cfg.use_bfloat16, "batches": nb,
        "batch_wall_ms": wall / nb * 1e3,
        "device_busy_ms_per_batch": kernel_us / nb / 1e3,
        "device_idle_share": 1.0 - kernel_us / 1e6 / wall,
        "device_ops_per_batch": launches / nb,
        "host_syncs_per_batch": host_flag.syncs / nb,
        "rounds_mean": sum(rounds) / nb,
        "tile_kernel_launches": {k: f.launches
                                 for k, f in kernels.KERNELS.items()},
        "tile_kernel_device_us_per_batch": {
            k: sum(e.self_device_time_total for e in gpu if k in e.key) / nb
            for k in TILE_KERNELS},
        "top_device_us_per_batch": [
            [e.key, e.self_device_time_total / nb, int(e.count) / nb]
            for e in top_dev],
        "top_host_self_us_per_batch": [
            [e.key, e.self_cpu_time_total / nb, int(e.count) / nb]
            for e in top_cpu],
    }))


if __name__ == "__main__":
    main()
