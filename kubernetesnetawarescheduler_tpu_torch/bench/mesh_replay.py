"""The mesh-sharded density replay against the single-device one, one
process per rank.

Run it under torchrun, one rank per card (NCCL picks itself when every
rank has a card of its own):

    torchrun --nproc-per-node 4 -m \\
        kubernetesnetawarescheduler_tpu_torch.bench.mesh_replay --dp 2 --tp 2

Every rank generates the same seeded ``synthetic_density`` workload on the
host and keeps its shard on its device; rank 0 also replays it on one
device.  Each mesh drive is timed on every rank (host clock, ending in a
copy of the assignment to the host) after an untimed two-batch warm-up.
Rank 0 prints one JSON line: per drive, each rank's pods/s, collectives
and host syncs per batch, kernel launches, ``max_memory_allocated`` and
``lat``/``bw`` shapes, and whether its assignments equal the
single-device replay's.  The exit code is 1 when any rank's assignments
differ.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch
import torch.distributed as dist

from kubernetesnetawarescheduler_tpu_torch.bench.density import (
    synthetic_density,
)
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import kernels
from kubernetesnetawarescheduler_tpu_torch.core.replay import replay_stream
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    host_flag,
    tree_map,
)
from kubernetesnetawarescheduler_tpu_torch.parallel.sharding import (
    Mesh,
    sharded_replay_stream,
)

DRIVES = (("pallas", False), ("pallas", True), ("xla", True))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device, reset: bool = False) -> int:
    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def workload(nodes: int, pods: int, batch: int, seed: int = 0):
    """``(base_cfg, state, stream)``: the seeded ``synthetic_density``
    workload on the host, which every rank generates alike."""
    base = SchedulerConfig(max_nodes=nodes, max_pods=batch, max_peers=4)
    state, stream = synthetic_density(nodes, pods, base, seed=seed,
                                      device="cpu")
    return base, state, stream


def run(mesh: Mesh, base: SchedulerConfig, state, stream,
        drives=DRIVES) -> dict:
    """Every drive of ``drives`` (``(score_backend, use_bfloat16)`` over
    ``base``) on ``mesh``, each against rank 0's single-device replay.
    Collective: every rank calls it alike.  Returns rank 0's report
    (other ranks get ``{}``); each rank's record holds its kernels'
    launches in the timed drive, counted from 0 just before it."""
    dev = mesh.device
    batch = base.max_pods
    n_valid = int(stream.pod_valid.sum())
    batches = stream.num_pods // batch
    warm = stream.slice(0, 2 * batch)
    report = {"mesh": mesh.shape, "backend": mesh.backend,
              "nodes": base.max_nodes, "pods": stream.num_pods,
              "batch": batch, "drives": {}}
    for backend, bf16 in drives:
        cfg = dataclasses.replace(base, score_backend=backend,
                                  use_bfloat16=bf16)
        key = f"{backend}_{'bf16' if bf16 else 'f32'}"
        solo = None
        if mesh.rank == 0:
            full = tree_map(lambda x: x.to(dev), state)
            replay_stream(full, warm.to(dev), cfg)
            _sync(dev)
            _peak(dev, reset=True)
            t0 = time.perf_counter()
            res = replay_stream(full, stream.to(dev), cfg)
            solo = res[0].cpu()
            solo_s = time.perf_counter() - t0
            solo_mem = _peak(dev)
            del res, full
        sharded_replay_stream(state, warm, cfg, mesh)
        _sync(dev)
        _peak(dev, reset=True)
        kernels.reset_launch_counts()
        s0, c0 = host_flag.syncs, mesh.collectives
        t0 = time.perf_counter()
        assignment, fin, rounds = sharded_replay_stream(
            state, stream, cfg, mesh, with_stats=True)
        assignment = assignment.cpu()
        wall = time.perf_counter() - t0
        rec = {"pods_per_s": n_valid / wall, "batches": batches,
               "collectives_per_batch": (mesh.collectives - c0) / batches,
               "host_syncs_per_batch": (host_flag.syncs - s0) / batches,
               "rounds_mean": sum(rounds) / len(rounds),
               "rounds_max": max(rounds),
               "launches": {n: fn.launches
                            for n, fn in kernels.KERNELS.items()},
               "max_memory_allocated": _peak(dev),
               "lat_shape": list(fin.lat.shape),
               "bw_shape": list(fin.bw.shape)}
        del fin
        recs = [None] * mesh.size
        dist.all_gather_object(recs, (rec, assignment))
        if mesh.rank == 0:
            report["drives"][key] = {
                "solo": {"pods_per_s": n_valid / solo_s,
                         "max_memory_allocated": solo_mem},
                "ranks": [r for r, _ in recs],
                "identical": all(torch.equal(a, solo) for _, a in recs)}
    return report if mesh.rank == 0 else {}


def main(argv=None) -> int:
    from kubernetesnetawarescheduler_tpu_torch.parallel.multihost import (
        global_mesh,
        init_multihost,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5120)
    ap.add_argument("--pods", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    init_multihost()
    try:
        mesh = global_mesh(args.dp, args.tp, device=args.device)
        report = run(mesh, *workload(args.nodes, args.pods, args.batch,
                                     args.seed))
    finally:
        dist.destroy_process_group()
    if report:
        if mesh.device.type == "cuda":
            report["device"] = torch.cuda.get_device_name(mesh.device)
        print(json.dumps(report), flush=True)
        if not all(d["identical"] for d in report["drives"].values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
