"""Multi-process meshes: joining the process group and the global mesh.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/parallel/
multihost.py``.  torch drives one device per process, so a mesh of R
ranks is R processes (``--multihost``, one per rank, or torchrun).  JAX's
"process" maps to a host here and its "local devices" to the ranks on
that host: ``LOCAL_WORLD_SIZE`` (torchrun sets it; 1 when unset, so a
process started without torchrun is a host of its own).

Axis placement follows the JAX package: ``tp`` (the node shard, whose
gathers run every conflict round) stays within a host, and ``dp`` (the
pod shard) goes across hosts; :func:`global_mesh` refuses a ``tp`` group
that spans hosts.

The collective backend is an argument: ``nccl`` when each rank has a
card of its own, ``gloo`` on the CPU and for ranks that share one card
(NCCL refuses two ranks on one device; gloo stages CUDA tensors through
the host).  :func:`default_backend` picks by that rule; it never picks by
catching an NCCL error.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from kubernetesnetawarescheduler_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
)

# How long a rank waits at the coordinator's store for the others to join
# (JAX's ``initialization_timeout``).
BOOTSTRAP_TIMEOUT = datetime.timedelta(seconds=300)
# How long a collective may wait.  A follower waits in the header
# broadcast for as long as the controller is idle, which JAX's psum does
# without limit; an idle cluster must not end its followers.
COLLECTIVE_TIMEOUT = datetime.timedelta(days=365)


def ranks_per_host() -> int:
    """``LOCAL_WORLD_SIZE`` (torchrun's ranks on this host), 1 when
    unset."""
    return max(1, int(os.environ.get("LOCAL_WORLD_SIZE", "1")))


def default_backend(device="cuda") -> str:
    """``nccl`` when ``device`` is a CUDA device and this host has a card
    for each of its ranks, else ``gloo``."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= ranks_per_host()):
        return "nccl"
    return "gloo"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> None:
    """Join (or bootstrap) the process group.

    With ``coordinator_address`` (``host:port``, rank 0 listening there)
    the group forms over a TCP store from ``num_processes`` and
    ``process_id``, which must then be given (a rank that waits there
    longer than :data:`BOOTSTRAP_TIMEOUT` raises); without it, from the
    environment torchrun sets (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``).  ``backend`` defaults to :func:`default_backend`.

    Idempotent: a second call (``dist.is_initialized()``) is a no-op.
    Bootstrap failures PROPAGATE, a missing environment included:
    degrading to one process here would turn an N-rank deployment into N
    independent schedulers.  A single-process deployment that only wants
    a mesh on its card does not call this (``serve.py --mesh`` without
    ``--multihost``)."""
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    if coordinator_address:
        host, sep, port = coordinator_address.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"coordinator address {coordinator_address!r} "
                             "is not host:port")
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not a rank of "
                             f"{num_processes} processes")
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0,
                              timeout=BOOTSTRAP_TIMEOUT)
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id,
                                timeout=COLLECTIVE_TIMEOUT)
        return
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, init_method="env://",
                            timeout=COLLECTIVE_TIMEOUT, **kw)


def global_mesh(dp: int | None = None, tp: int | None = None,
                device="cuda") -> Mesh:
    """A ``(dp, tp)`` mesh over every rank, ``tp`` within a host.

    Defaults: ``dp`` = the hosts, ``tp`` = the ranks per host
    (:func:`ranks_per_host`): one pod shard per host, the node axis
    sharded over each host's ranks.  Any explicit ``(dp, tp)`` is
    accepted if it covers every rank and keeps each ``tp`` group on one
    host; a group that spans hosts raises instead of running the
    per-round tp gathers across the slow network.  Collective (it builds
    the mesh's groups)."""
    world = dist.get_world_size()
    local = ranks_per_host()
    if world % local != 0:
        raise ValueError(f"{world} ranks do not fill hosts of {local}")
    if dp is None and tp is None:
        dp, tp = world // local, local
    if dp is None:
        dp = world // tp
    if tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} must cover all {world} ranks")
    for d in range(dp):
        hosts = {(d * tp + t) // local for t in range(tp)}
        if len(hosts) > 1:
            raise ValueError(
                f"tp={tp} spans hosts {sorted(hosts)}: the conflict loop's "
                "per-round gathers over tp would cross hosts. Pick tp <= "
                f"ranks-per-host ({local}) with hosts grouped under dp.")
    return make_mesh(dp, tp, device=device)


__all__ = ["init_multihost", "global_mesh", "default_backend",
           "ranks_per_host"]
