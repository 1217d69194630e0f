"""Device-resident replay: the whole pending-pod stream, batch after batch.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/core/replay.py``.
The stream is shipped to the device once, and a Python loop drives batch
after batch of score → assign → commit on the device; the JAX package's
``lax.scan`` becomes that loop.  Peers inside the stream (traffic to an
earlier pod of the same service) are carried as stream indices and
resolved on the device against the assignments made so far.

The chunked feeds (:func:`replay_stream_pipelined`,
:func:`replay_stream_pipelined_feed`) yield the replay chunk by chunk.
The JAX package keeps a window of chunks in flight through asynchronous
dispatch; here ``assign_parallel`` returns to the host every conflict
round, so a chunk worker thread runs up to ``dispatch_window`` chunks
ahead of the consumer instead (:func:`_windowed_drain`), and each
chunk's assignment comes back through a pinned side-stream copy
(:func:`_prefetch_to_host`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core.assign import (
    UNASSIGNED,
    assign_greedy,
    assign_greedy_spmd,
    assign_parallel,
    assign_parallel_spmd,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    POD_DTYPES,
    ClusterState,
    PodBatch,
    _TensorTree,
    commit_assignments,
    commit_assignments_shard,
    concat_shards,
    resolve_device,
    to_tensor,
)
from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
    compute_assign_static,
)
from kubernetesnetawarescheduler_tpu_torch.utils.tracing import span


@dataclasses.dataclass
class PodStream(_TensorTree):
    """A whole workload of pending pods, columnar.  Same per-pod fields
    as :class:`~.state.PodBatch` except the peer encoding:
    ``peer_pods[i, k] >= 0`` names another stream index whose eventual
    node is the traffic endpoint, ``peer_nodes[i, k]`` a peer placed
    before the replay started (-1 = none).  Bit masks are i32."""

    req: torch.Tensor            # f32[S, R]
    peer_pods: torch.Tensor      # i32[S, K]
    peer_nodes: torch.Tensor     # i32[S, K]
    peer_traffic: torch.Tensor   # f32[S, K]
    tol_bits: torch.Tensor       # i32[S, W]
    sel_bits: torch.Tensor
    affinity_bits: torch.Tensor
    anti_bits: torch.Tensor
    group_bit: torch.Tensor
    priority: torch.Tensor       # f32[S]
    pod_valid: torch.Tensor      # bool[S]
    soft_sel_bits: torch.Tensor  # i32[S, T, W]
    soft_sel_w: torch.Tensor     # f32[S, T]
    soft_grp_bits: torch.Tensor
    soft_grp_w: torch.Tensor
    soft_zone_bits: torch.Tensor
    soft_zone_w: torch.Tensor
    group_idx: torch.Tensor      # i32[S]
    spread_maxskew: torch.Tensor  # i32[S]
    spread_hard: torch.Tensor    # bool[S]
    ns_anyof: torch.Tensor       # i32[S, T2, E, W]
    ns_forbid: torch.Tensor      # i32[S, T2, W]
    ns_term_used: torch.Tensor   # bool[S, T2]
    ns_num_col: torch.Tensor     # i32[S, T2, NE]
    ns_num_lo: torch.Tensor      # f32[S, T2, NE]
    ns_num_hi: torch.Tensor      # f32[S, T2, NE]
    zaff_bits: torch.Tensor      # i32[S, W]
    zanti_bits: torch.Tensor     # i32[S, W]

    @property
    def num_pods(self) -> int:
        return self.req.shape[0]

    def slice(self, start: int, stop: int) -> "PodStream":
        return PodStream(**{f.name: getattr(self, f.name)[start:stop]
                            for f in dataclasses.fields(self)})

    def to(self, device: torch.device) -> "PodStream":
        """The stream on ``device`` (itself when it is there already)."""
        return PodStream(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


_STREAM_DTYPES = dict(POD_DTYPES, peer_pods=torch.int32,
                      peer_nodes=torch.int32)
_PAD_FILL = dict(peer_pods=-1, peer_nodes=-1, group_idx=-1, ns_num_col=-1,
                 ns_num_lo=float("-inf"), ns_num_hi=float("inf"))


def stream_from_numpy(cfg: SchedulerConfig, stream_np: dict,
                      device="cuda") -> PodStream:
    """A :class:`PodStream` from numpy arrays keyed by field name (for
    example ``np.asarray`` of every leaf of a JAX ``PodStream``); u32
    masks become i32 through a bit-preserving view."""
    dev = resolve_device(device)
    return PodStream(**{
        f.name: to_tensor(stream_np[f.name], _STREAM_DTYPES[f.name], dev)
        for f in dataclasses.fields(PodStream)})


def pad_stream(stream: PodStream, multiple: int) -> PodStream:
    """Pad the stream with invalid pods up to a multiple of ``multiple``."""
    s = stream.num_pods
    target = ((s + multiple - 1) // multiple) * multiple
    if target == s:
        return stream
    out = {}
    for f in dataclasses.fields(stream):
        x = getattr(stream, f.name)
        pad = torch.full((target - s,) + tuple(x.shape[1:]),
                         _PAD_FILL.get(f.name, 0), dtype=x.dtype,
                         device=x.device)
        out[f.name] = torch.cat([x, pad])
    return PodStream(**out)


def fold_stream(stream: PodStream, cfg: SchedulerConfig) -> list[PodStream]:
    """Validate the stream length and cut it into ``cfg.max_pods``-sized
    batches (views, in stream order)."""
    s_total = stream.num_pods
    batch = cfg.max_pods
    if s_total % batch != 0:
        raise ValueError(f"stream length {s_total} not a multiple of "
                         f"max_pods={batch}")
    return [stream.slice(i, i + batch) for i in range(0, s_total, batch)]


def batch_from_stream(sl: PodStream, node_of_pod: torch.Tensor) -> PodBatch:
    """The :class:`PodBatch` of one stream slice, with in-stream peers
    resolved against the assignments made so far.  A peer that is still
    unplaced (or unschedulable) stays -1 and the scorer drops it."""
    s_total = node_of_pod.shape[0]
    pp = sl.peer_pods
    from_stream = node_of_pod[pp.clamp(0, s_total - 1).long()]
    peers = torch.where(pp >= 0, from_stream, sl.peer_nodes)
    fields = {f.name: getattr(sl, f.name)
              for f in dataclasses.fields(PodBatch)
              if f.name not in ("peers",)}
    return PodBatch(peers=peers, **fields)


def _make_step(state: ClusterState, cfg: SchedulerConfig, method: str,
               static, mesh=None):
    """The per-batch body shared by the replay variants.  Carry is
    ``(used, group_bits, resident_anti, gz_counts, az_anti,
    node_of_pod)``: only the placement-mutated tensors; the large
    immutable state is closed over.  Returns ``(carry, assignment,
    rounds)``; ``node_of_pod`` is updated in place (the replay owns it).

    A callable ``static`` is a per-batch builder ``(st, pods) -> (raw,
    ok)`` (or a tile dict) whose result goes to the assigner as its
    precomputed pair.  With a ``mesh``, ``state`` is the rank's node
    shard and the step is the SPMD one (:func:`~.assign.
    assign_parallel_spmd`, :func:`~.state.commit_assignments_shard`);
    every batch is whole on every rank.

    Spans (:func:`~..utils.tracing.span`): ``replay.batch`` over each
    step, ``replay.commit`` over its commit."""
    batch = cfg.max_pods
    if mesh is not None:
        node_zone = concat_shards(mesh, state.node_zone, "tp")
        rows = state.num_nodes
        off, n = mesh.tp_index * rows, rows * mesh.tp

    def run(carry, i: int, sl: PodStream):
        (used, group_bits, resident_anti, gz_counts, az_anti,
         node_of_pod) = carry
        st = state.replace(used=used, group_bits=group_bits,
                           resident_anti=resident_anti,
                           gz_counts=gz_counts, az_anti=az_anti)
        pods = batch_from_stream(sl, node_of_pod)
        batch_static = static
        if callable(static):
            out = static(st, pods)
            batch_static = (out if isinstance(out, dict)
                            else {"raw": out[0], "ok": out[1]})
        if method not in ("parallel", "greedy"):
            raise ValueError(f"unknown method {method!r}")
        if mesh is not None:
            if method == "parallel":
                assignment, rounds = assign_parallel_spmd(
                    st, pods, cfg, mesh, batch_static, with_stats=True,
                    node_zone=node_zone)
            else:
                assignment = assign_greedy_spmd(st, pods, cfg, mesh,
                                                batch_static,
                                                node_zone=node_zone)
                rounds = 0
            with span("replay.commit"):
                st = commit_assignments_shard(st, pods, assignment, off, n,
                                              node_zone)
        else:
            if method == "parallel":
                assignment, rounds = assign_parallel(
                    st, pods, cfg, batch_static, with_stats=True)
            else:
                assignment = assign_greedy(st, pods, cfg, batch_static)
                rounds = 0
            with span("replay.commit"):
                st = commit_assignments(st, pods, assignment)
        node_of_pod[i * batch:(i + 1) * batch] = assignment
        return ((st.used, st.group_bits, st.resident_anti, st.gz_counts,
                 st.az_anti, node_of_pod), assignment, rounds)

    def step(carry, i: int, sl: PodStream):
        with span("replay.batch"):
            return run(carry, i, sl)

    return step


def _initial_carry(state: ClusterState, s_total: int):
    """The replay's carry before its first batch: the placement-mutated
    planes of ``state`` and an all-unassigned ``node_of_pod``."""
    return (state.used, state.group_bits, state.resident_anti,
            state.gz_counts, state.az_anti,
            torch.full((s_total,), UNASSIGNED, dtype=torch.int32,
                       device=state.device))


def replay_folded(state: ClusterState, folded: list[PodStream],
                  cfg: SchedulerConfig, method: str = "parallel",
                  static=None, with_stats: bool = False,
                  batch_hook=None, static_builder=None, mesh=None):
    """Run pre-folded batches through score → assign → commit.  The
    batch-invariant static prep is computed ONCE here unless ``static``
    is given.  ``batch_hook(i, "start" | "end")``, if given, is called
    around each batch (timing).

    ``static_builder``, if given, replaces that prep: called once with
    the state, it returns the static, or a per-batch callable ``(st,
    pods) -> (raw, static_ok)`` (the row-shard kernel route of
    ``parallel.sharding.pallas_static_builder``).  With a ``mesh`` the
    replay is the SPMD one: ``state`` is the rank's node shard, the
    batches are whole on every rank, every rank calls it (collective),
    and the final state is the rank's shard."""
    if method not in ("parallel", "greedy"):
        raise ValueError(f"unknown method {method!r}")
    s_total = len(folded) * cfg.max_pods
    if static_builder is not None:
        static = static_builder(state)
    elif static is None:
        static = compute_assign_static(state, cfg)
    step = _make_step(state, cfg, method, static, mesh)
    carry = _initial_carry(state, s_total)
    assignments, rounds = [], []
    for i, sl in enumerate(folded):
        if batch_hook is not None:
            batch_hook(i, "start")
        carry, assignment, r = step(carry, i, sl)
        if batch_hook is not None:
            batch_hook(i, "end")
        assignments.append(assignment)
        rounds.append(r)
    used, group_bits, resident_anti, gz_counts, az_anti, _ = carry
    final_state = state.replace(used=used, group_bits=group_bits,
                                resident_anti=resident_anti,
                                gz_counts=gz_counts, az_anti=az_anti)
    assignment = (torch.cat(assignments) if assignments else
                  torch.zeros((0,), dtype=torch.int32, device=state.device))
    if with_stats:
        return assignment, final_state, rounds
    return assignment, final_state


def replay_stream(state: ClusterState, stream: PodStream,
                  cfg: SchedulerConfig, method: str = "parallel",
                  with_stats: bool = False):
    """Run the full stream through score → assign → commit on the device.
    Returns ``(assignment i32[S], final_state)``, plus the per-batch
    conflict-round counts (a list of ints) with ``with_stats=True``.
    The stream length must be a multiple of ``cfg.max_pods``
    (:func:`pad_stream`)."""
    return replay_folded(state, fold_stream(stream, cfg), cfg, method,
                         with_stats=with_stats)


def replay_stream_static(state: ClusterState, stream: PodStream, static,
                         cfg: SchedulerConfig, method: str = "parallel",
                         with_stats: bool = False):
    """:func:`replay_stream` with the batch-invariant static prep passed
    in (a serving path caches it across bursts) instead of recomputed."""
    return replay_folded(state, fold_stream(stream, cfg), cfg, method,
                         static=static,
                         with_stats=with_stats)


def _replay_chunk(step, carry, batches: list[PodStream], batch_start: int):
    """One chunk of the chunked replays: its batches, the first being
    global batch ``batch_start``, through ``step``.  Returns ``(carry,
    assignment i32[len(batches) * batch], rounds list)``.  The JAX
    package compiles a whole-stream and a feed variant of this body; here
    both feeds pass their chunk's batches to this one loop."""
    assignments, rounds = [], []
    for off, sl in enumerate(batches):
        carry, a, r = step(carry, batch_start + off, sl)
        assignments.append(a)
        rounds.append(int(r))
    return carry, torch.cat(assignments), rounds


def _prefetch_to_host(a: torch.Tensor):
    """Start the copy of ``a`` to the host: ``(host tensor, event)``.

    On the card the copy goes into a pinned buffer with
    ``non_blocking=True`` on a side stream that first waits for the
    compute stream, and ``event`` is recorded after it: the consumer
    waits on the event, never on a synchronizing ``.cpu()``.  The
    source is marked as used on the side stream, so the allocator does
    not hand its memory out again before the copy reads it.  On a CPU
    tensor it is a plain copy and ``event`` is None."""
    if a.device.type != "cuda":
        return a.clone(), None
    compute = torch.cuda.current_stream(a.device)
    side = torch.cuda.Stream(device=a.device)
    host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        host.copy_(a, non_blocking=True)
        a.record_stream(side)
        event = torch.cuda.Event()
        event.record(side)
    return host, event


def _windowed_drain(run_next, dispatch_window: int):
    """The chunk window of the chunked replays: a worker thread runs
    chunks up to ``dispatch_window`` ahead of the consumer.

    ``run_next()`` runs one chunk on the worker thread (which owns the
    replay's carry) and returns ``(pod_start, assignment tensor,
    rounds list)``, or False once the stream is exhausted.  The worker
    starts HERE, at call time, and copies each chunk's assignment to the
    host through :func:`_prefetch_to_host`; the returned generator
    yields ``(pod_start, np.ndarray assignment, np.ndarray rounds)`` in
    stream order and is the only place that waits for results.  An
    exception on the worker (a chunk, or the feed's producer iterator,
    which the worker consumes) is re-raised in the consumer after the
    chunks before it; closing the generator early stops the worker
    after its current chunk."""
    slots = threading.Semaphore(max(1, int(dispatch_window)))
    done: queue.Queue = queue.Queue()
    stop = threading.Event()

    def worker() -> None:
        try:
            while True:
                slots.acquire()
                if stop.is_set():
                    return
                item = run_next()
                if item is False:
                    done.put(("end", None))
                    return
                pod_start, assignment, rounds = item
                done.put(("chunk", (pod_start,
                                    _prefetch_to_host(assignment), rounds)))
        except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
            done.put(("error", exc))

    thread = threading.Thread(target=worker, name="replay-chunks",
                              daemon=True)
    thread.start()

    def drain():
        try:
            while True:
                kind, val = done.get()
                if kind == "end":
                    return
                if kind == "error":
                    raise val
                slots.release()
                pod_start, (host, event), rounds = val
                if event is not None:
                    event.synchronize()
                yield (pod_start, host.numpy(),
                       np.asarray(rounds, dtype=np.int32))
        finally:
            stop.set()
            slots.release()
            thread.join()

    return drain()


def _stream_chunks(stream: PodStream, chunk_pods: int):
    """``stream`` in chunks of ``chunk_pods`` pods (views; the last may
    be shorter)."""
    for a in range(0, stream.num_pods, chunk_pods):
        yield stream.slice(a, a + chunk_pods)


def replay_stream_pipelined(state: ClusterState, stream: PodStream,
                            cfg: SchedulerConfig, method: str = "parallel",
                            chunk_batches: int = 8,
                            dispatch_window: int = 4):
    """Chunked replay for the pipelined drain: yields ``(start_pod_index,
    assignment np.ndarray, rounds np.ndarray)`` per chunk of
    ``chunk_batches`` batches, in stream order (``rounds`` is the
    per-batch conflict-round count of the chunk's batches; the final
    chunk may be shorter).  A worker thread runs up to
    ``dispatch_window`` chunks ahead of the consumer
    (:func:`_windowed_drain`), so the card runs chunk ``i+1`` while the
    caller binds chunk ``i``.  It is :func:`replay_stream_pipelined_feed`
    fed with the stream's own chunks.

    SETUP IS EAGER (at call time, before the generator is returned): the
    length check, the stream's move to the state's device, the static
    prep and the start of the worker.  A caller timing per-chunk service
    latency takes its clock after this call returns."""
    s_total = stream.num_pods
    if s_total % cfg.max_pods != 0:
        raise ValueError(f"stream length {s_total} not a multiple of "
                         f"max_pods={cfg.max_pods}")
    chunks = _stream_chunks(stream.to(state.device),
                            chunk_batches * cfg.max_pods)
    return replay_stream_pipelined_feed(state, chunks, s_total, cfg, method,
                                        dispatch_window)


def replay_stream_pipelined_feed(state: ClusterState, chunk_iter,
                                 s_total: int, cfg: SchedulerConfig,
                                 method: str = "parallel",
                                 dispatch_window: int = 4):
    """Chunked replay fed by an encode producer: consumes
    :class:`PodStream` chunks from ``chunk_iter`` (each a positive
    multiple of ``cfg.max_pods`` pods, concatenating to ``s_total``) and
    yields ``(start_pod_index, assignment, rounds)`` per chunk, in
    order — the contract of :func:`replay_stream_pipelined`.

    The whole-stream variant needs the workload encoded and uploaded
    before its first chunk; here the host encode (a producer thread
    running ``Encoder.encode_stream_chunks``) overlaps the drain.
    ``chunk_iter`` is consumed on the chunk worker, so a producer that
    raises fails the drain in the consumer, as does a chunk of the
    wrong length (``ValueError``).  The length check and the static
    prep run at call time."""
    if method not in ("parallel", "greedy"):
        raise ValueError(f"unknown method {method!r}")
    batch = cfg.max_pods
    if s_total % batch != 0:
        raise ValueError(
            f"stream length {s_total} not a multiple of max_pods={batch}")
    nb = s_total // batch
    step = _make_step(state, cfg, method, compute_assign_static(state, cfg))
    box = {"carry": _initial_carry(state, s_total), "start": 0}
    it = iter(chunk_iter)

    def run_next():
        start = box["start"]
        try:
            ch = next(it)
        except StopIteration:
            if start != nb:
                raise ValueError(
                    f"chunk iterator ended at batch {start} of {nb}")
            return False
        cp = ch.num_pods
        if cp % batch != 0 or cp == 0:
            raise ValueError(
                f"chunk of {cp} pods is not a positive multiple of "
                f"max_pods={batch}")
        cb = cp // batch
        if start + cb > nb:
            raise ValueError(
                f"chunks overrun s_total={s_total} at batch {start}+{cb}")
        box["carry"], assignment, rounds = _replay_chunk(
            step, box["carry"], fold_stream(ch.to(state.device), cfg),
            start)
        box["start"] = start + cb
        return start * batch, assignment, rounds

    return _windowed_drain(run_next, dispatch_window)
