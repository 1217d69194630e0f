#!/usr/bin/env python3
"""Drive the PyTorch port's density replay, serving seam, scheduling
loop, Score/Filter webhook, device-replay feeds, robustness layers,
learning layers and scenario engine on one NVIDIA GPU and check them.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA tile kernels from ``kubernetesnetawarescheduler_tpu_torch/
csrc`` and prints one JSON object per phase:

1. ``device``   the card (``nvidia-smi`` name and power limit), torch and
                CUDA versions, the kernels' build time and ``ptxas``
                report; fails if a score kernel spills.
2. ``kernels``  each kernel against its plain PyTorch version on the card
                at P=128, N=5120, with ``use_bfloat16`` off and on, on a
                stream batch and on a dense seeded traffic matrix: the
                peer-column compaction identical to its plain version;
                each score kernel over the compacted columns
                bit-identical to the same kernel over every column;
                masks identical and scores within rtol=atol=1e-4; the
                winner's ``best`` within the same bar, its ``node``
                identical on every row whose plain top-two gap exceeds
                it, and both identical to ``winner_from_scores`` of the
                masked kernel.  Kernel, plain and library-yardstick
                times, each call with the L2 cache flushed before it,
                and each kernel's bound from the bytes and operations
                this batch needs.
3. ``main``     the density replay: a 65,536-pod backlog on 5,120 nodes
                (bench.py's shape) through ``replay_stream`` with the
                kernel backend, then Score/Filter answers
                (``score_pods_auto``) for a few pending batches against the
                final state.  Fails unless the static kernel ran once per
                batch, the answer kernel ran, the peer columns were
                compacted once per static and answer launch, no node
                exceeds its capacity, and every placed pod sits on a node
                its plain static mask allows.
4. ``parity``   the first 16 batches replayed at f32 through the kernel
                path and the dense torch path: identical assignments.
5. ``serve``    the serving seam: a generated 5,120-node cluster through
                the ``Encoder``, then 64 batches of 128 pods, each encoded
                (peers resolved against the pods placed so far),
                snapshotted, given an incremental static prep, answered by
                the fused winner (``score_winner_auto``), placed by
                ``fused_schedule_step`` with its state digest and committed
                back into the encoder, with link and metric churn every 8
                batches.  Fails unless the winner kernel ran once per
                batch and agrees with the two-stage winner, the peer
                columns were compacted once per score kernel launch, the
                fused step equals ``assign_parallel`` +
                ``commit_assignments``, every
                digest equals the host digest of the state, every
                incremental prep equals a full one, the final snapshot
                equals ``expected_device_arrays()``, no node exceeds its
                capacity, and a batch with live nodeAffinity terms takes
                the masked kernel instead of the winner.  Then
                ``measure_device_latency`` at the same size.
6. ``loop``     the scheduling loop (``SchedulerLoop``) at the serving
                width: a 2,048-pod backlog (``serve``'s workload) drained
                by fresh loops on 5,120-node fake clusters through the
                serial, burst (8 batches), pipelined and multicycle (K=8,
                coalesced async binds) paths.  Fails unless the four give
                the same bindings, final ``used`` and counters, each
                non-serial path engaged, the static kernel ran at least
                once per real batch with one compaction per launch, and
                no node exceeds its capacity.  Then ``run_density(5120,
                8192, batch_size=128, mode="host")`` with the default burst
                and pipelined (pods/s, per-batch phase percentiles,
                rounds, static refreshes and kernel launches, reported
                without a bar); a ``generate_gang_workload`` backlog that
                must bind every gang whole or not at all, each gang the
                gate released accounted bound or rolled back; and a
                checkpoint of the density loop's encoder saved and loaded
                into a fresh ``Encoder(device="cuda")``, whose manifest
                must verify and whose snapshot must equal the saved one
                bit for bit.
7. ``webhook``  the Score/Filter webhook at deploy/scorer.yaml's config
                (5,120 nodes, ``max_pods`` 256, ``max_peers`` 8): the
                masked kernel against its plain version on the batcher's
                own encoded batches at P = 8 … 256; 64 seeded
                ExtenderArgs (half with peers; 1, 16, 512 and 5,120
                candidates) from 16 clients under the kernel backend and
                the dense backend on one state, which must give identical
                filter lists and priorities at f32 (ties within 1e-4·span
                of a rounding boundary counted; at bf16 the two round
                different operands and their differences are reported);
                masked-kernel launches equal
                to the batcher's dispatches with one compaction each;
                one ``/prioritize`` of all 5,120 candidates through
                ``call_uds`` and through the native shim (``make -C
                native``) over HTTP, per backend; the daemon
                (``serve.main``, ``fake:5120``) answering ``/filter``,
                ``/prioritize``, ``/readyz`` and ``/metrics`` (no repeated
                ``# TYPE``) over its socket; ``drain_daemon(512, 2048)``
                against the fake API server, every pod bound exactly
                once; and ``run_qps`` under both backends (32 sequential
                requests, then 128 clients × 2,048 requests).
8. ``feed``     the chunked device-replay feeds and explain capture:
                bench.py's headline drain, ``run_density(5120, 65536,
                batch_size=128, mode="pipeline", chunk_batches=16,
                churn_links=4)`` with the kernel backend (its warm-up
                replays the stream once), which must bind or leave
                unschedulable every pod exactly once, leave no node over
                capacity, launch the static kernel once per batch with one
                compaction each, and whose 200th measured static launch is
                held against the plain version; the identity drive
                (16,384 pods, no churn): ``mode="host"``, ``"device"`` and
                ``"pipeline"`` with encode overlap on and off must bind
                alike (the dense backend's pipeline drain is reported);
                ``measure_multicycle_latency(5120, 128, k=8, reps=10)`` and
                ``multicycle_identity_check()``, which must be identical;
                and the ``loop`` phase's backlog over the serial, burst,
                pipelined and multicycle paths plus a gang backlog with
                ``enable_explain`` on and off: the same bindings, a record
                for every bound pod naming its node, winners whose
                components sum to their score, ``explains_failed`` 0, and
                the host ms per captured batch.
9. ``robust``   the robustness layers at 5,120 nodes: a 2,048-pod drain,
                its checkpoint, 20 clean audits (p50/p99 ms) and
                ``run_state_fault_matrix`` under an ``IntegrityAuditor``
                (every runtime fault detected and repaired bit for bit),
                staging NaN healed at the ``checkpoint_restore`` rung,
                each rung timed alone, and each ``checkpoint_corrupt``
                mode refused on a copy; the ``loop`` phase's backlog on a
                pipelined loop with and without an audit at every
                ``maintain()`` (identical bindings, ``used`` and counters,
                every audit clean, the static kernel once per real batch,
                one launch held against its plain version);
                ``run_chaos_soak(seed=7, num_nodes=5120, num_pods=2048,
                state_faults=True)`` on the dense ``"xla"`` path
                (recovered, invariants 0, every state fault detected and
                none unrepaired); ``run_density``'s 8,192-pod drain with
                ``enable_rebalance``, two nodes cordoned and one tick past
                the age bar (the scan on the card equal to the same scan
                on the CPU, at most ``rebalance_max_moves_per_cycle``
                moves, each with a positive gain, all completed, the
                invariants 0 but for the migrated pods' second bindings);
                an 8-member shaped gang reshaped after a node loss; and
                the daemon at ``fake:5120`` with ``--audit-interval 1
                --state-chaos 0.5 --rebalance`` for 10 s (its families on
                ``/metrics`` once each, no unrepaired drift,
                ``/debug/rebalance`` enabled, a clean shutdown).
10. ``learn``   the learning layers at 5,120 nodes: the topology model
                fit over ``LEARN_CYCLES`` probe cycles of 64 picked by the
                EIG planner (the JAX suite's topology leg: ``BW_LAT``
                weights, 36 Adam steps per refit), with the card's
                ``_predict_dense`` equal to the CPU's (rtol 1e-5), the
                blended snapshot equal to ``expected_device_arrays()``,
                the static kernel on the blended planes equal to its
                plain version, and 16 gangs of 8 judged on the sparse,
                blended and oracle planes (reported); the ``loop`` phase's
                backlog, burst and pipelined, with quality, SLO and policy
                off and on (identical bindings), then pipelined with the
                model attached (a clean audit, ``netmodel_blend`` explain
                records, an outcome for every bound pod with a resolvable
                peer, the harvest on the card equal to the CPU's, policy
                steps and shadow ranks, every gate decision
                ``no_replay_trace``, SLO evaluations); and the daemon with
                ``--quality-obs --slo --learned-score`` and
                ``enable_netmodel`` for 10 s (the families once each,
                ``/debug/slo`` and ``/debug/policy``, a clean shutdown).
11. ``scenario`` the scenario engine: the bench suite's campaign
                (``run_scenario_config``: 256 nodes in three classes,
                batch 256, every knob on) with its virtual duration cut
                to ``SCENARIO_DURATION_S``, which must give a clean
                scorecard, no pod dropped from the queue or lost, no
                half-moved gang, every state fault repaired, and names
                bound twice only among the evicted pods, each twice (its
                wall split by part and the loop's phases reported); the
                JAX tests' state-fault replay on the card (faults
                applied and repaired, ≥ 90% bound); a knobs-off trace of
                the campaign's spec at 5,120 nodes whose ``pod_waves``
                drain through the loop under ``"xla"`` and ``"pallas"``
                (each pod bound or unschedulable once, no node over
                capacity, ≥ 1 static launch per wave with one compaction
                each, one launch held against its plain version, the
                bindings the backends share reported); the suite's policy
                leg (``run_policy_config``: bindings identical with the
                policy attached, the loser refused by the records leg
                before any replay, the winner's decision and ratios
                reported); and the daemon at ``fake:512`` with
                ``--learned-score --policy-eval-trace`` on the leg's
                trace, which must finish a gate evaluation, with its
                replays on the card, and stop every thread it started.

Then a ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  A failed check fails its phase; every
phase still runs, and the script then exits 1 without the last line.
Without a CUDA device it exits 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

SEED = 0
NODES, PODS, BATCH, PEERS = 5120, 65536, 128, 4
ANSWER_BATCHES = 8
PARITY_BATCHES = 16
SERVE_PODS, SERVE_BATCHES, CHURN_EVERY = 8192, 64, 8
LOOP_PODS, DENSITY_PODS, GANG_FILLER = 2048, 8192, 256
# The webhook phase: deploy/scorer.yaml's config.json (max_pods 256,
# max_peers 8), the pod-axis sizes the batcher pads to, the requests'
# candidate counts, the bench legs and the daemon drain.
WEBHOOK_MAX_PODS, WEBHOOK_PEERS = 256, 8
WEBHOOK_P = (8, 16, 32, 64, 128, 256)
WEBHOOK_SETUP_PODS, WEBHOOK_REQUESTS = 512, 64
WEBHOOK_CANDS = (1, 16, 512, NODES)
QPS_SEQ, QPS_CLIENTS, QPS_REQUESTS = 32, 128, 2048
DRAIN_NODES, DRAIN_PODS = 512, 2048
HOP_REPS = 50
TOL = 1e-4
FLUSH_BYTES = 256 << 20   # > the H100's 50 MB L2
SPIN_CYCLES = 2_000_000   # ≈1 ms at the H100's clocks
# Published H100 rates by part (memory bytes/s, f32 FLOP/s without tensor
# cores); the card's name picks the row.
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "SXM": (3.35e12, 67e12)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(Exception):
    """A check of a phase failed; :func:`run_phase` reports it."""


FAILED: list[str] = []


def fail(phase: str, msg: str) -> None:
    raise CheckFailed(f"{phase}: {msg}")


def run_phase(name: str, fn, *args):
    """Run one phase; a failed check or an error fails the phase (one
    ``{"phase": name, "ok": false}`` line) and the next phase runs."""
    try:
        return fn(*args)
    except CheckFailed as exc:
        emit({"phase": name, "ok": False, "error": str(exc)})
    except Exception:  # noqa: BLE001 - report it, then run the next phase
        emit({"phase": name, "ok": False,
              "error": traceback.format_exc()[-3000:]})
    FAILED.append(name)
    return None


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are checks, not the path: every kernel
    count is restored on exit."""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K

    saved = {name: fn.launches for name, fn in K.KERNELS.items()}
    try:
        yield
    finally:
        for name, fn in K.KERNELS.items():
            fn.launches = saved[name]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float]:
    for part, rates in PEAKS.items():
        if part in name:
            return rates
    return PEAKS["SXM"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, with the 50 MB L2 cache
    flushed before each call (a ``FLUSH_BYTES`` buffer is written), as a
    caller that moves on to a new batch finds it.  CUDA events bracket
    each call; a spin kernel after the flush keeps the card busy while
    the host enqueues the call, so host time is not counted."""
    for _ in range(warmup):
        fn()
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device="cuda")
    marks = []
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_spills(log: str) -> dict:
    """``{function: [spill store bytes, spill load bytes]}`` from an
    ``nvcc -Xptxas -v`` report."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name] = [int(m.group(1)), int(m.group(2))]
    return out


def phase_device() -> dict:
    from kubernetesnetawarescheduler_tpu_torch.core import kernels

    smi = nvidia_smi()
    t0 = time.perf_counter()
    kernels.build_library()
    build_s = time.perf_counter() - t0
    log = kernels.build_library.log
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    spills = {}
    for kname in ("static_scores_kernel", "masked_scores_kernel",
                  "winner_scores_kernel", "peer_flags_kernel",
                  "peer_scan_kernel"):
        hits = [v for f, v in ptxas_spills(log).items() if kname in f]
        spills[kname] = hits[0] if hits else None
    info = {"phase": "device", "ok": True, "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device_name": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "build_s": build_s, "nvcc_s": kernels.build_library.seconds,
            "spills": spills, "ptxas": ptxas}
    # The peer-walk kernels must keep their register tiles unspilled.
    for kname in ("static_scores_kernel", "masked_scores_kernel",
                  "winner_scores_kernel"):
        if spills[kname] is None or any(spills[kname]):
            emit({**info, "ok": False})
            fail("device", f"ptxas reports spills for {kname}: "
                 f"{spills[kname]}")
    emit(info)
    return info


def kernel_inputs(cfg, state, stream):
    """A realistic batch for the kernel check: stream batch 8 with its
    in-stream peers resolved against a seeded random placement, on a
    state with seeded usage, group residency and resident anti bits."""
    from kubernetesnetawarescheduler_tpu_torch.core.replay import (
        batch_from_stream,
    )

    rng = np.random.default_rng(SEED + 7)
    dev = state.device
    n, s = state.num_nodes, stream.num_pods
    node_of = torch.from_numpy(rng.integers(0, n, s).astype(np.int32)).to(dev)
    sl = stream.slice(8 * cfg.max_pods, 9 * cfg.max_pods)
    pods = batch_from_stream(sl, node_of)
    w = cfg.mask_words
    frac = torch.from_numpy(rng.uniform(0.0, 0.7, (n, cfg.num_resources))
                            .astype(np.float32)).to(dev)
    groups = np.zeros((n, w), np.int32)
    groups[:, 0] = rng.integers(0, 1 << 20, n) & rng.integers(0, 1 << 20, n)
    ranti = np.zeros((n, w), np.int32)
    ranti[:, 0] = np.where(rng.random(n) < 0.05, 1 << rng.integers(0, 20, n),
                           0)
    state = state.replace(
        used=state.cap * frac,
        group_bits=torch.from_numpy(groups).to(dev),
        resident_anti=torch.from_numpy(ranti).to(dev))
    return state, pods


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def dense_walk(n_k: int):
    """``peers`` that walk every column: the dense accumulation."""
    return (torch.arange(n_k, dtype=torch.int32, device="cuda"),
            torch.tensor([n_k], dtype=torch.int32, device="cuda"))


def compare_kernels(pack, st, groups, pp, bf16, label):
    """Run the compaction, both peer-walk kernels and their plain
    versions on one batch; fail on a compaction that differs from its
    plain version, on compacted-column outputs that are not bit-identical
    to the same kernel's dense walk, on any mask difference, or on a
    score outside rtol=atol=TOL.  Returns the two max abs errors (static
    raw, masked feasible score) and the batch's peer-column count."""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K

    n_k = pp.t.shape[1]
    where = f"({label}, bf16={bf16})"
    cols, count = K.peer_columns(pp.t)
    cols_p, count_p = K.peer_columns_plain(pp.t)
    if not (torch.equal(cols, cols_p) and torch.equal(count, count_p)):
        fail("kernels", f"peer columns differ from the plain version {where}")
    margs = (pack, st.used, st.cap, groups, st.resident_anti, pp, bf16)
    raw_k, ok_k = K.static_tile_scores(pack, groups, pp, bf16)
    raw_p, ok_p = K.static_tile_scores_plain(pack, groups, pp, bf16)
    raw_t, ok_t = K.static_tile_scores(pack, groups, pp, bf16,
                                       transposed=True)
    raw_d, ok_d = K.static_tile_scores(pack, groups, pp, bf16,
                                       peers=dense_walk(n_k))
    out_k = K.masked_tile_scores(*margs)
    out_p = K.masked_tile_scores_plain(*margs)
    out_d = K.masked_tile_scores(*margs, peers=dense_walk(n_k))
    torch.cuda.synchronize()
    if not (torch.equal(bits(raw_k), bits(raw_d)) and torch.equal(ok_k, ok_d)
            and torch.equal(bits(out_k), bits(out_d))):
        fail("kernels", f"the peer-column walk differs from the dense walk "
             f"{where}: static raw {int((bits(raw_k) != bits(raw_d)).sum())}"
             f", ok {int((ok_k != ok_d).sum())}, masked "
             f"{int((bits(out_k) != bits(out_d)).sum())} entries")
    if not torch.equal(ok_k, ok_p):
        fail("kernels", f"static mask differs {where}: "
             f"{int((ok_k != ok_p).sum())} entries")
    if not (torch.equal(raw_t, raw_k.T) and torch.equal(ok_t, ok_k.T)):
        fail("kernels", f"transposed static output differs {where}")
    m_k, m_p = out_k > -5e29, out_p > -5e29
    if not torch.equal(m_k, m_p):
        fail("kernels", f"masked-kernel feasibility differs {where}: "
             f"{int((m_k != m_p).sum())} entries")
    if not bool(m_k.any()):
        fail("kernels", f"masked kernel has no feasible entry {where}")
    err_s = float((raw_k - raw_p).abs().max())
    err_m = float((out_k[m_k] - out_p[m_p]).abs().max())
    if not torch.allclose(raw_k, raw_p, rtol=TOL, atol=TOL):
        fail("kernels", f"static raw differs {where}: {err_s}")
    if not torch.allclose(out_k[m_k], out_p[m_p], rtol=TOL, atol=TOL):
        fail("kernels", f"masked score differs {where}: {err_m}")
    return err_s, err_m, int(count)


def canonical_bits(best: torch.Tensor) -> torch.Tensor:
    """The bits of ``best`` with -0.0 read as +0.0 (the winner key packs
    the two as one value, as ``==`` does)."""
    return (best + 0.0).view(torch.int32)


def compare_winner(pack, st, groups, pp, bf16, label):
    """The winner kernel against its plain version (``best`` within
    rtol=atol=TOL, ``node`` identical on every row whose plain top-two gap
    exceeds the allclose bar), and against ``winner_from_scores`` of the
    masked kernel on the card and its own dense walk (both identical).
    Returns the max abs error of ``best`` and the number of rows whose
    node was held to the plain version."""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core.score import (
        winner_from_scores,
    )

    args = (pack, st.used, st.cap, groups, st.resident_anti, pp, bf16)
    best_k, node_k = K.winner_tile_scores(*args)
    best_d, node_d = K.winner_tile_scores(*args,
                                          peers=dense_walk(pp.t.shape[1]))
    scores_p = K.masked_tile_scores_plain(*args)
    best_p, node_p = winner_from_scores(scores_p)
    best_m, node_m = winner_from_scores(K.masked_tile_scores(*args))
    torch.cuda.synchronize()
    where = f"({label}, bf16={bf16})"
    if not torch.allclose(best_k, best_p, rtol=TOL, atol=TOL):
        fail("kernels", f"winner best differs {where}: "
             f"{float((best_k - best_p).abs().max())}")
    # A row's node is held to the plain one where its top-two gap exceeds
    # the allclose bar at the best's magnitude: closer rows may rank
    # either way within the bar.
    top2 = scores_p.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL + TOL * top2[:, 0].abs()
    if not torch.equal(node_k[clear], node_p[clear]):
        fail("kernels", f"winner node differs from the plain version "
             f"{where}: {int((node_k[clear] != node_p[clear]).sum())} rows")
    if not (torch.equal(node_k, node_m)
            and torch.equal(canonical_bits(best_k), canonical_bits(best_m))):
        fail("kernels", f"winner kernel differs from winner_from_scores of "
             f"the masked kernel {where}")
    if not (torch.equal(node_k, node_d)
            and torch.equal(canonical_bits(best_k), canonical_bits(best_d))):
        fail("kernels", f"the winner's peer-column walk differs from its "
             f"dense walk {where}: {int((node_k != node_d).sum())} nodes, "
             f"{int((canonical_bits(best_k) != canonical_bits(best_d)).sum())}"
             f" best values")
    if not bool((node_k >= 0).any()):
        fail("kernels", f"winner kernel found no feasible node {where}")
    return float((best_k - best_p).abs().max()), int(clear.sum())


def phase_kernels(state, stream, base_cfg, mem_bw, f32_peak):
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import tiled_score

    torch.backends.cuda.matmul.allow_tf32 = False
    st, pods = kernel_inputs(base_cfg, state, stream)
    n = st.num_nodes
    pack = tiled_score.static_replay_pack(st, base_cfg)
    pp = tiled_score.pack_pods(pods, n)
    groups = st.group_bits.contiguous()
    nnz = int((pp.t != 0).sum())
    p = pp.t.shape[0]
    # The stream batch's T is sparse (at most K peers per pod).  A dense
    # seeded T of the same shape drives every column, every T·C product
    # term and every bf16 rounding of T.
    rng = np.random.default_rng(SEED + 11)
    dense = dataclasses.replace(pp, t=torch.from_numpy(
        rng.uniform(0.0, 1.0, (p, n)).astype(np.float32)).to(st.device))
    # No traffic: a walk of zero steps, the epilogue and fixed costs.
    quiet = dataclasses.replace(pp, t=torch.zeros_like(pp.t))

    def bound(nb: float, ops: float) -> dict:
        t_bytes, t_ops = nb / mem_bw * 1e3, ops / f32_peak * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nb, "ops": ops}

    def needs(t_in, count: int) -> dict:
        """Bytes and operations that this batch needs, per kernel: T
        once, the bw/lat (and validk, cols) entries of its ``count`` peer
        columns, the node and pod planes, each output once; FLOPs
        2·nnz(T)·N.  The winner writes 8 bytes per pod instead of the
        P x N plane."""
        nz = int((t_in != 0).sum())
        ops = 2.0 * nz * n
        net = nbytes(t_in) + (2 * n + 2) * count * 4 + 4
        pod = nbytes(pp.pod_valid, pp.tol, pp.sel, pp.soft_sel, pp.soft_grp,
                     pp.soft_sel_w, pp.soft_grp_w)
        node = nbytes(pack.params, pack.base, pack.node_valid, pack.taint,
                      pack.label, groups)
        masked_more = nbytes(pp.req, pp.affinity, pp.anti, pp.group_bit,
                             st.resident_anti, st.used, st.cap)
        static_b = net + pod + node + p * n * (4 + 1)
        masked_b = net + pod + node + masked_more + p * n * 4
        return {"static_scores_kernel": bound(static_b, ops),
                "masked_scores_kernel": bound(masked_b, ops),
                "winner_scores_kernel": bound(masked_b - p * n * 4 + p * 8,
                                              ops),
                "peer_columns": bound(nbytes(t_in) + (n + 1) * 4,
                                      float(t_in.numel()))}

    # Yardstick: one library product of T with a precomputed Cᵀ.
    c_t = K.desirability_plain(pack).T.contiguous()
    wargs = (pack, st.used, st.cap, groups, st.resident_anti)
    results = {}
    for bf16 in (False, True):
        err_s, err_m, count = compare_kernels(pack, st, groups, pp, bf16,
                                              "stream batch")
        dense_s, dense_m, dense_count = compare_kernels(
            pack, st, groups, dense, bf16, "dense T")
        err_w, clear_w = compare_winner(pack, st, groups, pp, bf16,
                                        "stream batch")
        dense_w, dense_clear_w = compare_winner(pack, st, groups, dense,
                                                bf16, "dense T")
        if bf16:
            t_l, c_l = pp.t.to(torch.bfloat16), c_t.to(torch.bfloat16)
        else:
            t_l, c_l = pp.t, c_t
        lib_ms = time_ms(lambda: torch.matmul(t_l, c_l))
        need, dense_need = needs(pp.t, count), needs(dense.t, dense_count)

        def static_on(b, **kw):
            return lambda: K.static_tile_scores(pack, groups, b, bf16, **kw)

        def masked_on(b, **kw):
            return lambda: K.masked_tile_scores(*wargs, b, bf16, **kw)

        def winner_on(b, **kw):
            return lambda: K.winner_tile_scores(*wargs, b, bf16, **kw)

        walk = dense_walk(n)
        row = {}
        for name, kern, plain, err, dense_err, lib, extra in (
                ("static_scores_kernel", static_on(pp),
                 lambda: K.static_tile_scores_plain(pack, groups, pp, bf16),
                 err_s, dense_s, lib_ms,
                 {"dense_t_ms": time_ms(static_on(dense)),
                  "dense_walk_ms": time_ms(static_on(pp, peers=walk)),
                  "no_traffic_ms": time_ms(static_on(quiet))}),
                ("masked_scores_kernel", masked_on(pp),
                 lambda: K.masked_tile_scores_plain(*wargs, pp, bf16),
                 err_m, dense_m, lib_ms,
                 {"dense_t_ms": time_ms(masked_on(dense)),
                  "dense_walk_ms": time_ms(masked_on(pp, peers=walk)),
                  "no_traffic_ms": time_ms(masked_on(quiet))}),
                ("winner_scores_kernel", winner_on(pp),
                 lambda: K.winner_tile_scores_plain(*wargs, pp, bf16),
                 err_w, dense_w, lib_ms,
                 {"dense_t_ms": time_ms(winner_on(dense)),
                  "dense_walk_ms": time_ms(winner_on(pp, peers=walk)),
                  "no_traffic_ms": time_ms(winner_on(quiet)),
                  "node_rows_held": clear_w,
                  "dense_t_node_rows_held": dense_clear_w}),
                # No single library call returns the compacted columns.
                ("peer_columns", lambda: K.peer_columns(pp.t),
                 lambda: K.peer_columns_plain(pp.t), 0.0, 0.0, None, {})):
            row[name] = {
                "max_abs_err": err, "dense_t_max_abs_err": dense_err,
                "kernel_ms": time_ms(kern), "plain_ms": time_ms(plain),
                "library_ms": lib, **need[name],
                "dense_t_bound_ms": dense_need[name]["bound_ms"], **extra}
        results["bf16" if bf16 else "f32"] = row
        emit({"phase": "kernels", "ok": True, "use_bfloat16": bf16,
              "p": p, "n": n, "nnz_t": nnz, "count": count,
              "dense_t_count": dense_count, "l2": "flushed",
              "peak_bytes_per_s": mem_bw, "peak_f32_flops": f32_peak,
              "card": nvidia_smi(), **row})
    return results


def phase_main(state, stream, cfg):
    from kubernetesnetawarescheduler_tpu_torch.bench.density import (
        measure_replay,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import score as score_lib
    from kubernetesnetawarescheduler_tpu_torch.core.replay import (
        batch_from_stream,
        fold_stream,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state import host_flag
    from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
        compute_static,
        score_pods_auto,
    )

    folded = fold_stream(stream, cfg)
    nb = len(folded)
    answer = folded[:ANSWER_BATCHES]
    K.reset_launch_counts()
    host_flag.syncs = 0
    res = measure_replay(state, stream, cfg)
    final = res["final_state"]
    node_of = res["assignment"]
    static = compute_static(final, cfg)
    t0 = time.perf_counter()
    answers = [score_pods_auto(final, batch_from_stream(sl, node_of), cfg,
                               static) for sl in answer]
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    syncs = host_flag.syncs

    a = res["assignment"]
    placed = int((a >= 0).sum())
    valid = int(stream.pod_valid.sum())
    rounds = np.asarray(res["rounds"])
    info = {"phase": "main", "nodes": NODES, "pods": valid,
            "batches": nb, "pods_per_s": res["pods_per_s"],
            "wall_s": res["wall_s"], "batch_p50_ms": res["p50_ms"],
            "batch_p99_ms": res["p99_ms"],
            "batch_max_ms": float(res["batch_ms"].max()),
            "rounds": {"mean": float(rounds.mean()),
                       "p50": float(np.percentile(rounds, 50)),
                       "p99": float(np.percentile(rounds, 99)),
                       "max": int(rounds.max()),
                       "hist": np.bincount(rounds).tolist()},
            "host_syncs": syncs, "scheduled": placed,
            "unschedulable": valid - placed, "launches": launches,
            "answer_batches": len(answers), "answer_s": answer_s}
    if launches["static_scores_kernel"] != nb:
        fail("main", f"static kernel launched "
             f"{launches['static_scores_kernel']} times for {nb} batches")
    if launches["masked_scores_kernel"] < 1:
        fail("main", "the Score/Filter kernel was never launched")
    if launches["peer_columns"] != (launches["static_scores_kernel"]
                                    + launches["masked_scores_kernel"]):
        fail("main", f"peer columns compacted {launches['peer_columns']} "
             "times, not once per static and answer kernel launch")
    over = final.used > final.cap + score_lib._EPS
    if bool(over.any()):
        fail("main", f"{int(over.any(dim=1).sum())} nodes over capacity")
    # Every placed pod sits on a node its plain static mask allows.
    bad = 0
    for i, sl in enumerate(folded):
        ai = a[i * BATCH:(i + 1) * BATCH]
        pods = batch_from_stream(sl, node_of)
        ok = score_lib.static_feasibility(state, pods)
        hit = ok.gather(1, ai.clamp_min(0).long()[:, None])[:, 0]
        bad += int(((ai >= 0) & ~hit).sum())
    if bad:
        fail("main", f"{bad} placed pods violate the plain static mask")
    for s in answers:
        feas = s > -5e29
        if s.shape != (BATCH, NODES) or not bool(torch.isfinite(s).all()):
            fail("main", "Score/Filter answer has a bad shape or value")
        if not bool(feas.any()):
            fail("main", "Score/Filter answer has no feasible entry")
    # The kernel answer agrees with the dense torch reference at f32.
    cfg32 = dataclasses.replace(cfg, use_bfloat16=False)
    pods0 = batch_from_stream(answer[0], node_of)
    got = score_pods_auto(final, pods0, cfg32)
    want = score_lib.score_pods(final, pods0,
                                dataclasses.replace(cfg32,
                                                    score_backend="xla"))
    mg, mw = got > -5e29, want > -5e29
    if not torch.equal(mg, mw) or not torch.allclose(
            got[mg], want[mw], rtol=TOL, atol=TOL):
        fail("main", "Score/Filter answer disagrees with the dense path")
    info["answer_vs_dense_max_abs_err"] = float(
        (got[mg] - want[mw]).abs().max())
    info["ok"] = True
    emit(info)
    return info


def phase_parity(state, stream, cfg):
    from kubernetesnetawarescheduler_tpu_torch.core.replay import (
        replay_stream,
    )

    cfg32 = dataclasses.replace(cfg, use_bfloat16=False)
    sub = stream.slice(0, PARITY_BATCHES * BATCH)
    out = {}
    for backend in ("pallas", "xla"):
        c = dataclasses.replace(cfg32, score_backend=backend)
        a, _, rounds = replay_stream(state, sub, c, with_stats=True)
        out[backend] = (a, rounds)
    a_k, a_d = out["pallas"][0], out["xla"][0]
    diff = int((a_k != a_d).sum())
    info = {"phase": "parity", "pods": sub.num_pods, "differ": diff,
            "scheduled": int((a_k >= 0).sum()),
            "rounds_kernel": out["pallas"][1], "rounds_dense": out["xla"][1]}
    if diff:
        fail("parity", f"{diff} of {sub.num_pods} assignments differ "
             "between the kernel and dense paths")
    info["ok"] = True
    emit(info)
    return info


def churn(enc, names, rng, sample_metrics) -> None:
    """A probe and scrape tick: four links re-measured, eight nodes'
    metrics re-sampled, so the next snapshot and static prep take their
    delta paths."""
    for _ in range(4):
        i, j = rng.choice(len(names), 2, replace=False)
        enc.update_link(names[int(i)], names[int(j)],
                        lat_ms=float(rng.uniform(0.1, 2.0)),
                        bw_bps=float(rng.uniform(1e9, 25e9)))
    for i in rng.choice(len(names), 8, replace=False):
        enc.update_metrics(names[int(i)], sample_metrics(rng))


def phase_serve():
    from kubernetesnetawarescheduler_tpu_torch.bench.density import (
        measure_device_latency,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_workload,
        sample_metrics,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core.assign import (
        assign_parallel,
        fused_schedule_step,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
    from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
        host_plane_digest_vector,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.kernels import StaticPack
    from kubernetesnetawarescheduler_tpu_torch.core.score import (
        _EPS,
        winner_from_scores,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        commit_assignments,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
        compute_assign_static,
        compute_assign_static_incremental,
        compute_static,
        score_pods_auto,
        score_winner_auto,
        winner_joins_active,
    )

    errors: list[str] = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    def planes_equal(a, b) -> bool:
        """Bit for bit (``node_numeric`` holds NaN, which == never
        matches)."""
        def same(x, y):
            return (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.contiguous().view(torch.uint8),
                                    y.contiguous().view(torch.uint8)))
        return all(same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))

    def over_capacity(s) -> int:
        over = (s.used > s.cap + _EPS).any(dim=1) & s.node_valid
        return int(over.sum())

    # bench.py's serving shape at its default precision (bf16 inputs).
    cfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                          score_backend="pallas")
    t0 = time.perf_counter()
    cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=NODES,
                                                      seed=SEED))
    enc = Encoder(cfg, device="cuda")
    for node in cluster.list_nodes():
        enc.upsert_node(node)
    enc.set_network(lat, bw)
    rng = np.random.default_rng(SEED + 3)
    feed_metrics(cluster, enc, rng)
    pods = generate_workload(
        WorkloadSpec(num_pods=SERVE_PODS, seed=SEED + 5, services=8,
                     peer_fraction=0.5, affinity_fraction=0.1,
                     anti_fraction=0.1),
        scheduler_name=cfg.scheduler_name)
    setup_s = time.perf_counter() - t0
    names = enc.known_node_names()
    placed: dict[str, str] = {}

    def node_of(name: str) -> str:
        return placed.get(name, "")

    stages = ("encode", "snapshot", "static", "winner", "fused", "commit")
    ms = {k: [] for k in stages}
    rounds_all, delta_batches, peers_resolved = [], 0, 0
    static = ex = ver = score_static = score_ver = None

    def timed(stage, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[stage].append((time.perf_counter() - t) * 1e3)
        return out

    K.reset_launch_counts()
    for b in range(SERVE_BATCHES):
        if b and b % CHURN_EVERY == 0:
            churn(enc, names, rng, sample_metrics)
        chunk = pods[b * BATCH:(b + 1) * BATCH]
        batch = timed("encode", lambda: enc.encode_pods(chunk, node_of,
                                                        lenient=True))
        state, v = timed("snapshot", enc.snapshot_versioned)

        def prep():
            nonlocal static, ex, score_static, score_ver
            dirty = None if ver is None else enc.static_delta_since(ver)
            static, ex = compute_assign_static_incremental(
                state, cfg, static, ex, dirty)
            if score_ver != v:
                score_static, score_ver = compute_static(state, cfg), v
            return dirty

        dirty = timed("static", prep)
        delta_batches += bool(dirty and dirty.get("net_pairs")
                              and not dirty.get("topo"))
        ver = v
        best, node = timed("winner", lambda: score_winner_auto(
            state, batch, cfg, score_static))
        new_state, a, rounds, digest = timed(
            "fused", lambda: fused_schedule_step(state, batch, cfg, static,
                                                 with_digest=True))

        def commit():
            a_host = a.cpu().numpy()
            hit = [i for i in range(len(chunk)) if a_host[i] >= 0]
            enc.commit_many([chunk[i] for i in hit],
                            [int(a_host[i]) for i in hit])
            placed.update({chunk[i].name: enc.node_name(int(a_host[i]))
                           for i in hit})

        timed("commit", commit)
        rounds_all.append(int(rounds))
        peers_resolved += int((batch.peers >= 0).sum())

        with uncounted():
            full = compute_assign_static(state, cfg)
            check(isinstance(static, StaticPack) and planes_equal(static,
                                                                  full),
                  f"batch {b}: incremental static prep differs from a "
                  "full one")
            wb, wn = winner_from_scores(score_pods_auto(state, batch, cfg,
                                                        score_static))
            check(torch.equal(node, wn) and torch.equal(best, wb),
                  f"batch {b}: fused winner differs from the two-stage "
                  f"winner on {int((node != wn).sum())} pods")
            a2 = assign_parallel(state, batch, cfg, static)
            s2 = commit_assignments(state, batch, a2)
            check(torch.equal(a, a2) and planes_equal(new_state, s2),
                  f"batch {b}: fused step differs from assign_parallel + "
                  "commit_assignments")
            want = host_plane_digest_vector(new_state.numpy())
            got = digest.cpu().numpy().view(np.uint32)
            check(np.array_equal(got, want),
                  f"batch {b}: device digest differs from the host digest "
                  f"on planes {np.flatnonzero(got != want).tolist()}")
            check(over_capacity(new_state) == 0,
                  f"batch {b}: {over_capacity(new_state)} nodes over "
                  "capacity")

    final = enc.snapshot()
    expected = enc.expected_device_arrays()
    for name, arr in expected.items():
        got = getattr(final, name).cpu().numpy()
        want = arr.view(np.int32) if arr.dtype == np.uint32 else arr
        check(got.dtype == want.dtype and got.tobytes() == want.tobytes(),
              f"final snapshot plane {name} differs from "
              "expected_device_arrays()")
    check(over_capacity(final) == 0,
          f"final snapshot: {over_capacity(final)} nodes over capacity")

    # One batch with live nodeAffinity terms: an out-of-kernel join, so
    # the fused winner must take the two-stage masked-kernel path.
    ns_pods = generate_workload(
        WorkloadSpec(num_pods=BATCH, seed=SEED + 6, services=8,
                     peer_fraction=0.5, ns_fraction=0.5),
        scheduler_name=cfg.scheduler_name)
    ns_batch = enc.encode_pods(ns_pods, node_of, lenient=True)
    ns_state = enc.snapshot()
    joins = winner_joins_active(ns_state, ns_batch)
    check(joins, "the nodeAffinity batch shows no live out-of-kernel join")
    before = {n: fn.launches for n, fn in K.KERNELS.items()}
    ns_best, ns_node = score_winner_auto(ns_state, ns_batch, cfg)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in K.KERNELS.items()}
    check(launches["winner_scores_kernel"] == before["winner_scores_kernel"]
          and launches["masked_scores_kernel"]
          == before["masked_scores_kernel"] + 1,
          "the nodeAffinity batch did not take the masked kernel alone")
    check(bool((ns_node >= 0).any()),
          "the nodeAffinity batch found no feasible node")

    check(launches["winner_scores_kernel"] == SERVE_BATCHES,
          f"winner kernel launched {launches['winner_scores_kernel']} "
          f"times for {SERVE_BATCHES} batches")
    check(launches["static_scores_kernel"] == SERVE_BATCHES,
          f"static kernel launched {launches['static_scores_kernel']} "
          f"times for {SERVE_BATCHES} fused steps")
    check(launches["peer_columns"] == (launches["static_scores_kernel"]
                                       + launches["masked_scores_kernel"]
                                       + launches["winner_scores_kernel"]),
          f"peer columns compacted {launches['peer_columns']} times, not "
          "once per score kernel launch")
    check(delta_batches > 0, "no batch took the static delta path")
    check(peers_resolved > 0, "no peer resolved to a placed pod")

    wall_ms = sum(sum(v) for v in ms.values())
    scheduled = len(placed)
    info = {
        "phase": "serve", "nodes": NODES, "batch": BATCH,
        "batches": SERVE_BATCHES, "pods": SERVE_BATCHES * BATCH,
        "scheduled": scheduled, "setup_s": setup_s,
        "pods_per_s": scheduled / (wall_ms / 1e3),
        "batch_host_ms": {k: {"p50": float(np.percentile(v, 50)),
                              "p99": float(np.percentile(v, 99)),
                              "mean": float(np.mean(v))}
                          for k, v in ms.items()},
        "rounds": {"mean": float(np.mean(rounds_all)),
                   "max": int(max(rounds_all))},
        "peers_resolved": peers_resolved,
        "static_delta_batches": delta_batches,
        "snapshot_full_bytes_total": enc.snapshot_full_bytes_total,
        "snapshot_delta_bytes_total": enc.snapshot_delta_bytes_total,
        "launches": launches, "ns_batch_joins_active": joins,
    }
    lat_res = measure_device_latency(NODES, BATCH, reps=10)
    info["device_latency"] = {
        k: lat_res[k] for k in ("p50_ms", "p99_ms", "max_ms", "reps",
                                "scan_k", "static_prep_ms", "p99_source",
                                "winner_fusion")}
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("serve", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info


class _ZeroLaunches:
    """``run_density``'s sampler: started after the warm-up loop, it sets
    every kernel count to 0, so the counts read after the drain are the
    measured window's."""

    def start(self) -> None:
        from kubernetesnetawarescheduler_tpu_torch.core import kernels as K

        K.reset_launch_counts()


def phase_loop():
    import tempfile

    from kubernetesnetawarescheduler_tpu_torch.bench.density import (
        run_density,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_gang_workload,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
        load_checkpoint,
        save_checkpoint,
        verify_manifest,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.score import _EPS

    t_phase = time.perf_counter()
    errors: list[str] = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    def over_capacity(s) -> int:
        return int(((s.used > s.cap + _EPS).any(dim=1) & s.node_valid)
                   .sum())

    def fresh_loop(cfg, **loop_kw):
        cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=NODES,
                                                          seed=SEED))
        loop = SchedulerLoop(cluster, cfg, method="parallel",
                             device="cuda", **loop_kw)
        loop.encoder.set_network(lat, bw)
        feed_metrics(cluster, loop.encoder, np.random.default_rng(SEED + 3))
        return cluster, loop

    def counts() -> dict:
        return {n: fn.launches for n, fn in K.KERNELS.items()}

    # 1. Four paths, one backlog: the serving width, bf16 inputs.
    cfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                          score_backend="pallas",
                          queue_capacity=LOOP_PODS + BATCH)
    paths = {"serial": (cfg, dict(burst_batches=1)),
             "burst": (cfg, dict(burst_batches=8)),
             "pipelined": (cfg, dict(burst_batches=8, pipelined=True)),
             "multicycle": (dataclasses.replace(
                 cfg, bind_coalesce_window=4, bind_max_inflight=2,
                 multicycle_queue_depth=8),
                 dict(burst_batches=8, multicycle=8, async_bind=True))}
    real_batches = -(-LOOP_PODS // BATCH)
    runs: dict[str, dict] = {}
    launches = {n: 0 for n in K.KERNELS}
    for name, (c, kw) in paths.items():
        cluster, loop = fresh_loop(c, **kw)
        pods = generate_workload(
            WorkloadSpec(num_pods=LOOP_PODS, seed=SEED + 5, services=8,
                         peer_fraction=0.5, affinity_fraction=0.1,
                         anti_fraction=0.1),
            scheduler_name=c.scheduler_name)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            cluster.add_pods(pods)
            loop.run_until_drained()
            loop.flush_binds()
            torch.cuda.synchronize()
        finally:
            loop.stop_bind_worker()
        wall = time.perf_counter() - t0
        run_launches = counts()
        for n, v in run_launches.items():
            launches[n] += v
        snap = loop.encoder.snapshot()
        runs[name] = {
            "bindings": {b.pod_name: b.node_name for b in cluster.bindings},
            "used": snap.used.cpu(), "over": over_capacity(snap),
            "scheduled": loop.scheduled,
            "unschedulable": loop.unschedulable,
            "burst_cycles": loop.burst_cycles,
            "multicycle_windows": loop.multicycle_windows,
            "rounds": list(loop.round_samples),
            "launches": run_launches, "wall_s": wall,
            "pods_per_s": loop.scheduled / wall,
            "budgets": loop.timer.pipeline_budgets(),
        }
    base = runs["serial"]
    for name, r in runs.items():
        check(r["bindings"] == base["bindings"],
              f"{name}: bindings differ from the serial path on "
              f"{sum(base['bindings'].get(k) != v for k, v in r['bindings'].items())}"
              " pods")
        check(torch.equal(r["used"], base["used"]),
              f"{name}: final used differs from the serial path")
        check((r["scheduled"], r["unschedulable"])
              == (base["scheduled"], base["unschedulable"]),
              f"{name}: scheduled/unschedulable "
              f"{r['scheduled']}/{r['unschedulable']} differ from serial "
              f"{base['scheduled']}/{base['unschedulable']}")
        check(r["over"] == 0, f"{name}: {r['over']} nodes over capacity")
        n_static = r["launches"]["static_scores_kernel"]
        check(n_static >= real_batches,
              f"{name}: static kernel launched {n_static} times for "
              f"{real_batches} batches")
        check(r["launches"]["peer_columns"] == n_static,
              f"{name}: peer columns compacted "
              f"{r['launches']['peer_columns']} times for {n_static} "
              "static launches")
    check(base["scheduled"] > 0, "the serial path bound nothing")
    for name in ("burst", "pipelined"):
        check(runs[name]["burst_cycles"] > 0, f"{name}: no burst cycle")
    check(runs["multicycle"]["multicycle_windows"] > 0,
          "multicycle: no window dispatched")

    # 2. Throughput of the host-mode density run, default burst and
    # pipelined; the first one's encoder is checkpointed (4.).
    density: dict[str, dict] = {}
    saved: dict = {}

    def keep_encoder(loop) -> None:
        saved["encoder"] = loop.encoder
        saved["launches"] = counts()

    for name, kw in (("burst", {}), ("pipelined", {"pipelined": True})):
        res = run_density(NODES, DENSITY_PODS, batch_size=BATCH,
                          score_backend="pallas", mode="host",
                          sampler=_ZeroLaunches(), after_drain=keep_encoder,
                          device="cuda", **kw)
        density[name] = {
            "pods_per_s": res.pods_per_sec, "wall_s": res.wall_s,
            "pods_bound": res.pods_bound,
            "pods_unschedulable": res.pods_unschedulable,
            "score_assign_ms": {"p50": res.score_p50_ms,
                                "p99": res.score_p99_ms},
            "encode_ms": {"p50": res.encode_p50_ms,
                          "p99": res.encode_p99_ms},
            "bind_ms": {"p50": res.bind_p50_ms, "p99": res.bind_p99_ms},
            "rounds": {"p50": res.rounds_p50, "p99": res.rounds_p99,
                       "max": res.rounds_max},
            "score_samples": res.score_samples,
            "pipeline_budgets": res.pipeline_budgets,
            "static_refresh_count": res.static_refresh_count,
            "static_sync_builds": res.static_sync_builds,
            "launches": saved["launches"],
            "worst_cycle": res.trace_provenance.get("worst_cycle"),
        }
        check(res.pods_bound > 0, f"density {name}: nothing bound")
        if name == "burst":
            saved["checkpoint_encoder"] = saved["encoder"]

    # 3. Gangs: slice-shaped pod groups among filler pods, one loop.
    gcfg = dataclasses.replace(cfg, queue_capacity=4096)
    cluster, loop = fresh_loop(gcfg)
    gpods = generate_gang_workload(filler_pods=GANG_FILLER, seed=SEED + 7,
                                   scheduler_name=gcfg.scheduler_name)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cluster.add_pods(gpods)
    loop.run_until_drained()
    torch.cuda.synchronize()
    gang_wall = time.perf_counter() - t0
    gang_launches = counts()
    bound = {b.pod_name for b in cluster.bindings}
    groups: dict[str, list[str]] = {}
    for p in gpods:
        if p.pod_group:
            groups.setdefault(p.pod_group, []).append(p.name)
    half = [g for g, m in groups.items()
            if 0 < sum(x in bound for x in m) < len(m)]
    whole = [g for g, m in groups.items() if all(x in bound for x in m)]
    reg = loop.gangs.snapshot()["counters"]
    check(not half, f"half-bound gangs: {half}")
    check(reg["admitted"] == reg["bound"] + reg["rolled_back"],
          f"gangs released by the gate {reg['admitted']} != bound "
          f"{reg['bound']} + rolled back {reg['rolled_back']}")
    check(loop.gangs_bound == reg["bound"] == len(whole),
          f"gangs bound: loop {loop.gangs_bound}, registry {reg['bound']}, "
          f"whole on the server {len(whole)}")
    check(len(whole) > 0, "no gang bound")
    check(over_capacity(loop.encoder.snapshot()) == 0,
          "gangs: a node is over capacity")
    loop.stop_bind_worker()

    # 4. Checkpoint round trip from the density loop's encoder.
    enc = saved["checkpoint_encoder"]
    build_dir = (Path(__file__).resolve().parent
                 / "kubernetesnetawarescheduler_tpu_torch" / "_build")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, enc)
        save_s = time.perf_counter() - t0
        manifest = verify_manifest(tmp)
        t0 = time.perf_counter()
        restored = load_checkpoint(tmp, device="cuda")
        load_s = time.perf_counter() - t0
    check(manifest == [], f"checkpoint manifest: {manifest}")
    a, b = enc.snapshot(), restored.snapshot()
    differ = [f.name for f in dataclasses.fields(a)
              if not (getattr(a, f.name).dtype == getattr(b, f.name).dtype
                      and torch.equal(
                          getattr(a, f.name).contiguous().view(torch.uint8),
                          getattr(b, f.name).contiguous().view(torch.uint8)))]
    check(not differ, f"restored snapshot differs on {differ}")
    check(restored.device.type == "cuda", "restored encoder is not on cuda")
    check(len(restored._committed) == len(enc._committed),
          "restored ledger size differs")

    info = {
        "phase": "loop", "nodes": NODES, "batch": BATCH, "pods": LOOP_PODS,
        "card": nvidia_smi(),
        "paths": {n: {k: r[k] for k in ("scheduled", "unschedulable",
                                        "burst_cycles", "multicycle_windows",
                                        "launches", "wall_s", "pods_per_s",
                                        "budgets")}
                  | {"rounds_mean": float(np.mean(r["rounds"]))
                     if r["rounds"] else 0.0}
                  for n, r in runs.items()},
        "density": density,
        "gangs": {"gangs": len(groups), "bound_whole": len(whole),
                  "half_bound": len(half), "registry": reg,
                  "loop_rolled_back": loop.gangs_rolled_back,
                  "pods": len(gpods), "bound_pods": len(bound),
                  "wall_s": gang_wall, "launches": gang_launches},
        "checkpoint": {"save_s": save_s, "load_s": load_s,
                       "committed": len(enc._committed)},
        "launches": launches,
        "seconds": time.perf_counter() - t_phase,
    }
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("loop", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info


def webhook_args(rng, i: int, names: list, bound: list, n_cand: int):
    """A seeded ExtenderArgs: even requests carry ``netaware/peers`` naming
    up to ``WEBHOOK_PEERS`` placed pods; the candidates are ``n_cand``
    distinct nodes (all of them at ``n_cand >= len(names)``)."""
    meta = {"name": f"hook-{i}", "uid": f"hook-{i}", "namespace": "default",
            "annotations": {}}
    if i % 2 == 0 and bound:
        chosen = rng.choice(len(bound), size=min(WEBHOOK_PEERS, len(bound)),
                            replace=False)
        meta["annotations"]["netaware/peers"] = json.dumps(
            {bound[int(j)]: float(rng.uniform(0.5, 5.0)) for j in chosen})
    req = {"cpu": f"{int(rng.integers(100, 2000))}m",
           "memory": f"{int(rng.integers(1, 8))}Gi"}
    cand = (list(names) if n_cand >= len(names) else
            [names[int(j)] for j in np.sort(rng.choice(len(names), n_cand,
                                                       replace=False))])
    return {"pod": {"metadata": meta,
                    "spec": {"schedulerName": "netAwareScheduler",
                             "containers": [{"resources":
                                             {"requests": req}}]}},
            "nodenames": cand}


def pct_ms(samples_s) -> dict:
    ms = np.asarray(samples_s, dtype=float) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "n": int(ms.size)}


def phase_webhook():
    import concurrent.futures
    import http.client
    import os
    import shutil
    import socket
    import tempfile
    import threading

    from kubernetesnetawarescheduler_tpu_torch import serve
    from kubernetesnetawarescheduler_tpu_torch.api.extender import (
        ExtenderHandlers,
        _pod_from_k8s,
    )
    from kubernetesnetawarescheduler_tpu_torch.api.server import (
        ScorerServer,
        call_uds,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.daemon_smoke import (
        drain_daemon,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.extender_qps import (
        build_webhook,
        run_qps,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        WorkloadSpec,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
        _masked_kernel_args,
        compute_static,
    )

    t_phase = time.perf_counter()
    errors: list[str] = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    root = Path(__file__).resolve().parent
    build = root / "kubernetesnetawarescheduler_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build))
    # deploy/scorer.yaml's config.json under the kernel backend; the
    # other configurations share its encoder (one state for all).
    loop, hk = build_webhook(NODES, WEBHOOK_MAX_PODS, WEBHOOK_PEERS,
                             "pallas", seed=SEED, device="cuda")
    cluster = loop.client
    loops, servers, procs = [(loop, hk)], [], []

    def sibling(**over):
        lp = SchedulerLoop(cluster, dataclasses.replace(loop.cfg, **over),
                           encoder=loop.encoder, device="cuda")
        loops.append((lp, ExtenderHandlers(lp)))
        return loops[-1][1]

    hx = sibling(score_backend="xla")
    # At bf16 the two backends round different operands (the kernel T and
    # C, the dense gather C only), so their answers are held to each
    # other at f32, as the parity phase holds the replay.
    hk32 = sibling(use_bfloat16=False)
    hx32 = sibling(score_backend="xla", use_bfloat16=False)
    try:
        # Placed pods for the requests' peers to name.
        setup = generate_workload(
            WorkloadSpec(num_pods=WEBHOOK_SETUP_PODS, seed=SEED + 5,
                         services=8, peer_fraction=0.5),
            scheduler_name=loop.cfg.scheduler_name)
        cluster.add_pods(setup)
        loop.run_until_drained()
        bound = sorted(b.pod_name for b in cluster.bindings)
        names = loop.encoder.known_node_names()
        rng = np.random.default_rng(SEED + 13)

        # 1. The masked kernel at each pod-axis size the batcher pads to,
        # on its own encoded batches.
        batch_pods = [_pod_from_k8s(webhook_args(
            rng, i, names, bound, 1)["pod"]) for i in range(WEBHOOK_MAX_PODS)]
        state = loop.encoder.snapshot()
        static = compute_static(state, loop.cfg)
        sizes = {}
        with uncounted():
            for p in WEBHOOK_P:
                enc = loop.encoder.encode_pods(
                    batch_pods[:p], node_of=loop._peer_node, lenient=True,
                    pad_to=p)
                args = _masked_kernel_args(state, enc, loop.cfg, static)
                got = K.masked_tile_scores(*args)
                want = K.masked_tile_scores_plain(*args)
                torch.cuda.synchronize()
                mg, mw = got > -5e29, want > -5e29
                err = (float((got[mg] - want[mw]).abs().max())
                       if bool(mg.any()) else 0.0)
                sizes[p] = {"shape": list(got.shape),
                            "feasible": int(mg.sum()), "max_abs_err": err,
                            "peers": int((enc.peers >= 0).sum())}
                check(tuple(got.shape) == (p, NODES),
                      f"P={p}: kernel output shape {tuple(got.shape)}")
                check(torch.equal(mg, mw),
                      f"P={p}: infeasible entries differ on "
                      f"{int((mg != mw).sum())}")
                check(bool(mg.any()), f"P={p}: no feasible entry")
                check(torch.equal(mg, mw) and torch.allclose(
                    got[mg], want[mw], rtol=TOL, atol=TOL),
                      f"P={p}: feasible scores differ by {err}")

        # 2-3. The same requests under both backends, 16 clients each.
        reqs = [webhook_args(rng, i, names, bound,
                             WEBHOOK_CANDS[i % len(WEBHOOK_CANDS)])
                for i in range(WEBHOOK_REQUESTS)]

        def answer(h):
            def one(a):
                return h.filter(a), h.prioritize(a), h._score_row(a)[2]
            with concurrent.futures.ThreadPoolExecutor(16) as ex:
                return list(ex.map(one, reqs))

        def compare(got_k, got_x):
            """(filter lists that differ, priorities that differ away from
            a rounding boundary, priorities that differ within 1e-4·span
            of one)."""
            filt, prio, ties = 0, 0, 0
            for (fk, pk, _), (fx, px, sx) in zip(got_k, got_x):
                filt += fk["nodenames"] != fx["nodenames"]
                ok = sx > -5e29
                if not ok.any():
                    continue
                lo, hi = float(sx[ok].min()), float(sx[ok].max())
                span = max(hi - lo, 1e-9)
                # Distance to the nearest boundary (k + 0.5)·span/10.
                pos = (sx - lo) / span * 10
                near = ok & (np.abs(pos - np.floor(pos) - 0.5) * span / 10
                             <= 1e-4 * span)
                for j, (a, b) in enumerate(zip(pk, px)):
                    if a != b:
                        ties += bool(near[j])
                        prio += not near[j]
            return filt, prio, ties

        for h in (hk, hx):
            answer(h)  # warm: the first waves allocate
        d0 = hk._batcher.dispatches
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got_k = answer(hk)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in K.KERNELS.items()}
        dispatches = hk._batcher.dispatches - d0
        bf16_filt, bf16_prio, bf16_ties = compare(got_k, answer(hx))
        with uncounted():
            filt_diff, prio_diff, ties = compare(answer(hk32), answer(hx32))
        check(filt_diff == 0, f"{filt_diff} filter lists differ between "
              "the backends at f32")
        check(prio_diff == 0, f"{prio_diff} priorities differ between the "
              "backends at f32 away from a rounding boundary")
        check(launches["masked_scores_kernel"] == dispatches,
              f"masked kernel launched {launches['masked_scores_kernel']} "
              f"times for {dispatches} batcher dispatches")
        check(launches["peer_columns"] == launches["masked_scores_kernel"],
              f"peer columns compacted {launches['peer_columns']} times for "
              f"{launches['masked_scores_kernel']} masked launches")
        check(dispatches > 0, "the webhook drive dispatched nothing")

        # One /prioritize of every candidate, one client, per hop.
        full = json.dumps(webhook_args(rng, 9999, names, bound,
                                       len(names))).encode()
        hops: dict = {}
        make = subprocess.run(["make", "-C", str(root / "native")],
                              capture_output=True, text=True, timeout=300)
        check(make.returncode == 0,
              f"make -C native failed: {make.stderr[-500:]}")
        for backend, h in (("pallas", hk), ("xla", hx)):
            sock = str(tmp / f"{backend}.sock")
            srv = ScorerServer(h, sock)
            srv.start()
            servers.append(srv)
            uds_lat = []
            for i in range(HOP_REPS + 3):
                t0 = time.perf_counter()
                out = call_uds(sock, "/prioritize", full, timeout_s=120)
                if i >= 3:
                    uds_lat.append(time.perf_counter() - t0)
            check(len(json.loads(out)) == len(names),
                  f"{backend}: UDS /prioritize answered "
                  f"{len(json.loads(out))} of {len(names)} hosts")
            hops[backend] = {"uds_ms": pct_ms(uds_lat)}
            if make.returncode != 0:
                continue
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            proc = subprocess.Popen(
                [str(root / "native" / "netaware_extender"), str(port),
                 sock], stderr=subprocess.DEVNULL)
            procs.append(proc)
            conn = None
            for _ in range(100):
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=120)
                    conn.request("GET", "/healthz")
                    conn.getresponse().read()
                    break
                except OSError:
                    conn = None
                    time.sleep(0.05)
            check(conn is not None, f"{backend}: the native shim never "
                  "answered /healthz")
            if conn is None:
                continue
            shim_lat = []
            for i in range(HOP_REPS + 3):
                t0 = time.perf_counter()
                conn.request("POST", "/prioritize", body=full,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                if i >= 3:
                    shim_lat.append(time.perf_counter() - t0)
            conn.close()
            check(resp.status == 200 and len(json.loads(body)) == len(names),
                  f"{backend}: shim /prioritize gave {resp.status}")
            hops[backend]["native_shim_ms"] = pct_ms(shim_lat)

        # The daemon at the deploy config: answers over its socket.
        cfgp = tmp / "config.json"
        cfgp.write_text(json.dumps({
            "max_nodes": NODES, "max_pods": WEBHOOK_MAX_PODS,
            "max_peers": WEBHOOK_PEERS, "score_backend": "pallas"}))
        dsock = str(tmp / "daemon.sock")
        stop = threading.Event()
        t0 = time.perf_counter()
        # --probe-period-s 0: the fake prober's stalest-first pair pick
        # walks all N²/2 pairs in Python, seconds at this width.
        th = threading.Thread(target=serve.main, args=(
            ["--cluster", f"fake:{NODES}", "--uds", dsock, "--config",
             str(cfgp), "--device", "cuda", "--probe-period-s", "0"],
            stop), daemon=True)
        th.start()
        daemon = {}
        try:
            ready = None
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and th.is_alive():
                try:
                    ready = json.loads(call_uds(dsock, "/readyz", b""))
                    break
                except OSError:
                    time.sleep(0.1)
            daemon["start_s"] = time.perf_counter() - t0
            check(bool(ready and ready["ready"]), "daemon never ready")
            if ready:
                dn = [f"node-{j:04d}" for j in range(NODES)]
                a = dict(webhook_args(rng, 7, dn, [], 64))
                body = json.dumps(a).encode()
                f = json.loads(call_uds(dsock, "/filter", body,
                                        timeout_s=120))
                pr = json.loads(call_uds(dsock, "/prioritize", body,
                                         timeout_s=120))
                metrics = call_uds(dsock, "/metrics", b"").decode()
                types = [ln.split()[2] for ln in metrics.splitlines()
                         if ln.startswith("# TYPE ")]
                check(len(f["nodenames"]) + len(f["failedNodes"]) == 64
                      and len(f["nodenames"]) > 0,
                      "daemon /filter answer is wrong")
                check([p["host"] for p in pr] == a["nodenames"],
                      "daemon /prioritize answer is wrong")
                check(len(types) == len(set(types)),
                      "daemon /metrics repeats a # TYPE family")
                check("netaware_extender_dispatches_total" in types,
                      "daemon /metrics lacks the batcher's families")
                daemon.update({"filter_passed": len(f["nodenames"]),
                               "metric_families": len(types),
                               "readyz": ready})
        finally:
            stop.set()
            th.join(timeout=120)
            check(not th.is_alive(), "the daemon did not stop")

        # The daemon draining a backlog from the fake API server.
        drain = drain_daemon(DRAIN_NODES, DRAIN_PODS, deadline_s=300,
                             collect_phases=True, device="cuda")
        # The daemon's own phase timer: seconds and counts per phase.
        drain["phase_budget"] = {
            k.replace("netaware_phase_latency_seconds", ""): v
            for k, v in drain["phase_budget"].items()
            if "_hist" not in k and ("_sum{" in k or "_count{" in k)}
        check(drain["distinct_pods_bound"] == DRAIN_PODS
              and drain["max_binds_per_pod"] == 1,
              f"drain: {drain['distinct_pods_bound']} pods bound, at most "
              f"{drain['max_binds_per_pod']} binds per pod")

        # Webhook throughput and per-request latency, both backends.
        qps = {b: run_qps(NODES, WEBHOOK_MAX_PODS, QPS_SEQ, QPS_CLIENTS,
                          QPS_REQUESTS, seed=SEED, max_peers=WEBHOOK_PEERS,
                          score_backend=b, device="cuda").to_dict()
               for b in ("pallas", "xla")}
    finally:
        for srv in servers:
            srv.stop()
        for proc in procs:
            proc.terminate()
            proc.wait(timeout=10)
        for lp, h in loops:
            h.close()
            lp.stop_bind_worker()
        shutil.rmtree(tmp, ignore_errors=True)

    info = {
        "phase": "webhook", "nodes": NODES, "max_pods": WEBHOOK_MAX_PODS,
        "max_peers": WEBHOOK_PEERS, "card": nvidia_smi(),
        "masked_by_p": sizes, "requests": len(reqs),
        "drive_s": drive_s, "dispatches": dispatches,
        "f32_priority_ties": ties,
        "bf16_differ": {"filter_lists": bf16_filt, "priorities": bf16_prio,
                        "priority_ties": bf16_ties},
        "launches": launches,
        "hops_5120_candidates": hops, "daemon": daemon,
        "drain": drain,
        "qps": {b: {k: r[k] for k in (
            "seq_qps", "seq_ms", "seq_maxpods_qps", "conc_qps_best",
            "conc_qps_mean", "conc_qps_passes", "conc_ms", "mean_batch",
            "conc_dispatches", "conc512_qps", "rtt_budget")}
            for b, r in qps.items()},
        "seconds": time.perf_counter() - t_phase,
    }
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("webhook", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info


# The feed phase: bench.py's headline drain (run_density(5120, 65536,
# batch_size=128, mode="pipeline", chunk_batches=16, churn_links=4)), the
# identity drive, the multicycle measurements and the explain drive.
FEED_CHUNK_BATCHES, FEED_CHURN_LINKS = 16, 4
FEED_CAPTURE_AT = 200          # the measured drain's launch held vs plain
IDENTITY_PODS = 16384
MULTICYCLE_K, MULTICYCLE_REPS = 8, 10


class _FeedSampler:
    """``run_density``'s sampler for the feed phase: started after the
    warm-up, it sets every kernel count to 0 and arms the capture of one
    static-kernel call of the measured drain."""

    def __init__(self, armed: dict) -> None:
        self.armed = armed

    def start(self) -> None:
        from kubernetesnetawarescheduler_tpu_torch.core import kernels as K

        K.reset_launch_counts()
        self.armed["on"] = True


def phase_feed():
    import os

    from kubernetesnetawarescheduler_tpu_torch.bench import density
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_gang_workload,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.score import _EPS

    t_phase = time.perf_counter()
    errors: list[str] = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    def over_capacity(s) -> int:
        return int(((s.used > s.cap + _EPS).any(dim=1) & s.node_valid)
                   .sum())

    def counts() -> dict:
        return {n: fn.launches for n, fn in K.KERNELS.items()}

    # 1. The headline drain, as bench.py calls it; one static-kernel call
    # of the measured drain is kept to hold against the plain version.
    armed: dict = {"on": False, "calls": 0}
    real_static = tiled_score.static_tile_scores

    def capturing(pack, groups, pods, use_bfloat16, transposed=False,
                  peers=None):
        if armed["on"]:
            armed["calls"] += 1
            if armed["calls"] == FEED_CAPTURE_AT:
                armed["args"] = (pack, groups.clone(), pods, use_bfloat16)
        return real_static(pack, groups, pods, use_bfloat16,
                           transposed=transposed, peers=peers)

    seen: dict = {}

    def keep(loop) -> None:
        seen["launches"] = counts()
        seen["bindings"] = [(b.pod_name, b.node_name)
                            for b in loop.client.bindings]
        seen["over"] = over_capacity(loop.encoder.snapshot())

    tiled_score.static_tile_scores = capturing
    try:
        res = density.run_density(
            NODES, PODS, batch_size=BATCH, mode="pipeline",
            chunk_batches=FEED_CHUNK_BATCHES, churn_links=FEED_CHURN_LINKS,
            score_backend="pallas", sampler=_FeedSampler(armed),
            after_drain=keep, device="cuda")
    finally:
        tiled_score.static_tile_scores = real_static
    batches = -(-PODS // BATCH)
    names = [n for n, _ in seen["bindings"]]
    launches = seen["launches"]
    check(res.pods_bound + res.pods_unschedulable == PODS,
          f"headline: {res.pods_bound} bound + {res.pods_unschedulable} "
          f"unschedulable != {PODS} pods")
    check(len(names) == len(set(names)) == res.pods_bound,
          f"headline: {len(names)} bindings of {len(set(names))} pods for "
          f"{res.pods_bound} bound")
    check(seen["over"] == 0, f"headline: {seen['over']} nodes over capacity")
    check(launches["static_scores_kernel"] == batches,
          f"headline: static kernel launched "
          f"{launches['static_scores_kernel']} times for {batches} batches")
    check(launches["peer_columns"] == launches["static_scores_kernel"],
          f"headline: peer columns compacted {launches['peer_columns']} "
          f"times for {launches['static_scores_kernel']} static launches")
    kernel_check = {}
    if "args" not in armed:
        check(False, "headline: no static-kernel call was captured")
    else:
        pack, groups, pods, bf16 = armed["args"]
        with uncounted():
            raw_t, ok_t = K.static_tile_scores(pack, groups, pods, bf16,
                                               transposed=True)
            raw, ok = K.static_tile_scores_plain(pack, groups, pods, bf16)
        torch.cuda.synchronize()
        raw_t, ok_t = raw_t.T, ok_t.T
        err = (float((raw_t[ok] - raw[ok]).abs().max())
               if bool(ok.any()) else 0.0)
        kernel_check = {"launch": FEED_CAPTURE_AT,
                        "shape": list(raw_t.shape),
                        "feasible": int(ok.sum()), "max_abs_err": err,
                        "peer_columns": int((pods.t != 0).any(0).sum())}
        check(torch.equal(ok_t, ok),
              f"headline: static mask differs on {int((ok_t != ok).sum())}")
        check(bool(ok.any()), "headline: the captured batch has no "
              "feasible entry")
        check(torch.equal(ok_t, ok) and torch.allclose(
            raw_t[ok], raw[ok], rtol=TOL, atol=TOL),
              f"headline: static kernel differs from plain by {err}")
    headline = {
        "pods_per_s": res.pods_per_sec, "wall_s": res.wall_s,
        "pods_bound": res.pods_bound,
        "pods_unschedulable": res.pods_unschedulable,
        "score_ms": {"p50": res.score_p50_ms, "p99": res.score_p99_ms,
                     "samples": res.score_samples},
        "bind_tail_ms": res.bind_tail_ms,
        "bind_queue_wait_p99_ms": res.bind_queue_wait_p99_ms,
        "bind_rtt_p99_ms": res.bind_rtt_p99_ms,
        "bind_ms": {"p50": res.bind_p50_ms, "p99": res.bind_p99_ms},
        "rounds": {"p50": res.rounds_p50, "p99": res.rounds_p99,
                   "max": res.rounds_max},
        "encode_p99_ms": res.encode_p99_ms,
        "encode_overlap": res.encode_overlap,
        "static_refresh_count": res.static_refresh_count,
        "static_sync_builds": res.static_sync_builds,
        "launches": launches, "batches": batches,
        "kernel_vs_plain": kernel_check,
        "worst_cycle": res.trace_provenance.get("worst_cycle"),
    }

    # 2. The identity drive: host, device and pipeline (encode overlap on
    # and off) must bind alike; the dense backend is reported.
    ident: dict = {}

    def drain(mode: str, overlap: str, backend: str = "pallas") -> dict:
        got: dict = {}

        def take(loop) -> None:
            got["bindings"] = {b.pod_name: b.node_name
                               for b in loop.client.bindings}
            got["over"] = over_capacity(loop.encoder.snapshot())

        os.environ["BENCH_ENCODE_OVERLAP"] = overlap
        try:
            r = density.run_density(
                NODES, IDENTITY_PODS, batch_size=BATCH, mode=mode,
                chunk_batches=FEED_CHUNK_BATCHES, score_backend=backend,
                warmup=False, after_drain=take, device="cuda")
        finally:
            os.environ.pop("BENCH_ENCODE_OVERLAP", None)
        ident[f"{mode}/{backend}/overlap={overlap}"] = {
            "pods_per_s": r.pods_per_sec, "wall_s": r.wall_s,
            "pods_bound": r.pods_bound,
            "pods_unschedulable": r.pods_unschedulable,
            "encode_overlap": r.encode_overlap,
            "score_ms": {"p50": r.score_p50_ms, "p99": r.score_p99_ms}}
        check(got["over"] == 0, f"identity {mode}: nodes over capacity")
        return got["bindings"]

    base = drain("host", "0")
    for mode, ov in (("device", "0"), ("pipeline", "1"), ("pipeline", "0")):
        b = drain(mode, ov)
        diff = sum(base.get(k) != v for k, v in b.items()) + abs(
            len(b) - len(base))
        check(b == base, f"identity {mode} overlap={ov}: bindings differ "
              f"from host on {diff} pods")
    dense = drain("pipeline", "1", backend="xla")
    ident["xla_vs_pallas_differ"] = sum(base.get(k) != v
                                        for k, v in dense.items())

    # 3. The multicycle measurements.
    mc_lat = density.measure_multicycle_latency(
        NODES, BATCH, k=MULTICYCLE_K, reps=MULTICYCLE_REPS, device="cuda")
    mc_id = density.multicycle_identity_check(device="cuda")
    check(mc_id["identical"], f"multicycle identity: {mc_id}")

    # 4. The explain drive: the loop phase's backlog over the four paths
    # and a gang backlog, explain on and off.
    capture_s: list[float] = []
    real_capture = SchedulerLoop._capture_explains

    def timed_capture(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_capture(self, *args, **kwargs)
        finally:
            if self.cfg.enable_explain:
                capture_s.append(time.perf_counter() - t0)

    ecfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                           score_backend="pallas", queue_capacity=4096,
                           explain_retain=4096)
    paths = {"serial": (ecfg, dict(burst_batches=1)),
             "burst": (ecfg, dict(burst_batches=8)),
             "pipelined": (ecfg, dict(burst_batches=8, pipelined=True)),
             "multicycle": (dataclasses.replace(
                 ecfg, bind_coalesce_window=4, bind_max_inflight=2,
                 multicycle_queue_depth=8),
                 dict(burst_batches=8, multicycle=8, async_bind=True)),
             "gang": (ecfg, dict(burst_batches=1))}
    explain: dict = {}
    SchedulerLoop._capture_explains = timed_capture
    try:
        for name, (c, kw) in paths.items():
            out = {}
            for on in (True, False):
                cluster, lat, bw = build_fake_cluster(
                    ClusterSpec(num_nodes=NODES, seed=SEED))
                loop = SchedulerLoop(cluster, dataclasses.replace(
                    c, enable_explain=on), method="parallel",
                    device="cuda", **kw)
                try:
                    loop.encoder.set_network(lat, bw)
                    feed_metrics(cluster, loop.encoder,
                                 np.random.default_rng(SEED + 3))
                    if name == "gang":
                        pods = generate_gang_workload(
                            filler_pods=GANG_FILLER, seed=SEED + 7,
                            scheduler_name=c.scheduler_name)
                    else:
                        pods = generate_workload(
                            WorkloadSpec(num_pods=LOOP_PODS, seed=SEED + 5,
                                         services=8, peer_fraction=0.5,
                                         affinity_fraction=0.1,
                                         anti_fraction=0.1),
                            scheduler_name=c.scheduler_name)
                    n0 = len(capture_s)
                    t0 = time.perf_counter()
                    cluster.add_pods(pods)
                    loop.run_until_drained()
                    loop.flush_binds()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    loop.stop_bind_worker()
                out[on] = {"bindings": {b.pod_name: b.node_name
                                        for b in cluster.bindings},
                           "wall_s": wall, "loop": loop, "pods": pods,
                           "captures": capture_s[n0:]}
            on, off = out[True], out[False]
            loop, bound = on["loop"], on["bindings"]
            check(on["bindings"] == off["bindings"],
                  f"explain {name}: bindings differ with explain on")
            check(bool(bound), f"explain {name}: nothing bound")
            missing = wrong = 0
            summed = bad_sum = 0
            for pod in on["pods"]:
                if pod.name not in bound:
                    continue
                rec = loop.flight.get_explain(pod.uid)
                if rec is None:
                    missing += 1
                    continue
                if rec["decision"] != "bound" or rec["node"] != bound[
                        pod.name]:
                    wrong += 1
                win = [x for x in rec["candidates"]
                       if x["node_index"] == rec["node_index"]]
                if win:
                    summed += 1
                    recon = sum(win[0]["components"].values())
                    if abs(recon - rec["score"]) > 1e-3 + 1e-4 * abs(recon):
                        bad_sum += 1
            failed = loop.flight.explains_failed
            check(missing == 0, f"explain {name}: {missing} bound pods "
                  "without a record")
            check(wrong == 0, f"explain {name}: {wrong} records name "
                  "another node than the binding")
            check(bad_sum == 0, f"explain {name}: {bad_sum} winners whose "
                  "components do not sum to the score")
            check(summed > 0, f"explain {name}: no winner among the "
                  "records' candidates")
            check(failed == 0, f"explain {name}: explains_failed {failed}")
            caps = on["captures"]
            explain[name] = {
                "bound": len(bound), "records": loop.flight.explains_len(),
                "winner_in_top_k": summed, "explains_failed": failed,
                "captured_batches": len(caps),
                "capture_ms": {"p50": float(np.percentile(caps, 50)) * 1e3,
                               "p99": float(np.percentile(caps, 99)) * 1e3}
                if caps else None,
                "wall_s": {"explain_on": on["wall_s"],
                           "explain_off": off["wall_s"]}}
    finally:
        SchedulerLoop._capture_explains = real_capture

    info = {
        "phase": "feed", "nodes": NODES, "batch": BATCH, "pods": PODS,
        "chunk_batches": FEED_CHUNK_BATCHES,
        "churn_links": FEED_CHURN_LINKS, "card": nvidia_smi(),
        "headline": headline,
        "identity": {"pods": IDENTITY_PODS, "runs": ident},
        "multicycle": {"latency": mc_lat, "identity": mc_id},
        "explain": explain,
        "launches": launches,
        "seconds": time.perf_counter() - t_phase,
    }
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("feed", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info


ROBUST_CHUNK = 256     # pods per arrival wave of the clean-run drives
CLEAN_AUDITS = 20
# The audited drive's static launch held vs plain: the first, a real
# batch (a burst pads its tail with empty batches).
ROBUST_CAPTURE_AT = 1
RESHAPE_MEMBERS, RESHAPE_SHAPES = 8, "8,4:0.5"
DAEMON_S = 10.0


def phase_robust():
    import os
    import shutil
    import tempfile
    import threading

    from kubernetesnetawarescheduler_tpu_torch import serve
    from kubernetesnetawarescheduler_tpu_torch.api.server import call_uds
    from kubernetesnetawarescheduler_tpu_torch.bench.density import (
        run_density,
    )
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import rebalance
    from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
    from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.gang import (
        parse_gang_shapes,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
        REPAIR_RUNGS,
        IntegrityAuditor,
        device_row_digests_host,
        host_row_digests,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.score import _EPS
    from kubernetesnetawarescheduler_tpu_torch.core.state_chaos import (
        StateChaosInjector,
        run_state_fault_matrix,
    )
    from kubernetesnetawarescheduler_tpu_torch.k8s.chaos import (
        FAULT_CLASSES,
        check_invariants,
        run_chaos_soak,
    )
    from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod

    t_phase = time.perf_counter()
    errors: list[str] = []
    card = nvidia_smi()

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    def counts() -> dict:
        return {n: fn.launches for n, fn in K.KERNELS.items()}

    def over_capacity(s) -> int:
        return int(((s.used > s.cap + _EPS).any(dim=1) & s.node_valid)
                   .sum())

    def fresh_loop(cfg, **loop_kw):
        cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=NODES,
                                                          seed=SEED))
        loop = SchedulerLoop(cluster, cfg, method="parallel",
                             device="cuda", **loop_kw)
        loop.encoder.set_network(lat, bw)
        feed_metrics(cluster, loop.encoder, np.random.default_rng(SEED + 3))
        return cluster, loop

    def backlog(cfg):
        return generate_workload(
            WorkloadSpec(num_pods=LOOP_PODS, seed=SEED + 5, services=8,
                         peer_fraction=0.5, affinity_fraction=0.1,
                         anti_fraction=0.1),
            scheduler_name=cfg.scheduler_name)

    def pct(xs) -> dict:
        return {"p50": float(np.percentile(xs, 50)),
                "p99": float(np.percentile(xs, 99))}

    def check_static(launches: dict, batches: int, label: str) -> None:
        n_static = launches["static_scores_kernel"]
        check(n_static >= batches, f"{label}: static kernel launched "
              f"{n_static} times for {batches} batches")
        check(launches["peer_columns"] == n_static,
              f"{label}: peer columns compacted {launches['peer_columns']} "
              f"times for {n_static} static launches")

    cfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                          score_backend="pallas",
                          queue_capacity=LOOP_PODS + BATCH)
    real_batches = -(-LOOP_PODS // BATCH)
    launches = {n: 0 for n in K.KERNELS}
    build_dir = (Path(__file__).resolve().parent
                 / "kubernetesnetawarescheduler_tpu_torch" / "_build")
    build_dir.mkdir(parents=True, exist_ok=True)

    # 1. The fault matrix on a committed 2,048-pod drain, its checkpoint
    # kept for the restore rung and for the checkpoint_corrupt modes.
    cluster, loop = fresh_loop(cfg, burst_batches=8)
    cluster.add_pods(backlog(cfg))
    loop.run_until_drained()
    loop.flush_binds()
    loop.stop_bind_worker()
    enc = loop.encoder
    check(loop.scheduled > 0, "matrix drain bound nothing")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        save_checkpoint(ck, enc)
        save_s = time.perf_counter() - t0
        auditor = IntegrityAuditor(enc, loop, checkpoint_dir=ck)
        clean_ms = []
        for _ in range(CLEAN_AUDITS):
            out = auditor.audit_once()
            clean_ms.append(auditor.last_audit_ms)
            check(out["clean"], f"clean audit found drift: "
                  f"{sorted(out['drift'])} {sorted(out['staging'])}")
        # Where a clean audit's time goes: the device digests (and their
        # few KB to the host), the staging copy, the host digests.
        split = {"device_digests": [], "staging_copy": [],
                 "host_digests": []}
        for _ in range(5):
            with enc._lock:
                state, _ = enc.snapshot_versioned()
                t0 = time.perf_counter()
                expected = enc.expected_device_arrays()
                t1 = time.perf_counter()
            device_row_digests_host(state)
            t2 = time.perf_counter()
            host_row_digests(expected)
            t3 = time.perf_counter()
            split["staging_copy"].append((t1 - t0) * 1e3)
            split["device_digests"].append((t2 - t1) * 1e3)
            split["host_digests"].append((t3 - t2) * 1e3)
        del expected
        matrix = run_state_fault_matrix(enc, auditor, seed=SEED + 11)
        matrix_ms = list(auditor.audit_ms)[-len(matrix):]
        for (kind, res), ms in zip(matrix.items(), matrix_ms):
            res["audit_ms"] = ms
            check(res["detected"] == 1 and res["repaired"] == 1,
                  f"matrix {kind}: {res}")
        # Staging poison: invisible to the device compare, healed only
        # by the checkpoint rung.
        row = int(np.flatnonzero(enc._node_valid)[0])
        with enc._lock:
            enc._metrics[row, 0] = np.nan
            enc._mark_rows("metrics", row)
        out = auditor.audit_once()
        poison = {"rung": out["rung"], "repaired": out["repaired"],
                  "audit_ms": auditor.last_audit_ms}
        check(out["rung"] == "checkpoint_restore" and out["repaired"],
              f"staging poison: {poison}")
        check(bool(np.isfinite(enc._metrics).all()),
              "staging poison survived the repair")
        check(auditor.audit_once()["clean"], "audit after restore not clean")
        # Each rung alone (its host side, then the flush), timed.
        rung_ms = {}
        for rung in REPAIR_RUNGS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            auditor._apply_rung(rung, {"metrics": [row]})
            auditor._flush()
            torch.cuda.synchronize()
            rung_ms[rung] = (time.perf_counter() - t0) * 1e3
        check(auditor.audit_once()["clean"], "audit after the rungs not clean")
        check(auditor.unrepaired_total == 0,
              f"unrepaired {auditor.unrepaired_total}")
        # checkpoint_corrupt, each mode into a copy: refused, or restored
        # from a verified set.
        corrupt = {}
        for seed in range(64):
            mode = ("truncate", "flip", "delete_meta")[int(
                np.random.default_rng(seed).integers(0, 3))]
            if mode in corrupt:
                continue
            copy = os.path.join(tmp, f"c{seed}")
            shutil.copytree(ck, copy)
            desc = StateChaosInjector(enc, seed=seed,
                                      checkpoint_dir=copy).inject(
                "checkpoint_corrupt")
            try:
                load_checkpoint(copy, device="cuda")
                corrupt[mode] = "loaded"
            except ValueError as exc:
                corrupt[mode] = f"refused: {str(exc)[:120]}"
            shutil.rmtree(copy)
            check(desc["mode"] == mode, f"corrupt seed {seed}: {desc}")
            check(corrupt[mode] != "loaded",
                  f"checkpoint_corrupt {mode}: a corrupt set loaded")
            if len(corrupt) == 3:
                break
        check(len(corrupt) == 3, f"corrupt modes covered: {sorted(corrupt)}")
    fault = {"pods": LOOP_PODS, "checkpoint_save_s": save_s,
             "clean_audit_ms": pct(clean_ms),
             "clean_audit_split_ms": {k: float(np.median(v))
                                      for k, v in split.items()},
             "matrix": {k: {x: v[x] for x in ("detected", "repaired", "rung",
                                              "audit_ms")}
                        | {"descriptor": v["descriptor"]}
                        for k, v in matrix.items()},
             "staging_poison": poison, "rung_ms": rung_ms,
             "checkpoint_corrupt": corrupt,
             "repairs": dict(auditor.repairs)}

    # 2. Clean-run identity: a pipelined drain without audits and with an
    # audit at every maintain(); one static launch of the audited drive
    # is held against the plain version.
    armed: dict = {"on": False, "calls": 0}
    real_static = tiled_score.static_tile_scores

    def capturing(pack, groups, pods, use_bfloat16, transposed=False,
                  peers=None):
        if armed["on"]:
            armed["calls"] += 1
            if armed["calls"] == ROBUST_CAPTURE_AT:
                armed["args"] = (pack, groups.clone(), pods, use_bfloat16)
        return real_static(pack, groups, pods, use_bfloat16,
                           transposed=transposed, peers=peers)

    ident = {}
    tiled_score.static_tile_scores = capturing
    try:
        for audited in (False, True):
            cluster, loop = fresh_loop(cfg, burst_batches=8, pipelined=True)
            auditor = IntegrityAuditor(loop.encoder, loop) if audited else None
            pods = backlog(cfg)
            outs = []
            armed["on"] = audited
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                for start in range(0, len(pods), ROBUST_CHUNK):
                    cluster.add_pods(pods[start:start + ROBUST_CHUNK])
                    loop.run_once()
                    loop.maintain()
                    if auditor is not None:
                        outs.append(auditor.audit_once()["clean"])
                loop.run_until_drained()
                loop.flush_binds()
                loop.maintain()
                if auditor is not None:
                    outs.append(auditor.audit_once()["clean"])
                torch.cuda.synchronize()
            finally:
                loop.stop_bind_worker()
            armed["on"] = False
            run_launches = counts()
            for n, v in run_launches.items():
                launches[n] += v
            snap = loop.encoder.snapshot()
            ident[audited] = {
                "bindings": {b.pod_name: b.node_name
                             for b in cluster.bindings},
                "used": snap.used.cpu(), "over": over_capacity(snap),
                "counters": (loop.scheduled, loop.unschedulable,
                             loop.burst_cycles, loop.bind_failures),
                "audits": outs, "launches": run_launches,
                "audit_ms": (pct(list(auditor.audit_ms))
                             if auditor is not None else None),
                "wall_s": time.perf_counter() - t0}
            check_static(run_launches, real_batches,
                         f"identity audited={audited}")
            check(ident[audited]["over"] == 0,
                  f"identity audited={audited}: nodes over capacity")
    finally:
        tiled_score.static_tile_scores = real_static
    a, b = ident[False], ident[True]
    check(a["bindings"] == b["bindings"], "identity: bindings differ with "
          "the auditor on")
    check(torch.equal(a["used"], b["used"]), "identity: used differs with "
          "the auditor on")
    check(a["counters"] == b["counters"], f"identity: counters "
          f"{a['counters']} vs {b['counters']}")
    check(bool(b["audits"]) and all(b["audits"]),
          f"identity: {b['audits'].count(False)} audits not clean")
    check(a["counters"][0] > 0, "identity: nothing bound")
    kernel_check = {}
    if "args" not in armed:
        check(False, "identity: no static-kernel call was captured")
    else:
        pack, groups, kpods, bf16 = armed["args"]
        with uncounted():
            raw_t, ok_t = K.static_tile_scores(pack, groups, kpods, bf16,
                                               transposed=True)
            raw, ok = K.static_tile_scores_plain(pack, groups, kpods, bf16)
        torch.cuda.synchronize()
        raw_t, ok_t = raw_t.T, ok_t.T
        err = (float((raw_t[ok] - raw[ok]).abs().max())
               if bool(ok.any()) else 0.0)
        kernel_check = {"launch": ROBUST_CAPTURE_AT,
                        "shape": list(raw_t.shape),
                        "feasible": int(ok.sum()), "max_abs_err": err}
        check(bool(ok.any()), "identity: the captured batch has no "
              "feasible entry")
        check(torch.equal(ok_t, ok) and torch.allclose(
            raw_t[ok], raw[ok], rtol=TOL, atol=TOL),
              f"identity: static kernel differs from plain by {err}, mask "
              f"on {int((ok_t != ok).sum())}")
    identity = {"pods": LOOP_PODS, "chunk": ROBUST_CHUNK,
                "audits": len(b["audits"]), "audit_ms": b["audit_ms"],
                "wall_s": {"plain": a["wall_s"], "audited": b["wall_s"]},
                "launches": {"plain": a["launches"],
                             "audited": b["launches"]},
                "kernel_vs_plain": kernel_check}

    # 3. The chaos soak at width, with state faults: the soak's config is
    # the JAX default, score_backend="xla", the dense torch path.
    t0 = time.perf_counter()
    doc = run_chaos_soak(seed=7, num_nodes=NODES, num_pods=LOOP_PODS,
                         classes=FAULT_CLASSES, state_faults=True,
                         device="cuda")
    soak_wall = time.perf_counter() - t0
    integ = doc["detail"]["integrity"]
    injected = sum(integ["state_faults_injected"].values())
    check(doc["recovered"], "soak: not recovered")
    check(doc["invariants"] == {k: 0 for k in doc["invariants"]},
          f"soak invariants: {doc['invariants']}")
    check(integ["unrepaired"] == 0, f"soak unrepaired {integ['unrepaired']}")
    check(integ["drift_detected"] == injected > 0,
          f"soak: detected {integ['drift_detected']} of {injected}")
    soak = {"backend": "xla (the dense torch path; no kernel)",
            "nodes": NODES, "pods": LOOP_PODS, "wall_s": soak_wall,
            "recovered": doc["recovered"],
            "time_to_recover_s": doc["time_to_recover_s"],
            "invariants": doc["invariants"],
            "healthy_assumed_per_cycle":
                doc["detail"]["healthy"]["assumed_per_cycle"],
            "brownout_assumed_per_cycle":
                doc["detail"]["brownout"]["assumed_per_cycle"],
            "cycles": doc["detail"]["cycles"],
            "bound": doc["detail"]["bound"],
            "injected": doc["detail"]["injected"], "integrity": integ}

    # 4. Rebalance: run_density's 8,192-pod drain with the rebalancer on,
    # two nodes cordoned (the drain trigger), one tick past the age bar;
    # the scan's inputs are kept to run it again on the CPU.
    rcfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                           score_backend="pallas",
                           queue_capacity=DENSITY_PODS + BATCH,
                           enable_rebalance=True)
    scans: list = []
    real_scan = rebalance._scan

    def keep_scan(*args):
        scans.append(args)
        return real_scan(*args)

    reb: dict = {}

    def rebalance_tick(loop) -> None:
        reb["launches"] = counts()
        reb["drained"] = loop.scheduled
        rb = loop.rebalance
        c = loop.client
        placed = {}
        for b_ in c.bindings:
            placed[b_.pod_name] = b_.node_name
        peered = sorted({placed[p.name] for p in c.list_all_pods()
                         if p.peers and p.name in placed})
        nodes = {n.name: n for n in c.list_nodes()}
        for name in peered[:2]:
            c.add_node(dataclasses.replace(nodes[name], unschedulable=True))
        reb["cordoned"] = peered[:2]
        now = time.monotonic() + rcfg.rebalance_min_age_s + 1.0
        rb._last_tick = 0.0
        rebalance._scan = keep_scan
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved = rb.tick(loop, now=now)
            reb["tick_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            rebalance._scan = real_scan
        reb["moved"] = moved
        reb["gains"] = [mv.gain for mv in rb._inflight.values()]
        moved_members = [m for mv in rb._inflight.values()
                         for m in mv.members]
        reb["scan_ms"] = dict(rb.last_scan_ms)
        reb["pods_scanned"] = rb.last_scan_pods
        loop.run_until_drained()
        loop.flush_binds()
        rb._settle(now)
        reb["summary"] = rb.summary()
        reb["invariants"] = check_invariants(loop, c)
        names = [b_.pod_name for b_ in c.bindings]
        reb["rebound"] = sorted({n for n in names if names.count(n) > 1})
        reb["rebound_max"] = max((names.count(n) for n in reb["rebound"]),
                                 default=0)
        reb["evicted"] = sorted(m[2] for m in moved_members)
        reb["over"] = over_capacity(loop.encoder.snapshot())

    res = run_density(NODES, DENSITY_PODS, batch_size=BATCH, cfg=rcfg,
                      warmup=False, sampler=_ZeroLaunches(),
                      after_drain=rebalance_tick, device="cuda")
    for n, v in reb["launches"].items():
        launches[n] += v
    check_static(reb["launches"], -(-DENSITY_PODS // BATCH), "rebalance drain")
    s = reb["summary"]
    check(len(scans) == 1, f"rebalance: {len(scans)} scans")
    scan_check = {}
    if scans:
        args = scans[0]
        dev_out = real_scan(*args)
        cpu_out = real_scan(*(a.cpu() if torch.is_tensor(a) else a
                              for a in args))
        torch.cuda.synchronize()
        scan_check = {
            "pods": int(args[4].shape[0]),
            "target_differs": int((dev_out[2].cpu() != cpu_out[2]).sum()),
            "max_abs_err": max(float((dev_out[i].cpu() - cpu_out[i])
                                     .abs().max()) for i in (0, 1))}
        check(torch.equal(dev_out[2].cpu(), cpu_out[2]),
              f"rebalance scan: {scan_check['target_differs']} targets "
              "differ between the card and the CPU")
        check(all(torch.allclose(dev_out[i].cpu(), cpu_out[i], rtol=TOL,
                                 atol=TOL) for i in (0, 1)),
              f"rebalance scan: mine/best differ by "
              f"{scan_check['max_abs_err']}")
    check(0 < reb["moved"] <= rcfg.rebalance_max_moves_per_cycle,
          f"rebalance: {reb['moved']} moves (cap "
          f"{rcfg.rebalance_max_moves_per_cycle})")
    check(all(g > 0.0 for g in reb["gains"]), f"rebalance gains {reb['gains']}")
    check(s["triggers_drain"] >= 1, f"rebalance: no drain trigger ({s})")
    check(s["moves_completed"] == s["moves_total"],
          f"rebalance: {s['moves_completed']} of {s['moves_total']} moves "
          "completed")
    check(s["half_moved_gangs"] == 0, "rebalance: half-moved gangs")
    # check_invariants counts a pod name in more than one binding as
    # double-bound; the fake API server's bindings are a history, so a
    # migrated pod (bound, evicted, re-added, bound again) appears twice.
    # The invariant the move must keep: the only names bound twice are
    # the evicted members, each exactly twice; the rest are 0.
    inv = dict(reb["invariants"])
    check(reb["rebound"] == reb["evicted"] and reb["rebound_max"] <= 2
          and inv.pop("pods_double_bound") == len(reb["evicted"]),
          f"rebalance: rebound {reb['rebound']} vs evicted "
          f"{reb['evicted']} ({reb['invariants']})")
    check(inv == {k: 0 for k in inv}, f"rebalance invariants: {inv}")
    check(reb["over"] == 0, "rebalance: nodes over capacity")

    # The gang reshape after a node loss.
    gcfg = dataclasses.replace(cfg, enable_gang_reshaping=True,
                               queue_capacity=4096)
    cluster, loop = fresh_loop(gcfg)
    fam = parse_gang_shapes(RESHAPE_SHAPES)
    gpods = [Pod(name=f"slice-r-w{i}", requests={"cpu": 0.25, "mem": 0.25},
                 pod_group="slice-r", gang_min_member=RESHAPE_MEMBERS,
                 gang_shapes=fam, group="slice-r",
                 anti_groups=frozenset({"slice-r"}))
             for i in range(RESHAPE_MEMBERS)]
    K.reset_launch_counts()
    cluster.add_pods(gpods)
    bound0 = loop.run_until_drained()
    rb = rebalance.Rebalancer(dataclasses.replace(
        gcfg, enable_rebalance=True, rebalance_interval_s=1e-4,
        rebalance_max_moves_per_cycle=0,
        rebalance_evictions_per_hour=1000.0,
        rebalance_move_timeout_s=60.0), loop.encoder, loop.client)
    loop.rebalance = rb
    dead = cluster.node_of(gpods[0].name)
    node = next(n for n in cluster.list_nodes() if n.name == dead)
    cluster.add_node(dataclasses.replace(node, unschedulable=True))
    units = rb._gang_units(loop)
    plan = (rb.evaluate_reshape(loop, "default/slice-r",
                                units["default/slice-r"], time.monotonic())
            if "default/slice-r" in units else None)
    check(bound0 == RESHAPE_MEMBERS, f"reshape: {bound0} members bound")
    check(plan is not None and plan["new_key"] > plan["cur_key"],
          f"reshape: plan {plan}")
    for _ in range(4):
        rb._last_tick = 0.0
        rb.tick(loop)
        loop.run_until_drained()
        loop.flush_binds()
        if rb.reshapes_completed and not rb._inflight_reshapes:
            break
    loop.stop_bind_worker()
    gang_launches = counts()
    for n, v in gang_launches.items():
        launches[n] += v
    placed = {p.name: cluster.node_of(p.name) for p in gpods
              if cluster.node_of(p.name)}
    real = loop.encoder.gang_realizations().get("default/slice-r")
    resh = rb.summary()["reshape"]
    check(resh["reshapes_completed"] >= 1 and resh["half_shaped_gangs"] == 0,
          f"reshape: {resh}")
    check(dead not in placed.values(), "reshape: a member on the lost node")
    check(real is not None and real[0] == len(placed)
          and len(placed) in {c for c, _p in fam},
          f"reshape: {len(placed)} bound, realization {real}")
    check(gang_launches["static_scores_kernel"] >= 2,
          f"reshape: static kernel launched "
          f"{gang_launches['static_scores_kernel']} times")
    rebal = {"pods": DENSITY_PODS, "drained": reb["drained"],
             "drain_pods_per_s": res.pods_per_sec,
             "cordoned": reb["cordoned"], "moved": reb["moved"],
             "pods_scanned": reb["pods_scanned"],
             "scan_ms": reb["scan_ms"], "tick_ms": reb["tick_ms"],
             "scan_vs_cpu": scan_check, "summary": s,
             "invariants": reb["invariants"],
             "rebound_pods": len(reb["rebound"]),
             "reshape": {"plan": {k: plan[k] for k in (
                 "new_count", "old_count", "kind", "gain", "cur_key",
                 "new_key")} if plan else None,
                 "placed": len(placed), "summary": resh,
                 "launches": gang_launches}}

    # 5. The daemon with every robustness flag for DAEMON_S seconds.
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        dsock = os.path.join(tmp, "robust.sock")
        cfgp = os.path.join(tmp, "config.json")
        with open(cfgp, "w") as fh:
            json.dump({"max_nodes": NODES, "max_pods": BATCH,
                       "max_peers": PEERS, "score_backend": "pallas"}, fh)
        stop = threading.Event()
        outcome: dict = {}

        def run_daemon():
            try:
                outcome["rc"] = serve.main(
                    ["--cluster", f"fake:{NODES}", "--uds", dsock,
                     "--config", cfgp, "--device", "cuda",
                     "--probe-period-s", "0",
                     "--audit-interval", "1", "--state-chaos", "0.5",
                     "--rebalance"], stop)
            except BaseException as exc:  # noqa: BLE001 - checked below
                outcome["error"] = repr(exc)

        before = {t.name for t in threading.enumerate()}
        th = threading.Thread(target=run_daemon, daemon=True)
        t0 = time.perf_counter()
        th.start()
        daemon: dict = {}
        try:
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and th.is_alive():
                if os.path.exists(dsock):
                    break
                time.sleep(0.1)
            daemon["start_s"] = time.perf_counter() - t0
            if not os.path.exists(dsock):
                fail("robust", f"the daemon did not start: {outcome}")
            time.sleep(DAEMON_S)
            metrics = call_uds(dsock, "/metrics", b"").decode()
            rbdoc = json.loads(call_uds(dsock, "/debug/rebalance", b""))
        finally:
            stop.set()
            th.join(timeout=120)
        # Threads the daemon started end within a few seconds of its
        # return (the batcher's finisher drains its sentinel).
        for _ in range(50):
            alive = [t.name for t in threading.enumerate()
                     if t.name not in before and t.is_alive()]
            if not alive:
                break
            time.sleep(0.1)
        types_ = [ln.split()[2] for ln in metrics.splitlines()
                  if ln.startswith("# TYPE ")]

        def value(name: str) -> float:
            return sum(float(ln.rsplit(" ", 1)[1])
                       for ln in metrics.splitlines()
                       if ln.startswith(name)
                       and ln[len(name):len(name) + 1] in " {")

        for fam_ in ("netaware_integrity_audits_total",
                     "netaware_integrity_repairs_total",
                     "netaware_state_faults_injected_total",
                     "netaware_rebalance_scans_total",
                     "netaware_rebalance_triggers_total"):
            check(types_.count(fam_) == 1,
                  f"daemon /metrics: {fam_} TYPE x{types_.count(fam_)}")
        check(len(types_) == len(set(types_)),
              "daemon /metrics repeats a # TYPE family")
        check(value("netaware_integrity_audits_total") >= 1,
              "daemon: no audit ran")
        check(value("netaware_integrity_unrepaired_total") == 0,
              "daemon: unrepaired drift")
        check(rbdoc.get("enabled") is True, f"/debug/rebalance: {rbdoc}")
        check(not th.is_alive(), "the daemon did not stop")
        check(outcome.get("rc") == 0 and "error" not in outcome,
              f"daemon shutdown: {outcome}")
        check(not alive, f"threads left running: {alive}")
        daemon.update({
            "seconds": DAEMON_S,
            "audits": value("netaware_integrity_audits_total"),
            "drift": value("netaware_integrity_drift_total"),
            "repairs": value("netaware_integrity_repairs_total"),
            "faults_injected": value("netaware_state_faults_injected_total"),
            "last_audit_ms": value("netaware_integrity_last_audit_ms"),
            "rebalance_scans": value("netaware_rebalance_scans_total"),
            "metric_families": len(types_)})

    info = {"phase": "robust", "nodes": NODES, "batch": BATCH, "card": card,
            "fault_matrix": fault, "identity": identity, "soak": soak,
            "rebalance": rebal, "daemon": daemon, "launches": launches,
            "seconds": time.perf_counter() - t_phase}
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("robust", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info



# The learning layers: the topology leg (1,024 nodes in the JAX suite,
# here the serving width), its probe horizon, the Adam steps per refit,
# and the gang workload judged on the sparse, blended and oracle planes.
# The leg's horizon is 280 cycles; at 5,120 nodes a cycle costs 0.4-1 s
# of host (the planner's selection over 13.1 M pairs, then the refit),
# so the depth is cut to 96 to keep the phase under ≈150 s.
LEARN_CYCLES, LEARN_BUDGET, LEARN_STEPS = 96, 64, 36
LEARN_GANGS, LEARN_MEMBERS = 16, 8
# The topology leg's score weights (the JAX suite's BW_LAT).
BW_LAT = dict(cpu=0.5, mem=0.5, net_tx=0.0, net_rx=0.0, bandwidth=1.0,
              disk=0.0, peer_bw=3.0, peer_lat=2.0, balance=0.5)


def phase_learn():
    import os
    import tempfile
    import threading

    from kubernetesnetawarescheduler_tpu_torch import serve
    from kubernetesnetawarescheduler_tpu_torch.api.server import call_uds
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        WorkloadSpec,
        build_fake_cluster,
        feed_metrics,
        generate_gang_workload,
        generate_workload,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import (
        SchedulerConfig,
        ScoreWeights,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
    from kubernetesnetawarescheduler_tpu_torch.core.assign import (
        assign_parallel,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
    from kubernetesnetawarescheduler_tpu_torch.core.gang import (
        gang_key_of,
        mean_intra_gang_bw,
        place_gang,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
        IntegrityAuditor,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        commit_assignments,
    )
    from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (
        FakeProber,
        ProbeOrchestrator,
    )
    from kubernetesnetawarescheduler_tpu_torch.netmodel import (
        EIGProbePlanner,
        TopologyModel,
    )
    from kubernetesnetawarescheduler_tpu_torch.netmodel.model import (
        TopoParams,
        _predict_dense,
    )
    from kubernetesnetawarescheduler_tpu_torch.obs import quality as qmod

    t_phase = time.perf_counter()
    errors: list[str] = []
    card = nvidia_smi()

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    def counts() -> dict:
        return {n: fn.launches for n, fn in K.KERNELS.items()}

    def pct(xs) -> dict:
        return ({"p50": float(np.percentile(xs, 50)),
                 "p99": float(np.percentile(xs, 99))} if len(xs) else {})

    def timed(obj, name: str, into: list) -> None:
        """Wrap ``obj.name`` so each call's wall time lands in ``into``
        (ms); the wrapped calls end with a host copy, so their device
        work is inside."""
        real = getattr(obj, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            into.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, name, wrapper)

    launches = {n: 0 for n in K.KERNELS}

    # 1. The topology leg at the serving width.
    tcfg = SchedulerConfig(max_nodes=NODES, max_pods=max(16, LEARN_MEMBERS),
                           max_peers=PEERS, weights=ScoreWeights(**BW_LAT),
                           enable_netmodel=True, netmodel_steps=LEARN_STEPS,
                           score_backend="pallas")
    cluster, lat, bw = build_fake_cluster(ClusterSpec(num_nodes=NODES,
                                                      seed=SEED))
    nodes = cluster.list_nodes()
    names = [n.name for n in nodes]
    enc = Encoder(tcfg, device="cuda")
    dev = enc.device
    for node in nodes:
        enc.upsert_node(node)
    feed_metrics(cluster, enc, np.random.default_rng(SEED + 1))
    model = TopologyModel(tcfg, seed=SEED, device="cuda")
    enc.attach_netmodel(model)
    planner = EIGProbePlanner(model,
                              explore_frac=tcfg.netmodel_explore_frac,
                              seed=SEED)
    orch = ProbeOrchestrator(enc, FakeProber(names, lat, bw, noise=0.02,
                                             seed=SEED), names,
                             planner=planner, model=model)
    fit_ms: list = []
    select_ms: list = []
    timed(model, "fit", fit_ms)
    timed(planner, "select_pairs", select_ms)
    t0 = time.perf_counter()
    for _ in range(LEARN_CYCLES):
        orch.run_cycle(budget=LEARN_BUDGET)
        orch.advance_clock(60.0)
    probe_s = time.perf_counter() - t0
    stale = orch.staleness()
    steps = model.steps_total
    check(steps == LEARN_CYCLES * LEARN_STEPS,
          f"topology: {steps} Adam steps for {LEARN_CYCLES} cycles")
    # predict: the card's dense planes, then their copy to the host; the
    # plain CPU function at the same parameters.
    with model._lock:
        params = model._eval_params_locked()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_lat, d_bw = _predict_dense(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h_lat, h_bw = d_lat.cpu(), d_bw.cpu()
    t2 = time.perf_counter()
    pred_dev_ms, pred_d2h_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    c_lat, c_bw = _predict_dense(TopoParams(*(p.cpu() for p in params)))
    pred_err = max(float(((h_lat - c_lat).abs() / c_lat.abs()).max()),
                   float(((h_bw - c_bw).abs() / c_bw.abs()).max()))
    check(torch.allclose(h_lat, c_lat, rtol=1e-5, atol=0.0)
          and torch.allclose(h_bw, c_bw, rtol=1e-5, atol=0.0),
          f"topology: _predict_dense on the card differs from the CPU by "
          f"{pred_err} (relative)")
    del d_lat, d_bw, h_lat, h_bw, c_lat, c_bw
    model._dense_version = -1
    t0 = time.perf_counter()
    model.predict()
    predict_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    lat_b, bw_b = model.blend(enc._lat, enc._bw)
    blend_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    up = (torch.from_numpy(lat_b).to(dev), torch.from_numpy(bw_b).to(dev))
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    del up, lat_b, bw_b
    enc.touch_net()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blended = enc.snapshot()
    torch.cuda.synchronize()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    expected = enc.expected_device_arrays()
    check(np.array_equal(blended.lat.cpu().numpy(), expected["lat"])
          and np.array_equal(blended.bw.cpu().numpy(), expected["bw"]),
          "topology: the blended snapshot's lat/bw differ from "
          "expected_device_arrays()")
    del expected
    model.enabled = False
    enc.touch_net()
    sparse = enc.snapshot()
    model.enabled = True
    lat_pad = np.zeros((NODES, NODES), np.float32)
    bw_pad = np.zeros((NODES, NODES), np.float32)
    lat_pad[:len(names), :len(names)] = lat
    bw_pad[:len(names), :len(names)] = bw
    oracle = sparse.replace(lat=torch.from_numpy(lat_pad).to(dev),
                            bw=torch.from_numpy(bw_pad).to(dev))
    gpods = generate_gang_workload(num_gangs=LEARN_GANGS,
                                   member_counts=(LEARN_MEMBERS,),
                                   filler_pods=0, seed=SEED)
    by_gang: dict = {}
    for p in gpods:
        by_gang.setdefault(gang_key_of(p), []).append(p)
    armed: dict = {"on": False}
    real_static = tiled_score.static_tile_scores

    def capturing(pack, groups, pods, use_bfloat16, transposed=False,
                  peers=None):
        if armed["on"] and "args" not in armed:
            armed["args"] = (pack, groups.clone(), pods, use_bfloat16)
        return real_static(pack, groups, pods, use_bfloat16,
                           transposed=transposed, peers=peers)

    def judge(state) -> float:
        static = tiled_score.compute_assign_static(state, tcfg)
        st, vals = state, []
        for key in sorted(by_gang):
            members = by_gang[key]
            batch = enc.encode_pods(members, lambda n: "")
            a = place_gang(st, batch, tcfg, static, assign_parallel,
                           len(members))
            st = commit_assignments(st, batch,
                                    torch.from_numpy(a).to(dev))
            vals.append(mean_intra_gang_bw(bw, a[:len(members)]))
        return float(np.mean(vals))

    gang_bw = {}
    tiled_score.static_tile_scores = capturing
    try:
        for label, state in (("sparse", sparse), ("blended", blended),
                             ("oracle", oracle)):
            armed["on"] = label == "blended"
            K.reset_launch_counts()
            gang_bw[label] = judge(state)
            torch.cuda.synchronize()
            c = counts()
            for n, v in c.items():
                launches[n] += v
            check(c["static_scores_kernel"] >= LEARN_GANGS,
                  f"topology {label}: {c['static_scores_kernel']} static "
                  f"launches for {LEARN_GANGS} gangs")
    finally:
        tiled_score.static_tile_scores = real_static
        armed["on"] = False
    denom = gang_bw["oracle"] - gang_bw["sparse"]
    gain = ((gang_bw["blended"] - gang_bw["sparse"]) / denom
            if denom > 0 else 1.0)
    kernel_check = {}
    if "args" not in armed:
        check(False, "topology: no static launch on the blended state")
    else:
        pack, groups, kpods, bf16 = armed["args"]
        with uncounted():
            raw_t, ok_t = K.static_tile_scores(pack, groups, kpods, bf16,
                                               transposed=True)
            raw, ok = K.static_tile_scores_plain(pack, groups, kpods, bf16)
        torch.cuda.synchronize()
        raw_t, ok_t = raw_t.T, ok_t.T
        err = (float((raw_t[ok] - raw[ok]).abs().max())
               if bool(ok.any()) else 0.0)
        kernel_check = {"shape": list(raw_t.shape),
                        "feasible": int(ok.sum()), "max_abs_err": err}
        check(bool(ok.any()) and torch.equal(ok_t, ok) and torch.allclose(
            raw_t[ok], raw[ok], rtol=TOL, atol=TOL),
              f"topology: static kernel on the blended state differs from "
              f"plain by {err}, mask on {int((ok_t != ok).sum())}")
    p50, p99 = model.residual_quantiles()
    topology = {
        "nodes": NODES, "cycles": LEARN_CYCLES, "budget": LEARN_BUDGET,
        "adam_steps": steps, "probe_wall_s": probe_s,
        "fit_ms_per_step": float(np.sum(fit_ms)) / max(steps, 1),
        "fit_ms": pct(fit_ms), "planner_select_ms": pct(select_ms),
        "predict_device_ms": pred_dev_ms, "predict_d2h_ms": pred_d2h_ms,
        "coverage": stale["coverage_fraction"],
        "pairs_observed": model.pairs_observed,
        "residual_p50": p50, "residual_p99": p99,
        "predict_vs_cpu_max_rel_err": pred_err,
        "predict_ms": predict_ms, "blend_host_ms": blend_ms,
        "net_upload_ms": upload_ms, "blended_snapshot_ms": snapshot_ms,
        "gang_bw": gang_bw, "gain_ratio": gain,
        "static_kernel_vs_plain": kernel_check}
    del sparse, oracle, blended

    # 2. The loop with the layers on: the loop phase's backlog in arrival
    # waves, a maintain() after each (every interval ~0, so each one
    # harvests, evaluates the SLOs, trains and shadow-ranks).
    lcfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                           score_backend="pallas",
                           queue_capacity=LOOP_PODS + BATCH,
                           enable_explain=True)
    on = dataclasses.replace(
        lcfg, enable_quality_obs=True, enable_slo=True,
        enable_learned_score=True, quality_harvest_interval_s=1e-6,
        slo_eval_interval_s=1e-6, policy_train_interval_s=1e-6,
        policy_eval_interval_s=1e-6)
    real_batches = -(-LOOP_PODS // BATCH)
    captured: dict = {}
    real_eval = qmod._evaluate

    def keep_eval(*args):
        captured.setdefault("args", args)
        return real_eval(*args)

    def drive(cfg, loop_kw, attach=None):
        cluster, lat_, bw_ = build_fake_cluster(ClusterSpec(num_nodes=NODES,
                                                            seed=SEED))
        loop = SchedulerLoop(cluster, cfg, method="parallel", device="cuda",
                             **loop_kw)
        loop.encoder.set_network(lat_, bw_)
        feed_metrics(cluster, loop.encoder, np.random.default_rng(SEED + 3))
        if attach is not None:
            loop.encoder.attach_netmodel(attach)
        harvest_ms: list = []
        train_ms: list = []
        if loop.quality is not None:
            timed(loop.quality, "harvest", harvest_ms)
        if loop.policy is not None:
            timed(loop, "_policy_train_tick", train_ms)
        pods = generate_workload(
            WorkloadSpec(num_pods=LOOP_PODS, seed=SEED + 5, services=8,
                         peer_fraction=0.5, affinity_fraction=0.1,
                         anti_fraction=0.1),
            scheduler_name=cfg.scheduler_name)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for start in range(0, len(pods), ROBUST_CHUNK):
                cluster.add_pods(pods[start:start + ROBUST_CHUNK])
                loop.run_once()
                loop.maintain()
            loop.run_until_drained()
            loop.flush_binds()
            loop.maintain()
            torch.cuda.synchronize()
        finally:
            loop.stop_bind_worker()
        wall = time.perf_counter() - t0
        c = counts()
        for n, v in c.items():
            launches[n] += v
        check(c["static_scores_kernel"] >= real_batches,
              f"loop drive: {c['static_scores_kernel']} static launches "
              f"for {real_batches} batches")
        spans = [sp.dur_s * 1e3 for sp in loop.flight.spans()]
        return cluster, loop, pods, {
            "bindings": {b.pod_name: b.node_name for b in cluster.bindings},
            "scheduled": loop.scheduled, "wall_s": wall,
            "cycle_ms": pct(spans), "launches": c,
            "harvest_ms": pct(harvest_ms), "train_tick_ms": pct(train_ms)}

    identity = {}
    for path, kw in (("burst", dict(burst_batches=8)),
                     ("pipelined", dict(burst_batches=8, pipelined=True))):
        _, _, _, off_run = drive(lcfg, kw)
        _, lp, _, on_run = drive(on, kw)
        check(off_run["bindings"] == on_run["bindings"],
              f"{path}: bindings differ with quality, SLO and policy on "
              f"({sum(off_run['bindings'].get(k) != v for k, v in on_run['bindings'].items())} pods)")
        check(on_run["scheduled"] > 0, f"{path}: nothing bound")
        check(lp.quality.harvested_total > 0 and lp.policy.steps_total > 0
              and lp.slo.evaluations_total > 0,
              f"{path}: a layer did not run ({lp.quality.summary()}, "
              f"{lp.policy.steps_total} policy steps)")
        identity[path] = {
            "scheduled": on_run["scheduled"],
            "cycle_ms": {"off": off_run["cycle_ms"],
                         "on": on_run["cycle_ms"]},
            "wall_s": {"off": off_run["wall_s"], "on": on_run["wall_s"]},
            "harvest_ms": on_run["harvest_ms"],
            "train_tick_ms": on_run["train_tick_ms"]}

    # The same backlog, pipelined, with the topology model of (1) blending
    # the loop's net planes.
    qmod._evaluate = keep_eval
    try:
        cluster, loop, pods, run = drive(
            on, dict(burst_batches=8, pipelined=True), attach=model)
    finally:
        qmod._evaluate = real_eval
    auditor = IntegrityAuditor(loop.encoder, loop)
    audit = auditor.audit_once()
    check(audit["clean"], f"blended loop: the audit found drift "
          f"{sorted(audit['drift'])} {sorted(audit['staging'])}")
    recs = loop.flight.explains()
    prov = sorted({r["provenance"]["network"] for r in recs})
    check(prov == ["netmodel_blend"], f"blended loop: explain provenance "
          f"{prov}")
    # An outcome for every bound pod with a resolvable peer (the
    # pipelined path notes some pods twice, in both packages, so the
    # counters are not compared with the pod count).
    q = loop.quality.summary()
    bound = {b.pod_name for b in cluster.bindings}

    def resolvable(pod) -> bool:
        for peer in pod.peers:
            node = loop._peer_node(peer)
            if node and loop.encoder.node_slot(node) is not None:
                return True
        return False

    want = {p.uid for p in pods if p.name in bound and resolvable(p)}
    got = {o["pod_uid"] for o in loop.quality.outcomes()}
    check(q["pending"] == 0 and want == got and got,
          f"blended loop: {len(got)} outcomes for {len(want)} bound pods "
          f"with a resolvable peer ({q})")
    pol = loop.policy
    check(pol.steps_total > 0, "blended loop: no policy step")
    check(pol.shadow_agree_total + pol.shadow_disagreement_total > 0,
          "blended loop: nothing shadow-ranked")
    check(pol.evals_total > 0 and pol.rejections_total == pol.evals_total
          and pol.promotions_total == 0,
          f"blended loop: {pol.evals_total} evals, {pol.rejections_total} "
          f"rejections, {pol.promotions_total} promotions")
    check(loop.slo.evaluations_total > 0, "blended loop: no SLO evaluation")
    harvest_check = {}
    if "args" not in captured:
        check(False, "blended loop: no harvest was captured")
    else:
        args = captured["args"]
        dev_out = real_eval(*args)
        cpu_out = real_eval(*(a.cpu() if torch.is_tensor(a) else a
                              for a in args))
        torch.cuda.synchronize()
        harvest_check = {
            "pods": int(args[3].shape[0]),
            "max_rel_err": max(float(((dev_out[i].cpu() - cpu_out[i]).abs()
                                      / cpu_out[i].abs().clamp_min(1e-30))
                                     .max()) for i in range(7))}
        check(all(torch.allclose(dev_out[i].cpu(), cpu_out[i], rtol=1e-5,
                                 atol=1e-6) for i in range(7))
              and torch.equal(dev_out[7].cpu(), cpu_out[7]),
              f"blended loop: harvest on the card differs from the CPU by "
              f"{harvest_check['max_rel_err']}")
    blended_loop = {
        "scheduled": run["scheduled"], "wall_s": run["wall_s"],
        "cycle_ms": run["cycle_ms"], "launches": run["launches"],
        "harvest_ms": run["harvest_ms"],
        "train_tick_ms": run["train_tick_ms"],
        "audit_ms": auditor.last_audit_ms,
        "explain_records": len(recs), "quality": q,
        "policy": {k: pol.summary()[k] for k in (
            "steps_total", "examples_total", "version", "evals_total",
            "rejections_total", "promotions_total", "shadow_agree_total",
            "shadow_disagreement_total")},
        "slo_evaluations": loop.slo.evaluations_total,
        "harvest_vs_cpu": harvest_check}
    del cluster, loop

    # 3. The daemon with every learning layer for DAEMON_S seconds.
    build_dir = (Path(__file__).resolve().parent
                 / "kubernetesnetawarescheduler_tpu_torch" / "_build")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        dsock = os.path.join(tmp, "learn.sock")
        cfgp = os.path.join(tmp, "config.json")
        with open(cfgp, "w") as fh:
            json.dump({"max_nodes": NODES, "max_pods": BATCH,
                       "max_peers": PEERS, "score_backend": "pallas",
                       "enable_explain": True, "enable_netmodel": True}, fh)
        base_argv = ["--cluster", f"fake:{NODES}", "--uds", dsock,
                     "--config", cfgp, "--device", "cuda", "--quality-obs",
                     "--slo", "--learned-score"]
        stop = threading.Event()
        outcome: dict = {}

        def run_daemon():
            try:
                outcome["rc"] = serve.main(
                    base_argv + ["--probe-period-s", "1"], stop)
            except BaseException as exc:  # noqa: BLE001 - checked below
                outcome["error"] = repr(exc)

        before = {t.name for t in threading.enumerate()}
        th = threading.Thread(target=run_daemon, daemon=True)
        t0 = time.perf_counter()
        th.start()
        daemon: dict = {}
        try:
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and th.is_alive():
                if os.path.exists(dsock):
                    break
                time.sleep(0.1)
            daemon["start_s"] = time.perf_counter() - t0
            if not os.path.exists(dsock):
                fail("learn", f"the daemon did not start: {outcome}")
            time.sleep(DAEMON_S)
            metrics = call_uds(dsock, "/metrics", b"").decode()
            slo_doc = json.loads(call_uds(dsock, "/debug/slo", b""))
            pol_doc = json.loads(call_uds(dsock, "/debug/policy", b""))
        finally:
            stop.set()
            th.join(timeout=120)
        for _ in range(50):
            alive = [t.name for t in threading.enumerate()
                     if t.name not in before and t.is_alive()]
            if not alive:
                break
            time.sleep(0.1)
        types_ = [ln.split()[2] for ln in metrics.splitlines()
                  if ln.startswith("# TYPE ")]

        def value(name: str) -> float:
            return sum(float(ln.rsplit(" ", 1)[1])
                       for ln in metrics.splitlines()
                       if ln.startswith(name)
                       and ln[len(name):len(name) + 1] in " {")

        for fam in ("netaware_netmodel_sgd_steps_total",
                    "netaware_netmodel_pair_coverage_fraction",
                    "netaware_netmodel_probe_selection_entropy_bits",
                    "netaware_quality_outcomes_total",
                    "netaware_quality_regret",
                    "netaware_slo_evaluations_total",
                    "netaware_slo_burn_rate",
                    "netaware_policy_train_steps_total",
                    "netaware_policy_version"):
            check(types_.count(fam) == 1,
                  f"daemon /metrics: {fam} TYPE x{types_.count(fam)}")
        check(len(types_) == len(set(types_)),
              "daemon /metrics repeats a # TYPE family")
        check(slo_doc.get("slo", {}).get("evaluations_total", 0) >= 0
              and "objectives" in slo_doc.get("slo", {})
              and "harvested_total" in slo_doc.get("quality", {}),
              f"/debug/slo: {str(slo_doc)[:300]}")
        check(pol_doc.get("enabled") is True and "dataset" in pol_doc,
              f"/debug/policy: {str(pol_doc)[:300]}")
        check(not th.is_alive(), "the daemon did not stop")
        check(outcome.get("rc") == 0 and "error" not in outcome,
              f"daemon shutdown: {outcome}")
        check(not alive, f"threads left running: {alive}")
        daemon.update({
            "seconds": DAEMON_S,
            "netmodel_steps": value("netaware_netmodel_sgd_steps_total"),
            "netmodel_coverage":
                value("netaware_netmodel_pair_coverage_fraction"),
            "slo_evaluations": value("netaware_slo_evaluations_total"),
            "policy_steps": value("netaware_policy_train_steps_total"),
            "metric_families": len(types_)})

    info = {"phase": "learn", "nodes": NODES, "batch": BATCH, "card": card,
            "topology": topology, "identity": identity,
            "blended_loop": blended_loop, "daemon": daemon,
            "launches": launches, "seconds": time.perf_counter() - t_phase}
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("learn", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info


# The scenario engine.  The campaign is the JAX suite's scenario leg at
# its own shape (256 nodes in three classes, base rate 360, batch 256,
# every knob on) with its virtual duration cut from 2,900 s to
# SCENARIO_DURATION_S (≈209 k pods); the fault drive is JAX
# tests/test_scenario.py's state-fault replay; the width drive streams a
# knobs-off trace of the campaign's spec at the serving width, its rate
# ×20 to hold the leg's occupancy, through the loop under both backends;
# the policy gate is the suite's policy leg at its defaults, then the
# daemon replaying that leg's trace.
SCENARIO_DURATION_S = 580.0
FAULT_DURATION_S, FAULT_RATE = 60.0, 25.0
WIDTH_RATE, WIDTH_DURATION_S, WIDTH_BATCH = 7200.0, 4.0, 256
WIDTH_CAPTURE_AT = 20
POLICY_DAEMON_NODES = 512


class _CountingList(list):
    """A cluster's binding history that also counts every name bound,
    whatever the replay later truncates."""

    def __init__(self, counts) -> None:
        super().__init__()
        self.counts = counts

    def append(self, binding) -> None:
        self.counts[binding.pod_name] += 1
        super().append(binding)


def phase_scenario():
    import collections
    import contextlib
    import io
    import os
    import tempfile
    import threading

    from kubernetesnetawarescheduler_tpu_torch import serve
    from kubernetesnetawarescheduler_tpu_torch.api.server import call_uds
    from kubernetesnetawarescheduler_tpu_torch.bench import suite
    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        build_fake_cluster,
        feed_metrics,
    )
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import preempt
    from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
    from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
    from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
        IntegrityAuditor,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.core.rebalance import (
        Rebalancer,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.score import _EPS
    from kubernetesnetawarescheduler_tpu_torch.obs.quality import (
        QualityObserver,
    )
    from kubernetesnetawarescheduler_tpu_torch.policy import replay_eval
    from kubernetesnetawarescheduler_tpu_torch.scenario import (
        generate as sgen,
    )
    from kubernetesnetawarescheduler_tpu_torch.scenario import (
        replay as srep,
    )
    from kubernetesnetawarescheduler_tpu_torch.scenario.scorecard import (
        check_scorecard,
    )

    t_phase = time.perf_counter()
    errors: list[str] = []
    card = nvidia_smi()

    def check(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)

    def counts() -> dict:
        return {n: fn.launches for n, fn in K.KERNELS.items()}

    def over_capacity(s) -> int:
        return int(((s.used > s.cap + _EPS).any(dim=1) & s.node_valid)
                   .sum())

    build_dir = (Path(__file__).resolve().parent
                 / "kubernetesnetawarescheduler_tpu_torch" / "_build")
    build_dir.mkdir(parents=True, exist_ok=True)
    launches = {n: 0 for n in K.KERNELS}

    # 1. The campaign.  Each loop the replay builds keeps a full count of
    # the names bound (the replay truncates the binding history), every
    # eviction is recorded, and the replay's wall is split by what its
    # outermost calls spend (a call made inside another counts in the
    # outer one; the oracle's loop counts as the oracle).
    split: collections.Counter = collections.Counter()
    depth = {"n": 0}
    restore: list = []

    def timed_part(owner, attr: str, part: str) -> None:
        real = getattr(owner, attr)
        restore.append((owner, attr, real))

        def wrapper(*a, **kw):
            if depth["n"]:
                return real(*a, **kw)
            depth["n"] = 1
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                split[part] += time.perf_counter() - t0
                depth["n"] = 0

        setattr(owner, attr, wrapper)

    built: list = []
    evicted: collections.Counter = collections.Counter()
    real_build = srep._build_loop
    real_evict = preempt.evict_as_unit

    def build(*a, **kw):
        out = real_build(*a, **kw)
        client = out[2]
        inner = client.inner if hasattr(client, "inner") else client
        names: collections.Counter = collections.Counter()
        inner.bindings = _CountingList(names)
        built.append({"loop": out[0], "names": names})
        return out

    def evict(client, enc, victims):
        done = real_evict(client, enc, victims)
        evicted.update(v.name for v in done)
        return done

    srep._build_loop = build
    preempt.evict_as_unit = evict
    for owner, attr, part in (
            (SchedulerLoop, "run_once", "cycles"),
            (SchedulerLoop, "maintain", "loop_maintain"),
            (SchedulerLoop, "run_until_drained", "final_drain"),
            (IntegrityAuditor, "audit_once", "audits"),
            (QualityObserver, "harvest", "harvest"),
            (Rebalancer, "tick", "rebalance_tick"),
            (Encoder, "set_network", "network_uploads"),
            (srep, "_sampled_oracle_bw", "oracle")):
        timed_part(owner, attr, part)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        camp = suite.run_scenario_config(duration_s=SCENARIO_DURATION_S,
                                         device="cuda").metrics
    finally:
        srep._build_loop = real_build
        preempt.evict_as_unit = real_evict
        for owner, attr, real in restore:
            setattr(owner, attr, real)
    peak_device = int(torch.cuda.max_memory_allocated())
    d = camp["detail"]
    sc = d["scorecard"]
    main_run = built[0]
    main_loop, names = main_run["loop"], main_run["names"]
    rebound = {n: c for n, c in names.items() if c > 1}
    inv = dict(d["invariants"])
    check(d["scorecard_problems"] == [] and check_scorecard(sc) == [],
          f"campaign: scorecard problems {d['scorecard_problems']}")
    check(d["queue_dropped"] == 0, f"campaign: {d['queue_dropped']} pods "
          f"dropped from the queue")
    check(d["half_moved_gangs"] == 0,
          f"campaign: {d['half_moved_gangs']} half-moved gangs")
    integ = sc["repair_events"]["integrity"]
    check(integ.get("unrepaired", -1) == 0,
          f"campaign: unrepaired state faults {integ}")
    check(len(main_loop.queue) == 0, f"campaign: {len(main_loop.queue)} "
          f"pods still queued after the drain")
    check(inv.get("pods_lost", -1) == 0 and inv.get("ledger_orphans", -1)
          == 0 and inv.get("ledger_missing", -1) == 0,
          f"campaign: invariants {inv} (a pending pod neither queued nor "
          f"warned unschedulable, or a ledger mismatch)")
    check(set(rebound) <= set(evicted)
          and all(c == 2 for c in rebound.values())
          and inv.get("pods_double_bound", -1) <= len(rebound),
          f"campaign: names bound twice {dict(list(rebound.items())[:8])} "
          f"({len(rebound)}) are not the evicted pods, each twice "
          f"({len(evicted)} evicted)")
    check(d["pods_streamed"] == d["gen_stats"]["pods"],
          f"campaign: streamed {d['pods_streamed']} of "
          f"{d['gen_stats']['pods']} generated pods")
    campaign = {
        "nodes": d["num_nodes"], "batch": d["batch"],
        "duration_virtual_s": d["duration_virtual_s"],
        "pods_per_wall_s": camp["value"],
        "gen_wall_s": d["gen_wall_s"], "replay_wall_s": d["replay_wall_s"],
        "cycle_p50_ms": d["cycle_p50_ms"],
        "cycle_p99_ms": d["cycle_p99_ms"],
        "pods_streamed": d["pods_streamed"], "pods_bound": d["pods_bound"],
        "unschedulable_events": d["unschedulable_events"],
        "peak_rss_bytes": d["peak_rss_bytes"],
        "rss_first_bytes": d["rss_first_bytes"],
        "rss_last_bytes": d["rss_last_bytes"],
        "max_memory_allocated": peak_device,
        "gen_stats": d["gen_stats"], "trace_bytes_gz": d["trace_bytes_gz"],
        "repair_events": sc["repair_events"],
        "rebalance": {k: sc["rebalance"][k] for k in (
            "pods_evicted_total", "half_moved_gangs", "within_budget")},
        "names_bound_twice": len(rebound), "evicted": len(evicted),
        "wall_split_s": {**split, "other": d["replay_wall_s"]
                         - sum(split.values())},
        "loop_phases": main_loop.timer.summary(),
        "invariants": inv, "scorecard": sc}
    del built, main_run, main_loop

    # 2. The fault drive: JAX tests/test_scenario.py's state-fault replay
    # on the card, only the state-fault knob on.
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        fspec = sgen.ScenarioSpec(
            seed=1, duration_s=FAULT_DURATION_S, base_rate=FAULT_RATE,
            tick_s=1.0, gang_fraction=0.0, gang_sizes=(4,),
            serving_lifetime_s=10.0, batch_lifetime_s=5.0,
            gang_lifetime_s=8.0, lifetime_floor_s=2.0,
            state_fault_rate_per_s=0.1,
            cluster=ClusterSpec(num_nodes=32, seed=3))
        fpath = os.path.join(tmp, "faulty.jsonl")
        fstats = sgen.generate_trace(fspec, fpath)
        t0 = time.perf_counter()
        fres = srep.replay_trace(fpath, batch=16, chaos=False, drift=False,
                                 state_faults=True, rebalance=False,
                                 quality=False, oracle_sample=0,
                                 queue_capacity=1024, device="cuda")
        fwall = time.perf_counter() - t0
    applied = sum(fres.state_faults.values())
    check(fstats["state_faults"] > 0 and applied > 0,
          f"fault drive: {applied} faults applied of "
          f"{fstats['state_faults']} generated")
    check(fres.integrity is not None
          and fres.integrity["unrepaired"] == 0,
          f"fault drive: integrity {fres.integrity}")
    check(fres.pods_bound >= 0.9 * fres.pods_streamed,
          f"fault drive: {fres.pods_bound} of {fres.pods_streamed} bound")
    check(fres.queue_dropped == 0,
          f"fault drive: {fres.queue_dropped} dropped")
    fault = {"pods_streamed": fres.pods_streamed,
             "pods_bound": fres.pods_bound, "state_faults": fres.state_faults,
             "integrity": fres.integrity, "wall_s": fwall}

    # 3. The width drive: a knobs-off trace of the campaign's spec at the
    # serving width, its pod_waves through a loop of _build_loop's config,
    # as built ("xla") and with the kernel backend.
    wspec = dataclasses.replace(
        suite.scenario_spec(num_nodes=NODES, duration_s=WIDTH_DURATION_S,
                            base_rate=WIDTH_RATE, seed=SEED),
        link_burst_rate_per_s=0.0, node_churn_rate_per_s=0.0,
        state_fault_rate_per_s=0.0, chaos_seed=None)
    armed: dict = {"on": False, "calls": 0}
    real_static = tiled_score.static_tile_scores

    def capturing(pack, groups, pods, use_bfloat16, transposed=False,
                  peers=None):
        if armed["on"]:
            armed["calls"] += 1
            if armed["calls"] == WIDTH_CAPTURE_AT:
                armed["args"] = (pack, groups.clone(), pods, use_bfloat16)
        return real_static(pack, groups, pods, use_bfloat16,
                           transposed=transposed, peers=peers)

    width: dict = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        wpath = os.path.join(tmp, "width.jsonl.gz")
        t0 = time.perf_counter()
        wstats = sgen.generate_trace(wspec, wpath)
        width["gen_wall_s"] = time.perf_counter() - t0
        width["pods"] = wstats["pods"]
        header, _ = sgen.read_trace(wpath)
        loop0, wcfg, *_ = srep._build_loop(
            header, WIDTH_BATCH, "parallel", chaos=False,
            queue_capacity=4096, device="cuda")
        loop0.stop_bind_worker()
        del loop0
        runs = {}
        for backend in ("xla", "pallas"):
            cfg = dataclasses.replace(wcfg, score_backend=backend)
            cluster, lat, bw = build_fake_cluster(wspec.cluster)
            loop = SchedulerLoop(cluster, cfg, method="parallel",
                                 device="cuda")
            loop.encoder.set_network(lat, bw)
            feed_metrics(cluster, loop.encoder,
                         np.random.default_rng(wspec.seed + 1))
            _, events = sgen.read_trace(wpath)
            waves = 0
            K.reset_launch_counts()
            armed["on"] = backend == "pallas"
            tiled_score.static_tile_scores = capturing
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                for _t, wave in srep.pod_waves(events, WIDTH_BATCH,
                                               wspec.tick_s,
                                               cfg.scheduler_name):
                    cluster.add_pods(wave)
                    loop.run_once(timeout=0.0)
                    waves += 1
                    stall = 0
                    while len(loop.queue) > 2 * WIDTH_BATCH and stall < 8:
                        before = (loop.scheduled, len(loop.queue))
                        loop.run_once(timeout=0.0)
                        stall = (stall + 1 if (loop.scheduled,
                                               len(loop.queue)) == before
                                 else 0)
                loop.run_until_drained()
                loop.flush_binds()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = counts()
            finally:
                tiled_score.static_tile_scores = real_static
                armed["on"] = False
                loop.stop_bind_worker()
            if backend == "pallas":
                for n, v in c.items():
                    launches[n] += v
            bound = [(b.pod_name, b.node_name) for b in cluster.bindings]
            bnames = [n for n, _ in bound]
            warned = {e.involved_pod for e in cluster.events
                      if e.type == "Warning"}
            pending = [p.name for p in cluster.list_pending_pods()]
            check(len(bnames) == len(set(bnames)),
                  f"width {backend}: {len(bnames) - len(set(bnames))} pods "
                  f"bound twice")
            check(len(bnames) + len(pending) == wstats["pods"]
                  and all(n in warned for n in pending)
                  and len(loop.queue) == 0,
                  f"width {backend}: {len(bnames)} bound + {len(pending)} "
                  f"pending of {wstats['pods']} "
                  f"({sum(n not in warned for n in pending)} not "
                  f"unschedulable)")
            over = over_capacity(loop.encoder.snapshot())
            check(over == 0, f"width {backend}: {over} nodes over capacity")
            if backend == "pallas":
                check(c["static_scores_kernel"] >= waves,
                      f"width: {c['static_scores_kernel']} static launches "
                      f"for {waves} waves")
                check(c["peer_columns"] == c["static_scores_kernel"],
                      f"width: peer columns compacted {c['peer_columns']} "
                      f"times for {c['static_scores_kernel']} static "
                      f"launches")
            runs[backend] = {"bindings": dict(bound)}
            width[backend] = {"pods_per_s": len(bnames) / wall,
                              "wall_s": wall, "bound": len(bnames),
                              "unschedulable": len(pending),
                              "waves": waves, "launches": c,
                              "loop_phases": loop.timer.summary()}
            del loop, cluster, lat, bw
    shared = sum(runs["pallas"]["bindings"].get(k) == v
                 for k, v in runs["xla"]["bindings"].items())
    width["bindings_shared"] = shared
    kernel_check = {}
    if "args" not in armed:
        check(False, "width: no static-kernel call was captured")
    else:
        pack, groups, kpods, bf16 = armed["args"]
        with uncounted():
            raw_t, ok_t = K.static_tile_scores(pack, groups, kpods, bf16,
                                               transposed=True)
            raw, ok = K.static_tile_scores_plain(pack, groups, kpods, bf16)
        torch.cuda.synchronize()
        raw_t, ok_t = raw_t.T, ok_t.T
        err = (float((raw_t[ok] - raw[ok]).abs().max())
               if bool(ok.any()) else 0.0)
        kernel_check = {"launch": WIDTH_CAPTURE_AT,
                        "shape": list(raw_t.shape),
                        "feasible": int(ok.sum()), "max_abs_err": err}
        check(bool(ok.any()) and torch.equal(ok_t, ok) and torch.allclose(
            raw_t[ok], raw[ok], rtol=TOL, atol=TOL),
              f"width: static kernel differs from plain by {err}, mask on "
              f"{int((ok_t != ok).sum())}")
        del armed["args"], pack, groups, kpods
    width["static_kernel_vs_plain"] = kernel_check

    # 4. The policy gate: the suite's policy leg at its defaults; the
    # loser must be refused by the records leg before any replay (two
    # replays in all: the winner's incumbent and candidate).
    replays = {"n": 0}
    real_ratio = replay_eval._replay_ratio

    def counted_ratio(*a, **kw):
        replays["n"] += 1
        return real_ratio(*a, **kw)

    replay_eval._replay_ratio = counted_ratio
    try:
        pdoc = suite.run_policy_config(device="cuda").metrics
    finally:
        replay_eval._replay_ratio = real_ratio
    pol = pdoc["detail"]["policy"]
    check(pol["disabled_bit_identical"],
          "policy: bindings differ with the policy attached")
    check(pol["rejection"]["reason"] == "records_regression"
          and replays["n"] == 2,
          f"policy: the loser was {pol['rejection']['reason']} after "
          f"{replays['n']} replays in all")
    gate = {
        "decision": pol["promotion"]["reason"],
        "promoted": pol["promoted"],
        "incumbent_bw_ratio_vs_oracle": pol["incumbent_bw_ratio_vs_oracle"],
        "candidate_bw_ratio_vs_oracle": pol["candidate_bw_ratio_vs_oracle"],
        "oracle_gain_recovered_fraction":
            pol["oracle_gain_recovered_fraction"],
        "rejection": pol["rejection"]["reason"],
        "records_delta": pol["rejection"]["records_delta"],
        "shadow_overhead_fraction": pol["shadow_overhead_fraction"],
        "shadow_ms_p50": pdoc["detail"]["shadow_ms_p50"],
        "cycle_ms_p50_off": pdoc["detail"]["cycle_ms_p50_off"],
        "cycle_ms_p50_on": pdoc["detail"]["cycle_ms_p50_on"],
        "ab_p50_inflation": pdoc["detail"]["ab_p50_inflation"],
        "gate_replay_wall_s": pdoc["detail"]["gate_replay_wall_s"],
        "explains_recorded": pdoc["detail"]["explains_recorded"]}

    # The daemon with the policy leg's trace: it starts, its first
    # maintain() runs the gate with both replays on the card, and every
    # thread it started ends.
    daemon: dict = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        trace = os.path.join(tmp, "policy.jsonl.gz")
        sgen.generate_trace(suite.policy_trace_spec(), trace)
        dsock = os.path.join(tmp, "policy.sock")
        cfgp = os.path.join(tmp, "config.json")
        with open(cfgp, "w") as fh:
            json.dump({"max_nodes": POLICY_DAEMON_NODES, "max_pods": 64,
                       "max_peers": PEERS, "enable_explain": True}, fh)
        argv = ["--cluster", f"fake:{POLICY_DAEMON_NODES}", "--uds", dsock,
                "--config", cfgp, "--device", "cuda", "--learned-score",
                "--policy-eval-trace", trace, "--probe-period-s", "0"]
        stop = threading.Event()
        outcome: dict = {}
        err = io.StringIO()

        def run_daemon():
            try:
                with contextlib.redirect_stderr(err):
                    outcome["rc"] = serve.main(argv, stop)
            except BaseException as exc:  # noqa: BLE001 - checked below
                outcome["error"] = repr(exc)

        before = {t.name for t in threading.enumerate()}
        th = threading.Thread(target=run_daemon, daemon=True)
        t0 = time.perf_counter()
        th.start()
        pol_doc: dict = {}
        try:
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and th.is_alive():
                if os.path.exists(dsock):
                    break
                time.sleep(0.1)
            daemon["start_s"] = time.perf_counter() - t0
            if not os.path.exists(dsock):
                fail("scenario", f"the daemon did not start: {outcome}")
            deadline = time.monotonic() + 180
            while time.monotonic() < deadline and th.is_alive():
                pol_doc = json.loads(call_uds(dsock, "/debug/policy", b""))
                if (pol_doc.get("rejections_total", 0)
                        + pol_doc.get("promotions_total", 0)) >= 1:
                    break
                time.sleep(0.5)
            daemon["first_eval_s"] = time.perf_counter() - t0
            rest = DAEMON_S - (time.perf_counter() - t0)
            if rest > 0:
                time.sleep(rest)
        finally:
            stop.set()
            th.join(timeout=120)
        for _ in range(50):
            alive = [t.name for t in threading.enumerate()
                     if t.name not in before and t.is_alive()]
            if not alive:
                break
            time.sleep(0.1)
        check(pol_doc.get("eval_trace") == trace,
              f"daemon /debug/policy eval_trace {pol_doc.get('eval_trace')}")
        tally = {k: pol_doc.get(k, 0) for k in (
            "evals_total", "rejections_total", "promotions_total")}
        check(tally["evals_total"] >= 1
              and tally["rejections_total"] + tally["promotions_total"]
              == tally["evals_total"],
              f"daemon: the gate did not finish an evaluation ({tally})")
        check("NEVER be promoted" not in err.getvalue(),
              "daemon: the shadow-only WARN with a trace given")
        check(not th.is_alive(), "the daemon did not stop")
        check(outcome.get("rc") == 0 and "error" not in outcome,
              f"daemon shutdown: {outcome}")
        check(not alive, f"threads left running: {alive}")
        daemon.update({"nodes": POLICY_DAEMON_NODES, **tally,
                       "seconds": time.perf_counter() - t0})

    info = {"phase": "scenario", "card": card, "campaign": campaign,
            "fault_drive": fault, "width": width, "policy": gate,
            "daemon": daemon, "launches": launches,
            "seconds": time.perf_counter() - t_phase}
    if errors:
        emit({**info, "ok": False, "errors": errors[:20]})
        fail("scenario", f"{len(errors)} failed checks")
    info["ok"] = True
    emit(info)
    return info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from kubernetesnetawarescheduler_tpu_torch.bench.density import (
        synthetic_density,
    )
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K

    run_phase("device", phase_device)
    name = torch.cuda.get_device_name(0)
    mem_bw, f32_peak = peaks(name)
    # bench.py's density shape at its default precision (bf16 inputs).
    cfg = SchedulerConfig(max_nodes=NODES, max_pods=BATCH, max_peers=PEERS,
                          score_backend="pallas")

    def generate():
        t0 = time.perf_counter()
        out = synthetic_density(NODES, PODS, cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        emit({"phase": "generate", "ok": True, "nodes": NODES,
              "pods": int(out[1].pod_valid.sum()),
              "seconds": time.perf_counter() - t0})
        return out

    state, stream = run_phase("generate", generate) or (None, None)
    kres = run_phase("kernels", phase_kernels, state, stream, cfg, mem_bw,
                     f32_peak)
    main_res = run_phase("main", phase_main, state, stream, cfg)
    run_phase("parity", phase_parity, state, stream, cfg)
    serve_res = run_phase("serve", phase_serve)
    loop_res = run_phase("loop", phase_loop)
    webhook_res = run_phase("webhook", phase_webhook)
    feed_res = run_phase("feed", phase_feed)
    robust_res = run_phase("robust", phase_robust)
    learn_res = run_phase("learn", phase_learn)
    scenario_res = run_phase("scenario", phase_scenario)
    if FAILED:
        emit({"failed_phases": FAILED})
        return 1
    prec = "bf16" if cfg.use_bfloat16 else "f32"
    src = "kubernetesnetawarescheduler_tpu/core/pallas_score.py"
    replaces = {"static_scores_kernel": f"{src}:278",
                "masked_scores_kernel": f"{src}:193",
                "winner_scores_kernel": f"{src}:217",
                # The compaction picks the columns _net_accum walks.
                "peer_columns": f"{src}:60"}
    # Each kernel's launches on the path it belongs to: the replay for
    # the static kernel and the compaction, the serving seam for the
    # winner, the webhook's Score/Filter drive for the masked kernel.  The
    # scheduling loop (its four identity drives) runs the static kernel
    # and its compaction, and so do the feed phase's headline drain and
    # the robust phase's loop drives (identity, rebalance, reshape), the
    # learn phase's gang placements and loop drives, and the scenario
    # phase's width drive.
    path_of = {"static_scores_kernel": "main",
               "masked_scores_kernel": "webhook",
               "winner_scores_kernel": "serve",
               "peer_columns": "main"}
    by_path = {"main": main_res["launches"], "serve": serve_res["launches"],
               "loop": loop_res["launches"],
               "webhook": webhook_res["launches"],
               "feed": feed_res["launches"],
               "robust": robust_res["launches"],
               "learn": learn_res["launches"],
               "scenario": scenario_res["launches"]}
    rows = []
    for kname in K.KERNELS:
        r = kres[prec][kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "kubernetesnetawarescheduler_tpu_torch/csrc/"
                      "tiled_score.cu",
            "replaces": replaces[kname],
            "launches": by_path[path_of[kname]][kname],
            "launches_by_path": {p: c[kname] for p, c in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "l2": "flushed"})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
