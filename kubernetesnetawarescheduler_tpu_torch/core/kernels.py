"""The hand-written Hopper tile kernels, their plain versions, the build.

Three CUDA C++ kernels live in ``csrc/tiled_score.cu``; all call one
``__device__`` net-accumulation routine, as the JAX package's three
Pallas kernels share ``_net_accum``:

- :func:`static_tile_scores` replaces ``_static_kernel``
  (``kubernetesnetawarescheduler_tpu/core/pallas_score.py:_static_kernel``,
  launched by ``_static_pallas_call``): ``raw = T·Cᵀ + base + wsoft·soft``
  and the static mask, once per assign call.
- :func:`masked_tile_scores` replaces ``_kernel``
  (``kubernetesnetawarescheduler_tpu/core/pallas_score.py:_kernel``,
  launched by ``score_pods_tiled``): the same accumulation with the full
  ``_tile_scores`` epilogue, the Score/Filter answer.
- :func:`winner_tile_scores` replaces ``_winner_kernel``
  (``kubernetesnetawarescheduler_tpu/core/pallas_score.py:_winner_kernel``,
  launched by ``score_winner_tiled``): the masked kernel's scores, through
  the same ``__device__`` epilogue, reduced per pod to ``(best, node)``
  with the lowest-node-index tie-break.  Pallas carries the pair through
  the node tiles in order; CUDA blocks run in no order, so each tile's
  best goes into one ``atomicMax`` on a packed 64-bit key (ordered score
  bits high, inverted node index low).  It writes 8 bytes per pod and
  never the P×N plane.
- :func:`static_tile_scores_lanes` is ``_static_kernel`` over a lane
  axis, as the JAX fleet's ``vmap`` of ``_static_pallas_call`` adds a
  grid dimension: every input stacked ``[K, ...]`` (one tenant per
  lane), the compaction per lane, then one launch of
  ``static_scores_lanes_kernel`` with the lane on ``blockIdx.z``, which
  runs the solo kernel's tile body on its lane's slices (each lane has
  the solo launch's bits).

What bounds them on an H100: ``T`` holds at most ``max_peers`` non-zeros
per pod (192 of 5,120 columns in a 128-pod stream batch), so the function
needs only ``T``, the ``bw``/``lat`` columns of the batch's peers
(``2·N·count·4`` bytes), the node and pod planes and the outputs: ≈13 MB
at P=128, N=5,120, a bytes bound of ≈0.004 ms at 3.35 TB/s; the
``2·nnz(T)·N`` FLOPs are negligible.

All three kernels walk only those peer columns:
:func:`peer_columns` compacts them on the device (two small kernels,
``peer_flags_kernel`` and ``peer_scan_kernel``: the ascending columns
with any non-zero ``T`` and their count, which stays in device memory).
Each score call then copies ``T[:, cols]`` into a peer-major scratch
(``peer_traffic_kernel``) and walks the columns 32 at a time, copying
the traffic rows and gathering the ``bw``/``lat`` columns with
``cp.async``, two stages deep, forming ``C`` in shared memory (it never
reaches device memory).  Skipped columns would add
``fmaf(0, c, acc) == acc``, so the result has the same bits as the dense
walk; ``peers=(arange(n_k), [n_k])`` runs that dense walk through the
same kernel.  Tiles are 128 pods × 16 nodes (320 blocks at P=128,
N=5,120, three resident per SM), and the output tile goes through shared
memory so that both the ``[P, N]`` and the node-major ``[N, P]`` layout
are stored in contiguous runs; the winner stores no tile and reduces it
in registers, an 8-lane shuffle per pod row and one ``atomicMax`` per
pod row and tile.  What is left of the time is the scattered
``bw``/``lat`` gathers, one 32-byte sector per element in the row-major
layout, and the epilogue; a peer-major copy of ``bw``/``lat`` would
remove the first, at the cost of another N×N pair kept in step with the
encoder's delta patches.

Beside each kernel is its plain PyTorch version (same function, same
bf16 rounding rule: bf16-rounded inputs when ``use_bfloat16`` is set,
f32 accumulation, f32 out); the plain score versions compute the dense
product.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises — it never falls back.  Each
wrapper counts its kernel launches in ``.launches`` (under a lock: the
webhook's handler threads launch beside the loop's cycle thread).

:func:`conflict_round` is the conflict loop's round without zone work
(``csrc/conflict_round.cu``, seven launches a round; the JAX package's
``lax.while_loop`` body, which has no Pallas kernel).  Its plain version
is :func:`~.assign._round_body` with ``zone_work=False``.

The library is built on first use with ``nvcc`` for ``sm_90a`` from both
sources into ``kubernetesnetawarescheduler_tpu_torch/_build/`` and bound
with ``ctypes`` (a plain C interface; no PyTorch headers, so the build
takes seconds).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.core.score import (
    _EPS,
    winner_from_scores,
)
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    exact_matmul,
    index_tree,
)

NEG_INF = -1e30

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "tiled_score.cu",
           _PKG / "csrc" / "conflict_round.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class StaticPack:
    """Batch-invariant node side of both kernels, built once per replay
    or serving window.  ``bw``/``lat`` are ``[n_out, n_k]``: the output
    node axis may be a row shard of the peer axis, with ``params[7]``
    holding the shard's global row offset for the diagonal pin."""

    params: torch.Tensor      # f32[8]: wbw, wlat, inv_bw, inv_lat, wbal,
    #                           eps, wsoft, row_offset
    bw: torch.Tensor          # f32[n_out, n_k]
    lat: torch.Tensor         # f32[n_out, n_k]
    validk: torch.Tensor      # f32[n_k] peer-column validity
    base: torch.Tensor        # f32[n_out] metric vote
    node_valid: torch.Tensor  # f32[n_out]
    taint: torch.Tensor       # i32[n_out, W]
    label: torch.Tensor       # i32[n_out, W]


@dataclasses.dataclass
class PodPack:
    """Pod side of both kernels, packed per batch (O(P) work plus the
    ``[P, n_k]`` traffic matrix).  Soft weights are pre-zeroed where the
    term's bits are empty, so the kernels' trivially-true subset test
    adds no phantom weight."""

    t: torch.Tensor           # f32[P, n_k] traffic to each peer node
    req: torch.Tensor         # f32[P, R]
    pod_valid: torch.Tensor   # f32[P]
    tol: torch.Tensor         # i32[P, W]
    sel: torch.Tensor         # i32[P, W]
    affinity: torch.Tensor    # i32[P, W]
    anti: torch.Tensor        # i32[P, W]
    group_bit: torch.Tensor   # i32[P, W]
    soft_sel: torch.Tensor    # i32[P, T, W]
    soft_grp: torch.Tensor    # i32[P, T, W]
    soft_sel_w: torch.Tensor  # f32[P, T]
    soft_grp_w: torch.Tensor  # f32[P, T]


# ---------------------------------------------------------------------------
# Build and bind.
# ---------------------------------------------------------------------------

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{_PKG / 'csrc'} on first use and need the CUDA "
                       "toolkit")


def build_library() -> ctypes.CDLL:
    """Compile ``csrc/tiled_score.cu`` and ``csrc/conflict_round.cu``
    into one library (once per source content) and load it.
    ``build_library.seconds`` holds the compile time of this
    process's build (0 when a cached library was loaded) and
    ``build_library.log`` the compiler's ``-Xptxas -v`` report, kept
    beside the library so a cached load reads it too.

    Several processes may build into ``_build/`` at once (the ranks of a
    mesh): each compiles to a name of its own and renames the report,
    then the library, into place, so a process never loads a partial
    file, and one that finds the library finds its report too."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = b"".join(path.read_bytes() for path in SOURCES)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libtiled_score_{digest[:16]}.so"
    log = out.with_suffix(".log")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
            capture_output=True, text=True, check=False)
        build_library.seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES}:\n"
                               f"{proc.stdout + proc.stderr}")
        tmp_log = log.with_suffix(f".{os.getpid()}.logtmp")
        tmp_log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp_log, log)
        os.replace(tmp, out)
    build_library.log = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tiled_peer_columns.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    lib.tiled_peer_columns.restype = i32
    lib.tiled_static_scores.argtypes = (
        [ptr] * 20 + [ptr, ptr, i64, i64] + [i32] * 6 + [ptr])
    lib.tiled_static_scores.restype = i32
    lib.tiled_peer_columns_lanes.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.tiled_peer_columns_lanes.restype = i32
    lib.tiled_static_scores_lanes.argtypes = (
        [ptr] * 20 + [ptr, ptr, i64, i64] + [i32] * 7 + [ptr])
    lib.tiled_static_scores_lanes.restype = i32
    lib.tiled_masked_scores.argtypes = (
        [ptr] * 27 + [ptr] + [i32] * 7 + [ptr])
    lib.tiled_masked_scores.restype = i32
    lib.tiled_winner_scores.argtypes = (
        [ptr] * 27 + [ptr, ptr, ptr] + [i32] * 7 + [ptr])
    lib.tiled_winner_scores.restype = i32
    lib.conflict_round.argtypes = (
        [ptr] * 23 + [ctypes.c_float] * 2 + [i32] * 5 + [ptr])
    lib.conflict_round.restype = i32
    _LIB = lib
    return lib


build_library.seconds = 0.0
build_library.log = ""


def _check(x: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str,
           device: torch.device) -> int:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def _shapes(pack: StaticPack, pods: PodPack):
    n_out, n_k = pack.bw.shape[-2:]
    p, r = pods.req.shape[-2:]
    mw = pods.tol.shape[-1]
    t_soft = pods.soft_sel_w.shape[-1]
    return p, n_out, n_k, r, mw, t_soft


def _net_args(pack: StaticPack, pods: PodPack, dev: torch.device,
              lead: tuple = ()) -> list:
    """The input pointers every score kernel takes; ``lead`` is the
    leading lane axis ``(K,)`` of a lane launch."""
    p, n_out, n_k, _, mw, _ = _shapes(pack, pods)
    f32, i32 = torch.float32, torch.int32
    return [
        _check(pods.t, f32, lead + (p, n_k), "t", dev),
        _check(pack.bw, f32, lead + (n_out, n_k), "bw", dev),
        _check(pack.lat, f32, lead + (n_out, n_k), "lat", dev),
        _check(pack.validk, f32, lead + (n_k,), "validk", dev),
        _check(pack.params, f32, lead + (8,), "params", dev),
        _check(pack.base, f32, lead + (n_out,), "base", dev),
        _check(pack.node_valid, f32, lead + (n_out,), "node_valid", dev),
        _check(pack.taint, i32, lead + (n_out, mw), "taint", dev),
        _check(pack.label, i32, lead + (n_out, mw), "label", dev),
    ]


def _soft_args(pods: PodPack, dev: torch.device, lead: tuple = ()) -> list:
    p, t_soft, mw = pods.soft_sel.shape[-3:]
    f32, i32 = torch.float32, torch.int32
    return [
        _check(pods.soft_sel, i32, lead + (p, t_soft, mw), "soft_sel", dev),
        _check(pods.soft_grp, i32, lead + (p, t_soft, mw), "soft_grp", dev),
        _check(pods.soft_sel_w, f32, lead + (p, t_soft), "soft_sel_w", dev),
        _check(pods.soft_grp_w, f32, lead + (p, t_soft), "soft_grp_w", dev),
    ]


def _static_args(pack: StaticPack, groups: torch.Tensor, pods: PodPack,
                 dev: torch.device, lead: tuple = ()) -> list:
    """The 17 input pointers of the static kernel (solo or lanes)."""
    p, n_out, _, _, mw, _ = _shapes(pack, pods)
    f32, i32 = torch.float32, torch.int32
    return _net_args(pack, pods, dev, lead) + [
        _check(groups, i32, lead + (n_out, mw), "groups", dev),
        _check(pods.pod_valid, f32, lead + (p,), "pod_valid", dev),
        _check(pods.tol, i32, lead + (p, mw), "tol", dev),
        _check(pods.sel, i32, lead + (p, mw), "sel", dev),
    ] + _soft_args(pods, dev, lead)


def _masked_args(pack: StaticPack, used: torch.Tensor, cap: torch.Tensor,
                 groups: torch.Tensor, resident_anti: torch.Tensor,
                 pods: PodPack, dev: torch.device) -> list:
    """The 24 input pointers of the masked and the winner kernel."""
    p, n_out, _, r, mw, _ = _shapes(pack, pods)
    f32, i32 = torch.float32, torch.int32
    return _net_args(pack, pods, dev) + [
        _check(groups, i32, (n_out, mw), "groups", dev),
        _check(resident_anti, i32, (n_out, mw), "resident_anti", dev),
        _check(used, f32, (n_out, r), "used", dev),
        _check(cap, f32, (n_out, r), "cap", dev),
        _check(pods.pod_valid, f32, (p,), "pod_valid", dev),
        _check(pods.req, f32, (p, r), "req", dev),
        _check(pods.tol, i32, (p, mw), "tol", dev),
        _check(pods.sel, i32, (p, mw), "sel", dev),
        _check(pods.affinity, i32, (p, mw), "affinity", dev),
        _check(pods.anti, i32, (p, mw), "anti", dev),
        _check(pods.group_bit, i32, (p, mw), "group_bit", dev),
    ] + _soft_args(pods, dev)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


# ---------------------------------------------------------------------------
# Plain versions (the same functions in PyTorch).
# ---------------------------------------------------------------------------


def peer_columns_plain(t: torch.Tensor):
    """Plain version of :func:`peer_columns`: ``(cols i32[n_k],
    count i32[1])``, ``cols[:count]`` the ascending columns of ``t`` with
    any non-zero entry (NaN counts as non-zero), ``cols[count:] == -1``."""
    n_k = t.shape[1]
    hit = torch.nonzero((t != 0).any(dim=0)).flatten().to(torch.int32)
    cols = torch.full((n_k,), -1, dtype=torch.int32, device=t.device)
    cols[:hit.numel()] = hit
    return cols, torch.tensor([hit.numel()], dtype=torch.int32,
                              device=t.device)


def desirability_plain(pack: StaticPack) -> torch.Tensor:
    """``C f32[n_out, n_k]`` formed exactly as the kernels form each tile:
    the same f32 operation order, the diagonal pinned to ``wbw`` by
    global row index, invalid peer columns zeroed."""
    prm = pack.params
    wbw, wlat, inv_bw, inv_lat = prm[0], prm[1], prm[2], prm[3]
    n_out, n_k = pack.bw.shape
    c = wbw * pack.bw * inv_bw - wlat * pack.lat * inv_lat
    rows = prm[7].to(torch.int64) + torch.arange(n_out, device=c.device)
    cols = torch.arange(n_k, device=c.device)
    c = torch.where(rows[:, None] == cols[None, :], wbw, c)
    return c * pack.validk[None, :]


def net_accum_plain(pack: StaticPack, t: torch.Tensor,
                    use_bfloat16: bool) -> torch.Tensor:
    """``T @ Cᵀ`` (:func:`desirability_plain`), with both operands
    rounded to bf16 when asked, accumulated and returned in f32."""
    c = desirability_plain(pack)
    if use_bfloat16:
        t = t.to(torch.bfloat16).to(torch.float32)
        c = c.to(torch.bfloat16).to(torch.float32)
    return exact_matmul(t, c.T)


def soft_bonus_plain(label: torch.Tensor, groups: torch.Tensor,
                     pods: PodPack) -> torch.Tensor:
    """Unscaled soft-affinity bonus ``f32[P, N]``, term by term in the
    kernels' order."""
    p, t_soft, _ = pods.soft_sel.shape
    soft = torch.zeros((p, label.shape[0]), dtype=torch.float32,
                       device=label.device)
    for t in range(t_soft):
        sb = pods.soft_sel[:, t, None, :]                    # [P, 1, W]
        gb = pods.soft_grp[:, t, None, :]
        sel_match = ((label[None, :, :] & sb) == sb).all(dim=-1)
        grp_hit = ((groups[None, :, :] & gb) != 0).any(dim=-1)
        soft = soft + (torch.where(sel_match, pods.soft_sel_w[:, t, None], 0.0)
                       + torch.where(grp_hit, pods.soft_grp_w[:, t, None],
                                     0.0))
    return soft


def static_tile_scores_plain(pack: StaticPack, groups: torch.Tensor,
                             pods: PodPack, use_bfloat16: bool):
    """Plain version of :func:`static_tile_scores`: ``(raw f32[P, N],
    ok bool[P, N])``."""
    acc = net_accum_plain(pack, pods.t, use_bfloat16)
    ok = (pack.node_valid[None, :] > 0.5) & (pods.pod_valid[:, None] > 0.5)
    ok = ok & ((pack.taint[None, :, :] & ~pods.tol[:, None, :])
               == 0).all(dim=-1)
    ok = ok & ((pack.label[None, :, :] & pods.sel[:, None, :])
               == pods.sel[:, None, :]).all(dim=-1)
    soft = soft_bonus_plain(pack.label, groups, pods)
    raw = acc + pack.base[None, :] + pack.params[6] * soft
    return raw, ok


def static_tile_scores_lanes_plain(pack: StaticPack, groups: torch.Tensor,
                                   pods: PodPack, use_bfloat16: bool):
    """Plain version of :func:`static_tile_scores_lanes`:
    :func:`static_tile_scores_plain` on each lane, stacked, ``(raw
    f32[K, P, N], ok bool[K, P, N])``."""
    outs = [static_tile_scores_plain(index_tree(pack, k), groups[k],
                                     index_tree(pods, k), use_bfloat16)
            for k in range(groups.shape[0])]
    return (torch.stack([raw for raw, _ in outs]),
            torch.stack([ok for _, ok in outs]))


def masked_tile_scores_plain(pack: StaticPack, used: torch.Tensor,
                             cap: torch.Tensor, groups: torch.Tensor,
                             resident_anti: torch.Tensor, pods: PodPack,
                             use_bfloat16: bool) -> torch.Tensor:
    """Plain version of :func:`masked_tile_scores`: the masked score
    ``f32[P, N]`` with ``NEG_INF`` where infeasible."""
    prm = pack.params
    wbal, eps = prm[4], prm[5]
    acc = net_accum_plain(pack, pods.t, use_bfloat16)
    ok = (pack.node_valid[None, :] > 0.5) & (pods.pod_valid[:, None] > 0.5)
    bal = torch.zeros_like(acc)
    for r in range(pods.req.shape[1]):
        u = used[None, :, r]
        c = cap[None, :, r]
        q = pods.req[:, r, None]
        ok = ok & (q <= c - u + eps)
        bal = torch.maximum(bal, (u + q) / torch.maximum(c, eps))

    def words(node, pod, test):
        return test(node[None, :, :], pod[:, None, :]).all(dim=-1)

    ok = ok & words(pack.taint, pods.tol, lambda n, p: (n & ~p) == 0)
    ok = ok & words(pack.label, pods.sel, lambda n, p: (n & p) == p)
    ok = ok & words(groups, pods.anti, lambda n, p: (n & p) == 0)
    ok = ok & words(resident_anti, pods.group_bit, lambda n, p: (n & p) == 0)
    ok = ok & words(groups, pods.affinity, lambda n, p: (n & p) == p)
    soft = soft_bonus_plain(pack.label, groups, pods)
    score = acc + pack.base[None, :] + prm[6] * soft - wbal * bal
    return torch.where(ok, score, NEG_INF)


def winner_tile_scores_plain(pack: StaticPack, used: torch.Tensor,
                             cap: torch.Tensor, groups: torch.Tensor,
                             resident_anti: torch.Tensor, pods: PodPack,
                             use_bfloat16: bool):
    """Plain version of :func:`winner_tile_scores`:
    ``winner_from_scores(masked_tile_scores_plain(...))``."""
    return winner_from_scores(masked_tile_scores_plain(
        pack, used, cap, groups, resident_anti, pods, use_bfloat16))


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

# Webhook handler threads, the loop's cycle thread and the static
# refresher all launch kernels; the counts are incremented under a lock.
_COUNT_LOCK = threading.Lock()


def _count_launch(fn, launches: int = 1) -> None:
    with _COUNT_LOCK:
        fn.launches += launches


def peer_columns(t: torch.Tensor):
    """``(cols i32[n_k], count i32[1])``: the ascending columns of the
    traffic matrix ``t f32[P, n_k]`` with any non-zero entry, ``-1`` past
    ``count``.  CPU tensors take :func:`peer_columns_plain`; CUDA tensors
    launch ``peer_flags_kernel`` and ``peer_scan_kernel`` on the current
    stream, and ``count`` stays on the device (no host sync)."""
    dev = t.device
    if dev.type == "cpu":
        return peer_columns_plain(t)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, n_k = t.shape
    ptr = _check(t, torch.float32, (p, n_k), "t", dev)
    flags = torch.empty((n_k,), dtype=torch.int32, device=dev)
    cols = torch.empty((n_k,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tiled_peer_columns(ptr, flags.data_ptr(), cols.data_ptr(),
                                     count.data_ptr(), p, n_k, stream)
    _raise_on(err, "peer_columns")
    _count_launch(peer_columns)
    return cols, count


peer_columns.launches = 0


def _peer_buffers(peers, pods: PodPack, dev: torch.device):
    """``(cols, count, tk)``: ``peers`` (compacted from ``pods.t`` by
    :func:`peer_columns` when None), checked, and the kernels' scratch
    for the peer columns' traffic, ``f32[n_k, P rounded up to 4]``.  The
    caller holds all three until its launch is enqueued."""
    p, n_k = pods.t.shape
    cols, count = peer_columns(pods.t) if peers is None else peers
    _check(cols, torch.int32, (n_k,), "peer cols", dev)
    _check(count, torch.int32, (1,), "peer count", dev)
    tk = torch.empty((n_k, (p + 3) // 4 * 4), dtype=torch.float32,
                     device=dev)
    return cols, count, tk


def static_tile_scores(pack: StaticPack, groups: torch.Tensor,
                       pods: PodPack, use_bfloat16: bool,
                       transposed: bool = False, peers=None):
    """``(raw f32, ok bool)`` of ``_static_kernel``'s function, shaped
    ``[P, N]`` or, with ``transposed``, node-major ``[N, P]`` (the
    conflict loop's layout, written directly by the kernel).

    CPU tensors take :func:`static_tile_scores_plain`; CUDA tensors
    launch :func:`peer_columns` (unless ``peers=(cols, count)`` is given)
    and ``static_scores_kernel`` on the current stream."""
    dev = pack.bw.device
    if dev.type == "cpu":
        raw, ok = static_tile_scores_plain(pack, groups, pods, use_bfloat16)
        return (raw.T, ok.T) if transposed else (raw, ok)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, n_out, n_k, _, mw, t_soft = _shapes(pack, pods)
    f32 = torch.float32
    args = _static_args(pack, groups, pods, dev)
    bufs = _peer_buffers(peers, pods, dev)
    args += [b.data_ptr() for b in bufs]
    shape = (n_out, p) if transposed else (p, n_out)
    raw = torch.empty(shape, dtype=f32, device=dev)
    ok = torch.empty(shape, dtype=torch.bool, device=dev)
    sp, sn = (1, p) if transposed else (n_out, 1)
    lib = build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tiled_static_scores(
            *args, raw.data_ptr(), ok.data_ptr(), sp, sn, p, n_out, n_k,
            mw, t_soft, int(use_bfloat16), stream)
    _raise_on(err, "static_scores_kernel")
    _count_launch(static_tile_scores)
    return raw, ok


static_tile_scores.launches = 0


def peer_columns_lanes(t: torch.Tensor):
    """:func:`peer_columns` per lane of a stacked ``t f32[K, P, n_k]``:
    ``(cols i32[K, n_k], count i32[K])``.  CPU tensors take
    :func:`peer_columns_plain` per lane; CUDA tensors launch the two
    compaction kernels once each over all lanes (counted as part of the
    :func:`static_tile_scores_lanes` launch that needs them)."""
    dev = t.device
    if dev.type == "cpu":
        outs = [peer_columns_plain(t[k]) for k in range(t.shape[0])]
        return (torch.stack([c for c, _ in outs]),
                torch.cat([n for _, n in outs]))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k_lanes, p, n_k = t.shape
    ptr = _check(t, torch.float32, (k_lanes, p, n_k), "t", dev)
    flags = torch.empty((k_lanes, n_k), dtype=torch.int32, device=dev)
    cols = torch.empty((k_lanes, n_k), dtype=torch.int32, device=dev)
    count = torch.empty((k_lanes,), dtype=torch.int32, device=dev)
    lib = build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tiled_peer_columns_lanes(
            ptr, flags.data_ptr(), cols.data_ptr(), count.data_ptr(), p, n_k,
            k_lanes, stream)
    _raise_on(err, "peer_columns (lanes)")
    return cols, count


def static_tile_scores_lanes(pack: StaticPack, groups: torch.Tensor,
                             pods: PodPack, use_bfloat16: bool,
                             transposed: bool = False, peers=None):
    """:func:`static_tile_scores` over a leading lane axis: every field
    of ``pack`` and ``pods`` and ``groups`` is stacked ``[K, ...]`` (one
    tenant per lane, :func:`~.state.stack_trees`), and the result is
    ``(raw f32[K, P, N], ok bool[K, P, N])`` or node-major ``[K, N, P]``
    with ``transposed``.  Lane ``k`` equals :func:`static_tile_scores` on
    lane ``k``'s inputs bit for bit.

    CPU tensors take :func:`static_tile_scores_lanes_plain`; CUDA tensors
    launch the compaction per lane (:func:`peer_columns_lanes`, unless
    ``peers=(cols i32[K, n_k], count i32[K])`` is given), then
    ``static_scores_lanes_kernel`` once, the lane on ``blockIdx.z``."""
    dev = pack.bw.device
    if dev.type == "cpu":
        raw, ok = static_tile_scores_lanes_plain(pack, groups, pods,
                                                 use_bfloat16)
        return ((raw.transpose(1, 2), ok.transpose(1, 2)) if transposed
                else (raw, ok))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k_lanes = pack.bw.shape[0]
    lead = (k_lanes,)
    p, n_out, n_k, _, mw, t_soft = _shapes(pack, pods)
    args = _static_args(pack, groups, pods, dev, lead)
    cols, count = peer_columns_lanes(pods.t) if peers is None else peers
    _check(cols, torch.int32, (k_lanes, n_k), "peer cols", dev)
    _check(count, torch.int32, (k_lanes,), "peer count", dev)
    tk = torch.empty((k_lanes, n_k, (p + 3) // 4 * 4), dtype=torch.float32,
                     device=dev)
    args += [cols.data_ptr(), count.data_ptr(), tk.data_ptr()]
    shape = (k_lanes, n_out, p) if transposed else (k_lanes, p, n_out)
    raw = torch.empty(shape, dtype=torch.float32, device=dev)
    ok = torch.empty(shape, dtype=torch.bool, device=dev)
    sp, sn = (1, p) if transposed else (n_out, 1)
    lib = build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tiled_static_scores_lanes(
            *args, raw.data_ptr(), ok.data_ptr(), sp, sn, p, n_out, n_k,
            mw, t_soft, int(use_bfloat16), k_lanes, stream)
    _raise_on(err, "static_scores_lanes_kernel")
    _count_launch(static_tile_scores_lanes)
    return raw, ok


static_tile_scores_lanes.launches = 0


def masked_tile_scores(pack: StaticPack, used: torch.Tensor,
                       cap: torch.Tensor, groups: torch.Tensor,
                       resident_anti: torch.Tensor, pods: PodPack,
                       use_bfloat16: bool, peers=None) -> torch.Tensor:
    """Masked score ``f32[P, N]`` of ``_kernel``'s function.  CPU tensors
    take :func:`masked_tile_scores_plain`; CUDA tensors launch
    :func:`peer_columns` (unless ``peers=(cols, count)`` is given) and
    ``masked_scores_kernel`` on the current stream."""
    dev = pack.bw.device
    if dev.type == "cpu":
        return masked_tile_scores_plain(pack, used, cap, groups,
                                        resident_anti, pods, use_bfloat16)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, n_out, n_k, r, mw, t_soft = _shapes(pack, pods)
    args = _masked_args(pack, used, cap, groups, resident_anti, pods, dev)
    bufs = _peer_buffers(peers, pods, dev)
    args += [b.data_ptr() for b in bufs]
    out = torch.empty((p, n_out), dtype=torch.float32, device=dev)
    lib = build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tiled_masked_scores(
            *args, out.data_ptr(), p, n_out, n_k, r, mw, t_soft,
            int(use_bfloat16), stream)
    _raise_on(err, "masked_scores_kernel")
    _count_launch(masked_tile_scores)
    return out


masked_tile_scores.launches = 0


def winner_tile_scores(pack: StaticPack, used: torch.Tensor,
                       cap: torch.Tensor, groups: torch.Tensor,
                       resident_anti: torch.Tensor, pods: PodPack,
                       use_bfloat16: bool, peers=None):
    """``(best f32[P], node i32[P])`` of ``_winner_kernel``'s function:
    per pod, the highest masked score and the LOWEST node index holding
    it, ``node == -1`` where the row is all-infeasible.  CPU tensors take
    :func:`winner_tile_scores_plain`; CUDA tensors launch
    :func:`peer_columns` (unless ``peers=(cols, count)`` is given) and
    ``winner_scores_kernel`` on the current stream."""
    dev = pack.bw.device
    if dev.type == "cpu":
        return winner_tile_scores_plain(pack, used, cap, groups,
                                        resident_anti, pods, use_bfloat16)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, n_out, n_k, r, mw, t_soft = _shapes(pack, pods)
    args = _masked_args(pack, used, cap, groups, resident_anti, pods, dev)
    bufs = _peer_buffers(peers, pods, dev)
    args += [b.data_ptr() for b in bufs]
    keys = torch.empty((p,), dtype=torch.int64, device=dev)
    best = torch.empty((p,), dtype=torch.float32, device=dev)
    node = torch.empty((p,), dtype=torch.int32, device=dev)
    lib = build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tiled_winner_scores(
            *args, keys.data_ptr(), best.data_ptr(), node.data_ptr(), p,
            n_out, n_k, r, mw, t_soft, int(use_bfloat16), stream)
    _raise_on(err, "winner_scores_kernel")
    _count_launch(winner_tile_scores)
    return best, node


winner_tile_scores.launches = 0


# The conflict round's limits (``csrc/conflict_round.cu``): one block of
# at most 1,024 threads resolves a pass, with the batch's requests and
# mask words in shared memory and a proposal's in registers.
ROUND_MAX_PODS = 1024
ROUND_MAX_RESOURCES = 4
ROUND_MAX_WORDS = 8
# Kernel launches of one round: argmax, resolve and row patch for each
# pass, then the continue test.
ROUND_LAUNCHES = 7
_ROUND_IN = (("rawT", torch.float32, "np"), ("okT", torch.bool, "np"),
             ("rank", torch.int32, "p"), ("cap", torch.float32, "nr"),
             ("cap_eps", torch.float32, "nr"),
             ("node_zone", torch.int32, "n"), ("req", torch.float32, "pr"),
             ("affinity_bits", torch.int32, "pw"),
             ("anti_bits", torch.int32, "pw"),
             ("group_bit", torch.int32, "pw"), ("pod_valid", torch.bool, "p"))


def conflict_round(t: dict, cfg):
    """One conflict round without zone work, ``body(*carry) -> (*carry,
    cont)`` over :func:`~.assign._parallel_setup`'s ``t`` and carry
    ``(core, used, group_bits, resident_anti, gz_counts, az_anti,
    assignment)``.

    CPU tensors take the plain version, :func:`~.assign._round_body` with
    ``zone_work=False``.  CUDA tensors get a body that launches the seven
    kernels of ``csrc/conflict_round.cu`` on the current stream, updates
    the carry IN PLACE (``az_anti`` is left as it is: without zone work
    no pod carries zone-anti bits), returns the same tensors and a
    ``bool`` continue flag of its own, and makes no host sync, so a CUDA
    graph can capture it.  The body's scratch lives in its closure, and
    it reads the batch's inputs from ``t`` at every call.
    ``conflict_round.launches`` counts the kernels the card runs: a body
    call outside a stream capture adds its seven, and each replay of a
    captured body its seven, counted by the replay
    (:class:`~.round_graph.RoundGraph` calls ``body.replayed`` after each
    launch of the graph, inside span ``body.span``, ``assign.fused``)."""
    dev = t["rawT"].device
    if dev.type == "cpu":
        from kubernetesnetawarescheduler_tpu_torch.core.assign import (
            _round_body,
        )

        return _round_body(t, cfg, False)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, p = t["rawT"].shape
    r, w = t["req"].shape[1], t["group_bit"].shape[1]
    if p > ROUND_MAX_PODS or r > ROUND_MAX_RESOURCES or w > ROUND_MAX_WORDS:
        raise ValueError(f"conflict_round takes at most {ROUND_MAX_PODS} "
                         f"pods, {ROUND_MAX_RESOURCES} resources and "
                         f"{ROUND_MAX_WORDS} mask words, not {p}, {r}, {w}")
    dims = {"n": n, "p": p, "r": r, "w": w}
    keys = torch.zeros((p, 2), dtype=torch.int64, device=dev)
    va = torch.zeros((p,), dtype=torch.int32, device=dev)
    skip = torch.zeros((n,), dtype=torch.uint8, device=dev)
    rows = torch.zeros((2, p), dtype=torch.int32, device=dev)
    counts = torch.zeros((3,), dtype=torch.int32, device=dev)
    cont = torch.zeros((), dtype=torch.bool, device=dev)
    # The body holds the tensors, not only their addresses: a replay of
    # its graph writes them.
    scratch = (keys, va, skip, rows, counts, cont)
    w_bal = float(np.float32(cfg.weights.balance))
    lib = build_library()

    def body(core, used, group_bits, resident_anti, gz, az, assignment):
        z = gz.shape[1]
        ins = [_check(t[k], dtype, tuple(dims[d] for d in shape), k, dev)
               for k, dtype, shape in _ROUND_IN]
        carry = [_check(core, torch.float32, (n, p), "core", dev),
                 _check(used, torch.float32, (n, r), "used", dev),
                 _check(group_bits, torch.int32, (n, w), "group_bits", dev),
                 _check(resident_anti, torch.int32, (n, w), "resident_anti",
                        dev),
                 _check(gz, torch.int32, (32 * w, z), "gz_counts", dev),
                 _check(assignment, torch.int32, (p,), "assignment", dev)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.conflict_round(
                *ins, *carry, *(x.data_ptr() for x in scratch), w_bal, _EPS,
                n, p, r, w, z, stream)
        _raise_on(err, "conflict_round")
        if not torch.cuda.is_current_stream_capturing():
            _count_launch(conflict_round, ROUND_LAUNCHES)
        return (core, used, group_bits, resident_anti, gz, az, assignment,
                cont)

    body.span = "assign.fused"
    body.replayed = functools.partial(_count_launch, conflict_round,
                                      ROUND_LAUNCHES)
    return body


conflict_round.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    with _COUNT_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0


KERNELS = {
    "static_scores_kernel": static_tile_scores,
    "masked_scores_kernel": masked_tile_scores,
    "winner_scores_kernel": winner_tile_scores,
    "peer_columns": peer_columns,
    "static_scores_lanes_kernel": static_tile_scores_lanes,
    "conflict_round": conflict_round,
}
