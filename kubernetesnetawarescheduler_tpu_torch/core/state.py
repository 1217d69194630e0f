"""Device-resident columnar cluster state, as torch tensors.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/core/state.py``:
the same fields, shapes and semantics, held as dataclasses of tensors on
an explicit device.

- ``metrics[N, M]``, ``metrics_age[N]`` — node telemetry.
- ``lat[N, N]`` / ``bw[N, N]`` — the pairwise network matrices.
- ``cap/used[N, R]`` — capacities and usage.
- label/taint/group bitmasks — the batched feasibility planes.

Bit masks are u32 words in the JAX package.  Here they are ``torch.int32``
tensors holding the same bits (``numpy.ndarray.view`` converts both ways
without touching a bit).  ``>>`` on int32 is an arithmetic shift, so
every bit extraction masks with ``& 1``.

Entry points that create tensors take a ``device`` that defaults to
``"cuda"``; asking for CUDA where there is none raises instead of
running on the CPU.  Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.utils.tracing import span


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point builds on.  CUDA is the default; a CUDA
    request on a machine without a card raises — the port never falls
    back to the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def host_sync(site: str):
    """One wait of the host for the device at ``site``: counted in
    ``host_flag.syncs`` and timed as the span ``sync.<site>``
    (:func:`~..utils.tracing.span`; inside a serving cycle the loop's
    timer counts it per site, and those counts add up to the cycle's
    share of the total).  Enter it around the call that waits."""
    host_flag.syncs += 1
    return span("sync." + site)


def host_flag(x: torch.Tensor, site: str) -> bool:
    """Read a scalar device predicate on the host — the place where a
    JAX ``lax.cond``/``while_loop`` predicate becomes a Python ``if``.
    Each call is one host sync on a CUDA tensor (:func:`host_sync` at
    ``site``); ``host_flag.syncs`` counts them so a run can report what
    its control flow cost."""
    with host_sync(site):
        return bool(x)


host_flag.syncs = 0


def is_device_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a fault of the device or its kernels (a failed
    launch or copy, an illegal address, memory exhausted, a kernel that
    does not build) rather than of host logic.  Handlers that keep a
    maintenance step or a background thread alive across host errors
    re-raise these: they are never observation failures."""
    for name in ("OutOfMemoryError", "AcceleratorError"):
        kind = getattr(torch, name, None)
        if kind is not None and isinstance(exc, kind):
            return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and ("CUDA" in msg
                                              or "nvcc" in msg)


class _TensorTree:
    """``replace`` and host copies for the tensor dataclasses below."""

    def replace(self, **changes: Any):
        return dataclasses.replace(self, **changes)

    def numpy(self) -> dict[str, np.ndarray]:
        """Every field as a host numpy array (int32 bit planes stay
        int32; ``.view(np.uint32)`` recovers the JAX package's words)."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class ClusterState(_TensorTree):
    """Columnar cluster telemetry and allocation state.

    Shapes (``N = cfg.max_nodes``, ``M = cfg.num_metrics``,
    ``R = cfg.num_resources``, ``W = cfg.mask_words``,
    ``G = 32 * W``, ``Z = cfg.max_zones``, ``L = cfg.max_numeric_labels``):

    - ``metrics`` f32[N, M], ``metrics_age`` f32[N]
    - ``lat``, ``bw`` f32[N, N]
    - ``cap``, ``used`` f32[N, R]
    - ``node_valid`` bool[N]
    - ``label_bits``, ``taint_bits``, ``group_bits``, ``resident_anti``
      i32[N, W] (u32 bits)
    - ``node_zone`` i32[N] (-1 = no zone)
    - ``gz_counts`` i32[G, Z]: scheduled pods per (group slot, zone)
    - ``az_anti`` i32[Z, W]: OR of zone-scoped anti selectors per zone
    - ``node_numeric`` f32[N, L]: numeric label values; NaN means absent,
      and every comparison against NaN is false (fail-closed).
    """

    metrics: torch.Tensor
    metrics_age: torch.Tensor
    lat: torch.Tensor
    bw: torch.Tensor
    cap: torch.Tensor
    used: torch.Tensor
    node_valid: torch.Tensor
    label_bits: torch.Tensor
    taint_bits: torch.Tensor
    group_bits: torch.Tensor
    resident_anti: torch.Tensor
    node_zone: torch.Tensor
    gz_counts: torch.Tensor
    az_anti: torch.Tensor
    node_numeric: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.metrics.shape[0]

    @property
    def num_metrics(self) -> int:
        return self.metrics.shape[1]

    @property
    def num_resources(self) -> int:
        return self.cap.shape[1]

    @property
    def device(self) -> torch.device:
        return self.metrics.device


@dataclasses.dataclass
class PodBatch(_TensorTree):
    """A batch of pending pods (``P = cfg.max_pods``, ``K = max_peers``,
    ``T = max_soft_terms``, ``T2 = max_ns_terms``, ``E = max_ns_exprs``,
    ``NE = max_ns_num``).  Field meanings follow the JAX package's
    ``PodBatch``; every u32 mask is i32 here with the same bits."""

    req: torch.Tensor            # f32[P, R]
    peers: torch.Tensor          # i32[P, K] node index, -1 = none
    peer_traffic: torch.Tensor   # f32[P, K]
    tol_bits: torch.Tensor       # i32[P, W]
    sel_bits: torch.Tensor       # i32[P, W]
    affinity_bits: torch.Tensor  # i32[P, W]
    anti_bits: torch.Tensor      # i32[P, W]
    group_bit: torch.Tensor      # i32[P, W] full membership mask
    priority: torch.Tensor       # f32[P]
    pod_valid: torch.Tensor      # bool[P]
    soft_sel_bits: torch.Tensor  # i32[P, T, W]
    soft_sel_w: torch.Tensor     # f32[P, T]
    soft_grp_bits: torch.Tensor  # i32[P, T, W]
    soft_grp_w: torch.Tensor     # f32[P, T]
    soft_zone_bits: torch.Tensor  # i32[P, T, W]
    soft_zone_w: torch.Tensor    # f32[P, T]
    group_idx: torch.Tensor      # i32[P]
    spread_maxskew: torch.Tensor  # i32[P]
    spread_hard: torch.Tensor    # bool[P]
    ns_anyof: torch.Tensor       # i32[P, T2, E, W]
    ns_forbid: torch.Tensor      # i32[P, T2, W]
    ns_term_used: torch.Tensor   # bool[P, T2]
    ns_num_col: torch.Tensor     # i32[P, T2, NE]
    ns_num_lo: torch.Tensor      # f32[P, T2, NE]
    ns_num_hi: torch.Tensor      # f32[P, T2, NE]
    zaff_bits: torch.Tensor      # i32[P, W]
    zanti_bits: torch.Tensor     # i32[P, W]

    @property
    def num_pods(self) -> int:
        return self.req.shape[0]

    @property
    def max_peers(self) -> int:
        return self.peers.shape[1]


def _state_fields(cfg: SchedulerConfig, dev: torch.device) -> dict:
    n, m, r = cfg.max_nodes, cfg.num_metrics, cfg.num_resources
    w = cfg.mask_words
    f32, i32 = torch.float32, torch.int32
    return dict(
        metrics=torch.zeros((n, m), dtype=f32, device=dev),
        metrics_age=torch.zeros((n,), dtype=f32, device=dev),
        lat=torch.zeros((n, n), dtype=f32, device=dev),
        bw=torch.zeros((n, n), dtype=f32, device=dev),
        cap=torch.zeros((n, r), dtype=f32, device=dev),
        used=torch.zeros((n, r), dtype=f32, device=dev),
        node_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        label_bits=torch.zeros((n, w), dtype=i32, device=dev),
        taint_bits=torch.zeros((n, w), dtype=i32, device=dev),
        group_bits=torch.zeros((n, w), dtype=i32, device=dev),
        resident_anti=torch.zeros((n, w), dtype=i32, device=dev),
        node_zone=torch.full((n,), -1, dtype=i32, device=dev),
        gz_counts=torch.zeros((32 * w, cfg.max_zones), dtype=i32,
                              device=dev),
        az_anti=torch.zeros((cfg.max_zones, w), dtype=i32, device=dev),
        node_numeric=torch.full((n, cfg.max_numeric_labels), float("nan"),
                                dtype=f32, device=dev),
    )


def _pod_fields(cfg: SchedulerConfig, p: int, dev: torch.device) -> dict:
    k, r, w = cfg.max_peers, cfg.num_resources, cfg.mask_words
    t, t2, e, ne = (cfg.max_soft_terms, cfg.max_ns_terms, cfg.max_ns_exprs,
                    cfg.max_ns_num)
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=dev)

    return dict(
        req=z(p, r, dtype=f32),
        peers=full((p, k), -1, i32),
        peer_traffic=z(p, k, dtype=f32),
        tol_bits=z(p, w), sel_bits=z(p, w), affinity_bits=z(p, w),
        anti_bits=z(p, w), group_bit=z(p, w),
        priority=z(p, dtype=f32),
        pod_valid=z(p, dtype=torch.bool),
        soft_sel_bits=z(p, t, w), soft_sel_w=z(p, t, dtype=f32),
        soft_grp_bits=z(p, t, w), soft_grp_w=z(p, t, dtype=f32),
        soft_zone_bits=z(p, t, w), soft_zone_w=z(p, t, dtype=f32),
        group_idx=full((p,), -1, i32),
        spread_maxskew=z(p),
        spread_hard=z(p, dtype=torch.bool),
        ns_anyof=z(p, t2, e, w), ns_forbid=z(p, t2, w),
        ns_term_used=z(p, t2, dtype=torch.bool),
        ns_num_col=full((p, t2, ne), -1, i32),
        ns_num_lo=full((p, t2, ne), float("-inf"), f32),
        ns_num_hi=full((p, t2, ne), float("inf"), f32),
        zaff_bits=z(p, w), zanti_bits=z(p, w),
    )


def init_cluster_state(cfg: SchedulerConfig, device="cuda",
                       **overrides: Any) -> ClusterState:
    """An empty, all-padding cluster of static shape on ``device``."""
    dev = resolve_device(device)
    fields = _state_fields(cfg, dev)
    fields.update({k: v.to(dev) for k, v in overrides.items()})
    return ClusterState(**fields)


def init_pod_batch(cfg: SchedulerConfig, device="cuda",
                   **overrides: Any) -> PodBatch:
    """An empty, all-padding pod batch of static shape on ``device``."""
    dev = resolve_device(device)
    fields = _pod_fields(cfg, cfg.max_pods, dev)
    fields.update({k: v.to(dev) for k, v in overrides.items()})
    return PodBatch(**fields)


def to_tensor(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes, such as a JAX
    array) as a tensor of ``dtype`` on ``dev``, copied.  u32 words become
    i32 through a bit-preserving ``view``."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(dev, dtype)


STATE_DTYPES = dict(
    metrics=torch.float32, metrics_age=torch.float32, lat=torch.float32,
    bw=torch.float32, cap=torch.float32, used=torch.float32,
    node_valid=torch.bool, label_bits=torch.int32, taint_bits=torch.int32,
    group_bits=torch.int32, resident_anti=torch.int32,
    node_zone=torch.int32, gz_counts=torch.int32, az_anti=torch.int32,
    node_numeric=torch.float32)

POD_DTYPES = dict(
    req=torch.float32, peers=torch.int32, peer_traffic=torch.float32,
    tol_bits=torch.int32, sel_bits=torch.int32, affinity_bits=torch.int32,
    anti_bits=torch.int32, group_bit=torch.int32, priority=torch.float32,
    pod_valid=torch.bool, soft_sel_bits=torch.int32,
    soft_sel_w=torch.float32, soft_grp_bits=torch.int32,
    soft_grp_w=torch.float32, soft_zone_bits=torch.int32,
    soft_zone_w=torch.float32, group_idx=torch.int32,
    spread_maxskew=torch.int32, spread_hard=torch.bool,
    ns_anyof=torch.int32, ns_forbid=torch.int32, ns_term_used=torch.bool,
    ns_num_col=torch.int32, ns_num_lo=torch.float32,
    ns_num_hi=torch.float32, zaff_bits=torch.int32, zanti_bits=torch.int32)


def state_from_numpy(cfg: SchedulerConfig, state_np: dict,
                     device="cuda") -> ClusterState:
    """A :class:`ClusterState` from a dict of numpy arrays keyed by field
    name — ``tests/gen.py::random_instance`` output, or ``np.asarray`` of
    every leaf of a JAX ``ClusterState``.  Missing fields take
    :func:`init_cluster_state`'s padding values."""
    dev = resolve_device(device)
    return init_cluster_state(cfg, dev, **{
        k: to_tensor(v, STATE_DTYPES[k], dev) for k, v in state_np.items()})


def pods_from_numpy(cfg: SchedulerConfig, pods_np: dict,
                    device="cuda") -> PodBatch:
    """A :class:`PodBatch` from a dict of numpy arrays keyed by field
    name (the pod half of ``random_instance``, or a JAX ``PodBatch``'s
    leaves).  Missing fields take :func:`init_pod_batch`'s values."""
    dev = resolve_device(device)
    return init_pod_batch(cfg, dev, **{
        k: to_tensor(v, POD_DTYPES[k], dev) for k, v in pods_np.items()})


def _shifts(dev: torch.device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=dev)


def bit_planes(bits: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decompose ``i32[P, W]`` masks into 0/1 bitplanes ``[P, W*32]``.
    The shift is arithmetic on int32, so each plane masks with ``& 1``
    (bit 31 would otherwise smear the sign into every plane)."""
    p, w = bits.shape
    planes = (bits[:, :, None] >> _shifts(bits.device)) & 1
    return planes.reshape(p, w * 32).to(dtype)


def planes_to_words(present: torch.Tensor) -> torch.Tensor:
    """Re-pack boolean bitplanes ``[N, W*32]`` into ``i32[N, W]`` words
    (inverse of :func:`bit_planes` on presence).  The planes are
    distinct powers of two, so an int32 sum is their OR (bit 31 lands
    as the sign bit)."""
    n, cols = present.shape
    w = cols // 32
    vals = present.reshape(n, w, 32).to(torch.int32) << _shifts(
        present.device)
    return vals.sum(dim=-1, dtype=torch.int32)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 matrix product without TF32: on the card a TF32 product
    would keep ten mantissa bits of each input, which breaks the 0/1
    count reductions and capacity sums below.  A caller that enabled
    TF32 keeps it for its own products: the flag is cleared for this
    product only and restored after it."""
    flags = torch.backends.cuda.matmul
    if not (a.is_cuda and flags.allow_tf32):
        return a @ b
    flags.allow_tf32 = False
    try:
        return a @ b
    finally:
        flags.allow_tf32 = True


def scatter_or_onehot(onehot: torch.Tensor,
                      bits: torch.Tensor) -> torch.Tensor:
    """Per-node OR of per-pod multi-word bitmasks: ``out[n, :] = OR_p
    onehot[p, n] ? bits[p, :]`` for ``bits i32[P, W]``, as one
    ``[N, P] x [P, W*32]`` plane count (count > 0 ⇔ bit present)."""
    counts = exact_matmul(onehot.to(torch.float32).T, bit_planes(bits))
    return planes_to_words(counts > 0.5)


def scatter_add_rows(base: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].add(vals)`` over the rows where ``mask`` holds,
    accumulated deterministically.

    Several pods can land on one node in a batch (the multi-accept
    prefix places them together).  ``index_add_`` on CUDA accumulates
    with atomics in a run-dependent order, which can move ``used`` by an
    ulp and flip a capacity fit at the ``_EPS`` edge.  A one-hot
    ``[P, N]ᵀ @ vals`` product in full f32 sums in a fixed order instead
    (it may differ from a sequential scatter by an ulp when pods share a
    node, but it is the same on every run)."""
    n = base.shape[0]
    onehot = mask[:, None] & (
        idx[:, None] == torch.arange(n, device=idx.device)[None, :])
    add = torch.where(mask[:, None], vals, torch.zeros_like(vals))
    return base + exact_matmul(onehot.to(torch.float32).T, add)


def commit_assignments(state: ClusterState, pods: PodBatch,
                       assignment: torch.Tensor) -> ClusterState:
    """Apply a batch assignment (``i32[P]``, -1 = unschedulable) to the
    allocation state: requests into ``used``, group/anti bits into the
    node planes, membership counts and zone-anti bits into the zone
    planes."""
    n = state.num_nodes
    placed = (assignment >= 0) & pods.pod_valid
    used = scatter_add_rows(state.used, assignment, pods.req, placed)
    onehot = placed[:, None] & (
        assignment[:, None] == torch.arange(n, device=assignment.device)[
            None, :])
    zone_of = state.node_zone[assignment.clamp(0, n - 1).long()]
    z = state.az_anti.shape[0]
    zhot = (placed & (zone_of >= 0))[:, None] & (
        zone_of.clamp(0, z - 1)[:, None]
        == torch.arange(z, device=zone_of.device)[None, :])
    return state.replace(
        used=used,
        group_bits=state.group_bits | scatter_or_onehot(onehot,
                                                        pods.group_bit),
        resident_anti=state.resident_anti | scatter_or_onehot(
            onehot, pods.anti_bits),
        gz_counts=add_zone_counts(state.gz_counts, state.node_zone,
                                  pods.group_bit, assignment, placed),
        az_anti=state.az_anti | scatter_or_onehot(zhot, pods.zanti_bits))


def add_zone_counts(gz_counts: torch.Tensor, node_zone: torch.Tensor,
                    group_bit: torch.Tensor, assignment: torch.Tensor,
                    placed: torch.Tensor) -> torch.Tensor:
    """Add placed pods' full membership masks into the per-(group slot,
    zone) count matrix; pods on zone-less nodes add nothing."""
    z = gz_counts.shape[1]
    zone = node_zone[assignment.clamp(0, node_zone.shape[0] - 1).long()]
    ok = placed & (zone >= 0)
    zhot = ok[:, None] & (zone.clamp(0, z - 1)[:, None]
                          == torch.arange(z, device=zone.device)[None, :])
    counts = exact_matmul(zhot.to(torch.float32).T,
                          bit_planes(group_bit))             # [Z, G]
    return gz_counts + counts.T.round().to(torch.int32)


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` that is >= ``x``."""
    return ((x + mult - 1) // mult) * mult


def pad_axis(x: torch.Tensor, size: int, axis: int = 0,
             fill: float = 0.0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to ``size`` with ``fill``."""
    cur = x.shape[axis]
    if cur > size:
        raise ValueError(f"axis {axis} has {cur} > max {size}")
    if cur == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - cur
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis)


# ---------------------------------------------------------------------------
# Fleet batching: a leading lane (cluster) axis over whole-state trees.
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """Apply ``fn`` leaf by leaf over trees of one structure: tensor
    dataclasses (:class:`ClusterState`, :class:`PodBatch`, the kernels'
    packs), tuples and lists; any other value is a leaf."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, (tuple, list)):
        if any(len(t) != len(t0) for t in trees):
            raise ValueError("trees differ in structure")
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return fn(*trees)


def _stack_leaf(*leaves) -> torch.Tensor:
    ts = [x if isinstance(x, torch.Tensor) else torch.tensor(x)
          for x in leaves]
    t0 = ts[0]
    for t in ts[1:]:
        if t.shape != t0.shape or t.dtype != t0.dtype \
                or t.device != t0.device:
            raise ValueError(
                f"cannot stack a {tuple(t.shape)} {t.dtype} leaf on "
                f"{t.device} with a {tuple(t0.shape)} {t0.dtype} leaf on "
                f"{t0.device}: lanes must share one padding bucket")
    return torch.stack(ts)


def stack_trees(trees):
    """Stack same-shape trees along a NEW leading lane axis: every plane
    (and every :class:`PodBatch` column) of tenant ``k`` lands at
    ``out.<leaf>[k]``, the batched state the lane-batched conflict loop
    runs over.  Every leaf must share shape, dtype and device across
    the trees (one padding bucket); a mismatch raises.  Python scalars
    become 0-d tensors first, so every leaf gains the axis."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    return tree_map(_stack_leaf, *trees)


def index_tree(tree, k: int):
    """Tenant ``k``'s row of a :func:`stack_trees` result: views, no
    copy."""
    return tree_map(lambda a: a[k], tree)


def set_tree_row(tree, k: int, row):
    """Write ``row`` into tenant ``k``'s row of a :func:`stack_trees`
    result, in place (the per-tenant refresh between fleet cycles), and
    return the tree."""
    def put(a, r):
        if tuple(r.shape) != tuple(a.shape[1:]) or r.dtype != a.dtype:
            raise ValueError(
                f"row leaf {tuple(r.shape)} {r.dtype} does not fit lane "
                f"leaf {tuple(a.shape[1:])} {a.dtype}")
        a[k].copy_(r)

    tree_map(put, tree, row)
    return tree


# ---------------------------------------------------------------------------
# Mesh shards: a rank's rows of the node axis (tp) or the pod axis (dp).
# ---------------------------------------------------------------------------

# ClusterState leaves replicated on every rank of a mesh: the small zone
# planes, which every assign round reads at arbitrary rows.  Every other
# leaf splits its node axis (axis 0) over ``tp``.
REPLICATED_STATE_FIELDS = ("gz_counts", "az_anti")


def shard_rows(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Rows ``[index * s, (index + 1) * s)`` of ``x`` (``s = rows /
    count``), a view.  The axis must divide evenly."""
    rows = x.shape[0]
    if rows % count != 0:
        raise ValueError(f"axis of {rows} rows does not split into "
                         f"{count} equal shards")
    s = rows // count
    return x[index * s:(index + 1) * s]


def shard_pods(pods, dp_index: int, dp: int):
    """Pod shard ``dp_index`` of ``dp`` of a :class:`PodBatch` (or any
    tensor dataclass whose leaves lead with the pod axis).  Views."""
    return tree_map(lambda x: shard_rows(x, dp_index, dp), pods)


def concat_shards(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's ``x`` over a mesh axis (``mesh.gather``), concatenated
    along dim 0 in the axis's index order: the whole leaf from its
    shards."""
    g = mesh.gather(x, axis)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def local_rows(nodes: torch.Tensor, offset: int, rows: int) -> torch.Tensor:
    """Global node indices → a shard's local row indices: ``nodes -
    offset`` where the node lies in ``[offset, offset + rows)``, else
    ``rows`` (the drop sentinel of the row writes)."""
    local = nodes - offset
    inside = (local >= 0) & (local < rows)
    return torch.where(inside, local, rows)


def scatter_add_rows_shard(base: torch.Tensor, idx: torch.Tensor,
                           vals: torch.Tensor, mask: torch.Tensor,
                           offset: int, num_nodes: int) -> torch.Tensor:
    """:func:`scatter_add_rows` onto a node shard (``base`` holds global
    rows ``[offset, offset + rows)`` of ``num_nodes``; ``idx`` global).

    The one-hot product runs at the whole cluster's shape, ``[N, P] x
    [P, R]``, and the shard's rows of it are added: a product of the
    shard's shape may sum three or more pods on one node in another
    order (cuBLAS picks its kernel by shape), and ``used`` must keep the
    single-device bits."""
    onehot = mask[:, None] & (
        idx[:, None] == torch.arange(num_nodes, device=idx.device)[None, :])
    add = torch.where(mask[:, None], vals, torch.zeros_like(vals))
    prod = exact_matmul(onehot.to(torch.float32).T, add)
    return base + prod[offset:offset + base.shape[0]]


def commit_assignments_shard(state: ClusterState, pods: PodBatch,
                             assignment: torch.Tensor, offset: int,
                             num_nodes: int,
                             node_zone: torch.Tensor) -> ClusterState:
    """:func:`commit_assignments` on a node shard: ``state`` holds global
    node rows ``[offset, offset + rows)`` of ``num_nodes`` and the whole
    zone planes; ``pods`` and ``assignment`` are the whole batch (every
    rank of a mesh has them) and ``node_zone`` is the whole cluster's
    ``i32[N]``.  The shard's rows and the zone planes come out with the
    bits :func:`commit_assignments` gives them on one device."""
    rows = state.num_nodes
    placed = (assignment >= 0) & pods.pod_valid
    used = scatter_add_rows_shard(state.used, assignment, pods.req, placed,
                                  offset, num_nodes)
    ids = offset + torch.arange(rows, device=assignment.device)
    onehot = placed[:, None] & (assignment[:, None] == ids[None, :])
    zone_of = node_zone[assignment.clamp(0, num_nodes - 1).long()]
    z = state.az_anti.shape[0]
    zhot = (placed & (zone_of >= 0))[:, None] & (
        zone_of.clamp(0, z - 1)[:, None]
        == torch.arange(z, device=zone_of.device)[None, :])
    return state.replace(
        used=used,
        group_bits=state.group_bits | scatter_or_onehot(onehot,
                                                        pods.group_bit),
        resident_anti=state.resident_anti | scatter_or_onehot(
            onehot, pods.anti_bits),
        gz_counts=add_zone_counts(state.gz_counts, node_zone,
                                  pods.group_bit, assignment, placed),
        az_anti=state.az_anti | scatter_or_onehot(zhot, pods.zanti_bits))
