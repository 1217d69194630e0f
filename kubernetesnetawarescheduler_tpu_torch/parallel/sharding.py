"""Mesh construction, the shard layout and the mesh-sharded scheduling
entry points, as explicit SPMD over ``torch.distributed``.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/parallel/
sharding.py``.  The layout is the JAX package's:

- node-axis leaves (``metrics``, ``cap``/``used``, the node bit planes,
  ``node_zone``, ``node_numeric``) are row-sharded over ``tp``, and
  ``lat``/``bw`` are ``[N/tp, N]`` on each rank: the links of its node
  shard, with full peer columns;
- the pod axis of the score tiles is row-sharded over ``dp``;
- ``gz_counts`` and ``az_anti`` are replicated.

No rank holds a whole N×N plane.  In JAX, GSPMD partitions the step and
inserts the collectives; torch does not, so the conflict loop is written
as SPMD by hand (:func:`~..core.assign.assign_parallel_spmd`): every rank
runs the same program on its shard and the collectives are explicit
calls of :class:`Mesh`.  A mesh runs one rank per process; each rank has
its own explicit device.

Every entry point below is COLLECTIVE: every rank of the mesh calls it
with the same arguments (the whole state and the whole batch; each rank
keeps its shards), and each returns the whole assignment.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
from kubernetesnetawarescheduler_tpu_torch.core import kernels, tiled_score
from kubernetesnetawarescheduler_tpu_torch.core import score as score_lib
from kubernetesnetawarescheduler_tpu_torch.core.assign import (
    assign_greedy_spmd,
    assign_parallel_spmd,
)
from kubernetesnetawarescheduler_tpu_torch.core.score import NEG_HALF
from kubernetesnetawarescheduler_tpu_torch.core.state import (
    REPLICATED_STATE_FIELDS,
    ClusterState,
    PodBatch,
    commit_assignments_shard,
    concat_shards,
    host_flag,
    resolve_device,
    shard_pods,
    shard_rows,
    tree_map,
)

_WINNER_SENTINEL = 2 ** 30
_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


class Mesh:
    """A ``(dp, tp)`` mesh over the initialized process group, one rank
    per process: rank ``r`` sits at ``(r // tp, r % tp)``, so a ``tp``
    group is ``tp`` consecutive ranks (within a host under
    :func:`~.multihost.global_mesh`).

    ``gather``, ``reduce`` and ``flag`` are the collectives the SPMD
    step makes, over the ``"tp"`` group (the ranks sharing this rank's
    dp index), the ``"dp"`` group (sharing its tp index) or the
    ``"world"``.  Over a group of one they return at once.  The gloo
    backend stages CUDA tensors through the host; NCCL takes them as
    they are.  ``collectives`` counts the calls that crossed ranks."""

    axis_names = ("dp", "tp")

    def __init__(self, dp: int, tp: int, device: torch.device, backend: str,
                 rank: int, groups: dict) -> None:
        self.dp, self.tp = dp, tp
        self.device = device
        self.backend = backend
        self.rank = rank
        self.dp_index, self.tp_index = divmod(rank, tp)
        self._groups = groups
        self.collectives = 0

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def axis_size(self, axis: str) -> int:
        return {"dp": self.dp, "tp": self.tp, "world": self.size}[axis]

    def get_group(self, axis: str):
        return self._groups[axis]

    def wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend takes it: at least 1-D, bools as uint8,
        on the host for gloo and on the rank's device for NCCL."""
        t = x.reshape(-1) if x.dim() == 0 else x
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if self.backend == "gloo" and t.is_cuda:
            t = t.cpu()
        elif self.backend == "nccl" and not t.is_cuda:
            t = t.to(self.device)
        return t.contiguous()

    def gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` of the axis's group,
        in index order along the axis."""
        size = self.axis_size(axis)
        if size == 1:
            return x[None]
        self.collectives += 1
        t = self.wire(x)
        out = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(out, t, group=self._groups[axis])
        y = torch.stack(out).reshape((size,) + tuple(x.shape))
        return y.to(device=x.device, dtype=x.dtype)

    def reduce(self, x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        """``x`` all-reduced (``"max"``, ``"min"`` or ``"sum"``) over the
        axis's group."""
        if self.axis_size(axis) == 1:
            return x
        self.collectives += 1
        t = self.wire(x).clone()
        dist.all_reduce(t, op=_OPS[op], group=self._groups[axis])
        return t.reshape(x.shape).to(device=x.device, dtype=x.dtype)

    def flag(self, pred, site: str) -> bool:
        """A predicate read once on the host, OR-ed over the world: every
        rank takes the same branch, so every rank joins the same
        collectives after it.  One :func:`~..core.state.host_flag`, at
        ``mesh.<site>``."""
        t = torch.as_tensor(pred).to(torch.int32).reshape(1)
        return host_flag(self.reduce(t, "max", "world")[0], "mesh." + site)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def mesh_device(device="cuda") -> torch.device:
    """The rank's device: ``"cuda"`` without an index is card
    ``LOCAL_RANK % device_count`` (torchrun sets ``LOCAL_RANK``; 0 when
    unset, so ranks of one process group on a one-card host share it).
    Raises where CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


def make_mesh(dp: int, tp: int, device="cuda") -> Mesh:
    """A ``(dp, tp)`` mesh over the initialized process group (every rank
    calls it: it creates the ``tp`` and ``dp`` groups).  Raises
    ``ValueError`` unless ``dp * tp`` equals the ranks there are."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(parallel.multihost.init_multihost or "
            "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(
            f"mesh {dp}x{tp} needs {dp * tp} ranks, have {world}")
    rank = dist.get_rank()
    dev = mesh_device(device)
    backend = dist.get_backend()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device per rank")
        torch.cuda.set_device(dev)
    groups = {"world": dist.group.WORLD}
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["tp"] = g
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["dp"] = g
    return Mesh(dp, tp, dev, backend, rank, groups)


def _node_spec(ndim: int) -> tuple:
    return ("tp",) + (None,) * (ndim - 1)


def state_sharding(mesh: Mesh | None = None) -> ClusterState:
    """A ClusterState-shaped tree of shard specs: the axis name each
    dimension of a leaf splits on (``None`` = whole)."""
    ndim = dict(metrics=2, metrics_age=1, lat=2, bw=2, cap=2, used=2,
                node_valid=1, label_bits=2, taint_bits=2, group_bits=2,
                resident_anti=2, node_zone=1, gz_counts=2, az_anti=2,
                node_numeric=2)
    return ClusterState(**{
        k: (None,) * d if k in REPLICATED_STATE_FIELDS else _node_spec(d)
        for k, d in ndim.items()})


def pods_sharding(mesh: Mesh | None = None) -> PodBatch:
    """A PodBatch-shaped tree of shard specs: the pod axis on ``dp``.
    The score tiles take the rank's dp rows; the conflict loop reads
    every contender's O(P) columns, so each rank holds the whole batch
    (GSPMD all-gathers them in JAX)."""
    ndim = dict(req=2, peers=2, peer_traffic=2, tol_bits=2, sel_bits=2,
                affinity_bits=2, anti_bits=2, group_bit=2, priority=1,
                pod_valid=1, soft_sel_bits=3, soft_sel_w=2,
                soft_grp_bits=3, soft_grp_w=2, soft_zone_bits=3,
                soft_zone_w=2, group_idx=1, spread_maxskew=1,
                spread_hard=1, ns_anyof=4, ns_forbid=3, ns_term_used=2,
                ns_num_col=3, ns_num_lo=3, ns_num_hi=3, zaff_bits=2,
                zanti_bits=2)
    return PodBatch(**{k: ("dp",) + (None,) * (d - 1)
                       for k, d in ndim.items()})


def replicated(mesh: Mesh | None = None) -> tuple:
    """The spec of a whole (replicated) value."""
    return ()


def _fold_spec(mesh: Mesh | None = None):
    """Spec of a folded ``[NB, batch, ...]`` stream leaf: the batch axis
    on ``dp``."""
    def spec(x):
        return (None, "dp") + (None,) * (x.dim() - 2)
    return spec


def _to_device(tree, device: torch.device):
    return tree_map(lambda x: x.to(device), tree)


def place(mesh: Mesh, state: ClusterState, pods: PodBatch):
    """This rank's ``(state shard, batch)`` on its device: the node-axis
    leaves' ``tp`` rows and the whole zone planes, and the whole batch
    (:func:`pods_sharding`)."""
    return _leaf_placer(mesh)(state), _to_device(pods, mesh.device)


def unshard(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A node-axis leaf of the shards, whole (an all-gather over
    ``tp``); for O(N) leaves such as ``used`` or ``group_bits``."""
    return concat_shards(mesh, x, "tp")


def _leaf_placer(mesh: Mesh):
    """A state-placement closure with a per-leaf cache: the encoder's
    snapshot (and the extender's static cache) reuse tensor OBJECTS while
    their dirty group is clean, so re-placing only leaves whose identity
    changed keeps the N×N planes from being re-sliced or re-sent every
    call.  Keyed by field with a strong reference to the source, so an
    id reused after garbage collection cannot alias.  Placement is local
    (no collective)."""
    cache: dict[str, tuple] = {}

    def place_state(state: ClusterState) -> ClusterState:
        out = {}
        for f in dataclasses.fields(state):
            leaf = getattr(state, f.name)
            hit = cache.get(f.name)
            if hit is not None and hit[0] is leaf:
                out[f.name] = hit[1]
                continue
            y = leaf if f.name in REPLICATED_STATE_FIELDS else shard_rows(
                leaf, mesh.tp_index, mesh.tp)
            y = y.to(mesh.device).contiguous()
            cache[f.name] = (leaf, y)
            out[f.name] = y
        return ClusterState(**out)

    return place_state


class _StaticCache:
    """The shard's batch-invariant prep, rebuilt when any of the leaves
    it reads changed identity on ANY rank (one :meth:`Mesh.flag`): its
    build is collective, so every rank must rebuild together."""

    _KEYS = ("metrics", "metrics_age", "lat", "bw", "node_valid")

    def __init__(self, mesh: Mesh, build) -> None:
        self._mesh, self._build = mesh, build
        self._key: tuple | None = None
        self._val = None

    def get(self, placed: ClusterState):
        key = tuple(getattr(placed, k) for k in self._KEYS)
        stale = self._key is None or any(
            a is not b for a, b in zip(key, self._key))
        if self._mesh.flag(torch.tensor(stale), "static_stale"):
            self._val = self._build(placed)
            self._key = key
        return self._val


def _dense_static(cfg: SchedulerConfig, mesh: Mesh):
    def build(placed):
        return score_lib.static_node_scores_spmd(placed, cfg, mesh)
    return build


_PALLAS_STEP_WARNING = (
    "score_backend='pallas' is not supported on the "
    "sharded_schedule_step path (use the sharded replay); "
    "running the dense XLA kernel instead")


def _force_dense(cfg: SchedulerConfig) -> SchedulerConfig:
    """Coerce to the dense score backend.  The row-shard kernel route
    lives on the replay path (:func:`pallas_static_builder`: the replay,
    ``run_density(mode="device", mesh=...)`` and the serving burst); the
    single-batch step, the serving assign and the webhook's score and
    winner run dense on a mesh, as in JAX.  Warns (the JAX text); each
    caller calls it once, when its function is built."""
    if cfg.score_backend == "pallas":
        warnings.warn(
            "score_backend='pallas' requires max_nodes % (tp*128) == 0 "
            "and max_pods % (dp*8) == 0 on mesh-sharded paths; running "
            "the dense XLA kernel instead",
            RuntimeWarning, stacklevel=3)
        return dataclasses.replace(cfg, score_backend="xla")
    return cfg


def _assigner(method: str):
    return {"greedy": assign_greedy_spmd,
            "parallel": assign_parallel_spmd}[method]


def sharded_schedule_step(cfg: SchedulerConfig, mesh: Mesh,
                          method: str = "parallel"):
    """A full scheduling step (score + assign + commit) over the mesh:
    ``step(state_shard, pods) -> (assignment, new_state_shard)``, with
    ``(state_shard, pods)`` from :func:`place`.  Collective."""
    assign = _assigner(method)
    if cfg.score_backend == "pallas":
        warnings.warn(_PALLAS_STEP_WARNING, RuntimeWarning, stacklevel=2)
        cfg = dataclasses.replace(cfg, score_backend="xla")

    def step(state: ClusterState, pods: PodBatch):
        rows = state.num_nodes
        node_zone = concat_shards(mesh, state.node_zone, "tp")
        assignment = assign(state, pods, cfg, mesh, node_zone=node_zone)
        return assignment, commit_assignments_shard(
            state, pods, assignment, mesh.tp_index * rows, rows * mesh.tp,
            node_zone)

    return step


def sharded_assign_fn(cfg: SchedulerConfig, mesh: Mesh,
                      method: str = "parallel", state_placer=None):
    """A drop-in for the serving loop's assign callable
    (``(state, pods, cfg) -> assignment``, or ``(assignment, rounds)``
    with ``with_stats`` under ``"parallel"``): the whole state is placed
    onto the rank's shard (leaf-identity cached), the shard's dense
    static prep is cached the same way, and the SPMD assigner runs.  The
    cfg argument is accepted for signature parity but must equal the one
    given here.  Collective: under ``--multihost`` every process runs it
    on the controller's broadcast (:mod:`.serve_multihost`)."""
    assign = _assigner(method)
    cfg = _force_dense(cfg)
    place_state = state_placer or _leaf_placer(mesh)
    statics = _StaticCache(mesh, _dense_static(cfg, mesh))

    def fn(state, pods, cfg_arg=None, *, with_stats: bool = False):
        placed = place_state(state)
        pods = _to_device(pods, mesh.device)
        static = statics.get(placed)
        if method == "parallel":
            return assign(placed, pods, cfg, mesh, static,
                          with_stats=with_stats)
        return assign(placed, pods, cfg, mesh, static)

    return fn


def serving_fns(cfg: SchedulerConfig, mesh: Mesh,
                method: str = "parallel"):
    """The mesh serving triple ``(assign_fn, score_fn, burst_fn)``
    sharing ONE state placer, so the loop's cycle, the webhook and the
    backlog burst read one placed copy of the shard."""
    place_state = _leaf_placer(mesh)
    return (sharded_assign_fn(cfg, mesh, method, state_placer=place_state),
            sharded_score_fn(cfg, mesh, state_placer=place_state),
            serving_burst_fn(cfg, mesh, method, state_placer=place_state))


def _resolve_backend(cfg: SchedulerConfig, mesh: Mesh):
    """``(run_cfg, static_builder)`` for a mesh replay or burst: the
    row-shard kernel builder when the shapes tile, else the dense config
    (with the coercion's warning) and ``None`` — one rule for every
    sharded replay call site."""
    if cfg.score_backend == "pallas":
        builder = pallas_static_builder(cfg, mesh)
        if builder is not None:
            return cfg, builder
        return _force_dense(cfg), None
    return cfg, None


def serving_burst_fn(cfg: SchedulerConfig, mesh: Mesh,
                     method: str = "parallel", state_placer=None):
    """Backlog-burst callable of the mesh serving loop: ``run(state,
    stream) -> ((assignment, final_shard[, rounds]), with_stats)``, the
    sharded replay of the burst on the shared placement.  The dense
    static prep is cached by leaf identity; the kernel route builds its
    per-replay pack each burst."""
    place_state = state_placer or _leaf_placer(mesh)
    run_cfg, builder = _resolve_backend(cfg, mesh)
    with_stats = method == "parallel"
    statics = None if builder is not None else _StaticCache(
        mesh, _dense_static(run_cfg, mesh))

    def run(state, stream):
        from kubernetesnetawarescheduler_tpu_torch.core.replay import (
            fold_stream,
            replay_folded,
        )

        placed = place_state(state)
        folded = fold_stream(stream.to(mesh.device), run_cfg)
        if builder is not None:
            out = replay_folded(placed, folded, run_cfg, method,
                                with_stats=with_stats,
                                static_builder=builder, mesh=mesh)
        else:
            out = replay_folded(placed, folded, run_cfg, method,
                                static=statics.get(placed),
                                with_stats=with_stats, mesh=mesh)
        return out, with_stats

    return run


def _static_placer(mesh: Mesh):
    """Places the webhook's dense static ``(base f32[N], C.T [N, N])`` as
    the shard's ``(base[rows], C.T[:, rows])``, cached by identity."""
    cache: list = [None, None]

    def place_static(static):
        if cache[0] is not static:
            base, ct = static
            rows = base.shape[0] // mesh.tp
            off = mesh.tp_index * rows
            cache[0] = static
            cache[1] = (base[off:off + rows].to(mesh.device),
                        ct[:, off:off + rows].to(mesh.device).contiguous())
        return cache[1]

    return place_static


def _score_columns(cfg, mesh, place_state, place_static, state, pods,
                   static):
    placed = place_state(state)
    pods = _to_device(pods, mesh.device)
    return score_lib.score_pods_spmd(placed, pods, cfg, place_static(static),
                                     mesh)


def sharded_score_fn(cfg: SchedulerConfig, mesh: Mesh, state_placer=None):
    """Mesh-sharded full score for the webhook: ``fn(state, pods, static)
    -> scores f32[P, N]``, whole on every rank.  The batch is whole on
    every rank and the node axis — the state's rows and the dense static
    pair's columns — shards over ``tp``; each rank scores its columns
    (:func:`~..core.score.score_pods_spmd`) and the columns are gathered
    over ``tp``.  Dense backend only (:func:`_force_dense`)."""
    cfg = _force_dense(cfg)
    place_state = state_placer or _leaf_placer(mesh)
    place_static = _static_placer(mesh)

    def fn(state, pods, static):
        cols = _score_columns(cfg, mesh, place_state, place_static, state,
                              pods, static)
        g = mesh.gather(cols, "tp")                      # [tp, P, rows]
        return g.permute(1, 0, 2).reshape(cols.shape[0], -1)

    return fn


def sharded_winner_fn(cfg: SchedulerConfig, mesh: Mesh, state_placer=None):
    """Mesh-sharded fused winner: ``fn(state, pods, static) -> (best
    f32[P], node i32[P])`` without a whole ``P x N`` score plane on any
    rank.  Each rank reduces its score columns to a local ``(best,
    node)`` with GLOBAL node indices; the combine over ``tp`` is the max
    of the values and the min of the nodes whose local best equals it
    (JAX's ``pmax``/``pmin``), so the lowest-index tie-break survives
    sharding exactly.  Infeasible rows come back ``-1``."""
    cfg = _force_dense(cfg)
    place_state = state_placer or _leaf_placer(mesh)
    place_static = _static_placer(mesh)

    def fn(state, pods, static):
        cols = _score_columns(cfg, mesh, place_state, place_static, state,
                              pods, static)
        rows = cols.shape[1]
        ids = mesh.tp_index * rows + torch.arange(
            rows, dtype=torch.int32, device=cols.device)
        best_l = cols.amax(dim=1)
        node_l = torch.where(cols == best_l[:, None], ids[None, :],
                             _WINNER_SENTINEL).amin(dim=1)
        best = mesh.reduce(best_l, "max", "tp")
        node = mesh.reduce(torch.where(best_l == best, node_l,
                                       _WINNER_SENTINEL), "min", "tp")
        feasible = best > NEG_HALF
        return best, torch.where(feasible, node, -1).to(torch.int32)

    return fn


def pallas_static_builder(cfg: SchedulerConfig, mesh: Mesh):
    """The row-shard kernel route: a ``static_builder`` for
    :func:`~..core.replay.replay_folded` that launches
    ``static_scores_kernel`` on each rank's ``bw``/``lat`` row shard.

    Communication-free per batch: a rank's rows of ``raw`` need only its
    rows of ``bw``/``lat`` (full peer columns), so each rank launches the
    kernel on its ``[N/tp, N]`` shard with ``params[7]`` set to the
    shard's global row offset (the diagonal's loopback pin), its shard's
    node planes and group rows, and its dp rows of the batch.  The
    normalizers and the metric vote are the sharded prep's
    (:func:`~..core.score.static_tile_inputs_spmd`), once per replay.
    The soft zone term and the nodeAffinity mask join outside the launch,
    self-gated, as on one device.

    Returns ``None`` (callers fall back to :func:`_force_dense`) unless
    the shapes tile as JAX's gate asks: ``max_nodes % (tp * 128) == 0``,
    and ``max_pods / dp`` a multiple of 8 that its 128-pod blocks
    cover."""
    dp, tp = mesh.dp, mesh.tp
    n, p = cfg.max_nodes, cfg.max_pods
    if n % (tp * 128) != 0 or p % dp != 0 or (p // dp) % 8 != 0:
        return None
    p_local = p // dp
    if p_local % min(128, p_local) != 0:
        return None

    def builder(state: ClusterState):
        rows = state.num_nodes
        base, bw_max, lat_max, valid_all = score_lib.static_tile_inputs_spmd(
            state, cfg, mesh)
        params = tiled_score.kernel_params(cfg, bw_max, lat_max)
        params[7] = float(mesh.tp_index * rows)
        pack = kernels.StaticPack(
            params=params, bw=state.bw.contiguous(),
            lat=state.lat.contiguous(),
            validk=valid_all.to(torch.float32),
            base=base.contiguous(),
            node_valid=state.node_valid.to(torch.float32),
            taint=state.taint_bits.contiguous(),
            label=state.label_bits.contiguous())
        n_all = valid_all.shape[0]

        def static_fn(st: ClusterState, pods: PodBatch):
            lp = shard_pods(pods, mesh.dp_index, mesh.dp)
            raw, ok = tiled_score.static_tile_scores(
                pack, st.group_bits.contiguous(),
                tiled_score.pack_pods(lp, n_all), cfg.use_bfloat16,
                transposed=True)
            raw = raw + score_lib.soft_zone_scores(st, lp, cfg,
                                                   transposed=True)
            ok = ok & score_lib.ns_affinity_ok(st, lp, transposed=True)
            return {"rawT": raw, "okT": ok}

        return static_fn

    return builder


def sharded_replay_fn(cfg: SchedulerConfig, mesh: Mesh, method: str,
                      folded=None, with_stats: bool = False):
    """The mesh replay callable ``(state_shard, folded) ->
    (assignment, final_shard[, rounds])``, the backend resolved once
    (:func:`_resolve_backend`).  ``folded`` is accepted for signature
    parity with JAX, which reads its shardings.  Collective."""
    from kubernetesnetawarescheduler_tpu_torch.core.replay import (
        replay_folded,
    )

    run_cfg, builder = _resolve_backend(cfg, mesh)
    builder = builder or _dense_static(run_cfg, mesh)

    def run(state, folded):
        return replay_folded(state, folded, run_cfg, method,
                             with_stats=with_stats, static_builder=builder,
                             mesh=mesh)

    return run


def sharded_replay_stream(state, stream, cfg: SchedulerConfig, mesh: Mesh,
                          method: str = "parallel",
                          with_stats: bool = False):
    """Whole-workload replay over the mesh: the multi-rank form of
    :func:`~..core.replay.replay_stream`.  Every rank calls it with the
    whole state and stream; each keeps its node shard of the state (so
    ``lat``/``bw`` are ``[N/tp, N]`` on every rank) and returns the whole
    ``i32[S]`` assignment, equal to the single-device replay's, and its
    final shard (plus the per-batch rounds with ``with_stats``)."""
    from kubernetesnetawarescheduler_tpu_torch.core.replay import fold_stream

    placed = _leaf_placer(mesh)(state)
    folded = fold_stream(stream.to(mesh.device), cfg)
    return sharded_replay_fn(cfg, mesh, method, folded,
                             with_stats=with_stats)(placed, folded)


__all__ = ["Mesh", "make_mesh", "state_sharding", "pods_sharding", "place",
           "sharded_schedule_step", "sharded_replay_stream",
           "sharded_replay_fn", "sharded_assign_fn", "sharded_score_fn",
           "sharded_winner_fn", "serving_fns", "serving_burst_fn",
           "pallas_static_builder", "replicated", "unshard"]
