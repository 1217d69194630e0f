"""The port's mesh-sharded scheduling (``parallel/sharding.py``) on gloo
CPU meshes, against the JAX package.

The parent computes the JAX answers in-process (the conftest's 8 virtual
CPU devices; ``CFG`` is ``tests/test_sharding.py``'s), then spawns one
process per rank that imports no JAX (``jax`` and the JAX package are
blocked in ``sys.modules``), joins a gloo group over a file store and
runs the port's SPMD entry points on its shards.  The JAX package's own
2-D mesh breaks ties otherwise on the CPU (``tests/test_sharding.py``,
``_skip_if_cpu_2d_mesh``), so every mesh here, 2-D included, is held to
the JAX package's SINGLE-DEVICE answer: assignments, winners and bit
planes identical, ``used`` within 1e-6, scores within 1e-4.

Two spawns: two ranks (meshes 1x2 and 2x1) and four ranks (2x2, and 1x4
for the row-shard kernel route at 512 nodes; the four also run
``bench/mesh_replay.py``'s drives on a 2x2 mesh).
"""

from __future__ import annotations

import importlib
import os
import pickle
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG_KW = dict(max_nodes=64, max_pods=16, max_peers=4, use_bfloat16=False)
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}


# ---------------------------------------------------------------------------
# The spawn harness (shared by test_torch_multihost / _serve_multihost).
# ---------------------------------------------------------------------------

_RANK_MAIN = (
    "import sys; sys.path.insert(0, {repo!r}); "
    "sys.modules['jax'] = None; "
    "sys.modules['kubernetesnetawarescheduler_tpu'] = None; "
    "from tests.test_torch_sharding import _rank_main; _rank_main()")


def _rank_main() -> None:
    """A spawned rank: join the gloo group, run ``module.fn(rank, world,
    payload)`` and pickle its result (or its error) for the parent."""
    import traceback

    import torch.distributed as dist

    module, fn, rank, world, store, payload, out = sys.argv[1:8]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(payload, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = {"ok": getattr(importlib.import_module(module), fn)(
            rank, world, data)}
    except Exception:  # noqa: BLE001 — reported to the parent
        result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(result, f)


def spawn_world(tmp: Path, world: int, module: str, fn: str, payload,
                timeout: float = 90.0) -> list:
    """Run ``module.fn`` in ``world`` spawned ranks; returns each rank's
    result in rank order.  A rank that fails, or a world that outlives
    ``timeout``, fails the caller."""
    tmp.mkdir(parents=True, exist_ok=True)
    data, store, out = tmp / "payload.pkl", tmp / "store", tmp / "out"
    with open(data, "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    code = _RANK_MAIN.format(repo=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, module, fn, str(r), str(world),
         str(store), str(data), str(out)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(world):
        path = Path(f"{out}.{r}")
        assert path.exists(), f"rank {r} left no result:\n{logs[r][-3000:]}"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res.get('error')}"
        results.append(res["ok"])
    return results


# ---------------------------------------------------------------------------
# Instances (numpy, shared by both packages).
# ---------------------------------------------------------------------------


def stream_np(cfg_kw: dict, rng, s: int, n: int) -> dict:
    """``tests/test_sharding.py``'s replay stream, as numpy."""
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig

    cfg = SchedulerConfig(**cfg_kw)
    k, w, t = cfg.max_peers, cfg.mask_words, cfg.max_soft_terms
    t2, e, ne = cfg.max_ns_terms, cfg.max_ns_exprs, cfg.max_ns_num
    u32 = np.uint32
    return dict(
        req=rng.uniform(0.05, 0.5, (s, 3)).astype(np.float32),
        peer_pods=np.where(rng.random((s, k)) < 0.2,
                           rng.integers(0, s, (s, k)), -1).astype(np.int32),
        peer_nodes=np.where(rng.random((s, k)) < 0.2,
                            rng.integers(0, n, (s, k)), -1).astype(np.int32),
        peer_traffic=rng.uniform(0, 3, (s, k)).astype(np.float32),
        tol_bits=np.zeros((s, w), u32), sel_bits=np.zeros((s, w), u32),
        affinity_bits=np.zeros((s, w), u32),
        anti_bits=np.zeros((s, w), u32), group_bit=np.zeros((s, w), u32),
        priority=rng.uniform(0, 5, (s,)).astype(np.float32),
        pod_valid=np.ones((s,), bool),
        soft_sel_bits=np.zeros((s, t, w), u32),
        soft_sel_w=np.zeros((s, t), np.float32),
        soft_grp_bits=np.zeros((s, t, w), u32),
        soft_grp_w=np.zeros((s, t), np.float32),
        soft_zone_bits=np.zeros((s, t, w), u32),
        soft_zone_w=np.zeros((s, t), np.float32),
        group_idx=np.full((s,), -1, np.int32),
        spread_maxskew=np.zeros((s,), np.int32),
        spread_hard=np.zeros((s,), bool),
        ns_anyof=np.zeros((s, t2, e, w), u32),
        ns_forbid=np.zeros((s, t2, w), u32),
        ns_term_used=np.zeros((s, t2), bool),
        ns_num_col=np.full((s, t2, ne), -1, np.int32),
        ns_num_lo=np.full((s, t2, ne), -np.inf, np.float32),
        ns_num_hi=np.full((s, t2, ne), np.inf, np.float32),
        zaff_bits=np.zeros((s, w), u32), zanti_bits=np.zeros((s, w), u32))


def wide_instance(n: int, seed: int = 11):
    """``tests/test_sharding.py``'s row-shard kernel instance at ``n``
    nodes: dense random links and 32 pods, 40% of them with a soft
    node-label term."""
    kw = dict(max_nodes=n, max_pods=16, max_peers=4, use_bfloat16=False)
    rng = np.random.default_rng(seed)
    state = dict(node_valid=np.ones((n,), bool),
                 cap=rng.uniform(8, 64, (n, 3)).astype(np.float32),
                 lat=rng.uniform(0.05, 5, (n, n)).astype(np.float32),
                 bw=rng.uniform(1e9, 2e10, (n, n)).astype(np.float32),
                 metrics=rng.uniform(0, 100, (n, 6)).astype(np.float32))
    stream = stream_np(kw, rng, 32, n)
    t = stream["soft_sel_w"].shape[1]
    has = rng.random((32, t)) < 0.4
    stream["soft_sel_w"] = np.where(has, rng.uniform(1, 100, (32, t)),
                                    0).astype(np.float32)
    stream["soft_sel_bits"][:, :, 0] = np.where(has, 1, 0)
    stream["peer_pods"][:] = -1
    return kw, state, stream


# ---------------------------------------------------------------------------
# The ranks (no JAX).
# ---------------------------------------------------------------------------


def _sharding_rank(rank: int, world: int, data: dict) -> dict:
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K
    from kubernetesnetawarescheduler_tpu_torch.core import replay as R
    from kubernetesnetawarescheduler_tpu_torch.core import score as S
    from kubernetesnetawarescheduler_tpu_torch.core import state as ST
    from kubernetesnetawarescheduler_tpu_torch.core import tiled_score
    from kubernetesnetawarescheduler_tpu_torch.parallel import sharding as SH

    cfg = SchedulerConfig(**data["cfg"])

    def inst(i):
        s_np, p_np = data["inst"][i]
        return (ST.state_from_numpy(cfg, s_np, "cpu"),
                ST.pods_from_numpy(cfg, p_np, "cpu"))

    out = {}
    for dp, tp in MESHES[world]:
        mesh = SH.make_mesh(dp, tp, device="cpu")
        res = {}
        st, pods = inst(0)
        shard, pods_d = SH.place(mesh, st, pods)
        res["shard_shapes"] = (tuple(shard.lat.shape), tuple(shard.bw.shape))
        a, new = SH.sharded_schedule_step(cfg, mesh, "parallel")(shard,
                                                                 pods_d)
        res["parallel"] = (a.numpy(), SH.unshard(mesh, new.used).numpy(),
                           SH.unshard(mesh, new.group_bits).numpy())
        st1, pods1 = inst(1)
        s1, p1 = SH.place(mesh, st1, pods1)
        res["greedy"] = SH.sharded_schedule_step(cfg, mesh, "greedy")(
            s1, p1)[0].numpy()
        st2, _ = inst(2)
        stream = R.stream_from_numpy(cfg, data["stream"], "cpu")
        a2, fin = SH.sharded_replay_stream(st2, stream, cfg, mesh)
        res["replay"] = (a2.numpy(), SH.unshard(mesh, fin.used).numpy(),
                         tuple(fin.lat.shape))
        static = S.static_node_scores(st, cfg)
        res["winner"] = tuple(x.numpy() for x in SH.sharded_winner_fn(
            cfg, mesh)(st, pods, static))
        res["scores"] = SH.sharded_score_fn(cfg, mesh)(st, pods,
                                                       static).numpy()
        res["collectives"] = mesh.collectives
        out[(dp, tp)] = res

    # The row-shard kernel route: tp = world, N = 128 per rank.
    n = 128 * world
    kw, s_np, st_np = wide_instance(n)
    kcfg = SchedulerConfig(**kw, score_backend="pallas")
    dense = SchedulerConfig(**kw)
    state = ST.state_from_numpy(kcfg, s_np, "cpu")
    stream = R.pad_stream(R.stream_from_numpy(kcfg, st_np, "cpu"),
                          kcfg.max_pods)
    want, _ = R.replay_stream(state, stream, dense)
    solo_k, _ = R.replay_stream(state, stream, kcfg)
    mesh = SH.make_mesh(1, world, device="cpu")
    seen = []
    real = tiled_score.static_tile_scores

    def spy(pack, groups, pp, bf16, transposed=False, peers=None):
        seen.append((float(pack.params[7]), tuple(pack.bw.shape)))
        return real(pack, groups, pp, bf16, transposed=transposed,
                    peers=peers)

    tiled_score.static_tile_scores = spy
    try:
        got, fin = SH.sharded_replay_stream(state, stream, kcfg, mesh)
    finally:
        tiled_score.static_tile_scores = real
    # One captured shard launch's plain output against the solo plain
    # version's columns: the diagonal pin at the global row offset.
    pack_solo = tiled_score.static_replay_pack(state, kcfg)
    pods = R.batch_from_stream(stream.slice(0, kcfg.max_pods),
                               torch.full((stream.num_pods,), -1,
                                          dtype=torch.int32))
    pp = tiled_score.pack_pods(pods, n)
    raw_solo, ok_solo = K.static_tile_scores_plain(pack_solo,
                                                   state.group_bits, pp,
                                                   False)
    placed = SH._leaf_placer(mesh)(state)
    static_fn = SH.pallas_static_builder(kcfg, mesh)(placed)
    tile = static_fn(placed, pods)
    rows = n // world
    cols = slice(rank * rows, (rank + 1) * rows)
    out["kernel_route"] = {
        "want": want.numpy(), "solo_kernel": solo_k.numpy(),
        "got": got.numpy(), "launches": seen, "batches":
        stream.num_pods // kcfg.max_pods,
        "tile_equal": bool(torch.equal(tile["rawT"].T, raw_solo[:, cols])
                           and torch.equal(tile["okT"].T, ok_solo[:, cols])),
        "final_lat": tuple(fin.lat.shape)}
    if world == 4:
        from kubernetesnetawarescheduler_tpu_torch.bench import mesh_replay

        out["mesh_replay"] = mesh_replay.run(
            SH.make_mesh(2, 2, device="cpu"),
            *mesh_replay.workload(256, 128, 32),
            drives=(("pallas", False), ("xla", True)))
    return out


# ---------------------------------------------------------------------------
# The parent: JAX answers, then the spawns.
# ---------------------------------------------------------------------------


def _zone_work(state: dict, pods: dict) -> bool:
    """The conflict loop's zone-work gate on numpy fields: a live
    topology-spread constraint, a zone (anti-)affinity term, or a
    resident zone-anti bit."""
    spread = ((pods["spread_maxskew"] > 0) & (pods["group_idx"] >= 0)
              & pods["pod_valid"])
    return bool(spread.any() or pods["zaff_bits"].any()
                or pods["zanti_bits"].any() or state["az_anti"].any())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    from kubernetesnetawarescheduler_tpu.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu.core import assign as jassign
    from kubernetesnetawarescheduler_tpu.core import score as jscore
    from kubernetesnetawarescheduler_tpu.core.replay import (
        PodStream,
        pad_stream,
        replay_stream,
    )
    from kubernetesnetawarescheduler_tpu.core.state import (
        commit_assignments,
        init_cluster_state,
    )
    from tests import gen

    cfg = SchedulerConfig(**CFG_KW)
    insts, want = [], {}
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        insts.append(gen.random_instance(rng, cfg, n_nodes=48, n_pods=12))
    state, pods = gen.to_pytrees(cfg, *insts[0])
    a = jassign.assign_parallel(state, pods, cfg)
    new = commit_assignments(state, pods, a)
    want["parallel"] = (np.asarray(a), np.asarray(new.used),
                        np.asarray(new.group_bits).view(np.int32))
    s1, p1 = gen.to_pytrees(cfg, *insts[1])
    want["greedy"] = np.asarray(jassign.assign_greedy(s1, p1, cfg))
    s_np = stream_np(CFG_KW, np.random.default_rng(7), 64, 64)
    # The stream's pods carry no group bits, so the replay state's
    # resident zone-anti bits could mask nothing; cleared, the replay
    # runs the mesh loop without zone work (second-chance pass on) while
    # the parallel instance runs it with zone work (overlay and caps on).
    insts[2][0]["az_anti"][:] = 0
    assert _zone_work(*insts[0]) and not _zone_work(insts[2][0], s_np)
    s2, _ = gen.to_pytrees(cfg, *insts[2])
    a2, fin = replay_stream(s2, PodStream(**{
        k: jnp.asarray(v) for k, v in s_np.items()}), cfg, "parallel")
    want["replay"] = (np.asarray(a2), np.asarray(fin.used))
    static = jscore.static_node_scores(state, cfg)
    scores = jscore.score_pods(state, pods, cfg, static)
    want["scores"] = np.asarray(scores)
    want["winner"] = tuple(np.asarray(x)
                           for x in jscore.winner_from_scores(scores))
    # The row-shard kernel route's instances, replayed dense at f32 on
    # one device: the answer every rank's kernel-route replay must give.
    want["kernel_route"] = {}
    for n in (256, 512):
        kw, st_np, str_np = wide_instance(n)
        wcfg = SchedulerConfig(**kw)
        wstate = init_cluster_state(
            wcfg, **{k: jnp.asarray(v) for k, v in st_np.items()})
        wstream = pad_stream(PodStream(**{
            k: jnp.asarray(v) for k, v in str_np.items()}), wcfg.max_pods)
        want["kernel_route"][n] = np.asarray(
            replay_stream(wstate, wstream, wcfg, "parallel")[0])
    payload = {"cfg": CFG_KW, "inst": insts, "stream": s_np}
    base = tmp_path_factory.mktemp("sharding")
    got = {}
    for world in (2, 4):
        got[world] = spawn_world(base / f"w{world}", world,
                                 "tests.test_torch_sharding",
                                 "_sharding_rank", payload)
    return want, got


def _ranks(got, dp, tp):
    return got[dp * tp], (dp, tp)


MESH_IDS = [(1, 2), (2, 1), (2, 2)]


@pytest.mark.parametrize("dp,tp", MESH_IDS)
def test_sharded_step_matches_single_device_jax(runs, dp, tp):
    want, got = runs
    ranks, key = _ranks(got, dp, tp)
    for res in ranks:
        a, used, gb = res[key]["parallel"]
        np.testing.assert_array_equal(a, want["parallel"][0])
        np.testing.assert_allclose(used, want["parallel"][1], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(gb, want["parallel"][2])


@pytest.mark.parametrize("dp,tp", MESH_IDS)
def test_sharded_greedy_matches_single_device_jax(runs, dp, tp):
    want, got = runs
    ranks, key = _ranks(got, dp, tp)
    for res in ranks:
        np.testing.assert_array_equal(res[key]["greedy"], want["greedy"])


@pytest.mark.parametrize("dp,tp", MESH_IDS)
def test_sharded_replay_matches_single_device_jax(runs, dp, tp):
    want, got = runs
    ranks, key = _ranks(got, dp, tp)
    for res in ranks:
        a, used, _ = res[key]["replay"]
        np.testing.assert_array_equal(a, want["replay"][0])
        np.testing.assert_allclose(used, want["replay"][1], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dp,tp", MESH_IDS)
def test_each_rank_holds_row_shards_of_the_nxn_planes(runs, dp, tp):
    _, got = runs
    ranks, key = _ranks(got, dp, tp)
    n = CFG_KW["max_nodes"]
    for res in ranks:
        assert res[key]["shard_shapes"] == ((n // tp, n), (n // tp, n))
        assert res[key]["replay"][2] == (n // tp, n)
        assert res[key]["collectives"] > 0


@pytest.mark.parametrize("dp,tp", MESH_IDS)
def test_sharded_winner_matches_jax(runs, dp, tp):
    want, got = runs
    ranks, key = _ranks(got, dp, tp)
    for res in ranks:
        best, node = res[key]["winner"]
        np.testing.assert_array_equal(node, want["winner"][1])
        np.testing.assert_allclose(best, want["winner"][0], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dp,tp", MESH_IDS)
def test_sharded_scores_match_jax(runs, dp, tp):
    want, got = runs
    ranks, key = _ranks(got, dp, tp)
    w = want["scores"]
    for res in ranks:
        s = res[key]["scores"]
        np.testing.assert_array_equal(s > -5e29, w > -5e29)
        ok = w > -5e29
        np.testing.assert_allclose(s[ok], w[ok], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_row_shard_kernel_route_replay_equals_dense(runs, world):
    """The row-shard route (the plain static kernel on each rank's
    ``[N/tp, N]`` rows with its global row offset) replays as the JAX
    package's dense single-device replay, the port's, and the port's
    solo kernel route; each rank launched once per batch with its own
    offset, and one shard's output equals the solo plain version's
    columns bit for bit."""
    want, got = runs
    n = 128 * world
    rows = n // world
    for rank, res in enumerate(got[world]):
        kr = res["kernel_route"]
        np.testing.assert_array_equal(kr["got"], want["kernel_route"][n])
        np.testing.assert_array_equal(kr["got"], kr["want"])
        np.testing.assert_array_equal(kr["solo_kernel"], kr["want"])
        assert len(kr["launches"]) == kr["batches"]
        assert {off for off, _ in kr["launches"]} == {float(rank * rows)}
        assert {shape for _, shape in kr["launches"]} == {(rows, n)}
        assert kr["tile_equal"]
        assert kr["final_lat"] == (rows, n)


def test_mesh_replay_bench_reports_each_drive(runs):
    """``bench/mesh_replay.py``'s report on a 2x2 mesh: every drive's
    assignments equal rank 0's single-device replay on every rank, each
    rank holds ``[N/tp, N]`` and made collectives; only rank 0 reports.
    (On the CPU the kernel route runs the plain version, which launches
    nothing; the card counts its launches.)"""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels as K

    _, got = runs
    rep = got[4][0]["mesh_replay"]
    assert all(not r["mesh_replay"] for r in got[4][1:])
    assert rep["mesh"] == {"dp": 2, "tp": 2} and rep["backend"] == "gloo"
    assert set(rep["drives"]) == {"pallas_f32", "xla_bf16"}
    for key, d in rep["drives"].items():
        assert d["identical"], key
        for r in d["ranks"]:
            assert r["lat_shape"] == r["bw_shape"] == [128, 256]
            assert r["collectives_per_batch"] > 0
            assert r["batches"] == 4
            assert set(r["launches"]) == set(K.KERNELS)


class _StubMesh:
    def __init__(self, dp, tp):
        self.dp, self.tp = dp, tp
        self.dp_index = self.tp_index = 0


@pytest.mark.parametrize("n,p,dp,tp,tiles", [
    (64, 16, 2, 4, False), (512, 16, 2, 4, True), (256, 16, 1, 2, True),
    (256, 12, 2, 1, False), (512, 272, 2, 1, False)])
def test_row_shard_route_needs_tiling_shapes(n, p, dp, tp, tiles):
    """JAX's gate: ``max_nodes % (tp * 128) == 0`` and an 8-aligned
    ``max_pods / dp`` its 128-pod blocks cover; otherwise ``None`` and
    the replay falls back to the dense backend with the JAX warning."""
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.parallel import sharding as SH

    cfg = SchedulerConfig(max_nodes=n, max_pods=p, max_peers=4,
                          score_backend="pallas")
    mesh = _StubMesh(dp, tp)
    assert (SH.pallas_static_builder(cfg, mesh) is not None) == tiles
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_cfg, builder = SH._resolve_backend(cfg, mesh)
    assert (builder is not None) == tiles
    assert run_cfg.score_backend == ("pallas" if tiles else "xla")
    assert len(caught) == (0 if tiles else 1)


def test_dense_coercions_warn_once_when_built():
    """The step, the serving assign and the webhook's score and winner
    run dense on a mesh; each warns once when it is built (the JAX
    texts), never when it is called."""
    from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig
    from kubernetesnetawarescheduler_tpu_torch.parallel import sharding as SH

    cfg = SchedulerConfig(max_nodes=256, max_pods=16, max_peers=4,
                          score_backend="pallas")
    mesh = _StubMesh(1, 2)
    for build, text in ((SH.sharded_schedule_step, "sharded_schedule_step"),
                        (SH.sharded_assign_fn, "max_nodes % (tp*128)"),
                        (SH.sharded_score_fn, "max_nodes % (tp*128)"),
                        (SH.sharded_winner_fn, "max_nodes % (tp*128)")):
        with pytest.warns(RuntimeWarning, match=re.escape(text)) as rec:
            build(cfg, mesh)
        assert len(rec) == 1


def test_make_mesh_needs_a_group_and_a_covering_shape(tmp_path):
    import torch.distributed as dist

    from kubernetesnetawarescheduler_tpu_torch.parallel import sharding as SH

    with pytest.raises(RuntimeError, match="process group"):
        SH.make_mesh(1, 1, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
            SH.make_mesh(1, 2, device="cpu")
        mesh = SH.make_mesh(1, 1, device="cpu")
        assert mesh.shape == {"dp": 1, "tp": 1}
        assert mesh.axis_names == ("dp", "tp")
        assert mesh.backend == "gloo" and mesh.device.type == "cpu"
    finally:
        dist.destroy_process_group()
