"""The port's incremental static prep against its full rebuild and the JAX
package's, on the CPU.

The same fuzzed churn (link probes, metric samples, readiness flips,
extrema retreats) goes through the JAX ``Encoder`` and the port's.  At
every step the port's ``compute_assign_static_incremental`` must equal
its own full ``compute_assign_static`` bit for bit (``torch.equal`` per
field), for both score backends, and the full prep must equal the JAX
package's: the raw network planes and the running extrema exactly, the
derived floats (metric vote, normalized ``C``, kernel params) at
rtol=atol=1e-6, as tests/test_torch_score.py holds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import pallas_score as jpallas
from kubernetesnetawarescheduler_tpu.core import score as jscore
from kubernetesnetawarescheduler_tpu.core.encode import Encoder as JEncoder
from kubernetesnetawarescheduler_tpu.k8s.types import Node as JNode
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore
from kubernetesnetawarescheduler_tpu_torch.core.encode import (
    Encoder as TEncoder,
)
from kubernetesnetawarescheduler_tpu_torch.core.kernels import StaticPack
from kubernetesnetawarescheduler_tpu_torch.core.tiled_score import (
    compute_assign_static,
    compute_assign_static_incremental,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node as TNode

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

ZONES = ("z0", "z1", "z2")


def _fill(enc, node_cls, n: int, seed: int) -> list[str]:
    """tests/test_static_delta.py's cluster: symmetric seeded matrices
    with a zero diagonal, so the extrema holders are real pairs."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        name = f"n{i}"
        enc.upsert_node(node_cls(
            name=name, capacity={"cpu": 16.0, "mem": 32.0},
            zone=ZONES[i % len(ZONES)],
            labels=frozenset({f"disk={'ssd' if i % 2 else 'hdd'}"})))
        names.append(name)
    lat = rng.uniform(0.05, 2.0, (n, n)).astype(np.float32)
    bw = rng.uniform(1e8, 1e10, (n, n)).astype(np.float32)
    lat = (lat + lat.T) / 2
    bw = (bw + bw.T) / 2
    np.fill_diagonal(lat, 0.0)
    np.fill_diagonal(bw, 0.0)
    enc.set_network(lat, bw)
    for name in names:
        enc.update_metrics(name, {
            "cpu_freq": float(rng.uniform(1e9, 3e9)),
            "mem_pct": float(rng.uniform(5, 90)),
            "net_tx": float(rng.uniform(0, 1e5)),
            "net_rx": float(rng.uniform(0, 1e5)),
        })
    return names


def _mutate(encs, names: list[str], rng: np.random.Generator) -> None:
    """One fuzzed churn step, applied identically to every encoder."""
    k = int(rng.integers(0, 4))
    if k in (0, 3):
        # k == 3 hammers a pair downward: when it holds the running
        # bw/lat max, the incremental path must rescan.
        lo_lat, hi_lat, lo_bw, hi_bw = ((0.05, 3.0, 1e7, 1e10) if k == 0
                                        else (0.05, 0.1, 1e7, 2e7))
        ops = []
        for _ in range(int(rng.integers(1, 4)) if k == 0 else 1):
            a, b = rng.choice(len(names), size=2, replace=False)
            ops.append((names[int(a)], names[int(b)],
                        float(rng.uniform(lo_lat, hi_lat)),
                        float(rng.uniform(lo_bw, hi_bw))))
        for enc in encs:
            for a, b, lat, bw in ops:
                enc.update_link(a, b, lat_ms=lat, bw_bps=bw)
    elif k == 1:
        name = names[int(rng.integers(len(names)))]
        vals = {"cpu_freq": float(rng.uniform(1e9, 3e9)),
                "mem_pct": float(rng.uniform(5, 90))}
        for enc in encs:
            enc.update_metrics(name, vals)
    else:
        name = names[int(rng.integers(len(names)))]
        ready = rng.random() < 0.5
        for enc in encs:
            (enc.mark_unready if ready else enc.mark_ready)(name)


def _assert_static_equal(got, want, ctx: str) -> None:
    """Bit-identity of two port static preps, field by field."""
    if isinstance(want, StaticPack):
        for f in dataclasses.fields(StaticPack):
            g, w = getattr(got, f.name), getattr(want, f.name)
            assert torch.equal(g, w), f"{ctx}: {f.name}"
        return
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{ctx}: leaf {i}"


def _assert_matches_jax(tstatic, jstatic, n: int, ctx: str) -> None:
    close = dict(rtol=1e-6, atol=1e-6, err_msg=ctx)
    if isinstance(tstatic, StaticPack):
        params, bw, lat, validk, nodes, nodei = (np.asarray(x)
                                                 for x in jstatic)
        np.testing.assert_allclose(tstatic.params.numpy(), params, **close)
        np.testing.assert_array_equal(tstatic.bw.numpy(), bw[:n, :n], ctx)
        np.testing.assert_array_equal(tstatic.lat.numpy(), lat[:n, :n], ctx)
        np.testing.assert_array_equal(tstatic.validk.numpy(), validk[0, :n])
        np.testing.assert_allclose(tstatic.base.numpy(), nodes[0, :n],
                                   **close)
        mw = tstatic.taint.shape[1]
        np.testing.assert_array_equal(tstatic.taint.numpy(),
                                      nodei[0:mw, :n].T, ctx)
        np.testing.assert_array_equal(tstatic.label.numpy(),
                                      nodei[mw:2 * mw, :n].T, ctx)
        return
    for g, w in zip(tstatic, jstatic):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **close)


@pytest.mark.parametrize("score_backend", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_incremental_static_bit_identical_under_churn(seed, score_backend):
    kw = dict(max_nodes=32, max_pods=8, max_peers=2,
              score_backend=score_backend)
    tcfg, jcfg = TCfg(**kw), JCfg(**kw)
    tenc, jenc = TEncoder(tcfg, device="cpu"), JEncoder(jcfg)
    names = _fill(tenc, TNode, 24, seed)
    _fill(jenc, JNode, 24, seed)
    state, ver = tenc.snapshot_versioned()
    static, ex = compute_assign_static_incremental(state, tcfg, None, None,
                                                   None)
    _assert_static_equal(static, compute_assign_static(state, tcfg),
                         "initial")
    rng = np.random.default_rng(seed + 200)
    delta_steps = 0
    for step in range(12):
        _mutate((tenc, jenc), names, rng)
        state, ver2 = tenc.snapshot_versioned()
        dirty = tenc.static_delta_since(ver)
        if dirty is not None and dirty.get("net_pairs"):
            delta_steps += 1
        static, ex = compute_assign_static_incremental(state, tcfg, static,
                                                       ex, dirty)
        ctx = f"step {step} ({score_backend})"
        _assert_static_equal(static, compute_assign_static(state, tcfg), ctx)
        jstate = jenc.snapshot()
        _assert_matches_jax(static,
                            jpallas.compute_assign_static(jstate, jcfg),
                            tcfg.max_nodes, ctx)
        jex = jscore.net_extrema_scan(jstate)
        assert (ex.bw_m, ex.lat_m) == (jex.bw_m, jex.lat_m), ctx
        ver = ver2
    assert delta_steps > 0, "no step took the pair-delta path"


@pytest.mark.parametrize("score_backend", ["xla", "pallas"])
def test_extrema_retreat_rescans(score_backend):
    """Dirtying the pair that holds the bandwidth max (downward) forces
    the rescan: the patched static still equals the full rebuild, with
    the new, smaller normalizer."""
    cfg = TCfg(max_nodes=32, max_pods=8, max_peers=2,
               score_backend=score_backend)
    enc = TEncoder(cfg, device="cpu")
    names = _fill(enc, TNode, 16, 3)
    state, ver = enc.snapshot_versioned()
    static, ex = compute_assign_static_incremental(state, cfg, None, None,
                                                   None)
    n = cfg.max_nodes
    i, j = ex.bw_arg // n, ex.bw_arg % n
    assert i < 16 and j < 16 and i != j, "degenerate extrema holder"
    enc.update_link(names[i], names[j], bw_bps=1e7)
    state2, _ = enc.snapshot_versioned()
    dirty = enc.static_delta_since(ver)
    assert dirty["net_pairs"] and not dirty["topo"]
    static2, ex2 = compute_assign_static_incremental(state2, cfg, static, ex,
                                                     dirty)
    _assert_static_equal(static2, compute_assign_static(state2, cfg),
                         "post-retreat")
    fresh = tscore.net_extrema_scan(state2)
    assert ex2.bw_m == fresh.bw_m
    assert ex2.bw_m < ex.bw_m
    # The patched prep is a new object: the one handed out before the
    # retreat still holds the old normalizer.
    if isinstance(static, StaticPack):
        assert not torch.equal(static.params, static2.params)
    else:
        assert not torch.equal(static[1], static2[1])


def test_static_delta_since_gap_returns_none():
    """A version older than the descriptor window returns None (the
    caller rebuilds in full); a recent one still merges."""
    cfg = TCfg(max_nodes=16, max_pods=4, max_peers=2)
    enc = TEncoder(cfg, device="cpu")
    names = _fill(enc, TNode, 8, 4)
    _, v0 = enc.snapshot_versioned()
    for k in range(140):
        enc.update_link(names[k % 8], names[(k + 1) % 8],
                        lat_ms=0.5 + k * 1e-3)
        enc.snapshot_versioned()
    assert enc.static_delta_since(v0) is None
    _, v1 = enc.snapshot_versioned()
    enc.update_link(names[0], names[1], bw_bps=5e8)
    _, v2 = enc.snapshot_versioned()
    d = enc.static_delta_since(v1)
    assert d is not None and d["net_pairs"]
    assert enc.static_delta_since(v2) is not None
