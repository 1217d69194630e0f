"""The port's ``Encoder`` against the JAX package's, on the CPU.

The same seeded node and pod sequence (each package's own
``bench/fakecluster.py`` generators, from one seed) goes through both
encoders: upserts, metrics, links, commits, releases, removals.  Every
snapshot plane, every ``encode_pods`` batch and the ``encode_stream``
output must be identical (u32 words compared through their int32 view).
Then the port on its own: the delta snapshot equals a full one, and no
snapshot aliases the staging arrays.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import encode as jencode
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import encode as tencode
from kubernetesnetawarescheduler_tpu_torch.core.encode import (
    DeviceWaveRing,
    concat_stream_waves,
    split_stream_waves,
)

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=48, max_pods=16, max_peers=4)
NODES = 40
JAX = types.SimpleNamespace(fc=jfc, make=lambda cfg: jencode.Encoder(
    JCfg(**cfg)))
TORCH = types.SimpleNamespace(fc=tfc, make=lambda cfg: tencode.Encoder(
    TCfg(**cfg), device="cpu"))


def _np(tree) -> dict[str, np.ndarray]:
    """Every field as numpy, u32 words as their int32 view."""
    out = {}
    for f in dataclasses.fields(tree):
        a = getattr(tree, f.name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out[f.name] = a.view(np.int32) if a.dtype == np.uint32 else a
    return out


def _drive(pkg, seed: int, cfg_kw=KW) -> list:
    """One encoder run; returns everything it produced, as numpy."""
    fc = pkg.fc
    cluster, lat, bw = fc.build_fake_cluster(fc.ClusterSpec(
        num_nodes=NODES, seed=seed))
    enc = pkg.make(cfg_kw)
    for node in cluster.list_nodes():
        enc.upsert_node(node)
    enc.set_network(lat, bw)
    fc.feed_metrics(cluster, enc, np.random.default_rng(seed + 1))
    out = [("snapshot 0", _np(enc.snapshot()))]
    pods = fc.generate_workload(fc.WorkloadSpec(
        num_pods=60, seed=seed + 2, services=6, soft_zone_fraction=0.2,
        soft_spread_fraction=0.2, spread_fraction=0.3,
        zone_aff_fraction=0.1, zone_anti_fraction=0.1, ns_fraction=0.3))
    placed: dict[str, str] = {}

    def node_of(name: str) -> str:
        return placed.get(name, "")

    rng = np.random.default_rng(seed + 3)
    for b in range(2):
        chunk = pods[16 * b:16 * (b + 1)]
        out.append((f"batch {b}", _np(enc.encode_pods(chunk, node_of,
                                                      lenient=True))))
        idx = rng.integers(0, NODES, len(chunk))
        enc.commit_many(chunk, [int(i) for i in idx])
        placed.update({p.name: enc.node_name(int(i))
                       for p, i in zip(chunk, idx)})
        out.append((f"snapshot after commit {b}", _np(enc.snapshot())))
    # Churn: metrics rows, link pairs, releases, a removal, a readiness
    # flip and a new node in the freed slot.
    names = enc.known_node_names()
    for i in rng.choice(len(names), 3, replace=False):
        enc.update_metrics(names[int(i)], fc.sample_metrics(rng))
    for _ in range(4):
        a, b = rng.choice(len(names), 2, replace=False)
        enc.update_link(names[int(a)], names[int(b)],
                        lat_ms=float(rng.uniform(0.1, 3.0)),
                        bw_bps=float(rng.uniform(1e8, 2e10)))
    for p in pods[:4]:
        enc.release(p)
    enc.remove_node(names[7])
    enc.mark_unready(names[3])
    enc.upsert_node(dataclasses.replace(cluster.list_nodes()[7],
                                        name="node-new"))
    out.append(("snapshot after churn", _np(enc.snapshot())))
    out.append(("expected arrays", {
        k: (v.view(np.int32) if v.dtype == np.uint32 else v)
        for k, v in enc.expected_device_arrays().items()}))
    out.append(("stream", _np(enc.encode_stream(pods[32:], node_of,
                                                lenient=True))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_matches_jax(seed):
    got, want = _drive(TORCH, seed), _drive(JAX, seed)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (ctx, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w), ctx
        for name in w:
            assert g[name].dtype == w[name].dtype, (ctx, name)
            np.testing.assert_array_equal(g[name], w[name],
                                          err_msg=f"{ctx}: {name}")


def _fill(enc, seed: int) -> list[str]:
    cluster, lat, bw = tfc.build_fake_cluster(tfc.ClusterSpec(
        num_nodes=24, seed=seed))
    for node in cluster.list_nodes():
        enc.upsert_node(node)
    enc.set_network(lat, bw)
    tfc.feed_metrics(cluster, enc, np.random.default_rng(seed))
    return enc.known_node_names()


def _churn(enc, names, rng) -> None:
    k = int(rng.integers(0, 4))
    if k == 0:
        for _ in range(int(rng.integers(1, 4))):
            a, b = rng.choice(len(names), 2, replace=False)
            enc.update_link(names[int(a)], names[int(b)],
                            lat_ms=float(rng.uniform(0.05, 3.0)),
                            bw_bps=float(rng.uniform(1e7, 1e10)))
    elif k == 1:
        enc.update_metrics(names[int(rng.integers(len(names)))],
                           tfc.sample_metrics(rng))
    elif k == 2:
        name = names[int(rng.integers(len(names)))]
        (enc.mark_unready if rng.random() < 0.5 else enc.mark_ready)(name)
    else:
        pods = tfc.generate_workload(tfc.WorkloadSpec(
            num_pods=3, seed=int(rng.integers(1 << 30))))
        enc.commit_many(pods, [int(i) for i in
                               rng.integers(0, len(names), 3)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_snapshot_bit_identical_to_full(seed):
    """Dirty-row and dirty-pair patches give the same planes as an
    encoder that uploads every dirty group whole."""
    cfg_d = TCfg(max_nodes=32, max_pods=8, max_peers=2,
                 enable_delta_state=True)
    cfg_f = dataclasses.replace(cfg_d, enable_delta_state=False)
    enc_d = tencode.Encoder(cfg_d, device="cpu")
    enc_f = tencode.Encoder(cfg_f, device="cpu")
    names = _fill(enc_d, seed)
    _fill(enc_f, seed)
    rng_d, rng_f = (np.random.default_rng(seed + 50) for _ in range(2))
    for step in range(16):
        a, b = _np(enc_d.snapshot()), _np(enc_f.snapshot())
        for name in a:
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"step {step}: {name}")
        _churn(enc_d, names, rng_d)
        _churn(enc_f, names, rng_f)
    assert enc_d.snapshot_delta_bytes_total > 0, "delta path never ran"
    assert enc_f.snapshot_delta_bytes_total == 0


def test_snapshot_never_aliases_staging():
    """Writes to staging after a snapshot must not move that snapshot,
    through a full upload or a delta patch."""
    enc = tencode.Encoder(TCfg(max_nodes=32, max_pods=8, max_peers=2),
                          device="cpu")
    names = _fill(enc, 5)
    first = enc.snapshot()
    kept = {k: v.clone() for k, v in vars(first).items()}
    # In-place staging writes of every kind, then a delta snapshot.
    enc.update_link(names[0], names[1], lat_ms=9.0, bw_bps=1.0)
    enc.update_metrics(names[2], {"cpu_freq": 1.0})
    enc.mark_unready(names[3])
    enc._lat[5, 6] = 123.0
    enc._used[4] += 1.0
    second = enc.snapshot()
    for name, before in kept.items():
        # Bitwise (node_numeric holds NaN, which == never matches).
        np.testing.assert_array_equal(
            _np(first)[name].view(np.uint8),
            before.numpy().view(np.uint8), err_msg=name)
    assert float(second.lat[0, 1]) == 9.0
    assert float(first.lat[0, 1]) != 9.0
    # Nor do the tensors of a full upload share memory with staging.
    full = tencode.Encoder(TCfg(max_nodes=32, max_pods=8, max_peers=2),
                           device="cpu")
    _fill(full, 5)
    snap = full.snapshot()
    full._bw[:] = -1.0
    assert not bool((snap.bw == -1.0).any())


def test_stream_waves_round_trip():
    enc = tencode.Encoder(TCfg(max_nodes=32, max_pods=8, max_peers=2),
                          device="cpu")
    _fill(enc, 6)
    pods = tfc.generate_workload(tfc.WorkloadSpec(num_pods=24, seed=6))
    stream = enc.encode_stream(pods, lambda n: "")
    waves = split_stream_waves(stream, 8)
    assert len(waves) == 3
    back = concat_stream_waves(waves)
    for name, arr in _np(stream).items():
        np.testing.assert_array_equal(_np(back)[name], arr)
    ring = DeviceWaveRing(2, device="cpu")
    assert ring.push(waves[0]) and ring.push(waves[1])
    assert not ring.push(waves[2]) and ring.overflow_total == 1
    window = ring.pop_window()
    assert window.num_pods == 16 and len(ring) == 0
    assert ring.pop_window() is None


def test_netmodel_blend_raises():
    """An attached, enabled topology model blends the net group (the
    snapshot equals ``expected_device_arrays()``); an attached object
    that is no model raises at the next snapshot instead of being
    skipped."""
    from kubernetesnetawarescheduler_tpu_torch.k8s import types as ttypes
    from kubernetesnetawarescheduler_tpu_torch.netmodel import (
        TopologyModel,
    )

    cfg = TCfg(max_nodes=8, max_pods=4, max_peers=2, enable_netmodel=True)
    enc = tencode.Encoder(cfg, device="cpu")
    for i in range(4):
        enc.upsert_node(ttypes.Node(name=f"n{i}", capacity={"cpu": 4.0}))
    model = TopologyModel(cfg, device="cpu")
    for k in range(12):
        model.observe(k % 2, 2 + k % 2, 0.5, 1e10, float(k))
    model.fit(3)
    enc.attach_netmodel(model)
    enc.update_link("n0", "n2", lat_ms=0.5, bw_bps=1e10)
    snap = enc.snapshot()
    want = enc.expected_device_arrays()
    np.testing.assert_array_equal(snap.bw.numpy(), want["bw"])
    assert want["bw"][0, 3] > 0.0 == enc._bw[0, 3]
    enc.attach_netmodel(object())
    with pytest.raises(AttributeError):
        enc.snapshot()
