"""The port's explain capture in ``SchedulerLoop`` against the JAX loop's,
on the CPU.

- Loop drives with ``enable_explain`` over the five capture seams
  (serial, burst, pipelined, multicycle K=2, gang): the port's records
  under both score backends equal the JAX loop's records under its
  dense backend field by field (floats at rtol=atol=1e-4, ``t_wall``
  and the process-wide pod uid aside).  The JAX loop records nothing
  under ``score_backend="pallas"``: its explain unpacks the kernel pack
  as the dense pair and drops the error, a reference fault the port
  does not copy.  Bindings are the same with explain on and off, and
  ``explains_failed`` stays 0.
- A capture whose host-side record build or re-encode fails is counted
  in ``explains_failed`` (flight recorder summary and ``/debug/trace``
  meta) and the cycle goes on; a device-side error propagates.
- ``/explain/<uid>`` answers the record through both packages'
  ``ExtenderHandlers``.

One JAX config (``max_nodes=32``, ``max_pods=16``, f32, explain on) for
every drive, with ``burst_batches=2`` and K=2 so the burst, pipelined
and multicycle drives share one replay shape; the JAX loops are drained
once and kept for the endpoint test.
"""

from __future__ import annotations

import json
import math
import types

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.api import extender as jext
from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import loop as jloop
from kubernetesnetawarescheduler_tpu_torch.api import extender as text
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import loop as tloop
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

_LOOPS: list = []


@pytest.fixture(autouse=True)
def _stop_loops():
    yield
    while _LOOPS:
        _LOOPS.pop().stop_bind_worker()


JAX = types.SimpleNamespace(fc=jfc, cfg=JCfg, loop=jloop.SchedulerLoop,
                            ext=jext, kw={})
TORCH = types.SimpleNamespace(fc=tfc, cfg=TCfg, loop=tloop.SchedulerLoop,
                              ext=text, kw={"device": "cpu"})

LOOP_CFG = dict(max_nodes=32, max_pods=16, max_peers=4, queue_capacity=4096,
                use_bfloat16=False, enable_explain=True)
WL = dict(num_pods=32, seed=7, services=8, peer_fraction=0.5,
          affinity_fraction=0.1, anti_fraction=0.1)
DRIVES = {
    "serial": dict(burst_batches=1),
    "burst": dict(burst_batches=2),
    "pipelined": dict(burst_batches=2, pipelined=True),
    "multicycle": dict(burst_batches=2, multicycle=2),
    "gang": dict(burst_batches=1),
}


def _drain(pkg, drive: str, keep: bool = False, **cfg_over):
    cfg = pkg.cfg(**{**LOOP_CFG, **cfg_over})
    cluster, lat, bw = pkg.fc.build_fake_cluster(
        pkg.fc.ClusterSpec(num_nodes=24, seed=3))
    loop = pkg.loop(cluster, cfg, method="parallel", **DRIVES[drive],
                    **pkg.kw)
    if not keep:
        _LOOPS.append(loop)
    loop.encoder.set_network(lat, bw)
    pkg.fc.feed_metrics(cluster, loop.encoder, np.random.default_rng(4))
    if drive == "gang":
        pods = pkg.fc.generate_gang_workload(
            num_gangs=2, member_counts=(4, 6), filler_pods=8, seed=5,
            cpu=2.0, mem=4.0, scheduler_name=cfg.scheduler_name)
    else:
        pods = pkg.fc.generate_workload(pkg.fc.WorkloadSpec(**WL),
                                        scheduler_name=cfg.scheduler_name)
    cluster.add_pods(pods)
    loop.run_until_drained()
    loop.flush_binds()
    return loop, cluster, pods


def _bindings(cluster) -> dict:
    return {b.pod_name: b.node_name for b in cluster.bindings}


def _same(got, want, path="") -> list[str]:
    """Differences between two records: floats at rtol=atol=1e-4,
    everything else exactly."""
    if isinstance(want, float) and isinstance(got, float):
        return ([] if math.isclose(got, want, rel_tol=1e-4, abs_tol=1e-4)
                else [f"{path}: {got} != {want}"])
    if isinstance(want, dict) and isinstance(got, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(set(got) ^ set(want))}"]
        return [d for k in want for d in _same(got[k], want[k],
                                                 f"{path}.{k}")]
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return [f"{path}: {len(got)} != {len(want)} items"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _same(g, w, f"{path}[{i}]")]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def _records(loop) -> dict:
    """Records keyed by ``namespace/name``: pod uids come from a
    process-wide counter, so they differ between the two packages'
    drives."""
    out = {}
    for rec in loop.flight.explains():
        rec = dict(rec)
        rec.pop("t_wall")
        rec.pop("pod_uid")
        out[rec["pod"]] = rec
    return out


@pytest.fixture(scope="module")
def jax_drives():
    """Each drive through the JAX loop once: ``(bindings, records, loop,
    pods)``; the loops stop at the module's end."""
    out = {}
    try:
        for drive in DRIVES:
            loop, cluster, pods = _drain(JAX, drive, keep=True)
            out[drive] = (_bindings(cluster), _records(loop), loop, pods)
        yield out
    finally:
        for entry in out.values():
            entry[2].stop_bind_worker()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("drive", list(DRIVES))
def test_loop_records_match_jax(jax_drives, drive, backend):
    want_bind, want, _jl, _jp = jax_drives[drive]
    loop, cluster, pods = _drain(TORCH, drive, score_backend=backend)
    assert _bindings(cluster) == want_bind
    got = _records(loop)
    assert want and set(got) == set(want)
    diffs = [d for pod in want for d in _same(got[pod], want[pod], pod)]
    assert not diffs, diffs[:10]
    assert {r["path"] for r in got.values()} >= (
        {"serial", "gang"} if drive == "gang" else {drive})
    assert loop.flight.explains_failed == 0
    bound = _bindings(cluster)
    for pod in pods:
        rec = got.get(f"{pod.namespace}/{pod.name}")
        if pod.name in bound:
            assert rec["decision"] == "bound"
            assert rec["node"] == bound[pod.name]
            winner = [c for c in rec["candidates"]
                      if c["node_index"] == rec["node_index"]]
            comp = winner[0]["components"] if winner else None
            if comp is not None:
                recon = sum(comp.values())
                assert abs(recon - rec["score"]) <= 1e-3 + 1e-4 * abs(recon)


@pytest.mark.parametrize("drive", list(DRIVES))
def test_bindings_same_with_explain_on_and_off(drive):
    _l, on, _p = _drain(TORCH, drive)
    _l, off, _p = _drain(TORCH, drive, enable_explain=False)
    assert _bindings(on) == _bindings(off) and _bindings(on)


def test_record_build_failure_is_counted_and_serving_goes_on(monkeypatch):
    def broken(*args, **kwargs):
        raise KeyError("record build")

    monkeypatch.setattr(tloop.SchedulerLoop, "_explain_records", broken)
    loop, cluster, _ = _drain(TORCH, "serial")
    cycles = len([s for s in loop.flight.spans() if s.path == "serial"])
    assert loop.flight.explains_failed == cycles > 0
    assert loop.flight.explains_len() == 0
    trace = loop.flight.to_chrome_trace()
    assert trace["recorder"]["explains_failed"] == cycles
    assert trace["metadata"]["explains_failed"] == cycles
    _l, off, _p = _drain(TORCH, "serial", enable_explain=False)
    assert _bindings(cluster) == _bindings(off)


def test_encode_failure_in_burst_capture_is_counted(monkeypatch):
    loop, cluster, _ = _drain(TORCH, "burst")
    assert loop.flight.explains_failed == 0

    def broken(*args, **kwargs):
        raise ValueError("encode")

    monkeypatch.setattr(loop.encoder, "encode_pods", broken)
    pods = list(tfc.generate_workload(tfc.WorkloadSpec(num_pods=40, seed=9),
                                      scheduler_name=loop.cfg.scheduler_name))
    loop._capture_explains_burst(pods, np.zeros(40, np.int32),
                                 loop.encoder.snapshot(), None,
                                 loop.encoder.node_table(), 1, "burst")
    assert loop.flight.explains_failed == 3  # chunks of 16, 16 and 8


def test_device_side_explain_error_propagates(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tscore, "explain_scores", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        _drain(TORCH, "serial")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_explain_endpoint_answers_the_record(jax_drives, backend):
    _jb, _jr, jl, jpods = jax_drives["serial"]
    tl, tc, pods = _drain(TORCH, "serial", score_backend=backend)
    bound = _bindings(tc)
    jh, th = jext.ExtenderHandlers(jl), text.ExtenderHandlers(tl)
    try:
        checked = 0
        for jpod, pod in zip(jpods[:12], pods[:12]):
            assert jpod.name == pod.name
            want = json.loads(jh.handle(f"/explain/{jpod.uid}", b""))
            got = json.loads(th.handle(f"/explain/{pod.uid}", b""))
            assert got["pod_uid"] == pod.uid
            for rec in (want, got):
                rec.pop("t_wall")
                rec.pop("pod_uid")
            assert not _same(got, want)
            if pod.name in bound:
                assert got["node"] == bound[pod.name]
                checked += 1
        assert checked
        for h in (jh, th):
            err = json.loads(h.handle("/explain/not-a-uid", b""))
            assert "error" in err and err["enable_explain"] is True
        trace = json.loads(th.handle("/debug/trace", b""))
        assert trace["recorder"]["explains_failed"] == 0
        assert trace["metadata"]["explains_failed"] == 0
    finally:
        jh.close()
        th.close()
