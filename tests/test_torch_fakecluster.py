"""The port's ``bench/fakecluster.py`` against the JAX package's, on the
CPU: the same spec and seed give the same nodes, the same ``lat``/``bw``
matrices, the same metric samples and the same pods, bit for bit."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.bench import fakecluster as jfc
from kubernetesnetawarescheduler_tpu_torch.bench import fakecluster as tfc

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

CLASSES = dict(node_classes=(
    dict(name="gpu", fraction=0.25, cpu_range=(32.0, 96.0), lat_scale=0.5,
         bw_scale=4.0),
    dict(name="edge", fraction=0.75, netbw_range=(1.0, 5.0), lat_scale=3.0,
         bw_scale=0.25)))


def _spec(fc, num_nodes, seed, classes):
    kw = {}
    if classes:
        kw["node_classes"] = tuple(fc.NodeClassSpec(**c)
                                   for c in CLASSES["node_classes"])
    return fc.ClusterSpec(num_nodes=num_nodes, seed=seed, **kw)


def _objects(objs) -> list[dict]:
    out = []
    for o in objs:
        d = dataclasses.asdict(o)
        d.pop("uid", None)  # a process-wide counter in both packages
        out.append(d)
    return out


@pytest.mark.parametrize("classes", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_cluster_equal_jax(seed, classes):
    tc, tlat, tbw = tfc.build_fake_cluster(_spec(tfc, 37, seed, classes))
    jc, jlat, jbw = jfc.build_fake_cluster(_spec(jfc, 37, seed, classes))
    assert tlat.dtype == jlat.dtype and tbw.dtype == jbw.dtype
    np.testing.assert_array_equal(tlat, jlat)
    np.testing.assert_array_equal(tbw, jbw)
    assert _objects(tc.list_nodes()) == _objects(jc.list_nodes())


def test_metric_feed_equal_jax():
    """``feed_metrics`` draws the same samples for the same nodes."""

    class Recorder:
        def __init__(self):
            self.calls = []

        def update_metrics(self, name, values, age_s=0.0):
            self.calls.append((name, dict(values), age_s))

    got, want = Recorder(), Recorder()
    tc, _, _ = tfc.build_fake_cluster(tfc.ClusterSpec(num_nodes=20, seed=2))
    jc, _, _ = jfc.build_fake_cluster(jfc.ClusterSpec(num_nodes=20, seed=2))
    tfc.feed_metrics(tc, got, np.random.default_rng(9), drop_fraction=0.3)
    jfc.feed_metrics(jc, want, np.random.default_rng(9), drop_fraction=0.3)
    assert got.calls == want.calls
    assert 0 < len(got.calls) < 20


@pytest.mark.parametrize("spec", [
    dict(num_pods=80, seed=4, ns_fraction=0.5, spread_fraction=0.5),
    dict(num_pods=120, seed=5, services=8, peer_fraction=0.5,
         affinity_fraction=0.1, anti_fraction=0.1),
    dict(num_pods=60, seed=6, soft_zone_fraction=0.3,
         soft_spread_fraction=0.3, zone_aff_fraction=0.2,
         zone_anti_fraction=0.2),
])
def test_workload_equal_jax(spec):
    tp = tfc.generate_workload(tfc.WorkloadSpec(**spec))
    jp = jfc.generate_workload(jfc.WorkloadSpec(**spec))
    assert len(tp) == len(jp) == spec["num_pods"]
    assert _objects(tp) == _objects(jp)
