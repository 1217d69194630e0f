"""The generator: the same seed gives the same inputs."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import generate
from benchmark.tests.conftest import HERE, tiny_config


def _traffic(mix: str) -> dict:
    with open(HERE / "traffic" / f"{mix}.json", encoding="utf-8") as fh:
        return json.load(fh)


def test_cluster_is_deterministic_for_a_seed():
    spec = tiny_config()["cluster"]
    a = generate.make_cluster(spec, 2**33 + 5, "cpu")
    b = generate.make_cluster(spec, 2**33 + 5, "cpu")
    c = generate.make_cluster(spec, 2**33 + 6, "cpu")
    for f in ("cap", "tainted", "metrics", "lat", "bw"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.lat, c.lat)
    np.testing.assert_array_equal(a.lat, a.lat.T)
    assert (np.diag(a.lat) == 0).all()


@pytest.mark.parametrize("mix", ("saturation", "latency-pods"))
def test_pods_are_deterministic_for_a_seed(mix):
    traffic = _traffic(mix)
    traffic["pods"] = 4000
    a = generate.make_pods(traffic, 64, 99, 4000)
    b = generate.make_pods(traffic, 64, 99, 4000)
    c = generate.make_pods(traffic, 64, 100, 4000)
    for f in ("req", "priority", "tolerates", "peers", "volume",
              "bound_node"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.peers, c.peers)


def test_every_seed_gets_the_same_sizes_in_its_own_order():
    spec = tiny_config()["cluster"]
    a = generate.make_cluster(spec, 11, "cpu")
    b = generate.make_cluster(spec, 12, "cpu")
    assert not np.array_equal(a.cap, b.cap)
    for f in ("cap", "metrics"):
        np.testing.assert_array_equal(np.sort(getattr(a, f), axis=0),
                                      np.sort(getattr(b, f), axis=0))
    assert a.tainted.sum() == b.tainted.sum()
    traffic = _traffic("saturation")
    p = generate.make_pods(traffic, 64, 11, 3000)
    q = generate.make_pods(traffic, 64, 12, 3000)
    assert not np.array_equal(p.req, q.req)
    np.testing.assert_array_equal(np.sort(p.req, axis=0),
                                  np.sort(q.req, axis=0))
    np.testing.assert_array_equal(np.sort(p.priority), np.sort(q.priority))


def test_peers_are_bound_before_their_pod_is_scored():
    sat = _traffic("saturation")
    pods = generate.make_pods(sat, 64, 1, 20000)
    rows = np.arange(pods.s)[:, None]
    live = pods.peers >= 0
    assert live.any()
    assert (pods.peers[live] <= (rows - sat["peer_lag"])
            .repeat(live.shape[1], 1)[live]).all()
    assert (live.sum(1) <= sat["max_peers"]).all()
    lat = _traffic("latency-pods")
    pods = generate.make_pods(lat, 64, 1, 500)
    b = pods.first_arrival
    assert b == lat["bound_per_node"] * 64
    assert (np.bincount(pods.bound_node[:b], minlength=64)
            == lat["bound_per_node"]).all()
    assert (pods.peers[b:][pods.peers[b:] >= 0] < b).all()


def test_arrivals_per_run():
    assert generate.arrivals_of(_traffic("saturation"), 30) == 150000
    lat = dict(_traffic("latency-pods"), warm_pods=16, warm_s=2.0,
               rate_per_s=100.0)
    assert generate.arrivals_of(lat, 30) == 16 + 3200
