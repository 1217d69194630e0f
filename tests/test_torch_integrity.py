"""The port's state digests against the JAX package's, on the CPU: the
per-plane digest vector and the row digests are bit-identical (the
port's int32 bits viewed as uint32), the numpy mirror agrees, any single
flipped bit moves the digest, and every ``ClusterState`` plane is
registered."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import integrity as jint
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import integrity as tint
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=48, max_pods=8, max_peers=2)


def _states(seed: int, mask_words: int = 1):
    kw = dict(KW, mask_words=mask_words)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, JCfg(**kw), n_nodes=40)
    # NaN where a numeric label is absent, as the encoder leaves it.
    numeric = np.full((kw["max_nodes"], JCfg(**kw).max_numeric_labels),
                      np.nan, np.float32)
    numeric[:20, 0] = rng.uniform(0, 100, 20)
    state_np["node_numeric"] = numeric
    js, _ = gen.to_pytrees(JCfg(**kw), state_np, pods_np)
    return js, tstate.state_from_numpy(TCfg(**kw), state_np, "cpu")


@pytest.mark.parametrize("seed,mask_words", [(0, 1), (1, 1), (2, 2)])
def test_plane_digest_vector_matches_jax(seed, mask_words):
    js, ts = _states(seed, mask_words)
    want = np.asarray(jint.plane_digest_vector(js))
    got = tint.plane_digest_vector(ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        tint.host_plane_digest_vector(ts.numpy()), want)
    rows_j = jint.device_row_digests(js)
    rows_t = tint.device_row_digests(ts)
    for name in tint.PLANE_NAMES:
        np.testing.assert_array_equal(
            rows_t[name].numpy().view(np.uint32), np.asarray(rows_j[name]),
            err_msg=name)


@pytest.mark.parametrize("name", ["metrics", "lat", "used", "node_valid",
                                  "label_bits", "node_zone", "gz_counts",
                                  "node_numeric"])
def test_single_bit_flip_moves_the_digest(name):
    _, ts = _states(3)
    base = tint.plane_digest_vector(ts)
    plane = getattr(ts, name)
    rng = np.random.default_rng(4)
    for _ in range(4):
        flat = plane.clone().reshape(-1)
        i = int(rng.integers(flat.numel()))
        if flat.dtype == torch.bool:
            flat[i] = ~flat[i]
        else:
            bits = flat.view(torch.int32)
            bits[i] ^= 1 << int(rng.integers(31))
        moved = tint.plane_digest_vector(
            ts.replace(**{name: flat.reshape(plane.shape)}))
        k = tint.PLANE_NAMES.index(name)
        assert int(moved[k]) != int(base[k])
        others = [j for j in range(len(tint.PLANE_NAMES)) if j != k]
        assert torch.equal(moved[others], base[others])


def test_every_state_plane_is_registered():
    fields = {f.name for f in dataclasses.fields(tstate.ClusterState)}
    assert set(tint.PLANE_NAMES) == fields
    assert tint.PLANES == jint.PLANES
    assert set(tint.GROUP_OF.values()) == {"metrics", "net", "alloc",
                                           "topo"}
