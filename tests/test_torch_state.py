"""The PyTorch port's state module against the JAX package's.

The same numpy instance (``tests/gen.py::random_instance``) goes through
both packages on the CPU.  Bit planes and counts must be identical; usage
is held at rtol=atol=1e-6 because the port accumulates co-located pods
with a deterministic one-hot product, which may add in another order
than JAX's scatter.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import state as jstate
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=160, max_pods=24, max_peers=6, use_bfloat16=False)
JCFG, TCFG = JCfg(**KW), TCfg(**KW)


def _both(seed, n_nodes=150, n_pods=20):
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, JCFG, n_nodes=n_nodes,
                                            n_pods=n_pods)
    js, jp = gen.to_pytrees(JCFG, state_np, pods_np)
    ts = tstate.state_from_numpy(TCFG, state_np, "cpu")
    tp = tstate.pods_from_numpy(TCFG, pods_np, "cpu")
    return js, jp, ts, tp


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_from_numpy_preserves_every_field():
    js, jp, ts, tp = _both(0)
    for name, arr in ts.numpy().items():
        want = np.asarray(getattr(js, name))
        got = arr.view(np.uint32) if want.dtype == np.uint32 else arr
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name, arr in tp.numpy().items():
        want = np.asarray(getattr(jp, name))
        got = arr.view(np.uint32) if want.dtype == np.uint32 else arr
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_init_shapes_match_jax():
    js = jstate.init_cluster_state(JCFG)
    ts = tstate.init_cluster_state(TCFG, device="cpu")
    for name, arr in ts.numpy().items():
        want = np.asarray(getattr(js, name))
        assert arr.shape == want.shape, name
        np.testing.assert_array_equal(
            arr.view(np.uint32) if want.dtype == np.uint32 else arr, want,
            err_msg=name)
    jp = jstate.init_pod_batch(JCFG)
    tp = tstate.init_pod_batch(TCFG, device="cpu")
    for name, arr in tp.numpy().items():
        want = np.asarray(getattr(jp, name))
        np.testing.assert_array_equal(
            arr.view(np.uint32) if want.dtype == np.uint32 else arr, want,
            err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_planes_roundtrip_matches_jax(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (9, 3), dtype=np.uint64).astype(
        np.uint32)
    words[0, 0] = np.uint32(1 << 31)          # the sign bit of int32
    words[1] = np.uint32(0xFFFFFFFF)
    want = np.asarray(jstate.bit_planes(jnp.asarray(words), jnp.float32))
    planes = tstate.bit_planes(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(planes.numpy(), want)
    back = tstate.planes_to_words(planes > 0.5)
    np.testing.assert_array_equal(_bits(back), words)
    np.testing.assert_array_equal(
        _bits(back), np.asarray(jstate.planes_to_words(jnp.asarray(want)
                                                       > 0.5)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_commit_matches_jax_on_random_assignments(seed):
    js, jp, ts, tp = _both(seed)
    rng = np.random.default_rng(100 + seed)
    # Duplicates on purpose: several pods per node, some unplaced, a few
    # on padding nodes.
    assignment = rng.integers(-1, 40, KW["max_pods"]).astype(np.int32)
    jnew = jstate.commit_assignments(js, jp, jnp.asarray(assignment))
    tnew = tstate.commit_assignments(ts, tp, torch.from_numpy(assignment))
    for name in ("group_bits", "resident_anti", "az_anti"):
        np.testing.assert_array_equal(_bits(getattr(tnew, name)),
                                      np.asarray(getattr(jnew, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tnew.gz_counts.numpy(),
                                  np.asarray(jnew.gz_counts))
    np.testing.assert_allclose(tnew.used.numpy(), np.asarray(jnew.used),
                               rtol=1e-6, atol=1e-6)


def test_scatter_or_onehot_matches_jax():
    rng = np.random.default_rng(5)
    onehot = rng.random((20, 30)) < 0.1
    words = rng.integers(0, 2 ** 32, (20, 2), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jstate.scatter_or_onehot(jnp.asarray(onehot),
                                               jnp.asarray(words)))
    got = tstate.scatter_or_onehot(torch.from_numpy(onehot),
                                   torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(_bits(got), want)


def test_round_up_and_pad_axis():
    assert tstate.round_up(5120, 128) == jstate.round_up(5120, 128) == 5120
    assert tstate.round_up(5121, 128) == 5248
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = np.asarray(jstate.pad_axis(jnp.asarray(x), 4, axis=1, fill=-1.0))
    got = tstate.pad_axis(torch.from_numpy(x), 4, axis=1, fill=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tstate.pad_axis(torch.from_numpy(x), 1, axis=0)
