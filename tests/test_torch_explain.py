"""The port's score decomposition for placement explain against the JAX
package's, on the CPU: ``explain_scores`` on
``tests/gen.py::random_instance`` seeds at f32 gives identical gates and
every term within rtol=atol=1e-4, reproduces ``score_pods`` where
feasible, and gives the same arrays with the kernel backend's pack as
``static`` as with the dense pair.  ``serve.py`` runs with
``{"enable_explain": true}``.  The loop's capture is held against the
JAX loop in ``tests/test_torch_explain_loop.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import score as jscore
from kubernetesnetawarescheduler_tpu_torch import serve
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import score as tscore
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate
from kubernetesnetawarescheduler_tpu_torch.core import tiled_score

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

GATES = ("ok", "static_ok", "fits", "affinity", "anti", "sym_anti",
         "zone_ok", "spread_ok")
TERMS = ("base", "net", "soft", "balance", "spread", "total")

# -- explain_scores -------------------------------------------------------

# K=6 takes the peer-gather form of the network term, K=12 the product.
GATHER = dict(max_nodes=160, max_pods=24, max_peers=6, use_bfloat16=False)
DENSE = dict(GATHER, max_peers=12)


def _instance(seed, kw):
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=150,
                                            n_pods=20)
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    ts = tstate.state_from_numpy(tcfg, state_np, "cpu")
    tp = tstate.pods_from_numpy(tcfg, pods_np, "cpu")
    return jcfg, tcfg, js, jp, ts, tp


@pytest.mark.parametrize("kw", [GATHER, DENSE], ids=["gather", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_explain_scores_match_jax(seed, kw):
    jcfg, tcfg, js, jp, ts, tp = _instance(seed, kw)
    want = jscore.explain_scores(js, jp, jcfg)
    got = tscore.explain_scores(ts, tp, tcfg)
    assert set(got) == set(want)
    for key in GATES:
        assert got[key].dtype == np.bool_ and got[key].shape == (24, 160)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ok = want["ok"]
    assert ok.any()
    for key in TERMS:
        assert got[key].dtype == np.float32 and got[key].shape == (24, 160)
        g, w = (got[key], want[key]) if key != "total" else (
            got[key][ok], want[key][ok])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got["total"][~ok], want["total"][~ok])
    # The decomposition reproduces score_pods where feasible.
    recon = (got["base"] + got["net"] + got["soft"] - got["balance"]
             - got["spread"])
    np.testing.assert_allclose(recon[ok], tscore.score_pods(
        ts, tp, tcfg).numpy()[ok], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_explain_with_kernel_pack_equals_dense_pair(seed):
    _j, tcfg, _js, _jp, ts, tp = _instance(seed, GATHER)
    pcfg = TCfg(**GATHER, score_backend="pallas")
    pack = tiled_score.compute_assign_static(ts, pcfg)
    assert not isinstance(pack, tuple)
    dense = tscore.explain_scores(ts, tp, tcfg,
                                  tscore.static_node_scores(ts, tcfg))
    for static in (pack, None):
        got = tscore.explain_scores(ts, tp, pcfg, static)
        for key, val in dense.items():
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_serve_runs_with_explain_on(tmp_path, capsys):
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps({"enable_explain": True}))
    argv = ["--cluster", "fake:16", "--uds", str(tmp_path / "scorer.sock"),
            "--device", "cpu", "--config", str(cfgp), "--once"]
    assert serve.main(argv) == 0
    assert "ROADMAP" not in capsys.readouterr().err
