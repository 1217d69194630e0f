"""The port's ingest modules against the JAX package's, on the CPU.

The same node_exporter bodies and iperf3 documents parse to the same
values in both packages; the same seeded fake cluster probed through
``FakeProber`` → ``ProbeOrchestrator.run_cycle`` leaves identical ``lat``
and ``bw`` planes in both encoders; the scrape pool feeds both encoders
alike and stops on its event.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core.encode import Encoder as JEnc
from kubernetesnetawarescheduler_tpu.ingest import iperf as jiperf
from kubernetesnetawarescheduler_tpu.ingest import native as jnative
from kubernetesnetawarescheduler_tpu.ingest import probe as jprobe
from kubernetesnetawarescheduler_tpu.ingest import prometheus as jprom
from kubernetesnetawarescheduler_tpu.ingest import scraper as jscraper
from kubernetesnetawarescheduler_tpu.k8s.types import Node as JNode
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig as TCfg
from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder as TEnc
from kubernetesnetawarescheduler_tpu_torch.ingest import iperf as tiperf
from kubernetesnetawarescheduler_tpu_torch.ingest import native as tnative
from kubernetesnetawarescheduler_tpu_torch.ingest import probe as tprobe
from kubernetesnetawarescheduler_tpu_torch.ingest import prometheus as tprom
from kubernetesnetawarescheduler_tpu_torch.ingest import scraper as tscraper
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node as TNode
from tests.test_ingest import synth_scrape

torch.set_num_threads(1)


def _bodies() -> list[str]:
    rng = np.random.default_rng(3)
    out = [synth_scrape(), synth_scrape(n_cpus=3),
           "garbage line {{{\nnode_ok 1.5\nbad{unclosed 3\n",
           'node_disk_io_now{device="nvme0n1"} +Inf\n# HELP x "a\\\\nb"\n']
    for _ in range(4):
        out.append(synth_scrape(
            n_cpus=int(rng.integers(1, 16)),
            freqs=None, mem_total=float(rng.uniform(4e9, 64e9)),
            mem_avail=float(rng.uniform(1e8, 4e9)),
            nics=(("eth0", int(rng.integers(0, 10**6)),
                   int(rng.integers(0, 10**6))), ("cni0", 5, 6)),
            disks=(("sda", int(rng.integers(0, 40))), ("sda1", 2))))
    return out


@pytest.mark.parametrize("i", range(8))
def test_prometheus_parse_and_extract_match_jax(i):
    body = _bodies()[i]
    assert tprom.parse_prometheus_text(body) == \
        jprom.parse_prometheus_text(body)
    assert tprom.NodeExporterExtractor().extract(body) == \
        jprom.NodeExporterExtractor().extract(body)
    # The native parser when built (ctypes), else the Python fallback:
    # the same choice and the same values as the JAX package's binding.
    got, want = tnative.make_extractor(), jnative.make_extractor()
    assert type(got).__name__ == type(want).__name__
    assert got.extract(body) == want.extract(body)


@pytest.mark.parametrize("bps", [5.5e9, 1.0, 3.2e10])
def test_iperf_parse_matches_jax(bps):
    doc = jiperf.synth_iperf_json(bps, title="probe a->b")
    assert tiperf.synth_iperf_json(bps, title="probe a->b") == doc
    got, want = tiperf.parse_iperf_json(doc), jiperf.parse_iperf_json(doc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad in ("{}", "not json at all"):
        with pytest.raises(Exception) as t_err:
            tiperf.parse_iperf_json(bad)
        with pytest.raises(Exception) as j_err:
            jiperf.parse_iperf_json(bad)
        assert type(t_err.value) is type(j_err.value)


def _encoders(names):
    kw = dict(max_nodes=16, max_pods=4, max_peers=2)
    jenc, tenc = JEnc(JCfg(**kw)), TEnc(TCfg(**kw), device="cpu")
    for name in names:
        jenc.upsert_node(JNode(name=name, capacity={"cpu": 4.0}))
        tenc.upsert_node(TNode(name=name, capacity={"cpu": 4.0}))
    return jenc, tenc


@pytest.mark.parametrize("budget,fail", [(100, 0.0), (7, 0.0), (40, 0.3)])
def test_probe_cycles_leave_identical_planes(budget, fail):
    names = [f"n{i}" for i in range(12)]
    rng = np.random.default_rng(11)
    lat = rng.uniform(0.1, 3.0, (12, 12)).astype(np.float32)
    lat = (lat + lat.T) / 2
    bw = rng.uniform(1e9, 2.5e10, (12, 12)).astype(np.float32)
    bw = (bw + bw.T) / 2
    jenc, tenc = _encoders(names)
    orchs = []
    for mod, enc in ((jprobe, jenc), (tprobe, tenc)):
        prober = mod.FakeProber(names, lat, bw, seed=5, fail_fraction=fail)
        orch = mod.ProbeOrchestrator(enc, prober, names, forget_s=90.0)
        orchs.append(orch)
        for _ in range(3):
            orch.run_cycle(budget=budget)
            orch.advance_clock(60.0)
    js, ts = jenc.snapshot(), tenc.snapshot()
    np.testing.assert_array_equal(ts.lat.numpy(), np.asarray(js.lat))
    np.testing.assert_array_equal(ts.bw.numpy(), np.asarray(js.bw))
    jo, to = orchs
    assert (to.successes, to.failures, to.pruned_total) == \
        (jo.successes, jo.failures, jo.pruned_total)
    assert to.staleness() == jo.staleness()
    assert to.quarantined == jo.quarantined


def test_scrape_pool_feeds_both_encoders_alike_and_stops():
    names = ["a", "b", "c", "d"]
    bodies = {"http://a": synth_scrape(), "http://b": synth_scrape(n_cpus=4),
              "http://c": "garbage", "http://d": None}

    def fetch(url):
        if bodies[url] is None:
            raise OSError("down")
        return bodies[url]

    targets = {n: f"http://{n}" for n in names}
    jenc, tenc = _encoders(names)
    jpool = jscraper.ScrapePool(jenc, targets, fetch=fetch,
                                extractor=jprom.NodeExporterExtractor())
    tpool = tscraper.ScrapePool(tenc, targets, fetch=fetch,
                                extractor=tprom.NodeExporterExtractor())
    assert tpool.scrape_all(now_s=0.0) == jpool.scrape_all(now_s=0.0)
    assert tpool.scrape_all(now_s=400.0) == jpool.scrape_all(now_s=400.0)
    js, ts = jenc.snapshot(), tenc.snapshot()
    np.testing.assert_array_equal(ts.metrics.numpy(), np.asarray(js.metrics))
    np.testing.assert_array_equal(ts.node_valid.numpy(),
                                  np.asarray(js.node_valid))
    assert (tpool.failures, tpool.successes) == (jpool.failures,
                                                 jpool.successes)
    stop = threading.Event()
    th = threading.Thread(target=tpool.run_forever, args=(60.0, stop))
    th.start()
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
