"""The port's ingest modules against the JAX package's, on the CPU.

The same node_exporter bodies and iperf3 documents parse to the same
values in both packages; the same seeded fake cluster probed through
``FakeProber`` → ``ProbeOrchestrator.run_cycle`` leaves identical ``lat``
and ``bw`` planes in both encoders; the scrape pool feeds both encoders
alike and stops on its event.  The per-node probe agent
(``ingest/probe_agent.py``) serves ``tests/test_ingest.py``'s agent
contract over loopback: ``/probe`` runs the injected iperf3 client and
pinger, bad targets are refused, the token and the fleet allowlist gate
``/probe`` while ``/healthz`` stays open, and the port's
``AgentProber`` measures a↔b from node a's agent and feeds the
orchestrator; every answer is byte-identical to the JAX agent's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core.encode import Encoder as JEnc
from kubernetesnetawarescheduler_tpu.ingest import iperf as jiperf
from kubernetesnetawarescheduler_tpu.ingest import native as jnative
from kubernetesnetawarescheduler_tpu.ingest import probe as jprobe
from kubernetesnetawarescheduler_tpu.ingest import probe_agent as jagent
from kubernetesnetawarescheduler_tpu.ingest import prometheus as jprom
from kubernetesnetawarescheduler_tpu.ingest import scraper as jscraper
from kubernetesnetawarescheduler_tpu.k8s.types import Node as JNode
from kubernetesnetawarescheduler_tpu_torch.config import SchedulerConfig as TCfg
from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder as TEnc
from kubernetesnetawarescheduler_tpu_torch.ingest import iperf as tiperf
from kubernetesnetawarescheduler_tpu_torch.ingest import native as tnative
from kubernetesnetawarescheduler_tpu_torch.ingest import probe as tprobe
from kubernetesnetawarescheduler_tpu_torch.ingest import probe_agent as tagent
from kubernetesnetawarescheduler_tpu_torch.ingest import prometheus as tprom
from kubernetesnetawarescheduler_tpu_torch.ingest import scraper as tscraper
from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node as TNode
from tests.test_ingest import synth_iperf_json, synth_scrape

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


# -- the per-node probe agent --------------------------------------------


def _start_agent(mod, runner, pinger, **kw):
    server = mod.make_server(port=0, host="127.0.0.1", runner=runner,
                             pinger=pinger, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _get(url: str, headers: dict | None = None) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _agent_answers(mod, **kw) -> tuple[list, list]:
    calls = []

    def runner(target, duration, port):
        calls.append((target, duration, port))
        return synth_iperf_json(2.5e9).encode()

    server, port = _start_agent(mod, runner, lambda t, p: 0.8, **kw)
    base = f"http://127.0.0.1:{port}"
    tok = {"X-Netaware-Token": "s3cret"}
    try:
        out = [_get(f"{base}/probe?target=10.0.0.7&duration=3&port=5201",
                    tok),
               _get(f"{base}/healthz"),
               _get(f"{base}/probe?target=bad%20host", tok),
               _get(f"{base}/probe?target=10.0.0.7"),
               _get(f"{base}/probe?target=10.9.9.9", tok),
               _get(f"{base}/probe?target=10.0.0.7&duration=x", tok),
               _get(f"{base}/probe?target=10.0.0.7&duration=99", tok),
               _get(f"{base}/nope")]
    finally:
        server.shutdown()
        server.server_close()
    return out, calls


@pytest.mark.parametrize("gated", [False, True])
def test_probe_agent_http_contract_matches_jax(gated):
    kw = (dict(token="s3cret", allowed_targets=frozenset({"10.0.0.7"}))
          if gated else {})
    got, got_calls = _agent_answers(tagent, **kw)
    want, want_calls = _agent_answers(jagent, **kw)
    assert got == want and got_calls == want_calls
    codes = [c for c, _ in got]
    assert codes == ([200, 200, 400, 403, 403, 400, 200, 404] if gated
                     else [200, 200, 400, 200, 200, 400, 200, 404])
    doc = json.loads(got[0][1])
    assert doc["latency_ms"] == 0.8 and doc["iperf"]["end"]
    # duration is capped at MAX_DURATION_S before iperf3 runs.
    assert got_calls[-1][1] == tagent.MAX_DURATION_S


def test_agent_prober_measures_from_node_a():
    seen = []

    def runner(target, duration, port):
        seen.append(target)
        return synth_iperf_json(9e9).encode()

    server, port = _start_agent(tagent, runner, lambda t, p: 1.25)
    try:
        host_of = {"node-a": "127.0.0.1", "node-b": "127.0.0.1"}
        prober = tprobe.AgentProber(host_of, agent_port=port, duration_s=1)
        lat, bw = prober.probe("node-a", "node-b")
        assert lat == 1.25
        assert bw == pytest.approx(9e9)
        cfg = TCfg(max_nodes=8, max_pods=4, max_peers=2)
        enc = TEnc(cfg, device="cpu")
        for name in host_of:
            enc.upsert_node(TNode(name=name, capacity={"cpu": 4.0}))
        orch = tprobe.ProbeOrchestrator(enc, prober, list(host_of))
        assert orch.run_cycle(budget=4) == 1
        i, j = enc.node_index("node-a"), enc.node_index("node-b")
        assert enc._bw[i, j] == pytest.approx(9e9)
        assert enc._lat[i, j] == pytest.approx(1.25)
        assert seen == ["127.0.0.1", "127.0.0.1"]
    finally:
        server.shutdown()
        server.server_close()


def test_agent_prober_raises_on_agent_error():
    def broken(target, duration, port):
        raise OSError("iperf3 not found")

    server, port = _start_agent(tagent, broken, lambda t, p: 0.5)
    try:
        prober = tprobe.AgentProber({"a": "127.0.0.1", "b": "127.0.0.1"},
                                    agent_port=port)
        with pytest.raises(Exception):
            prober.probe("a", "b")
    finally:
        server.shutdown()
        server.server_close()


def test_probe_agent_runs_as_a_module(tmp_path):
    """``python -m ...ingest.probe_agent`` parses the JAX agent's flags
    and serves ``/healthz`` (the DaemonSet's readinessProbe)."""
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    allow = tmp_path / "allow.json"
    allow.write_text(json.dumps({"node-a": "10.0.0.7"}))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "kubernetesnetawarescheduler_tpu_torch.ingest.probe_agent",
         "--host", "127.0.0.1", "--port", str(port), "--token", "t",
         "--allow-targets", str(allow)],
        cwd=str(Path(__file__).resolve().parent.parent))
    try:
        code = body = None
        for _ in range(200):
            try:
                code, body = _get(f"http://127.0.0.1:{port}/healthz")
                break
            except OSError:  # not listening yet
                time.sleep(0.05)
        assert code == 200 and json.loads(body) == {"ok": True}
        assert _get(f"http://127.0.0.1:{port}/probe?target=10.9.9.9",
                    {"X-Netaware-Token": "t"})[0] == 403
    finally:
        proc.terminate()
        proc.wait(timeout=30)
