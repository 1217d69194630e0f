"""Telemetry ingestion: node-exporter scraping, iperf3 parsing, probes.

The PyTorch package's copy of the JAX package's ``ingest/``, writing
into the port's :class:`~..core.encode.Encoder`, with the per-node probe
agent (``python -m
kubernetesnetawarescheduler_tpu_torch.ingest.probe_agent``) that
``AgentProber`` asks to probe from its node.

The reference's ingestion is 5 synchronous HTTP scrapes *inside the
scheduling cycle* (scheduler.go:275-279), fragile substring slicing of
the Prometheus text format (scheduler.go:409-549), and iperf3 JSON
files dropped into ``/home`` by an out-of-band ``kubectl cp`` loop
(netperfScript/run.sh:12-14).  Here ingestion is asynchronous and
structured: a real text-format parser, a full iperf3 schema, a scrape
pool with failure tolerance, and a probe orchestrator maintaining the
pairwise latency/bandwidth matrices.
"""

from kubernetesnetawarescheduler_tpu_torch.ingest.prometheus import (  # noqa: F401
    NodeExporterExtractor,
    parse_prometheus_text,
)
from kubernetesnetawarescheduler_tpu_torch.ingest.iperf import (  # noqa: F401
    IperfResult,
    parse_iperf_json,
)
from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (  # noqa: F401
    FakeProber,
    ProbeOrchestrator,
)
from kubernetesnetawarescheduler_tpu_torch.ingest.scraper import (  # noqa: F401
    ScrapePool,
)
