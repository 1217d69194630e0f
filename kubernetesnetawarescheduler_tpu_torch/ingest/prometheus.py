"""A real Prometheus text-format parser for node_exporter scrapes.

Replaces the reference's ``strings.Index`` substring slicing
(scheduler.go:409-549), which hardcoded byte offsets (+42, +55, ...),
exactly four CPUs (with an explicit workaround when the master had
eight, scheduler.go:438-439), device names per node class
(``enp3s0f1``/``eth0``, ``sda``/``mmcblk0``; :466-471, :535-540) and
relied on a ``flannel.1`` series appearing right after the wanted one
(:468, :487).

The parser handles the actual exposition format: ``# HELP``/``# TYPE``
comments, ``name{label="value",...} value [timestamp]`` samples, escaped
label values, scientific notation.  The extractor computes the same
derived quantities as the reference (mean CPU scaling frequency over
*all* CPUs, occupied-memory %, per-NIC packet counters, disk io in
flight) without any of the hardcoding.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Mapping

LabelSet = frozenset[tuple[str, str]]

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?'
    r'\s+(?P<value>[^\s]+)'
    r'(?:\s+(?P<ts>[0-9]+))?\s*$')

_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:\\.|[^"\\])*)"')


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape(value: str) -> str:
    # Single pass (sequential str.replace would corrupt e.g. an escaped
    # backslash followed by a literal 'n').
    return re.sub(r"\\(.)",
                  lambda m: _ESCAPES.get(m.group(1), m.group(0)), value)


def parse_prometheus_text(body: str) -> dict[str, dict[LabelSet, float]]:
    """Parse an exposition-format body into
    ``{metric_name: {labelset: value}}``.  Malformed lines are skipped
    (a scrape with junk must degrade, not crash — the reference
    dereferenced a nil response body on error, scheduler.go:397-405)."""
    out: dict[str, dict[LabelSet, float]] = {}
    for line in body.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels_raw = m.group("labels") or ""
        labels = frozenset(
            (lm.group("key"), _unescape(lm.group("val")))
            for lm in _LABEL_RE.finditer(labels_raw))
        out.setdefault(m.group("name"), {})[labels] = value
    return out


class NodeExporterExtractor:
    """Derives the scheduler's metric channels from a parsed scrape.

    ``nic_devices`` / ``disk_devices`` replace the reference's per-node
    hardcoding: any of the listed devices found on the node is summed
    (a node may have several NICs), and overlay devices like
    ``flannel.1`` are simply never listed.
    """

    def __init__(self,
                 nic_devices: Iterable[str] = ("eth0", "enp3s0f1", "ens4"),
                 disk_devices: Iterable[str] = ("sda", "mmcblk0", "nvme0n1"),
                 ) -> None:
        self.nic_devices = frozenset(nic_devices)
        self.disk_devices = frozenset(disk_devices)

    @staticmethod
    def _by_label(samples: Mapping[LabelSet, float], key: str
                  ) -> dict[str, float]:
        out: dict[str, float] = {}
        for labels, value in samples.items():
            for k, v in labels:
                if k == key:
                    out[v] = out.get(v, 0.0) + value
        return out

    def cpu_frequency(self, parsed) -> float:
        """Mean ``node_cpu_scaling_frequency_hertz`` over ALL cpus —
        the reference averaged exactly cpu0..3 and mis-parsed the
        8-core master (scheduler.go:409-442)."""
        samples = parsed.get("node_cpu_scaling_frequency_hertz", {})
        if not samples:
            return 0.0
        return sum(samples.values()) / len(samples)

    def occupied_memory_pct(self, parsed) -> float:
        """``100 - MemAvailable*100/MemTotal`` (scheduler.go:460)."""
        total = parsed.get("node_memory_MemTotal_bytes", {})
        avail = parsed.get("node_memory_MemAvailable_bytes", {})
        t = next(iter(total.values()), 0.0)
        a = next(iter(avail.values()), 0.0)
        if t <= 0:
            return 0.0
        return 100.0 - (a * 100.0 / t)

    def _nic_total(self, parsed, metric: str) -> float:
        per_dev = self._by_label(parsed.get(metric, {}), "device")
        return sum(v for d, v in per_dev.items() if d in self.nic_devices)

    def packets_sent(self, parsed) -> float:
        return self._nic_total(parsed, "node_network_transmit_packets_total")

    def packets_received(self, parsed) -> float:
        return self._nic_total(parsed, "node_network_receive_packets_total")

    def disk_io_now(self, parsed) -> float:
        per_dev = self._by_label(parsed.get("node_disk_io_now", {}), "device")
        return sum(v for d, v in per_dev.items() if d in self.disk_devices)

    def extract(self, body: str) -> dict[str, float]:
        """Scrape body -> metric channels dict (config.Metric names,
        minus ``bandwidth``, which comes from the probe pipeline)."""
        parsed = parse_prometheus_text(body)
        channels = {
            "cpu_freq": self.cpu_frequency(parsed),
            "mem_pct": self.occupied_memory_pct(parsed),
            "net_tx": self.packets_sent(parsed),
            "net_rx": self.packets_received(parsed),
            "disk_io": self.disk_io_now(parsed),
        }
        return {k: v for k, v in channels.items()
                if math.isfinite(v)}
