"""iperf3 JSON result parsing — full schema parity.

The reference declares the complete iperf3 output schema as Go structs
(``Iperf``/``Start``/``End``/``Stream``/``Interval``/... at
scheduler.go:34-117) and consumes a single leaf:
``End.Streams[0].Receiver.BitsPerSecond`` (scheduler.go:528).  This
module mirrors that schema as dataclasses (tolerant of missing
optional fields, as iperf3 omits ``socket``/``retransmits``/... in
some modes) and exposes the same headline extraction plus the richer
quantities the probe pipeline wants (sender/receiver rates, retransmits,
CPU utilization, per-interval series).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class StreamEnd:
    """One direction of a finished stream (``sum_sent``/``sum_received``
    shape; scheduler.go:62-72)."""

    start: float = 0.0
    end: float = 0.0
    seconds: float = 0.0
    bytes: int = 0
    bits_per_second: float = 0.0
    retransmits: int | None = None
    snd_cwnd: int | None = None
    socket: int | None = None

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "StreamEnd":
        d = d or {}
        return cls(
            start=float(d.get("start", 0.0)),
            end=float(d.get("end", 0.0)),
            seconds=float(d.get("seconds", 0.0)),
            bytes=int(d.get("bytes", 0)),
            bits_per_second=float(d.get("bits_per_second", 0.0)),
            retransmits=d.get("retransmits"),
            snd_cwnd=d.get("snd_cwnd"),
            socket=d.get("socket"),
        )


@dataclasses.dataclass(frozen=True)
class CpuUtilization:
    """``end.cpu_utilization_percent`` (scheduler.go:48-55)."""

    host_total: float = 0.0
    host_user: float = 0.0
    host_system: float = 0.0
    remote_total: float = 0.0
    remote_user: float = 0.0
    remote_system: float = 0.0

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "CpuUtilization":
        d = d or {}
        return cls(**{f.name: float(d.get(f.name, 0.0))
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class IperfResult:
    """The subset of a parsed iperf3 run the scheduler consumes, plus
    provenance."""

    title: str
    protocol: str
    duration_s: float
    sender: StreamEnd
    receiver: StreamEnd
    sum_sent: StreamEnd
    sum_received: StreamEnd
    cpu: CpuUtilization
    intervals_bps: tuple[float, ...] = ()

    @property
    def bandwidth_bps(self) -> float:
        """The reference's headline value:
        ``End.Streams[0].Receiver.BitsPerSecond`` (scheduler.go:528)."""
        return self.receiver.bits_per_second


def parse_iperf_json(text: str | bytes) -> IperfResult:
    """Parse a full iperf3 ``-J`` output document.

    Raises ``ValueError`` on structurally unusable documents (no
    ``end`` section) — the failure mode the reference hits as a nil
    pointer after ``println``-ing the open error (scheduler.go:512-525).
    """
    return iperf_result_from_doc(json.loads(text))


def iperf_result_from_doc(doc: Mapping[str, Any]) -> IperfResult:
    """:func:`parse_iperf_json` for an already-decoded document (the
    probe agent returns iperf3's JSON embedded in its own response —
    no reason to re-serialize it just to re-parse)."""
    end = doc.get("end")
    if not isinstance(end, dict):
        raise ValueError("iperf3 document has no 'end' section")
    streams: Sequence[Mapping[str, Any]] = end.get("streams") or []
    first = streams[0] if streams else {}
    start = doc.get("start") or {}
    test_start = start.get("test_start") or {}
    intervals = tuple(
        float((iv.get("sum") or {}).get("bits_per_second", 0.0))
        for iv in doc.get("intervals") or ())
    return IperfResult(
        title=str(doc.get("title", "")),
        protocol=str(test_start.get("protocol", "")),
        duration_s=float(test_start.get("duration", 0.0)),
        sender=StreamEnd.from_dict(first.get("sender")),
        receiver=StreamEnd.from_dict(first.get("receiver")),
        sum_sent=StreamEnd.from_dict(end.get("sum_sent")),
        sum_received=StreamEnd.from_dict(end.get("sum_received")),
        cpu=CpuUtilization.from_dict(end.get("cpu_utilization_percent")),
        intervals_bps=intervals,
    )


def synth_iperf_json(bits_per_second: float, title: str = "",
                     duration_s: float = 10.0) -> str:
    """A minimal structurally-valid iperf3 ``-J`` document (test +
    fake-probe helper)."""
    stream = {
        "start": 0, "end": duration_s, "seconds": duration_s,
        "bytes": int(bits_per_second * duration_s / 8),
        "bits_per_second": bits_per_second,
    }
    return json.dumps({
        "title": title,
        "start": {"test_start": {"protocol": "TCP",
                                 "duration": duration_s}},
        "intervals": [{"sum": dict(stream)}],
        "end": {
            "streams": [{"sender": dict(stream, retransmits=0),
                         "receiver": dict(stream)}],
            "sum_sent": dict(stream, retransmits=0),
            "sum_received": dict(stream),
            "cpu_utilization_percent": {
                "host_total": 1.0, "host_user": 0.5, "host_system": 0.5,
                "remote_total": 1.0, "remote_user": 0.5,
                "remote_system": 0.5},
        },
    })
