"""ctypes binding for the native scrape parser (native/parser.cpp).

Loads ``libnetaware_parser.so`` if built (``make -C native``) and falls
back to the pure-Python :class:`~.prometheus.NodeExporterExtractor`
otherwise — same contract, so callers never branch.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable

from kubernetesnetawarescheduler_tpu_torch.ingest.prometheus import (
    NodeExporterExtractor,
)

_LIB_NAME = "libnetaware_parser.so"


def _find_library() -> str | None:
    override = os.environ.get("NETAWARE_PARSER_LIB")
    if override:
        return override if os.path.exists(override) else None
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidate = os.path.join(here, "native", _LIB_NAME)
    return candidate if os.path.exists(candidate) else None


class NativeExtractor:
    """Drop-in for :class:`NodeExporterExtractor.extract` backed by the
    C++ single-pass parser.  ``bandwidth`` is probe-sourced, as in the
    Python extractor."""

    CHANNELS = ("cpu_freq", "mem_pct", "net_tx", "net_rx", "disk_io")

    def __init__(self, lib_path: str,
                 nic_devices: Iterable[str] = ("eth0", "enp3s0f1", "ens4"),
                 disk_devices: Iterable[str] = ("sda", "mmcblk0", "nvme0n1"),
                 ) -> None:
        self._lib = ctypes.CDLL(lib_path)
        self._fn = self._lib.netaware_parse_scrape
        self._fn.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
        ]
        self._fn.restype = ctypes.c_int
        self._nics = ",".join(nic_devices).encode()
        self._disks = ",".join(disk_devices).encode()

    def extract(self, body: str) -> dict[str, float]:
        import math

        raw = body.encode("utf-8", errors="replace")
        out = (ctypes.c_double * 5)()
        derived = self._fn(raw, len(raw), self._nics, self._disks, out)
        if derived <= 0:
            return {}
        # Exposition format allows literal NaN samples; filter like the
        # Python extractor so they never poison the score matrix.
        return {k: v for k, v in zip(self.CHANNELS, out)
                if math.isfinite(v)}


def make_extractor(nic_devices: Iterable[str] = ("eth0", "enp3s0f1", "ens4"),
                   disk_devices: Iterable[str] = ("sda", "mmcblk0",
                                                  "nvme0n1")):
    """Native extractor when the library is built, Python fallback
    otherwise."""
    path = _find_library()
    if path is not None:
        try:
            return NativeExtractor(path, nic_devices, disk_devices)
        except OSError:
            pass
    return NodeExporterExtractor(nic_devices, disk_devices)
