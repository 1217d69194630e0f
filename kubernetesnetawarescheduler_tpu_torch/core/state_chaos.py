"""State-layer chaos: seeded fault injection into the device-resident
state pipeline.

The PyTorch package's copy of the JAX package's ``core/state_chaos.py``.
k8s/chaos.py makes control-plane misbehaviour a first-class input; this
module does the same for the state layer — the host staging mirror, the
delta-patch stream, the device planes and the checkpoint files.  Every
fault class below is something the delta-ingest design could suffer and
the integrity auditor (core/integrity.py) must detect within one audit
period and repair bit-identically:

- ``delta_drop`` — a staging write whose device patch was lost: the
  staging row moves with NO dirty marking, so the device keeps serving
  the stale row.
- ``delta_dup`` — a delta applied twice: the device row overshoots the
  staging truth by the delta a second application would add.
- ``delta_reorder`` — two patches landing out of order: the device net
  pair ends on the OLDER value while staging holds the newer one.
- ``nan_poison`` — NaN/Inf reaching a device metric row.
- ``bit_flip`` — one flipped bit in a device plane, across a float, a
  u32 bitmask (int32 bits here) and an int32 plane.
- ``checkpoint_corrupt`` — torn/corrupted checkpoint files on disk:
  truncation, byte flips, deleted members (detected by the MANIFEST
  digests at restore time, not by the runtime auditor).

Everything is deterministic from the seed (``np.random.default_rng``),
and the draws are made in the JAX package's order, so one seed gives the
same descriptors in both packages.  Each injection returns a descriptor
pinning what was corrupted and is counted in :attr:`injected`
(``/metrics``: ``netaware_state_faults_injected_total{fault=...}``);
with a loop attached, the class is tagged onto the next committed flight
recorder span (``fault_class``).

Device faults are written on the device and OUT OF PLACE: the injector
puts a new tensor in the encoder's cache (``index_put``), as the
encoder's own delta patches do.  A snapshot handed out before the
injection keeps its bits, so a pipelined cycle still scoring against it
sees no fault that was not injected into it.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

#: Every state-fault class the injector knows.
STATE_FAULT_CLASSES = ("delta_drop", "delta_dup", "delta_reorder",
                       "nan_poison", "bit_flip", "checkpoint_corrupt")

#: Device planes eligible for ``bit_flip``: one float, one bitmask, one
#: index plane, so the flip exercises every bit view of the digest.
_FLIP_PLANES = ("cap", "group_bits", "node_zone")


def _sign_safe_mask(bit: int) -> int:
    """``1 << bit`` as an int32 value: bit 31 is the sign bit, which a
    torch int32 scalar holds only as ``-(2**31)``."""
    return -(2 ** 31) if bit == 31 else 1 << bit


class StateChaosInjector:
    """Seeded injector of state-layer faults against one Encoder.

    ``inject(kind)`` applies one deterministic fault and returns its
    descriptor ``{"fault", "plane", "rows", ...}``; ``inject_random()``
    draws the class from the seeded stream.  ``checkpoint_corrupt``
    needs ``checkpoint_dir``; the others flush a snapshot first so the
    fault survives the next legitimate flush (un-flushed dirt would
    heal it and the detection test would pass vacuously).
    """

    def __init__(self, encoder, seed: int = 0, loop=None,
                 checkpoint_dir: str | None = None) -> None:
        self.encoder = encoder
        self.loop = loop
        self.checkpoint_dir = checkpoint_dir
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self.injected = {k: 0 for k in STATE_FAULT_CLASSES}
        self.faults: list[dict] = []

    # -- plumbing -----------------------------------------------------

    def _pick_row(self) -> int:
        rows = np.flatnonzero(self.encoder._node_valid)
        if rows.size == 0:
            return 0
        return int(rows[self._rng.integers(0, rows.size)])

    def _flush(self) -> None:
        """Settle the device cache so the injected fault is not masked
        by pending legitimate dirt."""
        self.encoder.snapshot()

    def _poke_device(self, key: str, row: int, col: int, value) -> None:
        """Write one element of a cached device plane into a NEW tensor
        on its device — corruption that happened on the device/transfer
        side, invisible to the dirty tracking."""
        enc = self.encoder
        cur = enc._cache[key]
        idx = torch.tensor([row, col], dtype=torch.int64,
                           device=cur.device)
        val = torch.tensor([value], dtype=cur.dtype, device=cur.device)
        enc._cache[key] = cur.index_put((idx[:1], idx[1:]), val)

    def _record(self, desc: dict) -> dict:
        self.injected[desc["fault"]] += 1
        self.faults.append(desc)
        loop = self.loop
        if loop is not None:
            # One-shot span tag: the next committed cycle span carries
            # this fault class (core/loop.py _span_commit).
            loop._state_fault_pending = desc["fault"]
        return desc

    # -- fault classes ------------------------------------------------

    def inject(self, kind: str) -> dict:
        if kind not in STATE_FAULT_CLASSES:
            raise ValueError(f"unknown state-fault class {kind!r}")
        return getattr(self, f"_inject_{kind}")()

    def inject_random(self) -> dict:
        """Draw a class from the seeded stream (checkpoint faults only
        when a checkpoint directory with files exists)."""
        classes = [k for k in STATE_FAULT_CLASSES
                   if k != "checkpoint_corrupt"
                   or (self.checkpoint_dir
                       and os.path.exists(os.path.join(
                           self.checkpoint_dir, "state.npz")))]
        return self.inject(
            classes[int(self._rng.integers(0, len(classes)))])

    @staticmethod
    def _perturb(value: np.float32) -> np.float32:
        """A float32 value bit-different from ``value`` at ANY magnitude
        (an additive epsilon would round away against multi-gigabyte
        metric values: 1e10 + 2.0 == 1e10 in f32)."""
        new = np.float32(value * np.float32(1.5) + np.float32(1.0))
        if new == value:  # value == -2.0, the fixpoint
            new = np.float32(value + np.float32(3.0))
        return new

    def _inject_delta_drop(self) -> dict:
        enc = self.encoder
        with enc._lock:
            self._flush()
            row = self._pick_row()
            chan = int(self._rng.integers(0, enc._metrics.shape[1]))
            # Staging moves; the dirty marking the write would have
            # left is deliberately NOT made — the patch was "dropped".
            enc._metrics[row, chan] = self._perturb(
                enc._metrics[row, chan])
        return self._record({"fault": "delta_drop", "plane": "metrics",
                             "rows": [row], "channel": chan})

    def _inject_delta_dup(self) -> dict:
        enc = self.encoder
        with enc._lock:
            self._flush()
            row = self._pick_row()
            chan = int(self._rng.integers(0, enc._metrics.shape[1]))
            # The same delta applied twice: the device overshoots the
            # staging truth by one application (scale-aware so it
            # cannot round away against large values).
            cur = np.float32(enc._cache["metrics"][row, chan].item())
            self._poke_device("metrics", row, chan, self._perturb(cur))
        return self._record({"fault": "delta_dup", "plane": "metrics",
                             "rows": [row], "channel": chan})

    def _inject_delta_reorder(self) -> dict:
        enc = self.encoder
        with enc._lock:
            self._flush()
            i = self._pick_row()
            j = self._pick_row()
            if j == i:
                j = (i + 1) % enc._lat.shape[0]
            stale = float(self._rng.uniform(0.1, 50.0))
            # An older patch landed LAST: the device pair reverts to a
            # stale value while staging keeps the newer one.
            self._poke_device("lat", i, j, np.float32(stale))
        return self._record({"fault": "delta_reorder", "plane": "lat",
                             "rows": [i], "pair": [i, j]})

    def _inject_nan_poison(self) -> dict:
        enc = self.encoder
        with enc._lock:
            self._flush()
            row = self._pick_row()
            chan = int(self._rng.integers(0, enc._metrics.shape[1]))
            val = np.float32(np.nan if self._rng.random() < 0.5
                             else np.inf)
            self._poke_device("metrics", row, chan, val)
        return self._record({"fault": "nan_poison", "plane": "metrics",
                             "rows": [row], "channel": chan})

    def _inject_bit_flip(self) -> dict:
        enc = self.encoder
        with enc._lock:
            self._flush()
            plane = _FLIP_PLANES[
                int(self._rng.integers(0, len(_FLIP_PLANES)))]
            cur = enc._cache[plane]
            flat = cur.reshape(cur.shape[0], -1)
            row = self._pick_row() % cur.shape[0]
            col = int(self._rng.integers(0, flat.shape[1]))
            bit = int(self._rng.integers(0, 32))
            # The XOR runs on the plane's int32 view on its device; the
            # flipped word goes into a new tensor.
            bits = flat.view(torch.int32)
            idx = torch.tensor([row, col], dtype=torch.int64,
                               device=cur.device)
            word = bits[idx[:1], idx[1:]] ^ _sign_safe_mask(bit)
            enc._cache[plane] = (bits.index_put((idx[:1], idx[1:]), word)
                                 .view(cur.dtype).reshape(cur.shape))
        return self._record({"fault": "bit_flip", "plane": plane,
                             "rows": [int(row)], "bit": bit})

    def _inject_checkpoint_corrupt(self) -> dict:
        if not self.checkpoint_dir:
            raise ValueError(
                "checkpoint_corrupt needs a checkpoint_dir")
        path = self.checkpoint_dir
        modes = ("truncate", "flip", "delete_meta")
        mode = modes[int(self._rng.integers(0, len(modes)))]
        target = os.path.join(path, "state.npz")
        if mode == "delete_meta":
            target = os.path.join(path, "meta.json")
            if os.path.exists(target):
                os.remove(target)
        elif mode == "truncate":
            size = os.path.getsize(target)
            keep = int(self._rng.integers(0, max(size, 1)))
            with open(target, "r+b") as fh:
                fh.truncate(keep)
        else:  # flip one byte
            size = os.path.getsize(target)
            off = int(self._rng.integers(0, max(size, 1)))
            with open(target, "r+b") as fh:
                fh.seek(off)
                b = fh.read(1)
                fh.seek(off)
                fh.write(bytes([(b[0] if b else 0) ^ 0xFF]))
        return self._record({"fault": "checkpoint_corrupt",
                             "plane": "checkpoint", "rows": [],
                             "mode": mode, "file": target})


def run_state_fault_matrix(encoder, auditor,
                           classes: Sequence[str] | None = None,
                           seed: int = 0) -> dict[str, dict]:
    """Drive the runtime fault classes (everything but
    ``checkpoint_corrupt``) against one encoder + auditor and report
    per-class ``{"injected", "detected", "repaired", "rung",
    "descriptor"}``: the fault-detection matrix."""
    from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
        compare_row_digests,
        device_row_digests_host,
        host_row_digests,
    )

    injector = StateChaosInjector(encoder, seed=seed)
    kinds = [k for k in (classes or STATE_FAULT_CLASSES)
             if k != "checkpoint_corrupt"]
    results: dict[str, dict] = {}
    for kind in kinds:
        desc = injector.inject(kind)
        outcome = auditor.audit_once()
        detected = not outcome["clean"]
        # Bit-identity proof: after repair, the device digests must
        # equal a fresh host derivation of the expected view.
        with encoder._lock:
            state, _ = encoder.snapshot_versioned()
            expected = encoder.expected_device_arrays()
        identical = not compare_row_digests(
            device_row_digests_host(state), host_row_digests(expected))
        results[kind] = {"injected": 1,
                         "detected": int(detected),
                         "repaired": int(outcome["repaired"]
                                         and identical),
                         "rung": outcome["rung"],
                         "descriptor": desc}
    return results
