"""State integrity: the per-plane digests of the cluster state.

The digest half of the JAX package's ``core/integrity.py``: the plane
registry and one rolling checksum, computed identically over the device
state (:func:`device_row_digests`, :func:`plane_digest_vector`) and by a
numpy mirror over host arrays (:func:`host_row_digests`,
:func:`host_plane_digest_vector`).  Bit-exact agreement of the two is the
delta-ingest invariant; disagreement localizes drift to (plane, row).
The anti-entropy auditor and its repair ladder follow with the
scheduling loop (ROADMAP Queue A, item 11).

Per row: ``digest = Σ_k u32(row[k]) · (2k + 1)  (mod 2^32)`` over the raw
bit patterns (float32 and int32 reinterpreted as uint32, bool as 0/1).
Odd weights make the map value -> digest a bijection per element, so a
single flipped bit always moves the digest.

torch has no general uint32 arithmetic.  The device side reinterprets
f32 and i32 as int32, widens to int64 and masks with ``& 0xFFFFFFFF``;
products and sums stay in int64, whose wraparound keeps the low 32 bits
right; a final mask leaves the u32 value, returned as the int32 with the
same bits (``numpy .view(np.uint32)`` recovers the JAX package's words).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.core.state import ClusterState

#: Every ClusterState plane, in checkpoint order, with the encoder dirty
#: group whose transfer path owns it.  The digest machinery iterates
#: this; tests/test_torch_integrity.py fails when a ClusterState field
#: is missing here.
PLANES: tuple[tuple[str, str], ...] = (
    ("metrics", "metrics"),
    ("metrics_age", "metrics"),
    ("lat", "net"),
    ("bw", "net"),
    ("cap", "alloc"),
    ("used", "alloc"),
    ("node_valid", "topo"),
    ("label_bits", "topo"),
    ("taint_bits", "topo"),
    ("group_bits", "alloc"),
    ("resident_anti", "alloc"),
    ("node_zone", "topo"),
    ("gz_counts", "alloc"),
    ("az_anti", "alloc"),
    ("node_numeric", "topo"),
)

PLANE_NAMES: tuple[str, ...] = tuple(name for name, _ in PLANES)
GROUP_OF: dict[str, str] = dict(PLANES)

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host (numpy) digests.
# ---------------------------------------------------------------------------


def _row_weights(width: int) -> np.ndarray:
    return (2 * np.arange(width, dtype=np.uint32) + np.uint32(1))


def _host_u32_rows(arr: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(arr)
    if a.dtype == np.bool_:
        a = a.astype(np.uint32)
    elif a.dtype in (np.dtype(np.float32), np.dtype(np.int32)):
        a = a.view(np.uint32)
    elif a.dtype != np.dtype(np.uint32):
        a = a.astype(np.float32).view(np.uint32)
    return a.reshape(a.shape[0], -1)


def host_row_digest(arr: np.ndarray) -> np.ndarray:
    """``u32[rows]`` rolling digest of one host array."""
    u = _host_u32_rows(arr)
    w = _row_weights(u.shape[1])
    return np.sum(u * w[None, :], axis=1, dtype=np.uint32)


def host_row_digests(arrays: Mapping[str, np.ndarray]
                     ) -> dict[str, np.ndarray]:
    """Per-plane row digests of a host array set (the expected device
    view from ``Encoder.expected_device_arrays``, or a state's
    ``.numpy()``)."""
    return {name: host_row_digest(arrays[name]) for name in PLANE_NAMES
            if name in arrays}


def host_plane_digest_vector(arrays: Mapping[str, np.ndarray]
                             ) -> np.ndarray:
    """Numpy mirror of :func:`plane_digest_vector`: ``u32[len(PLANES)]``."""
    return np.stack([
        np.sum(host_row_digest(arrays[name])
               * _row_weights(arrays[name].shape[0]), dtype=np.uint32)
        for name in PLANE_NAMES])


# ---------------------------------------------------------------------------
# Device (torch) digests.
# ---------------------------------------------------------------------------


def _dev_u32_rows(x: torch.Tensor) -> torch.Tensor:
    """The plane's raw bits as u32 values held in int64, one row per
    leading index."""
    if x.dtype == torch.bool:
        u = x.to(torch.int64)
    else:
        if x.dtype not in (torch.float32, torch.int32):
            x = x.to(torch.float32)
        u = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    return u.reshape(x.shape[0], -1)


def _weights(width: int, dev: torch.device) -> torch.Tensor:
    return 2 * torch.arange(width, dtype=torch.int64, device=dev) + 1


def _dev_row_digest(x: torch.Tensor) -> torch.Tensor:
    """``Σ_k u32(row[k]) · (2k + 1) mod 2^32`` per row, as int64 in
    ``[0, 2^32)``."""
    u = _dev_u32_rows(x)
    return (u * _weights(u.shape[1], u.device)[None, :]).sum(dim=1) & _U32


def _as_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` as the int32 with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def device_row_digests(state: ClusterState) -> dict[str, torch.Tensor]:
    """Per-plane ``u32[rows]`` digests of the device state, each as an
    int32 tensor with the same bits."""
    return {name: _as_i32_bits(_dev_row_digest(getattr(state, name)))
            for name in PLANE_NAMES}


def plane_digest_vector(state: ClusterState) -> torch.Tensor:
    """``u32[len(PLANES)]`` as int32 bits — one scalar digest per plane,
    the compact fingerprint :func:`~.assign.fused_schedule_step` returns
    with ``with_digest=True``."""
    folded = []
    for name in PLANE_NAMES:
        rowd = _dev_row_digest(getattr(state, name))
        w = _weights(rowd.shape[0], rowd.device)
        folded.append((rowd * w).sum() & _U32)
    return _as_i32_bits(torch.stack(folded))
