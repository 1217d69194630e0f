"""The roofline work counts against a count by hand."""

from __future__ import annotations

import pytest

from benchmark import readers


def test_static_kernel_work_by_hand():
    w = readers.work("static_scores_kernel")
    launch = {"p": 256, "n": 5120, "w": 4, "nnz": 1000, "cols": 900}
    b, f = w.bytes_flops(launch)
    pods = 256 * (4 + 16) + 1000 * 8          # validity, 4 tol words, pairs
    nodes = 5120 * (4 + 4 + 16)               # vote, validity, 4 taint words
    columns = 2 * 5120 * 900 * 4              # lat and bw of 900 peer nodes
    out = 5120 * 256 * 5                      # raw f32 and a mask byte
    assert b == pods + nodes + columns + out
    assert f == 5 * 5120 * 900 + 2 * 1000 * 5120 + 5120 * 256
    pk = readers.peaks()
    assert w.least_seconds(launch, pk) == pytest.approx(
        b / 3.35e12)


def test_roofline_reads_nothing_without_a_trace():
    assert readers.roofline({}, "static_scores_kernel") is None
    rec = {"trace": {"kernels": {}}, "launches": {
        "static_scores_kernel": [{"p": 1, "n": 1, "w": 1, "nnz": 0,
                                  "cols": 0}]}}
    assert readers.roofline(rec, "static_scores_kernel") is None


def test_roofline_share():
    w = readers.work("static_scores_kernel")
    launch = {"p": 256, "n": 5120, "w": 4, "nnz": 1000, "cols": 900}
    least = w.least_seconds(launch, readers.peaks())
    rec = {"trace": {"kernels": {"static_scores_kernel": 3 * least,
                                 "peer_scan_kernel": least,
                                 "elementwise_kernel": 50.0}},
           "launches": {"static_scores_kernel": [launch]}}
    assert readers.roofline(rec, "static_scores_kernel") == pytest.approx(
        25.0)
