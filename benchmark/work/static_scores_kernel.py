"""The least work of one launch of the static score kernel, counted from
the problem and not from the kernel's layout.

A launch is noted with the pods its batch really holds (``p``, not the
padding of the batch) and the cluster's nodes (``n``, not the padding of
the node axis).  Each input is read once and each output written once:
per pod its validity, its toleration words and its (peer node, volume)
pairs; per node its metric vote, validity and taint words; the ``lat``
and ``bw`` columns of the distinct peer nodes the batch references; and
the raw score (float32) and the static mask (one byte) of every pod on
every node.  The operations: forming the desirability of each node for each
peer node (5), a multiply-add per (pod, peer node) pair and node, and
adding the metric vote.  The peer-column compaction the kernel runs
first is part of the same work, so its kernels are timed with it.
"""

KERNELS = ("static_scores_kernel", "peer_flags_kernel", "peer_scan_kernel",
           "peer_traffic_kernel")


def bytes_flops(launch: dict) -> tuple[int, int]:
    p, n, w = launch["p"], launch["n"], launch["w"]
    nnz, cols = launch["nnz"], launch["cols"]
    read = (p * (4 + 4 * w) + nnz * 8 + n * (4 + 4 + 4 * w)
            + 2 * n * cols * 4)
    written = n * p * (4 + 1)
    flops = 5 * n * cols + 2 * nnz * n + n * p
    return read + written, flops


def least_seconds(launch: dict, peaks: dict) -> float:
    b, f = bytes_flops(launch)
    return max(b / peaks["hbm_bytes_per_s"], f / peaks["f32_flops_per_s"])
