"""Plain reference of the scheduler's semantics, and the check built on it.

The score of pod ``p`` on node ``n`` given the nodes' usage ``U``::

    score = base[n] + net[p, n]
            - w_balance * max_r (U[n, r] + req[p, r]) / cap[n, r]

- ``base``: the metric vote, each metric channel min-max normalised over
  the nodes and flipped so that 1 is best, weighted and summed;
- ``net[p, n] = sum_k vol[p, k] * C[n, node(peer k)]`` with
  ``C = w_bw * bw / max(bw) - w_lat * lat / max(lat)`` and its diagonal
  pinned to ``w_bw`` (co-located peers talk over loopback);
- a node is feasible when every request fits its free capacity and the
  pod tolerates its taint.

The check does not replay the program's conflict loop.  It holds each
cycle (one ``bind_many`` call) to what that loop guarantees: a pod
accepted on node ``c`` scored there, against the usage the cycle
started from, at least as well as any other node still feasible for it
once the whole cycle has committed, because usage only grows within a
cycle and every score falls as it grows.  ``score_gap`` is the widest
amount by which a chosen node falls short of that best alternative (0
where none does); a sound run reads only rounding.  Beside it:
``ledger_gap``, the widest difference between the program's committed
usage and the usage the binds add up to, as a share of capacity; and
``bind_faults``, a count of pods bound twice, binds to a node the pod
does not tolerate, nodes over capacity, and pods taken but never bound
although a node could hold them.
"""

from __future__ import annotations

import numpy as np
import torch

GOODNESS = (-1.0, -1.0, -1.0, -1.0, 1.0, -1.0)
METRIC_WEIGHTS = ("cpu", "mem", "net_tx", "net_rx", "bandwidth", "disk")
# An alternative counts only with this share of its capacity to spare,
# and a node is over capacity only past it: float32 usage in the program
# rounds far below it, and a node within it of full is too close to call.
CAPACITY_SLACK = 1e-4
PEER_BLOCK = 256


class Model:
    """The reference's view of one cluster in one precision.

    ``net_dtype`` is the type the net term's two operands are rounded to
    before their product (accumulated in float32 below float64);
    ``dtype`` is the type of everything else, the usage ledger
    included."""

    def __init__(self, cluster, weights: dict, device,
                 dtype=torch.float64, net_dtype=None) -> None:
        dev = torch.device(device)
        self.dev, self.dtype = dev, dtype
        self.net_dtype = net_dtype or dtype
        self.n = cluster.n
        self.cap = torch.as_tensor(cluster.cap, device=dev).to(dtype)
        self.tainted = torch.as_tensor(cluster.tainted, device=dev)
        self.w_bal = float(weights["balance"])
        m = torch.as_tensor(cluster.metrics, device=dev).to(torch.float64)
        lo, hi = m.amin(0), m.amax(0)
        unit = ((m - lo) / (hi - lo).clamp_min(1e-9)).clamp(0.0, 1.0)
        good = torch.tensor(GOODNESS, dtype=torch.float64, device=dev)
        norm = torch.where(good > 0, unit, 1.0 - unit)
        w = torch.tensor([float(weights[k]) for k in METRIC_WEIGHTS],
                         dtype=torch.float64, device=dev)
        self.base = (norm @ w).to(dtype)
        lat = torch.as_tensor(cluster.lat, device=dev).to(torch.float64)
        bw = torch.as_tensor(cluster.bw, device=dev).to(torch.float64)
        c = (float(weights["peer_bw"]) * bw / bw.max()
             - float(weights["peer_lat"]) * lat / lat.max())
        del lat, bw
        c.fill_diagonal_(float(weights["peer_bw"]))
        # Row j of ct is C[:, j]: the desirability of every node for a
        # peer on node j.
        self.ct = self._round(c.T.contiguous())
        del c

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the net operands' type, held in float64 for
        the reference and in float32 for a lower precision."""
        if self.net_dtype == torch.float64:
            return x.to(torch.float64)
        return x.to(torch.float32).to(self.net_dtype).to(torch.float32)

    def net(self, peer_nodes: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
        """``net[P, n]`` for peers on ``peer_nodes`` (``-1`` = none)."""
        live = peer_nodes >= 0
        v = self._round(torch.where(live, vol, 0.0))
        rows = self.ct[peer_nodes.clamp_min(0)]               # [P, K, n]
        return (v[:, :, None] * rows).sum(dim=1).to(self.dtype)

    def balance(self, used: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
        """``max_r (used + req) / cap`` for ``used [.., n, 3]`` and
        ``req [P, 3]``, shaped ``[P, n]``."""
        return ((used[None] + req[:, None, :])
                / self.cap.clamp_min(1e-9)[None]).amax(dim=-1)

    def feasible(self, used: torch.Tensor, req: torch.Tensor,
                 tolerates: torch.Tensor, slack: float,
                 nodes: torch.Tensor | None = None) -> torch.Tensor:
        """``[P, n]`` (or ``[P, len(nodes)]`` with ``used`` of those
        nodes): every request fits with ``slack`` of capacity to spare,
        and the pod tolerates the node's taint."""
        cap = self.cap if nodes is None else self.cap[nodes]
        tainted = self.tainted if nodes is None else self.tainted[nodes]
        free = cap - used - slack * cap
        fits = (req[:, None, :] <= free[None]).all(dim=-1)
        return fits & (~tainted[None, :] | tolerates[:, None])


def _pod_tensors(model: Model, pods, idx: np.ndarray,
                 node_of: np.ndarray):
    dev = model.dev
    peers = pods.peers[idx]
    pn = np.where(peers >= 0, node_of[np.maximum(peers, 0)], -1)
    return (torch.as_tensor(pn, device=dev),
            torch.as_tensor(pods.volume[idx], device=dev),
            torch.as_tensor(pods.req[idx], device=dev).to(model.dtype),
            torch.as_tensor(pods.tolerates[idx], device=dev))


def initial_usage(model: Model, pods) -> tuple[torch.Tensor, np.ndarray]:
    """Usage of the pods bound at set-up, and the node of every pod so
    far (``-1`` = not bound)."""
    node_of = pods.bound_node.copy()
    used = torch.zeros((model.n, 3), dtype=model.dtype, device=model.dev)
    b = pods.first_arrival
    if b:
        used.index_add_(0, torch.as_tensor(node_of[:b], device=model.dev),
                        torch.as_tensor(pods.req[:b],
                                        device=model.dev).to(model.dtype))
    return used, node_of


def check(model: Model, pods, cycles, program_used: np.ndarray,
          unbound: np.ndarray) -> dict:
    """Hold the program's cycles to the reference.

    ``cycles``: per ``bind_many`` call, in order, ``(pod indices, node
    indices)`` of the binds the fake API server accepted.
    ``program_used``: the program's committed usage ``[n, 3]`` once the
    window has closed.  ``unbound``: indices of pods the scheduler took
    (or that fell due) and never bound."""
    used, node_of = initial_usage(model, pods)
    gap = -float("inf")
    faults = 0
    for idx, nodes in cycles:
        idx = np.asarray(idx, np.int64)
        nodes = np.asarray(nodes, np.int64)
        if len(idx) == 0:
            continue
        faults += int((node_of[idx] >= 0).sum())
        faults += len(idx) - len(np.unique(idx))
        nd = torch.as_tensor(nodes, device=model.dev)
        req_all = torch.as_tensor(pods.req[idx],
                                  device=model.dev).to(model.dtype)
        used_end = used.clone().index_add_(0, nd, req_all)
        touched = torch.unique(nd)
        over = (used_end[touched]
                > model.cap[touched] * (1 + CAPACITY_SLACK)).any(dim=-1)
        faults += int(over.sum())
        for lo in range(0, len(idx), PEER_BLOCK):
            sl = slice(lo, lo + PEER_BLOCK)
            pn, vol, req, tol = _pod_tensors(model, pods, idx[sl], node_of)
            c = nd[sl]
            faults += int((model.tainted[c] & ~tol).sum())
            net = model.net(pn, vol)
            rows = torch.arange(len(c), device=model.dev)
            bal0 = ((used[c] + req) / model.cap[c].clamp_min(1e-9)).amax(-1)
            chosen = model.base[c] + net[rows, c] - model.w_bal * bal0
            alt = model.base[None] + net - model.w_bal * model.balance(
                used_end, req)
            ok = model.feasible(used_end, req, tol, CAPACITY_SLACK)
            ok[rows, c] = False
            best = torch.where(ok, alt, -torch.inf).amax(dim=1)
            gap = max(gap, float((best - chosen).max()))
        used = used_end
        node_of[idx] = nodes
    unbound = np.asarray(unbound, np.int64)
    for lo in range(0, len(unbound), PEER_BLOCK):
        sl = unbound[lo:lo + PEER_BLOCK]
        _, _, req, tol = _pod_tensors(model, pods, sl, node_of)
        faults += int(model.feasible(used, req, tol,
                                     CAPACITY_SLACK).any(dim=1).sum())
    prog = torch.as_tensor(program_used[:model.n],
                           device=model.dev).to(torch.float64)
    ledger_gap = float(((prog - used.to(torch.float64)).abs()
                        / model.cap.to(torch.float64)).max())
    return {"score_gap": max(gap, 0.0), "ledger_gap": ledger_gap,
            "bind_faults": faults}


def greedy_cycles(model: Model, pods, order: np.ndarray, cycle_sizes):
    """The reference put in the program's place: each cycle's pods, in
    priority order, placed one at a time on their best feasible node
    (lowest index on a tie), in ``model``'s precision.  Returns the
    cycles as :func:`check` takes them and the usage ledger."""
    used, node_of = initial_usage(model, pods)
    cycles = []
    pos = 0
    for size in cycle_sizes:
        idx = np.asarray(order[pos:pos + size], np.int64)
        pos += size
        idx = idx[np.argsort(-pods.priority[idx], kind="stable")]
        pn, vol, req, tol = _pod_tensors(model, pods, idx, node_of)
        net = model.net(pn, vol)
        placed_i, placed_n = [], []
        for j in range(len(idx)):
            score = (model.base + net[j]
                     - model.w_bal * model.balance(used, req[j:j + 1])[0])
            ok = model.feasible(used, req[j:j + 1], tol[j:j + 1], 0.0)[0]
            score = torch.where(ok, score, -torch.inf)
            c = int(torch.argmax(score))
            if not bool(ok[c]):
                continue
            used[c] += req[j]
            placed_i.append(int(idx[j]))
            placed_n.append(c)
        node_of[placed_i] = placed_n
        cycles.append((placed_i, placed_n))
    return cycles, used
