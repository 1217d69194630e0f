"""The conflict loop's round as one CUDA graph, replayed once per round.

Eagerly, a round of :func:`~.assign.assign_parallel` is ≈600 small
launches the host issues one by one; at 5,120 nodes and 256 pods the
host takes ≈9 ms to issue what the card runs in ≈1.3 ms.  Here the round
body is captured once per thread and shape in a ``torch.cuda.CUDAGraph``
and each round is one graph launch: the same kernels on the same
operands, so the same bits.  The body is the round body's PyTorch
kernels or the seven hand-written round kernels
(:func:`~.kernels.conflict_round`, which update the carry in place).
A body may name a span (``body.span``) that each replay runs inside and
a function (``body.replayed``) that each replay calls once the graph is
launched: the round kernels' body marks ``assign.fused`` and counts its
launches there, so callers treat both bodies alike.

An entry of the cache belongs to one thread and owns static copies of
every tensor the body reads (the batch's inputs) and of the carry.
:func:`acquire` copies the batch's tensors in (device-to-device) and
captures a new entry there (span ``assign.capture``: a warm-up run and
the capture, on a side stream).  Each replay writes the new carry back
into the static carry and the continue flag into a static scalar inside
the graph, so rounds replay with no host copies.

The cache holds at most :data:`MAX_ENTRIES` entries, least recently used
first out, and the graphs of a device share one memory pool.  That pool
holds only each round's intermediates, never a live output, and a
device runs one graph's work at a time (each capture, load and replay
waits on an event the previous one recorded, under one lock), so one
entry's replay cannot overwrite what another reads."""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from kubernetesnetawarescheduler_tpu_torch.utils.tracing import span

# Entries kept captured at once.  A serving thread runs one or two
# shapes (the loop's batch, a gang's); more cycle through recaptures.
MAX_ENTRIES = 8

_LOCK = threading.Lock()
_ENTRIES: collections.OrderedDict = collections.OrderedDict()
_DONE: dict = {}


def _like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@contextlib.contextmanager
def _in_turn(dev):
    """Graph work on ``dev``, one at a time across threads and streams."""
    with _LOCK:
        stream = torch.cuda.current_stream(dev)
        done = _DONE.get(dev)
        if done is None:
            done = _DONE[dev] = torch.cuda.Event()
        stream.wait_event(done)
        yield
        done.record(stream)


class RoundGraph:
    """One captured round: ``ins`` and ``carry`` are the static buffers
    the graph reads, ``flag`` the static continue flag it writes.
    Calling it runs one round on the static carry and returns
    ``(*carry, flag)``, as the eager body returns ``(*new_carry, cont)``;
    its arguments (the carry it returned) are not read."""

    def __init__(self, ins: dict, carry: tuple) -> None:
        self.ins = {k: _like(v) for k, v in ins.items()}
        self.carry = tuple(_like(c) for c in carry)
        self.flag = torch.zeros((), dtype=torch.bool, device=carry[0].device)
        self.body = self.graph = self.pool = None
        self.span = self.replayed = None

    def load(self, ins: dict, carry: tuple) -> None:
        for k, v in ins.items():
            self.ins[k].copy_(v)
        for dst, src in zip(self.carry, carry):
            dst.copy_(src)

    def capture(self, body) -> None:
        """Capture ``body`` on the loaded buffers, after one warm-up run
        on copies of the carry (kernel loads, library handles; a body
        that updates its carry in place, as the round kernels' does,
        leaves the loaded carry as it was).  A carry tensor the body
        returns as it was given needs no copy back.  The entry keeps
        ``body``: tensors its closure made outside the capture are read
        by every replay."""
        dev = self.flag.device
        # The pool of the cache's graphs on this device; a pool whose
        # graphs are all gone cannot take a new one, so a device without
        # an entry starts a pool of its own.
        pool = next((e.pool for k, e in _ENTRIES.items() if k[1] == dev),
                    None)
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            body(*(c.clone() for c in self.carry))
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                *new, cont = body(*self.carry)
                for dst, src in zip(self.carry, new):
                    if src is not dst:
                        dst.copy_(src)
                self.flag.copy_(cont)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.body, self.graph, self.pool = body, graph, pool
        self.span = getattr(body, "span", None)
        self.replayed = getattr(body, "replayed", None)

    def __call__(self, *_) -> tuple:
        if self.span is None:
            self._replay()
        else:
            with span(self.span):
                self._replay()
        return (*self.carry, self.flag)

    def _replay(self) -> None:
        with _in_turn(self.flag.device):
            self.graph.replay()
        if self.replayed is not None:
            self.replayed()


def acquire(key, ins: dict, carry: tuple, build) -> RoundGraph:
    """The calling thread's entry for ``key`` with this batch loaded,
    captured here if new.  ``key`` must fix every shape, dtype and Python
    constant of ``build(ins)``'s body besides those of ``ins`` and
    ``carry``, which it is extended with here."""
    dev = carry[0].device
    key = (threading.get_ident(), dev, key,
           tuple((k, tuple(v.shape), v.dtype) for k, v in ins.items()),
           tuple((tuple(c.shape), c.dtype) for c in carry))
    with _in_turn(dev):
        entry = _ENTRIES.get(key)
        if entry is None:
            entry = RoundGraph(ins, carry)
            entry.load(ins, carry)
            with span("assign.capture"):
                entry.capture(build(entry.ins))
            _ENTRIES[key] = entry
            while len(_ENTRIES) > MAX_ENTRIES:
                _ENTRIES.popitem(last=False)
        else:
            entry.load(ins, carry)
        _ENTRIES.move_to_end(key)
    return entry
