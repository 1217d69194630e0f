"""UDS scorer server: the backend the native extender shim talks to.

Frame protocol (matches native/extender.cpp):
  request:  u32 path_len | path | u32 body_len | body
  response: u32 body_len | body

Thread-per-connection over a unix domain socket; handler errors return
an empty frame (the shim fails open).  This is the low-latency local
hop of the reference's role split; the gRPC transport
(:mod:`.grpc_server`) serves remote clients over DCN.
"""

from __future__ import annotations

import os
import socket
import socketserver
import struct
import threading

from kubernetesnetawarescheduler_tpu_torch.api.extender import ExtenderHandlers


def _read_full(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_frame(sock: socket.socket) -> tuple[str, bytes] | None:
    header = _read_full(sock, 4)
    if header is None:
        return None
    (path_len,) = struct.unpack("!I", header)
    if path_len > 4096:
        return None
    path = _read_full(sock, path_len)
    size_raw = _read_full(sock, 4)
    if path is None or size_raw is None:
        return None
    (body_len,) = struct.unpack("!I", size_raw)
    if body_len > (64 << 20):
        return None
    body = _read_full(sock, body_len)
    if body is None:
        return None
    return path.decode("utf-8", errors="replace"), body


class ScorerServer:
    """Serves :class:`ExtenderHandlers` over a unix socket path."""

    def __init__(self, handlers: ExtenderHandlers, uds_path: str) -> None:
        self._handlers = handlers
        self.uds_path = uds_path
        if os.path.exists(uds_path):
            os.unlink(uds_path)
        # Live accepted sockets, so stop() is a REAL stop: without
        # this, shutdown() only closes the ACCEPT loop while handler
        # threads keep serving pooled keep-alive connections
        # (round 5's native shim holds one per client connection) —
        # a "stopped" server that still answers is exactly the
        # half-dead state the fail-open machinery must detect.
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self) -> None:
                with outer._conns_lock:
                    outer._conns.add(self.request)

            def finish(self) -> None:
                with outer._conns_lock:
                    outer._conns.discard(self.request)

            def handle(self) -> None:
                while True:
                    frame = _read_frame(self.request)
                    if frame is None:
                        return
                    path, body = frame
                    try:
                        resp = outer._handlers.handle(path, body)
                    except Exception:
                        resp = b""  # shim fails open on empty frame
                    self.request.sendall(
                        struct.pack("!I", len(resp)) + resp)

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True
            # The batcher coalesces 100+ concurrent webhook clients
            # into shared dispatches; socketserver's default listen
            # backlog of 5 EAGAINs a concurrent connect burst before
            # the batcher ever sees it.
            request_queue_size = 256

        self._server = Server(uds_path, Handler)
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # Close LIVE connections too (see _conns above): their
        # handler threads see EOF and exit; pooled clients observe a
        # genuinely dead backend instead of a lame duck.
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._handlers.close()  # releases the batcher's finisher thread
        if os.path.exists(self.uds_path):
            os.unlink(self.uds_path)


def call_uds(uds_path: str, path: str, body: bytes,
             timeout_s: float = 10.0) -> bytes:
    """Client helper (tests + tooling): one framed round-trip."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout_s)
        sock.connect(uds_path)
        encoded = path.encode()
        sock.sendall(struct.pack("!I", len(encoded)) + encoded +
                     struct.pack("!I", len(body)) + body)
        header = _read_full(sock, 4)
        if header is None:
            raise ConnectionError("no response frame")
        (size,) = struct.unpack("!I", header)
        resp = _read_full(sock, size)
        if resp is None:
            raise ConnectionError("truncated response frame")
        return resp
