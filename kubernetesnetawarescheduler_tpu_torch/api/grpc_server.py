"""gRPC transport for the Score/Filter service (remote/DCN clients).

Real gRPC (HTTP/2, grpcio) without protoc codegen: generic byte-in/
byte-out method handlers carrying the same JSON payloads as the UDS
frames.  Service surface:

    /netaware.Scorer/Filter      ExtenderArgs JSON -> FilterResult JSON
    /netaware.Scorer/Prioritize  ExtenderArgs JSON -> HostPriorityList
    /netaware.Scorer/Bind        BindingArgs JSON  -> {"error": ...}
    /netaware.Scorer/Health      {}                -> {"ok": true}

This is the DCN-side analog of what the reference entirely lacked — its
only transports were HTTP scrapes and kubectl-cp file drops
(scheduler.go:396-407, run.sh:12-14).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from kubernetesnetawarescheduler_tpu_torch.api.extender import ExtenderHandlers

SERVICE = "netaware.Scorer"
_METHOD_TO_PATH = {
    "Filter": "/filter",
    "Prioritize": "/prioritize",
    "Bind": "/bind",
    "Health": "/health",
}


def make_handler(handlers: "ExtenderHandlers"):
    """A grpc.GenericRpcHandler serving the scorer ops."""
    import grpc

    class Generic(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            # full method: /netaware.Scorer/<Method>
            _, service, method = handler_call_details.method.split("/")
            if service != SERVICE or method not in _METHOD_TO_PATH:
                return None
            path = _METHOD_TO_PATH[method]

            def unary(request: bytes, context) -> bytes:
                try:
                    return handlers.handle(path, request)
                except Exception as exc:  # surface as gRPC error
                    context.abort(grpc.StatusCode.INTERNAL, str(exc))
                    return b""

            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=None,   # raw bytes
                response_serializer=None)

    return Generic()


def serve_grpc(handlers: "ExtenderHandlers", address: str = "127.0.0.1:0",
               max_workers: int = 8):
    """Start a gRPC server; returns ``(server, bound_port)``."""
    import concurrent.futures

    import grpc

    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((make_handler(handlers),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port


def call_grpc(address: str, method: str, payload: bytes,
              timeout_s: float = 10.0) -> bytes:
    """Client helper: one unary call with raw-bytes (de)serialization."""
    import grpc

    with grpc.insecure_channel(address) as channel:
        fn = channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=None,
            response_deserializer=None)
        return fn(payload, timeout=timeout_s)
