"""Listeners: client gRPC port, peer HTTP port, info/metrics HTTP port.

Reference: pkg/endpoint/endpoint.go runs three root servers (client 2379 /
peer 2380 / info) with cmux demuxing HTTP1+gRPC on one TCP port
(server.go:65-100). Python grpcio owns its listening socket, so instead of
cmux this layer gives each protocol its own port — same surface, explicit
ports: the client port speaks gRPC (etcd3 + brain), the peer port serves the
HTTP control plane (/status revision sync, /health, /election), and the info
port serves /metrics + debug. TLS: gRPC via grpc.ssl_server_credentials,
HTTP via ssl context (reference security.go wraps with cmux.TLS()).
"""

from __future__ import annotations

import ssl
import threading
from concurrent import futures
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc


class _MetricsInterceptor(grpc.ServerInterceptor):
    """Per-RPC method/latency/success metrics (reference: grpc-prometheus
    unary+stream interceptors, pkg/metrics/prometheus/grpc_server_options.go:29-36)."""

    def __init__(self, metrics):
        self._m = metrics

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        m = self._m

        def wrap_unary(behavior):
            def inner(request, context):
                with m.timed("rpc.server", method=method):
                    return behavior(request, context)
            return inner

        def wrap_stream(behavior):
            def inner(request_or_iterator, context):
                with m.timed("rpc.server", method=method):
                    yield from behavior(request_or_iterator, context)
            return inner

        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                wrap_unary(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                wrap_stream(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.stream_stream:
            return grpc.stream_stream_rpc_method_handler(
                wrap_stream(handler.stream_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        return handler


class _FaultInterceptor(grpc.ServerInterceptor):
    """Chaos-mode connection drops (docs/faults.md): during an armed
    ``conn_drop`` window, unary client RPCs abort with a bare UNAVAILABLE
    BEFORE the handler runs — the wire shape of a dropped connection. No
    ``etcdserver:`` prefix on purpose: clients must classify it ambiguous
    (the handler never ran here, but a real connection drop gives the
    client no way to know that — the asymmetry is the fault). Ordered
    INSIDE the metrics interceptor so aborted RPCs still count in
    ``rpc_server_count`` and the harness reconcile stays exact."""

    def __init__(self, plane):
        self._plane = plane

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler  # streams are covered by watch_reset injection
        plane = self._plane
        behavior = handler.unary_unary

        def inner(request, context):
            if plane.conn_drop():
                context.abort(grpc.StatusCode.UNAVAILABLE,
                              "connection dropped (fault injection)")
            return behavior(request, context)

        return grpc.unary_unary_rpc_method_handler(
            inner,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


@dataclass
class EndpointConfig:
    host: str = "0.0.0.0"
    client_port: int = 2379
    peer_port: int = 2380
    info_port: int = 8081
    # TLS (applies to the client gRPC port + peer/info HTTPS when set)
    cert_file: str = ""
    key_file: str = ""
    ca_file: str = ""
    insecure: bool = True  # also serve plaintext when certs are configured
    # the sync gRPC stack holds one worker thread per ACTIVE stream (every
    # open Watch); kube-apiserver keeps dozens of watch streams open, so the
    # pool must be sized well above the expected stream count
    grpc_workers: int = 256
    extra_http: dict = field(default_factory=dict)


def http_call(fn, qs: str):
    """Zero-arg invoker for an HTTP route handler — the ONE place the
    query-string contract lives (both HTTP fronts dispatch through it):
    query-aware handlers (``fn.kb_query``, e.g. /debug/profile?seconds=N)
    receive the parsed query string as a flat last-value-wins dict."""
    if getattr(fn, "kb_query", False):
        from urllib.parse import parse_qs

        query = {k: v[-1] for k, v in parse_qs(qs).items()}
        return lambda: fn(query)
    return fn


class _HttpHandler(BaseHTTPRequestHandler):
    routes: dict = {}

    def do_GET(self):  # noqa: N802
        path, _, qs = self.path.partition("?")
        fn = self.routes.get(path)
        if fn is None:
            self.send_error(404)
            return
        try:
            content_type, body = http_call(fn, qs)()
        except Exception as e:  # surface handler errors as 500s
            self.send_error(500, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet
        pass


class Endpoint:
    def __init__(self, server, metrics, config: EndpointConfig):
        self.server = server
        self.metrics = metrics
        self.config = config
        self._grpc: grpc.Server | None = None
        self._https: list[ThreadingHTTPServer] = []
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------------- run
    def run(self) -> None:
        cfg = self.config
        interceptors = [_MetricsInterceptor(self.metrics)]
        fault_plane = getattr(
            getattr(self.server, "backend", None), "_kb_faults", None)
        if fault_plane is not None:
            # after metrics, so fault-aborted RPCs still reconcile
            interceptors.append(_FaultInterceptor(fault_plane))
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(max_workers=cfg.grpc_workers),
            options=[
                ("grpc.max_receive_message_length", 16 * 1024 * 1024),
                ("grpc.max_send_message_length", 16 * 1024 * 1024),
            ],
            interceptors=interceptors,
        )
        for h in self.server.grpc_handlers:
            self._grpc.add_generic_rpc_handlers((h,))
        bound = False
        if cfg.cert_file and cfg.key_file:
            creds = self._grpc_creds()
            if not self._grpc.add_secure_port(f"{cfg.host}:{cfg.client_port}", creds):
                raise RuntimeError(
                    f"failed to bind client port {cfg.host}:{cfg.client_port} (TLS)")
            bound = True
        if cfg.insecure or not bound:
            # add_*_port returns 0 on failure instead of raising; unchecked,
            # the process keeps running and "serves" with no listener
            if not self._grpc.add_insecure_port(f"{cfg.host}:{cfg.client_port}"):
                raise RuntimeError(
                    f"failed to bind client port {cfg.host}:{cfg.client_port}")
        self._grpc.start()

        routes = dict(self.server.http_handlers())
        routes["/metrics"] = self.metrics.http_handler()
        routes.update(cfg.extra_http)
        for port in {cfg.peer_port, cfg.info_port}:
            self._serve_http(port, routes)
        self.server.start_background()

    def _grpc_creds(self):
        cfg = self.config
        with open(cfg.key_file, "rb") as f:
            key = f.read()
        with open(cfg.cert_file, "rb") as f:
            cert = f.read()
        root = None
        if cfg.ca_file:
            with open(cfg.ca_file, "rb") as f:
                root = f.read()
        return grpc.ssl_server_credentials(
            [(key, cert)], root_certificates=root,
            require_client_auth=bool(root),
        )

    def _serve_http(self, port: int, routes: dict) -> None:
        handler = type("Handler", (_HttpHandler,), {"routes": routes})
        httpd = ThreadingHTTPServer((self.config.host, port), handler)
        if self.config.cert_file and self.config.key_file and not self.config.insecure:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.config.cert_file, self.config.key_file)
            httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
        t = threading.Thread(target=httpd.serve_forever, daemon=True, name=f"kb-http-{port}")
        t.start()
        self._https.append(httpd)
        self._threads.append(t)

    def wait(self) -> None:
        if self._grpc is not None:
            self._grpc.wait_for_termination()

    def close(self, grace: float = 1.0) -> None:
        if self._grpc is not None:
            self._grpc.stop(grace)
        for httpd in self._https:
            httpd.shutdown()
            httpd.server_close()
        self.server.close()
