"""Unary calls over HTTP/1.1 from the standard library: the port's
stand-in for the gRPC servers of the JAX package (the card's machine has
no grpc).  The serving front end (serving/server.py) and the master
(master/server.py) both serve through `HttpRpcServer`.

- `POST /<service>/<method>` with the serialized request as the body;
  method paths match without regard to case;
- HTTP/1.1 keep-alive with `Content-Length`, so a client holds one
  connection per thread;
- HTTP 200 for every request that decodes and whose handler returns; 400
  for a body that does not parse (`DecodeError`), 404 for another path,
  503 once the server is stopping, 500 when the handler raises.

`stop(grace)` drains: no new connection is accepted and no new request
is read, the requests in flight finish (for at most `grace` seconds),
then every connection is shut.
"""

from __future__ import annotations

import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto.serving import DecodeError

logger = get_logger(__name__)

CONTENT_TYPE = "application/x-protobuf"
# seconds an idle keep-alive connection stays open
IDLE_TIMEOUT_S = 300.0

# lower-cased path -> (handler(request, context) -> response, request class)
Routes = Dict[str, Tuple[Callable, type]]


class Intake:
    """The server's open connections and in-flight requests, so stop()
    can refuse new requests, let the running ones finish, and then
    close the idle keep-alive connections."""

    def __init__(self):
        self._cond = threading.Condition()
        self._in_flight = 0
        self._connections = set()
        self.stopping = False

    def opened(self, conn) -> None:
        with self._cond:
            self._connections.add(conn)

    def closed(self, conn) -> None:
        with self._cond:
            self._connections.discard(conn)

    def begin(self) -> bool:
        with self._cond:
            if self.stopping:
                return False
            self._in_flight += 1
            return True

    def end(self) -> None:
        with self._cond:
            self._in_flight -= 1
            self._cond.notify_all()

    def drain(self, grace: float) -> None:
        """Refuse new requests, wait up to `grace` seconds for the ones
        in flight, then shut every connection."""
        deadline = time.monotonic() + grace
        with self._cond:
            self.stopping = True
            while self._in_flight:
                left = deadline - time.monotonic()
                if left <= 0:
                    logger.warning("stopping with %d requests in flight",
                                   self._in_flight)
                    break
                self._cond.wait(left)
            connections = list(self._connections)
        for conn in connections:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass   # the peer closed it already


def routes_for(service: str, servicer, methods) -> Routes:
    """The routes of `servicer`'s `methods` ({name: request class})
    under `/<service>/<name>`."""
    return {f"/{service}/{name}".lower(): (getattr(servicer, name), cls)
            for name, cls in methods.items()}


def handler_class(routes: Routes, intake: Intake,
                  slots: threading.Semaphore):
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"      # keep-alive
        disable_nagle_algorithm = True     # headers and body go at once
        timeout = IDLE_TIMEOUT_S           # an idle connection closes

        def setup(self):
            super().setup()
            intake.opened(self.connection)

        def finish(self):
            intake.closed(self.connection)
            super().finish()

        def _reply(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if status == 503:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _error(self, status: int, message: str) -> None:
            self._reply(status, message.encode("utf-8", "replace"),
                        "text/plain; charset=utf-8")

        def do_POST(self):  # noqa: N802 (http.server API)
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                         0)))
            route = routes.get(self.path.lower())
            if route is None:
                self._error(404, f"unknown method {self.path}")
                return
            if not intake.begin():
                self._error(503, "server is stopping")
                return
            try:
                handler, request_cls = route
                try:
                    request = request_cls.FromString(body)
                except DecodeError as exc:
                    self._error(400, f"malformed {request_cls.__name__}: "
                                     f"{exc}")
                    return
                with slots:
                    try:
                        response = handler(request, None)
                    except Exception as exc:   # answered as HTTP 500
                        logger.exception("rpc handler %s failed",
                                         self.path)
                        self._error(500, f"{type(exc).__name__}: {exc}")
                        return
                self._reply(200, response.SerializeToString(),
                            CONTENT_TYPE)
            finally:
                intake.end()

        def log_message(self, fmt, *args):
            pass   # one line per request would swamp the log

    return _Handler


class HttpRpcServer:
    """Serves `routes` on `host`; `workers` bounds the requests handled
    at once (a gRPC server's thread pool); each connection has its own
    thread."""

    def __init__(self, routes: Routes, workers: int = 16,
                 host: str = "0.0.0.0", name: str = "rpc-http"):
        self._routes = routes
        self._workers = workers
        self._host = host
        self._name = name
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._intake: Optional[Intake] = None
        self.port: Optional[int] = None

    def start(self, port: int = 0) -> int:
        """Bind (port 0 = ephemeral), start serving; returns the port."""
        self._intake = Intake()
        handler = handler_class(self._routes, self._intake,
                                threading.BoundedSemaphore(self._workers))
        self._httpd = ThreadingHTTPServer((self._host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=self._name,
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self, grace: float = 5.0) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()          # no new connections
        self._intake.drain(grace)       # in-flight requests finish
        self._httpd.server_close()
        self._thread.join(timeout=grace)
        self._httpd = None
        self._thread = None

    def wait(self) -> None:
        """Block until stop() (from another thread) ends the server."""
        thread = self._thread
        while thread is not None and thread.is_alive():
            thread.join(timeout=1.0)
