"""Clients of the master and serving servicers (the port's copy of the
JAX package's proto/service.py, its method tables and clients).

- `InProcessMasterClient` and `InProcessServingClient` call a servicer
  directly, with no socket and no serialization: `client.get_task(req)`
  is `servicer.get_task(req, None)`.  The Local runner's master and
  workers share a process; tests and in-process benches drive serving
  the same way.
- `ServingStub` calls a serving server (serving/server.py) over HTTP/1.1
  from the standard library, where the JAX stub speaks gRPC: `POST
  /elasticdl_tpu.Serving/<method>` with the serialized request as the
  body, the serialized response back.  The stub and the in-process
  client are interchangeable.

The retry policy and the fault points (`common/resilience`,
`common/faults`) wait for the cluster slice of the port (ROADMAP.md
queue 1, item 12), and `FleetRouter` for the online loop (item 10).
Exceptions propagate to the caller unchanged.
"""

from __future__ import annotations

import http.client
import threading
from typing import Optional

from elasticdl_tpu_torch.proto import serving as spb

SERVICE_NAME = "elasticdl_tpu.Master"
SERVING_SERVICE_NAME = "elasticdl_tpu.Serving"

MASTER_METHODS = (
    "get_task",
    "report_task_result",
    "report_evaluation_metrics",
    "report_version",
)

# method name -> (request class, response class)
SERVING_METHODS = {
    "predict": (spb.PredictRequest, spb.PredictResponse),
    "health": (spb.HealthRequest, spb.HealthResponse),
}


class _InProcessClient:
    _methods: tuple = ()

    def __init__(self, servicer):
        for name in self._methods:
            setattr(self, name, self._bind(getattr(servicer, name)))

    @staticmethod
    def _bind(method):
        def call(request, timeout=None):
            return method(request, None)

        return call


class InProcessMasterClient(_InProcessClient):
    """Calls a MasterServicer directly."""

    _methods = MASTER_METHODS


class InProcessServingClient(_InProcessClient):
    """Direct-call twin of ServingStub, for tests and in-process
    benches."""

    _methods = tuple(SERVING_METHODS)


class ServingRpcError(RuntimeError):
    """The server answered with an HTTP status other than 200: 400 (the
    request did not parse), 404, 500 (the handler raised) or 503 (the
    server is stopping).  In-band codes are not errors."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServingStub:
    """Client of a ServingServer at `target` ("host:port").  Each thread
    that calls the stub holds its own persistent connection; a call that
    fails closes it, and the next call opens a new one.  `timeout` (per
    call, else the stub's default) bounds the connect and each socket
    read and write, in seconds; None waits forever."""

    def __init__(self, target: str, timeout: Optional[float] = None):
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"serving target {target!r} is not host:port")
        self._host = host.strip("[]")
        self._port = int(port)
        self._timeout = timeout
        self._local = threading.local()
        self._lock = threading.Lock()
        self._connections = set()

    def _connection(self, timeout) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=timeout)
            self._local.conn = conn
            with self._lock:
                self._connections.add(conn)
        elif conn.sock is not None:
            conn.sock.settimeout(timeout)
        else:
            conn.timeout = timeout
        return conn

    def _drop(self, conn) -> None:
        conn.close()
        self._local.conn = None
        with self._lock:
            self._connections.discard(conn)

    def _call(self, name: str, request, timeout):
        response_cls = SERVING_METHODS[name][1]
        timeout = self._timeout if timeout is None else timeout
        body = request.SerializeToString()
        conn = self._connection(timeout)
        try:
            conn.request("POST", f"/{SERVING_SERVICE_NAME}/{name}", body,
                         headers={"Content-Type": "application/x-protobuf"})
            reply = conn.getresponse()
            data = reply.read()
        except BaseException:
            self._drop(conn)
            raise
        if reply.will_close:
            self._drop(conn)
        if reply.status != 200:
            raise ServingRpcError(reply.status,
                                  data.decode("utf-8", "replace"))
        return response_cls.FromString(data)

    def predict(self, request: spb.PredictRequest,
                timeout: Optional[float] = None) -> spb.PredictResponse:
        return self._call("predict", request, timeout)

    def health(self, request: spb.HealthRequest,
               timeout: Optional[float] = None) -> spb.HealthResponse:
        return self._call("health", request, timeout)

    def close(self) -> None:
        """Close every thread's connection."""
        with self._lock:
            connections = list(self._connections)
            self._connections.clear()
        for conn in connections:
            conn.close()
