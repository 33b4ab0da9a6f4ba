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

Fault points and retries (`common/faults`, `common/resilience`), as in
the JAX package: each client fires the method's point
(`METHOD_FAULT_POINTS`, `SERVING_METHOD_FAULT_POINTS`) before every
attempt, so a chaos schedule drives the in-process path and the socket
alike.  The in-process clients do not retry: an exception, an injected
one included, reaches the caller unchanged (a Local job's
`TaskDataService` retries `get_task` and `report_task_result` itself).
A `ServingStub` given a `retry_policy` retries a call under it.
`FleetRouter` waits for the online loop (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import http.client
import threading
from typing import Optional

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.proto import serving as spb

SERVICE_NAME = "elasticdl_tpu.Master"
SERVING_SERVICE_NAME = "elasticdl_tpu.Serving"

MASTER_METHODS = (
    "get_task",
    "report_task_result",
    "report_evaluation_metrics",
    "report_version",
)

# method name -> fault-injection point (common/faults.py), the JAX
# package's table; the port's master serves the first four methods.
METHOD_FAULT_POINTS = {
    "get_task": faults.POINT_RPC_GET_TASK,
    "get_spmd_task": faults.POINT_RPC_GET_TASK,
    "report_task_result": faults.POINT_RPC_REPORT,
    "report_evaluation_metrics": faults.POINT_RPC_REPORT,
    "report_version": faults.POINT_RPC_REPORT,
    "get_cluster_spec": faults.POINT_RENDEZVOUS_JOIN,
    "keep_alive": faults.POINT_WORKER_HEARTBEAT,
}

# method name -> (request class, response class)
SERVING_METHODS = {
    "predict": (spb.PredictRequest, spb.PredictResponse),
    "health": (spb.HealthRequest, spb.HealthResponse),
}

# `health` has its own point, apart from the data path, so a schedule
# can flap a prober without touching predict traffic, or the reverse.
SERVING_METHOD_FAULT_POINTS = {
    "predict": faults.POINT_RPC_PREDICT,
    "health": faults.POINT_RPC_HEALTH_PROBE,
}


def _with_faults(attempt, point, retry_policy, name):
    """`attempt(request, timeout)` behind the method's fault point, fired
    once per attempt, and under `retry_policy` when one is given."""
    def fired(request, timeout):
        if point is not None:
            faults.fire(point)
        return attempt(request, timeout)

    if retry_policy is None:
        return lambda request, timeout=None: fired(request, timeout)
    return lambda request, timeout=None: retry_policy.call(
        lambda: fired(request, timeout), description=name)


class _InProcessClient:
    _methods: tuple = ()
    _fault_points: dict = {}

    def __init__(self, servicer):
        for name in self._methods:
            method = getattr(servicer, name)
            setattr(self, name, _with_faults(
                lambda request, timeout, _m=method: _m(request, None),
                self._fault_points.get(name), None, name))


class InProcessMasterClient(_InProcessClient):
    """Calls a MasterServicer directly."""

    _methods = MASTER_METHODS
    _fault_points = METHOD_FAULT_POINTS


class InProcessServingClient(_InProcessClient):
    """Direct-call twin of ServingStub, for tests and in-process
    benches."""

    _methods = tuple(SERVING_METHODS)
    _fault_points = SERVING_METHOD_FAULT_POINTS


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
    read and write, in seconds; None waits forever.

    Every attempt fires the method's fault point (`rpc.predict`,
    `rpc.health_probe`).  With a `retry_policy`, a call retries under it
    (common/resilience.py: an injected fault, a refused or reset
    connection, a socket timeout, HTTP 503 and 504 retry), and the
    policy's `attempt_timeout_s` bounds each attempt when the call gives
    no timeout of its own."""

    def __init__(self, target: str, timeout: Optional[float] = None,
                 retry_policy=None):
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"serving target {target!r} is not host:port")
        self._host = host.strip("[]")
        self._port = int(port)
        self._timeout = timeout
        self._local = threading.local()
        self._lock = threading.Lock()
        self._connections = set()
        self._retry_policy = retry_policy
        self._calls = {
            name: _with_faults(
                lambda request, timeout, _name=name: self._call(
                    _name, request, timeout),
                SERVING_METHOD_FAULT_POINTS[name], retry_policy, name)
            for name in SERVING_METHODS}

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
        if timeout is None:
            timeout = self._timeout
        if timeout is None and self._retry_policy is not None:
            timeout = self._retry_policy.attempt_timeout_s
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
        return self._calls["predict"](request, timeout)

    def health(self, request: spb.HealthRequest,
               timeout: Optional[float] = None) -> spb.HealthResponse:
        return self._calls["health"](request, timeout)

    def close(self) -> None:
        """Close every thread's connection."""
        with self._lock:
            connections = list(self._connections)
            self._connections.clear()
        for conn in connections:
            conn.close()
