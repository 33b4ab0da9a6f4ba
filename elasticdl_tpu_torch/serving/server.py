"""The serving front end (the port of the JAX package's
serving/server.py), over HTTP/1.1 from the standard library instead of
gRPC.

ServingServicer translates between the wire (PredictRequest /
PredictResponse, raw-bytes tensors; proto/serving.py) and the batcher's
ServingResult — it holds NO serving logic beyond decode/encode, so the
in-process client (proto/service.py InProcessServingClient) and a real
socket exercise identical code.  Status rides in-band as ServingCode:
overload/shutdown are expected outcomes, not transport failures.

ServingServer carries gRPC's unary calls on `http.server`:

- `POST /elasticdl_tpu.Serving/<method>` with the serialized request as
  the body; the methods are gRPC's, `predict` and `health`, and the
  method name is matched without regard to case (`/Predict` too);
- HTTP/1.1 keep-alive with `Content-Length`, so a client holds one
  connection per thread;
- HTTP 200 for every request that decodes, whatever its ServingCode; 400
  for a body that does not parse, 404 for another path, 503 once the
  server is stopping, 500 when the handler raises (a batcher that did not
  answer within `request_timeout_s`).

`stop()` drains in the JAX order: intake (no new request is read; those
in flight finish), then the batcher, then the reloader, then telemetry.
"""

from __future__ import annotations

import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import telemetry as telemetry_lib
from elasticdl_tpu_torch.common.export import SINGLE_FEATURE_KEY
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.proto.service import (
    SERVING_METHODS,
    SERVING_SERVICE_NAME,
)
from elasticdl_tpu_torch.serving import batcher as batcher_lib

logger = get_logger(__name__)

# ServingResult.code values coincide with the wire enum by construction
# (batcher.py) — asserted here so a drift in either is an import error,
# not a wrong status on the wire.
assert batcher_lib.OK == spb.SERVING_OK
assert batcher_lib.OVERLOADED == spb.SERVING_OVERLOADED
assert batcher_lib.SHUTTING_DOWN == spb.SERVING_SHUTTING_DOWN
assert batcher_lib.INVALID == spb.SERVING_INVALID
assert batcher_lib.INTERNAL == spb.SERVING_INTERNAL

CONTENT_TYPE = "application/x-protobuf"
# seconds an idle keep-alive connection stays open
IDLE_TIMEOUT_S = 300.0


def to_tensor_proto(arr: np.ndarray) -> spb.TensorProto:
    arr = np.ascontiguousarray(arr)
    return spb.TensorProto(
        dtype=str(arr.dtype),
        shape=list(arr.shape),
        data=arr.tobytes(),
    )


def from_tensor_proto(tp: spb.TensorProto) -> np.ndarray:
    """Decode a wire tensor; raises ValueError with a client-facing
    message on anything malformed (mapped to SERVING_INVALID)."""
    try:
        dtype = np.dtype(tp.dtype)
    except TypeError:
        raise ValueError(f"unknown tensor dtype {tp.dtype!r}")
    if dtype.hasobject:
        raise ValueError(f"object dtype {tp.dtype!r} is not servable")
    shape = tuple(int(d) for d in tp.shape)
    if any(d < 0 for d in shape):
        raise ValueError(f"negative dimension in shape {shape}")
    expected = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(tp.data) != expected:
        raise ValueError(
            f"tensor data is {len(tp.data)} bytes but shape {shape} "
            f"dtype {dtype} needs {expected}"
        )
    return np.frombuffer(tp.data, dtype=dtype).reshape(shape)


def decode_features(request: spb.PredictRequest) -> dict:
    if not request.inputs:
        raise ValueError("request has no input tensors")
    features = {}
    for named in request.inputs:
        if not named.name:
            raise ValueError("input tensor with empty name")
        if named.name in features:
            raise ValueError(f"duplicate input tensor {named.name!r}")
        features[named.name] = from_tensor_proto(
            named.tensor or spb.TensorProto())
    return features


def make_predict_request(features) -> spb.PredictRequest:
    """Client-side helper: dict of arrays (or one bare array, sent under
    the single-input key) -> PredictRequest."""
    if not isinstance(features, dict):
        features = {SINGLE_FEATURE_KEY: features}
    return spb.PredictRequest(
        inputs=[spb.NamedTensor(name=str(name),
                                tensor=to_tensor_proto(np.asarray(arr)))
                for name, arr in features.items()],
    )


class ServingServicer:
    """predict/health handlers; ServingServer routes the socket's
    requests to them and InProcessServingClient calls them directly."""

    def __init__(self, engine, batcher, reloader=None,
                 request_timeout_s: float = 30.0):
        self._engine = engine
        self._batcher = batcher
        self._reloader = reloader
        self._request_timeout_s = request_timeout_s

    def predict(self, request, context) -> spb.PredictResponse:
        # Trace context: a non-empty request_id means the caller sampled
        # this request in; it rides the batcher, stamps the span, and is
        # echoed on the response for client-side correlation.
        request_id = request.request_id
        clock = getattr(self._engine, "clock", None) or time.perf_counter
        decode_start = clock()
        try:
            features = decode_features(request)
        except ValueError as exc:
            if request_id:
                events.emit(
                    events.PREDICT_SPAN, request_id=request_id,
                    reason="invalid", code=int(spb.SERVING_INVALID),
                )
            return spb.PredictResponse(
                code=spb.SERVING_INVALID, error=str(exc),
                request_id=request_id,
            )
        # the port's own phase: wire tensors to arrays
        self._batcher.metrics.record_phase(
            "decode", max(0.0, clock() - decode_start))
        rows = int(next(iter(features.values())).shape[0])
        result = self._batcher.submit(
            features, request_id=request_id
        ).result(timeout=self._request_timeout_s)
        encode_start = clock()
        response = spb.PredictResponse(
            code=result.code, error=result.error,
            model_step=result.model_step, request_id=request_id,
        )
        if result.predictions is not None:
            response.predictions = to_tensor_proto(result.predictions)
        respond_s = max(0.0, clock() - encode_start)
        self._batcher.metrics.record_phase("respond", respond_s)
        if request_id:
            phases = dict(result.phases_s or {})
            phases["respond"] = respond_s
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="sampled", code=int(result.code),
                model_step=int(result.model_step), rows=rows,
                phases_s=phases,
            )
        return response

    def health(self, request, context) -> spb.HealthResponse:
        response = spb.HealthResponse(
            serving=True,
            model_step=self._engine.step,
            buckets=list(self._engine.buckets),
            queue_depth=self._batcher.queue_depth,
            compile_count=self._engine.compile_count,
        )
        metrics = dict(self._batcher.metrics.snapshot())
        metrics["swap_count"] = float(self._engine.swap_count)
        # producer wall-time stamp of the served checkpoint (absent when
        # unknown): end-to-end freshness rides the scalar-metric list
        produced = getattr(self._engine, "produced_unix_s", None)
        if produced is not None:
            metrics["produced_unix_s"] = float(produced)
        if self._reloader is not None:
            metrics["reload_count"] = float(self._reloader.reload_count)
            metrics["reload_rejected"] = float(
                self._reloader.rejected_count
            )
        response.metrics = [
            spb.ScalarMetric(name=name, value=float(metrics[name]))
            for name in sorted(metrics)
        ]
        return response


class _Intake:
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


def _handler_class(servicer, intake: _Intake, slots: threading.Semaphore):
    routes = {}
    for name, (request_cls, _) in SERVING_METHODS.items():
        routes[f"/{SERVING_SERVICE_NAME}/{name}".lower()] = (
            getattr(servicer, name), request_cls)

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
                except spb.DecodeError as exc:
                    self._error(400, f"malformed {request_cls.__name__}: "
                                     f"{exc}")
                    return
                with slots:
                    try:
                        response = handler(request, None)
                    except Exception as exc:   # answered as HTTP 500
                        logger.exception("serving handler %s failed",
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


class ServingServer:
    """Owns the HTTP server plus the batcher/reloader lifecycle.
    `workers` bounds the requests handled at once (the JAX server's gRPC
    thread pool); each connection has its own thread."""

    def __init__(self, engine, batcher, reloader=None, workers: int = 16,
                 request_timeout_s: float = 30.0,
                 telemetry_port: Optional[int] = 0,
                 host: str = "0.0.0.0"):
        self._engine = engine
        self._batcher = batcher
        self._reloader = reloader
        self.servicer = ServingServicer(
            engine, batcher, reloader,
            request_timeout_s=request_timeout_s,
        )
        self._workers = workers
        self._host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._intake: Optional[_Intake] = None
        self.port: Optional[int] = None
        self._telemetry_port = telemetry_port
        self.telemetry: Optional[telemetry_lib.TelemetryServer] = None

    @property
    def engine(self):
        return self._engine

    @property
    def batcher(self):
        return self._batcher

    @property
    def reloader(self):
        return self._reloader

    def telemetry_registries(self) -> list:
        """All registries this role exposes on /metrics: the process-wide
        default plus each per-component registry."""
        registries = [metrics_lib.default_registry()]
        registry = getattr(self._batcher, "metrics", None)
        if registry is not None:
            registries.append(registry.registry)
        engine_registry = getattr(self._engine, "metrics_registry", None)
        if engine_registry is not None:
            registries.append(engine_registry)
        if self._reloader is not None:
            registries.append(self._reloader.metrics_registry)
        return registries

    def _start_telemetry(self) -> None:
        if self._telemetry_port is None or self.telemetry is not None:
            return
        self.telemetry = telemetry_lib.TelemetryServer(
            registries=self.telemetry_registries(),
            role="serving",
            port=self._telemetry_port,
            host=self._host,
            healthz_fn=lambda: {
                "model_step": int(self._engine.step),
                "queue_depth": int(self._batcher.queue_depth),
            },
            varz_fn=lambda: {"serving_port": self.port},
        )
        self.telemetry.start()

    def start(self, port: int = 0) -> int:
        """Bind (port 0 = ephemeral), start serving; returns the port."""
        self._intake = _Intake()
        handler = _handler_class(
            self.servicer, self._intake,
            threading.BoundedSemaphore(self._workers))
        self._httpd = ThreadingHTTPServer((self._host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        if self._reloader is not None:
            self._reloader.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)
        self._thread.start()
        self._start_telemetry()
        logger.info("serving on port %d", self.port)
        return self.port

    def stop(self, grace: float = 5.0) -> None:
        """Drain order: stop intake (the socket), drain the batcher, stop
        the reloader, stop telemetry — requests in flight complete
        before the process exits."""
        if self._httpd is not None:
            self._httpd.shutdown()          # no new connections
            self._intake.drain(grace)       # in-flight requests finish
            self._httpd.server_close()
            self._thread.join(timeout=grace)
            self._httpd = None
            self._thread = None
        self._batcher.shutdown()
        if self._reloader is not None:
            self._reloader.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None

    def wait(self) -> None:
        """Block until stop() (from another thread) ends the server."""
        thread = self._thread
        while thread is not None and thread.is_alive():
            thread.join(timeout=1.0)
