"""The serving front end (the port of the JAX package's
serving/server.py), over HTTP/1.1 from the standard library instead of
gRPC.

ServingServicer translates between the wire (PredictRequest /
PredictResponse, raw-bytes tensors; proto/serving.py) and the batcher's
ServingResult — it holds NO serving logic beyond decode/encode, so the
in-process client (proto/service.py InProcessServingClient) and a real
socket exercise identical code.  Status rides in-band as ServingCode:
overload/shutdown are expected outcomes, not transport failures.

ServingServer carries gRPC's unary calls on `http.server`
(common/http_rpc.py, which the master's transport shares):

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

import time
from typing import Optional

import numpy as np

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import telemetry as telemetry_lib
from elasticdl_tpu_torch.common.http_rpc import HttpRpcServer, routes_for
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
        # the scalars (the shed records are a list)
        metrics = self._batcher.metrics.snapshot()
        metrics.pop("sheds", None)
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
        self._rpc: Optional[HttpRpcServer] = None
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
        self._rpc = HttpRpcServer(
            routes_for(SERVING_SERVICE_NAME, self.servicer,
                       {name: classes[0]
                        for name, classes in SERVING_METHODS.items()}),
            workers=self._workers, host=self._host, name="serving-http")
        self.port = self._rpc.start(port)
        if self._reloader is not None:
            self._reloader.start()
        self._start_telemetry()
        logger.info("serving on port %d", self.port)
        return self.port

    def stop(self, grace: float = 5.0) -> None:
        """Drain order: stop intake (the socket), drain the batcher, stop
        the reloader, stop telemetry — requests in flight complete
        before the process exits."""
        if self._rpc is not None:
            self._rpc.stop(grace)
        self._batcher.shutdown()
        if self._reloader is not None:
            self._reloader.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None

    def wait(self) -> None:
        """Block until stop() (from another thread) ends the server."""
        if self._rpc is not None:
            self._rpc.wait()
