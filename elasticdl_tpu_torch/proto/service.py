"""Clients of the master and serving servicers (the port's copy of the
JAX package's proto/service.py, its method tables and clients).

- `InProcessMasterClient` and `InProcessServingClient` call a servicer
  directly, with no socket and no serialization: `client.get_task(req)`
  is `servicer.get_task(req, None)`.  The Local runner's master and
  workers share a process; tests and in-process benches drive serving
  the same way.
- `ServingStub` calls a serving server (serving/server.py) and
  `MasterStub` a master (master/server.py) over HTTP/1.1 from the
  standard library, where the JAX stubs speak gRPC: `POST
  /elasticdl_tpu.<Service>/<method>` with the serialized request as the
  body, the serialized response back.  Each stub and its in-process
  client are interchangeable.

Fault points and retries (`common/faults`, `common/resilience`), as in
the JAX package: each client fires the method's point
(`METHOD_FAULT_POINTS`, `SERVING_METHOD_FAULT_POINTS`) before every
attempt, so a chaos schedule drives the in-process path and the socket
alike.  The in-process clients do not retry: an exception, an injected
one included, reaches the caller unchanged (a Local job's
`TaskDataService` retries `get_task` and `report_task_result` itself).
A stub given a `retry_policy` retries a call under it, as the JAX
`MasterStub` does (an injected fault, a refused or reset connection, a
socket timeout, HTTP 503 and 504 retry).

`FleetRouter` fans Predict requests out over serving replicas, one
client per replica (a `ServingStub` or an `InProcessServingClient`), as
the JAX package's router does: deterministic ranking, sweeps under the
resilience policy, freshness scoring and every-k-th trace sampling.
"""

from __future__ import annotations

import http.client
import threading
import time
from typing import Optional

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common import metrics as _metrics
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import serving as spb

SERVICE_NAME = "elasticdl_tpu.Master"
SERVING_SERVICE_NAME = "elasticdl_tpu.Serving"

# method name -> (request class, response class)
MASTER_METHOD_TYPES = {
    "get_task": (pb.GetTaskRequest, pb.GetTaskResponse),
    "get_spmd_task": (pb.GetSpmdTaskRequest, pb.SpmdTaskResponse),
    "report_task_result": (pb.ReportTaskResultRequest, pb.Empty),
    "report_evaluation_metrics": (pb.ReportEvaluationMetricsRequest,
                                  pb.Empty),
    "report_version": (pb.ReportVersionRequest, pb.Empty),
    "get_cluster_spec": (pb.GetClusterSpecRequest, pb.ClusterSpec),
    "keep_alive": (pb.KeepAliveRequest, pb.Empty),
}
MASTER_METHODS = tuple(MASTER_METHOD_TYPES)

# method name -> fault-injection point (common/faults.py), the JAX
# package's table
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


class HttpRpcError(RuntimeError):
    """The server answered with an HTTP status other than 200: 400 (the
    request did not parse), 404, 500 (the handler raised) or 503 (the
    server is stopping).  In-band codes are not errors."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServingRpcError(HttpRpcError):
    """A serving server's HTTP error."""


class MasterRpcError(HttpRpcError):
    """A master's HTTP error."""


class _HttpStub:
    """Client of an HTTP RPC server (common/http_rpc.py) at `target`
    ("host:port").  Each thread that calls the stub holds its own
    persistent connection; a call that fails closes it, and the next call
    opens a new one.  `timeout` (per call, else the stub's default)
    bounds the connect and each socket read and write, in seconds; None
    waits forever, unless a `retry_policy` gives an `attempt_timeout_s`.
    Every attempt fires the method's fault point."""

    _service = ""
    _methods: dict = {}
    _fault_points: dict = {}
    _error = HttpRpcError

    def __init__(self, target: str, timeout: Optional[float] = None,
                 retry_policy=None):
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"target {target!r} is not host:port")
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
                self._fault_points.get(name), retry_policy, name)
            for name in self._methods}

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
        response_cls = self._methods[name][1]
        if timeout is None:
            timeout = self._timeout
        if timeout is None and self._retry_policy is not None:
            timeout = self._retry_policy.attempt_timeout_s
        body = request.SerializeToString()
        conn = self._connection(timeout)
        try:
            conn.request("POST", f"/{self._service}/{name}", body,
                         headers={"Content-Type": "application/x-protobuf"})
            reply = conn.getresponse()
            data = reply.read()
        except BaseException:
            self._drop(conn)
            raise
        if reply.will_close:
            self._drop(conn)
        if reply.status != 200:
            raise self._error(reply.status,
                              data.decode("utf-8", "replace"))
        return response_cls.FromString(data)

    def close(self) -> None:
        """Close every thread's connection."""
        with self._lock:
            connections = list(self._connections)
            self._connections.clear()
        for conn in connections:
            conn.close()


class ServingStub(_HttpStub):
    """Client of a ServingServer.  Fault points `rpc.predict` and
    `rpc.health_probe`."""

    _service = SERVING_SERVICE_NAME
    _methods = SERVING_METHODS
    _fault_points = SERVING_METHOD_FAULT_POINTS
    _error = ServingRpcError

    def predict(self, request: spb.PredictRequest,
                timeout: Optional[float] = None) -> spb.PredictResponse:
        return self._calls["predict"](request, timeout)

    def health(self, request: spb.HealthRequest,
               timeout: Optional[float] = None) -> spb.HealthResponse:
        return self._calls["health"](request, timeout)


class MasterStub(_HttpStub):
    """Client of a master's server (master/server.py): one method per
    entry of MASTER_METHODS, each taking (request, timeout=None), as the
    in-process client does."""

    _service = SERVICE_NAME
    _methods = MASTER_METHOD_TYPES
    _fault_points = METHOD_FAULT_POINTS
    _error = MasterRpcError

    def __init__(self, target: str, timeout: Optional[float] = None,
                 retry_policy=None):
        super().__init__(target, timeout=timeout, retry_policy=retry_policy)
        for name, call in self._calls.items():
            setattr(self, name, call)


# Router-side fan-out counters: how often a request left its first-choice
# replica, and why.  Shared across router instances on purpose — the
# cluster-wide view is the one `elasticdl top` and the bench read.
_fleet_requests_counter = _metrics.default_registry().counter(
    "rpc_fleet_requests_total",
    "Predict requests entering the fleet router",
)
_fleet_failovers_counter = _metrics.default_registry().counter(
    "rpc_fleet_failovers_total",
    "requests re-offered to another replica, by reason",
    labelnames=("reason",),
)
_fleet_request_errors_counter = _metrics.default_registry().counter(
    "rpc_fleet_request_errors_total",
    "Predict requests that failed after every replica and retry was "
    "exhausted — the bad events of the predict_availability SLO",
)
_fleet_sheds_counter = _metrics.default_registry().counter(
    "rpc_fleet_sheds_total",
    "requests the whole fleet shed (admission control answered for "
    "every replica) — with rpc_fleet_requests_total, the windowed shed "
    "ratio the serving policy engine and the backpressure signal read",
)
_fleet_route_histogram = _metrics.default_registry().histogram(
    "rpc_fleet_route_seconds",
    "router-side end-to-end Predict latency (the `route` phase of the "
    "request span: sweeps + backoff until a response or exhaustion)",
)

#: In-band codes the router treats as routing signals: the replica is up
#: but refusing load, so re-offer elsewhere — never re-offer through the
#: retry interceptor (that would re-load a shedding server).
SHED_CODES = (spb.SERVING_OVERLOADED, spb.SERVING_SHUTTING_DOWN)


class FleetRouter:
    """Client-side Predict fan-out across serving replicas
    (docs/SERVING.md "Fleet").

    Holds one client per replica id — `ServingStub` or
    `InProcessServingClient`, the transports are interchangeable — and
    routes every request through the unified resilience policy
    (common/resilience.py): `predict()` wraps a single sweep of the
    fleet in `retry_policy.call`, so the public entry point is the
    interceptor (scripts/check_no_naked_retries.py enforces this shape).

    Failure semantics, per sweep:

    - A transport error (killed replica, injected fault) demotes the
      replica and moves on to the next candidate.  Only when EVERY
      replica errors does the sweep raise — the policy then backs off
      and re-sweeps, so a replica kill costs retries, not client errors.
    - In-band OVERLOADED / SHUTTING_DOWN responses are routing signals,
      not errors: the shedding replica is demoted and the request is
      offered to at most one other replica per candidate; when the whole
      fleet sheds, the shed response is returned as-is (rerouting must
      not turn admission control into a retry storm).
    - Ranking is deterministic (no RNG): demotion bucket first, then the
      batcher fill-ratio bucket fed by `observe_health()` (the fleet
      manager's probe loop scrapes it from each replica's Health RPC),
      with round-robin rotation breaking ties — so equal replicas share
      load and a loaded replica drains before it sheds.
    """

    def __init__(self, clients=None, retry_policy=None, freshness=None,
                 trace_sample_rate: float = 1.0, clock=time.monotonic):
        if retry_policy is None:
            from elasticdl_tpu_torch.common.resilience import default_policy

            retry_policy = default_policy()
        self._retry_policy = retry_policy
        # master/freshness.py FreshnessTracker: when present, every
        # successful response's echoed model_step is scored against the
        # latest produced checkpoint (train-to-serve staleness)
        self._freshness = freshness
        self._lock = threading.Lock()
        self._clients = dict(clients or {})
        self._penalty = {rid: 0 for rid in self._clients}
        self._fill = {rid: 0.0 for rid in self._clients}
        self._down = set()
        self._steps = {}
        self._produced = {}
        self._rr = 0
        self._max_skew = 0
        self._failovers = {"error": 0, "overloaded": 0, "shutdown": 0}
        self._requests = 0
        self._sheds = 0
        self._last_staleness = (0, 0.0)
        # Trace context (docs/OBSERVABILITY.md "Request tracing"): ids
        # come off a monotonic per-router counter — deterministic under
        # the fault harness, unlike uuid/wall-clock — and sampling is the
        # deterministic every-k'th request for the same reason.  k=0
        # (rate<=0) disables sampling; errors/sheds/failovers are
        # captured regardless (the always-on forensic path).
        rate = max(0.0, min(1.0, float(trace_sample_rate)))
        self._trace_every = int(round(1.0 / rate)) if rate > 0 else 0
        self._seq = 0
        self._clock = clock

    # ---- fleet membership (driven by the ServingFleetManager) ---------

    def set_client(self, replica_id, client) -> None:
        """Install or replace the client for one replica (a relaunch
        hands the router a fresh transport and a clean slate)."""
        with self._lock:
            self._clients[replica_id] = client
            self._penalty[replica_id] = 0
            self._fill.setdefault(replica_id, 0.0)
            self._down.discard(replica_id)

    def remove_client(self, replica_id) -> None:
        with self._lock:
            self._clients.pop(replica_id, None)
            self._penalty.pop(replica_id, None)
            self._fill.pop(replica_id, None)
            self._steps.pop(replica_id, None)
            self._produced.pop(replica_id, None)
            self._down.discard(replica_id)

    def mark_down(self, replica_id) -> None:
        """Probe-driven: stop offering traffic until `set_client` or
        `mark_live` readmits the replica."""
        with self._lock:
            self._down.add(replica_id)

    def mark_live(self, replica_id) -> None:
        with self._lock:
            self._down.discard(replica_id)
            if replica_id in self._clients:
                # a probe racing remove_client must not resurrect a
                # penalty bucket for a retired replica
                self._penalty[replica_id] = 0

    def observe_health(self, replica_id, fill_ratio=0.0, queue_depth=0,
                       model_step=None, produced_unix_s=None) -> None:
        """Feed one probe result into the ranking (fill-ratio weighting)
        and the cross-replica skew/freshness bookkeeping.
        `produced_unix_s` is the producer stamp the replica's engine
        carries for its served checkpoint (end-to-end freshness)."""
        del queue_depth  # fill-ratio is the load signal; depth rides along
        with self._lock:
            if replica_id not in self._clients:
                return
            self._fill[replica_id] = float(fill_ratio)
            if model_step is not None:
                self._note_step_locked(replica_id, int(model_step))
            if produced_unix_s is not None:
                self._produced[replica_id] = float(produced_unix_s)

    def replica_ids(self):
        with self._lock:
            return sorted(self._clients)

    # ---- skew observation ---------------------------------------------

    def _note_step_locked(self, replica_id, step: int) -> None:
        self._steps[replica_id] = step
        live = [s for r, s in self._steps.items() if r in self._clients]
        if len(live) > 1:
            self._max_skew = max(self._max_skew, max(live) - min(live))

    def observed_step_skew(self) -> int:
        """Current max-min `model_step` across replicas, from the steps
        echoed in responses and probes."""
        with self._lock:
            live = [s for r, s in self._steps.items() if r in self._clients]
            return max(live) - min(live) if len(live) > 1 else 0

    @property
    def max_observed_step_skew(self) -> int:
        with self._lock:
            return self._max_skew

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": len(self._clients),
                "down": sorted(self._down),
                "requests": self._requests,
                "sheds": self._sheds,
                "failovers": dict(self._failovers),
                "max_model_step_skew": self._max_skew,
                "last_staleness_steps": self._last_staleness[0],
                "last_staleness_seconds": self._last_staleness[1],
                "produced_unix_s": dict(self._produced),
            }

    # ---- routing ------------------------------------------------------

    def _ranked(self):
        """Candidate order for one sweep: demotion bucket, then fill
        bucket, round-robin rotation within equal buckets.  All-down
        fleets still return candidates — a stale down-mark must not turn
        into an outage when the replicas are actually back."""
        with self._lock:
            rids = [r for r in sorted(self._clients) if r not in self._down]
            if not rids:
                rids = sorted(self._clients)
            if not rids:
                return []
            offset = self._rr % len(rids)
            self._rr += 1
            rotated = rids[offset:] + rids[:offset]
            return sorted(
                rotated,
                key=lambda r: (
                    min(self._penalty.get(r, 0), 3),
                    round(self._fill.get(r, 0.0), 1),
                ),
            )

    def _sweep(self, request, timeout=None):
        """One pass over the ranked fleet; raises (retryably) only when
        every replica failed at the transport layer."""
        order = self._ranked()
        if not order:
            raise ConnectionError("fleet router has no serving replicas")
        shed_response = None
        last_error = None
        for rid in order:
            with self._lock:
                client = self._clients.get(rid)
            if client is None:
                continue
            try:
                response = client.predict(request, timeout=timeout)
            except Exception as exc:  # transport/injected: demote, move on
                last_error = exc
                with self._lock:
                    # a replica retired while its call was in flight
                    # must not get a resurrected penalty bucket
                    if rid in self._clients:
                        self._penalty[rid] = self._penalty.get(rid, 0) + 1
                    self._failovers["error"] += 1
                _fleet_failovers_counter.labels(reason="error").inc()
                continue
            if response.code in SHED_CODES:
                reason = (
                    "overloaded"
                    if response.code == spb.SERVING_OVERLOADED
                    else "shutdown"
                )
                with self._lock:
                    if rid in self._clients:
                        self._penalty[rid] = self._penalty.get(rid, 0) + 1
                    self._failovers[reason] += 1
                _fleet_failovers_counter.labels(reason=reason).inc()
                shed_response = response
                continue
            with self._lock:
                if rid in self._clients:
                    self._penalty[rid] = 0
                    self._note_step_locked(rid, int(response.model_step))
            if self._freshness is not None:
                steps, seconds = self._freshness.observe_response(
                    int(response.model_step)
                )
                with self._lock:
                    self._last_staleness = (steps, round(seconds, 6))
            return response
        if shed_response is not None:
            return shed_response
        if last_error is None:
            # Every candidate was retired mid-sweep (scale_down racing
            # this request): retryable, the next sweep sees the new
            # membership — never `raise None`.
            raise ConnectionError(
                "no serving replica survived the sweep"
            )
        raise last_error

    def predict(self, request, timeout=None):
        """Route one Predict through the resilience policy: each attempt
        is a full fleet sweep, so backoff only happens when no replica
        could take the request at all.

        Every request gets a deterministic `request_id`; sampled-in
        requests carry it on the wire (the replica stamps its span
        against it), and the router emits its own span — always for
        errors/sheds/failovers, per `trace_sample_rate` otherwise."""
        _fleet_requests_counter.inc()
        with self._lock:
            self._seq += 1
            self._requests += 1
            seq = self._seq
            failovers_before = sum(self._failovers.values())
        sampled = self._trace_every > 0 and seq % self._trace_every == 0
        request_id = f"rq-{seq:08d}"
        if hasattr(request, "request_id"):
            # always (re)stamp: a caller-reused request proto must not
            # ride the wire with the previous call's trace context
            request.request_id = request_id if sampled else ""
        route_start = self._clock()
        try:
            response = self._retry_policy.call(
                lambda: self._sweep(request, timeout=timeout),
                description="fleet_predict",
            )
        except Exception as exc:
            _fleet_request_errors_counter.inc()
            route_s = max(0.0, self._clock() - route_start)
            _fleet_route_histogram.record(route_s)
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="error", error=type(exc).__name__,
                phases_s={"route": route_s},
            )
            raise
        route_s = max(0.0, self._clock() - route_start)
        _fleet_route_histogram.record(route_s)
        if hasattr(response, "request_id") and not response.request_id:
            response.request_id = request_id
        with self._lock:
            failed_over = sum(self._failovers.values()) > failovers_before
        phases = {"route": route_s}
        if response.code in SHED_CODES:
            _fleet_sheds_counter.inc()
            with self._lock:
                self._sheds += 1
            # whole-fleet shed: admission control spoke — always capture
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="shed", code=int(response.code), phases_s=phases,
            )
        elif response.code == spb.SERVING_INVALID:
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="invalid", code=int(response.code), phases_s=phases,
            )
        elif response.code == spb.SERVING_INTERNAL:
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="internal", code=int(response.code),
                phases_s=phases,
            )
        elif failed_over:
            # served OK but not by the first choice: capture the hop
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="failover", code=int(response.code),
                phases_s=phases,
            )
        elif sampled:
            events.emit(
                events.PREDICT_SPAN, request_id=request_id,
                reason="sampled", code=int(response.code),
                phases_s=phases,
            )
        return response
