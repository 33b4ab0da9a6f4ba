"""Dynamic micro-batcher: admission control + batch assembly for serving
(the port's copy of the JAX package's serving/batcher.py, which never
touches a device: the engine does).

Requests land on a bounded row queue; a single dispatch thread gathers
them into the largest batch that fits a bucket, cutting either when
`max_batch` rows are ready or when the OLDEST queued request has waited
`max_latency_s` (latency cutoff beats fill: an idle service answers a
lone request within one deadline, never waiting for traffic that may not
come).  The engine pads the gathered rows to the nearest bucket, so the
batch-fill ratio (`rows / bucket`) is the efficiency metric — exported
through health and the serving bench.

Overload policy is shed-at-admission: when the queue is full the request
completes IMMEDIATELY with OVERLOADED instead of queueing into a
deadline it cannot meet.  Clients see an explicit in-band status
(serving.proto ServingCode) and can back off; latency of accepted
requests stays bounded.

Oversized requests (rows > largest bucket) are split into bucket-sized
chunks that ride the queue independently and re-assemble on completion —
or are rejected up front with INVALID when `reject_oversized` is set
(deployments that want clients to respect the contract).  A response is
one checkpoint's forward: when a hot swap lands between a split
request's chunks, so that they ran on different steps, the whole request
runs again at the head of the queue.  (The JAX batcher answers such a
request with rows of two steps, labelled with the older one.)

Shutdown drains: queued requests complete, then later submissions get
SHUTTING_DOWN.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

# In-band status codes, value-for-value the serving.proto ServingCode
# enum (the proto module stays optional here: the batcher is usable —
# and unit-tested — without grpc/protobuf in the process).
OK = 0
OVERLOADED = 1
SHUTTING_DOWN = 2
INVALID = 3
INTERNAL = 4


@dataclass
class ServingResult:
    """What a submission resolves to; maps 1:1 onto PredictResponse."""

    code: int
    error: str = ""
    predictions: Optional[np.ndarray] = None
    model_step: int = 0
    # Trace context (docs/OBSERVABILITY.md "Request tracing"): the
    # request_id echoed from submit(), and per-phase durations
    # (queue_wait/batch_form/pad/compute/unpack) the span exporter and
    # the `serving_request_phase_seconds{phase}` histogram both read.
    request_id: str = ""
    phases_s: Optional[Dict[str, float]] = None


def _merge_phases(results) -> Optional[Dict[str, float]]:
    """Worst-case per-phase durations across split-request chunks — the
    chunk that waited longest is the one the caller experienced."""
    merged: Dict[str, float] = {}
    for r in results:
        for phase, seconds in (r.phases_s or {}).items():
            merged[phase] = max(merged.get(phase, 0.0), seconds)
    return merged or None


@dataclass
class _Item:
    features: Dict[str, np.ndarray]
    rows: int
    future: Future
    enqueued_at: float
    request_id: str = ""
    # for split oversized requests: (aggregate, chunk_index)
    aggregate: Optional["_Aggregate"] = None
    chunk_index: int = 0


@dataclass
class _Aggregate:
    """Re-assembles a split oversized request in chunk order; `rerun`
    re-queues all of it when its chunks ran on different steps."""

    future: Future
    pending: int
    features: dict
    rows: int
    request_id: str
    rerun: Callable[["_Aggregate"], None]
    chunks: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def complete_chunk(self, index: int, result: ServingResult) -> None:
        with self.lock:
            self.chunks.append((index, result))
            self.pending -= 1
            if self.pending > 0:
                return
            chunks = sorted(self.chunks)
            self.chunks = []
        failed = [r for _, r in chunks if r.code != OK]
        if failed:
            self.future.set_result(failed[0])
            return
        if len({r.model_step for _, r in chunks}) > 1:
            self.rerun(self)
            return
        self.future.set_result(ServingResult(
            code=OK,
            predictions=np.concatenate(
                [r.predictions for _, r in chunks], axis=0
            ),
            model_step=chunks[0][1].model_step,
            request_id=chunks[0][1].request_id,
            phases_s=_merge_phases(r for _, r in chunks),
        ))


def _resolved(code: int, error: str = "") -> Future:
    f = Future()
    f.set_result(ServingResult(code=code, error=error))
    return f


class BatcherMetrics:
    """Registry-backed serving metrics (common/metrics.py): the registry
    holds the only copy of every counter, and the Health RPC, the serving
    bench, and the /metrics exposition all read it.  `snapshot()` keeps
    its historical keys so existing consumers (tests, bench, health
    probers) are unaffected by the storage change.

    Per-instance registry: each batcher's numbers are its own (many
    engines/batchers coexist in one test process); the serving server
    composes this registry into its telemetry surface."""

    def __init__(self, registry: Optional[metrics_lib.MetricsRegistry] = None):
        self.registry = registry or metrics_lib.MetricsRegistry()
        self._rows = self.registry.counter(
            "serving_batch_rows_total",
            "rows served successfully, summed over executed batches",
        )
        self._batches = self.registry.counter(
            "serving_batches_total", "batches executed on the engine"
        )
        self._fill_sum = self.registry.counter(
            "serving_batch_fill_sum_total",
            "sum of per-batch fill fractions rows/bucket; divide by "
            "serving_batches_total for the mean fill ratio",
        )
        self._rejected = self.registry.counter(
            "serving_requests_rejected_total",
            "requests resolved without serving, by reason",
            labelnames=("reason",),
        )
        self.latency = self.registry.histogram(
            "serving_batch_latency_seconds",
            "enqueue-to-completion latency per request row group",
        )
        self.phase = self.registry.histogram(
            "serving_request_phase_seconds",
            "per-request serve-path phase latency "
            "(queue_wait/batch_form/pad/compute/unpack/respond)",
            labelnames=("phase",),
        )
        self.registry.gauge_fn(
            "serving_batch_fill_ratio",
            self._mean_fill,
            "mean batch fill fraction (served rows / bucket capacity)",
        )

    def _mean_fill(self) -> float:
        batches = self._batches.value()
        return self._fill_sum.value() / batches if batches else 0.0

    def record_batch(self, rows: int, bucket: int) -> None:
        self._batches.inc()
        self._rows.inc(rows)
        self._fill_sum.inc(rows / bucket)

    def record_shed(self) -> None:
        self._rejected.labels(reason="shed").inc()

    def record_invalid(self) -> None:
        self._rejected.labels(reason="invalid").inc()

    def record_internal(self) -> None:
        self._rejected.labels(reason="internal").inc()

    def record_phase(self, phase: str, seconds: float) -> None:
        self.phase.labels(phase=phase).record(max(0.0, seconds))

    def snapshot(self) -> dict:
        lat = self.latency.snapshot()
        queue_wait = self.phase.labels(phase="queue_wait").snapshot()
        compute = self.phase.labels(phase="compute").snapshot()
        return {
            # per-phase serve latency (docs/OBSERVABILITY.md "Request
            # tracing"): rides Health RPC scalars so `elasticdl top`'s
            # fleet table can show overload without a trace dump
            "phase_queue_wait_p99_s": queue_wait["p99_s"],
            "phase_compute_p99_s": compute["p99_s"],
            "ok_rows": self._rows.value(),
            "batches": self._batches.value(),
            "batch_fill_ratio": self._mean_fill(),
            "shed": self._rejected.labels(reason="shed").value(),
            "invalid": self._rejected.labels(reason="invalid").value(),
            "internal": self._rejected.labels(reason="internal").value(),
            "latency_p50_s": lat["p50_s"],
            "latency_p99_s": lat["p99_s"],
            "latency_mean_s": lat["mean_s"],
        }


class DynamicBatcher:
    def __init__(
        self,
        engine,
        max_latency_s: float = 0.01,
        max_batch: Optional[int] = None,
        max_queue_rows: Optional[int] = None,
        reject_oversized: bool = False,
        clock=time.monotonic,
    ):
        self._engine = engine
        self._max_latency_s = float(max_latency_s)
        self._max_batch = int(max_batch or engine.max_bucket)
        if self._max_batch > engine.max_bucket:
            raise ValueError(
                f"max_batch={self._max_batch} exceeds largest engine "
                f"bucket {engine.max_bucket}"
            )
        # default queue bound: a few full batches of headroom — deep
        # queues only convert overload into latency, never into goodput
        self._max_queue_rows = int(
            max_queue_rows if max_queue_rows is not None
            else 4 * self._max_batch
        )
        self._reject_oversized = reject_oversized
        self._clock = clock
        # engines predating the tracing contract (or test fakes) may not
        # accept phase_out=; probe once and skip phase capture for them
        try:
            params = inspect.signature(engine.predict).parameters
            self._engine_traces = "phase_out" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            self._engine_traces = False
        self.metrics = BatcherMetrics()
        self.metrics.registry.gauge_fn(
            "serving_queue_depth_rows",
            lambda: self.queue_depth,
            "rows currently waiting in the batcher queue",
        )
        self._queue: deque = deque()
        self._queued_rows = 0
        self._cond = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="serving-batcher", daemon=True
        )
        self._thread.start()

    # ---- submission -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Rows currently queued (health metric)."""
        with self._cond:
            return self._queued_rows

    def submit(self, features: Dict[str, np.ndarray],
               request_id: str = "") -> Future:
        """Returns a Future resolving to ServingResult.  Never raises and
        never blocks: invalid/overload/shutdown resolve immediately.
        `request_id` is the router-minted trace context; it is echoed on
        the result and stamped into the per-request span."""
        error = self._engine.validate(features)
        if error is not None:
            self.metrics.record_invalid()
            return _resolved(INVALID, error)
        rows = int(next(iter(features.values())).shape[0])
        if rows > self._max_batch:
            if self._reject_oversized:
                self.metrics.record_invalid()
                return _resolved(
                    INVALID,
                    f"request of {rows} rows exceeds the batch limit "
                    f"{self._max_batch} "
                    "(oversized requests are rejected by policy)",
                )
            return self._submit_split(features, rows, request_id)
        return self._enqueue(features, rows, request_id)

    def _submit_split(self, features, rows: int,
                      request_id: str = "") -> Future:
        agg = _Aggregate(future=Future(), pending=0, features=features,
                         rows=rows, request_id=request_id,
                         rerun=self._rerun_split)
        # admission-check the WHOLE request before enqueuing any chunk:
        # partially admitting an oversized request sheds its own tail
        with self._cond:
            if self._stopped:
                return _resolved(SHUTTING_DOWN, "server is shutting down")
            if self._queued_rows + rows > self._max_queue_rows:
                self.metrics.record_shed()
                return _resolved(
                    OVERLOADED,
                    f"queue full ({self._queued_rows} rows queued)",
                )
            self._queue.extend(self._split_items(agg))
            self._queued_rows += rows
            self._cond.notify()
        return agg.future

    def _split_items(self, agg: _Aggregate) -> list:
        """`agg`'s request as max_batch-row chunk items, in order."""
        chunk, rows = self._max_batch, agg.rows
        agg.pending = (rows + chunk - 1) // chunk
        now = self._clock()
        return [
            _Item(features={k: v[lo:lo + chunk]
                            for k, v in agg.features.items()},
                  rows=min(chunk, rows - lo), future=Future(),
                  enqueued_at=now, request_id=agg.request_id,
                  aggregate=agg, chunk_index=i)
            for i, lo in enumerate(range(0, rows, chunk))
        ]

    def _rerun_split(self, agg: _Aggregate) -> None:
        """Queue all of a split request again, ahead of the rest (it was
        admitted once), after its chunks ran on different steps."""
        with self._cond:
            self._queue.extendleft(reversed(self._split_items(agg)))
            self._queued_rows += agg.rows
            self._cond.notify()

    def _enqueue(self, features, rows: int, request_id: str = "") -> Future:
        with self._cond:
            if self._stopped:
                return _resolved(SHUTTING_DOWN, "server is shutting down")
            if self._queued_rows + rows > self._max_queue_rows:
                self.metrics.record_shed()
                return _resolved(
                    OVERLOADED,
                    f"queue full ({self._queued_rows} rows queued)",
                )
            item = _Item(
                features=features, rows=rows, future=Future(),
                enqueued_at=self._clock(), request_id=request_id,
            )
            self._queue.append(item)
            self._queued_rows += rows
            self._cond.notify()
            return item.future

    # ---- dispatch -------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return  # stopped and drained
            self._execute(batch)

    def _gather(self):
        """Block until a batch is due: max_batch rows ready, or the
        oldest request's latency deadline has passed, or shutdown."""
        with self._cond:
            while True:
                if self._queue:
                    deadline = (
                        self._queue[0].enqueued_at + self._max_latency_s
                    )
                    if (
                        self._queued_rows >= self._max_batch
                        or self._clock() >= deadline
                        or self._stopped  # draining: don't wait out
                    ):                    # deadlines nobody benefits from
                        return self._pop_batch()
                    self._cond.wait(
                        timeout=max(0.0, deadline - self._clock())
                    )
                elif self._stopped:
                    return None
                else:
                    self._cond.wait()

    def _pop_batch(self):
        """Called under the lock: pop queued items that fit max_batch."""
        batch, rows = [], 0
        while self._queue and rows + self._queue[0].rows <= self._max_batch:
            item = self._queue.popleft()
            rows += item.rows
            batch.append(item)
        self._queued_rows -= rows
        return batch

    def _execute(self, batch) -> None:
        # Packed-payload clients (engine.packed_feature_spec ships id
        # planes as uint24 triples) may share the queue with native
        # ones; differently-shaped arrays can't concatenate, so run one
        # engine call per run of same-form items (arrival order kept).
        def form(item):
            return tuple(
                (k, np.asarray(item.features[k]).dtype.str,
                 np.asarray(item.features[k]).ndim)
                for k in sorted(item.features)
            )

        groups = []
        for item in batch:
            f = form(item)
            if groups and groups[-1][0] == f:
                groups[-1][1].append(item)
            else:
                groups.append((f, [item]))
        for _, group in groups:
            self._execute_uniform(group)

    def _execute_uniform(self, batch) -> None:
        rows = sum(item.rows for item in batch)
        # phase clock starts when the batch is cut: queue_wait ends
        # here, batch_form covers assembly, pad/compute/unpack come
        # back from the engine (docs/OBSERVABILITY.md "Request tracing")
        popped_at = self._clock()
        queue_waits = {
            id(item): max(0.0, popped_at - item.enqueued_at)
            for item in batch
        }
        for wait in queue_waits.values():
            self.metrics.record_phase("queue_wait", wait)
        features = {
            k: np.concatenate(
                [np.asarray(item.features[k]) for item in batch], axis=0
            )
            for k in batch[0].features
        }
        batch_form_s = max(0.0, self._clock() - popped_at)
        self.metrics.record_phase("batch_form", batch_form_s)
        engine_phases: Dict[str, float] = {}

        def item_phases(item):
            phases = {"queue_wait": queue_waits[id(item)],
                      "batch_form": batch_form_s}
            phases.update(engine_phases)
            return phases

        try:
            if self._engine_traces:
                preds, step = self._engine.predict(
                    features, rows, phase_out=engine_phases
                )
            else:
                preds, step = self._engine.predict(features, rows)
        except Exception as exc:  # engine failure: fail THIS batch only
            logger.exception("serving batch execution failed")
            self.metrics.record_internal()
            for item in batch:
                self._finish(item, ServingResult(
                    code=INTERNAL, error=f"execution failed: {exc}",
                    request_id=item.request_id,
                    phases_s=item_phases(item),
                ))
            return
        for phase, seconds in engine_phases.items():
            self.metrics.record_phase(phase, seconds)
        bucket = self._engine.bucket_for(rows)
        self.metrics.record_batch(rows, bucket)
        now = self._clock()
        offset = 0
        for item in batch:
            self.metrics.latency.record(max(0.0, now - item.enqueued_at))
            self._finish(item, ServingResult(
                code=OK,
                predictions=preds[offset:offset + item.rows],
                model_step=step,
                request_id=item.request_id,
                phases_s=item_phases(item),
            ))
            offset += item.rows

    @staticmethod
    def _finish(item: _Item, result: ServingResult) -> None:
        if item.aggregate is not None:
            item.aggregate.complete_chunk(item.chunk_index, result)
        else:
            item.future.set_result(result)

    # ---- lifecycle ------------------------------------------------------

    def shutdown(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work, drain everything queued, stop the
        dispatch thread.  Idempotent."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
