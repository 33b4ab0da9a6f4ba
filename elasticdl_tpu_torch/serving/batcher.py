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
runs again at the head of the queue, counted in
`serving_split_reruns_total`.  (The JAX batcher answers such a request
with rows of two steps, labelled with the older one.)  A split
request's chunks keep its first enqueue time across reruns and record
their latency once each, at its final answer, so every sample covers
the client's whole wait.

Shutdown drains: queued requests complete, then later submissions get
SHUTTING_DOWN.

The dispatch thread is always in one of four states, kept with the time
it entered it: `dispatch.empty` (nothing queued), `dispatch.held` (rows
queued, waiting out the oldest request's deadline), `dispatch.form`
(cutting and assembling a batch, answering the last one) and
`dispatch.engine` (inside the engine's predict).  Cumulative clocks of
the held and the busy (form + engine) time, read at each request's
enqueue and at its pop, split its `queue_wait` into `queue_held` (the
deadline), `queue_behind` (other batches) and `queue_wake` (the rest:
the thread late to wake for a due batch), which sum to it.  Every shed
keeps what the queue and the thread were doing (`BatcherMetrics.sheds`).
While a torch profiler records, the states, each request's `admit` and
`queue` spans and each `batch` go to the span recorder
(common/profiler.py `SPANS`), a late wake as `dispatch.wake`.
"""

from __future__ import annotations

import contextlib
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
from elasticdl_tpu_torch.common.profiler import SPANS, ns, torch_profiler

logger = get_logger(__name__)

# In-band status codes, value-for-value the serving.proto ServingCode
# enum (the proto module stays optional here: the batcher is usable —
# and unit-tested — without grpc/protobuf in the process).
OK = 0
OVERLOADED = 1
SHUTTING_DOWN = 2
INVALID = 3
INTERNAL = 4

# the dispatch thread's states (and their span names)
EMPTY = "dispatch.empty"
HELD = "dispatch.held"
FORM = "dispatch.form"
ENGINE = "dispatch.engine"
# a recorded held or empty span's tail, once a batch was due
WAKE = "dispatch.wake"
# not waiting: FORM or ENGINE (the split clocks' busy time)
BUSY = "busy"

# sheds kept for `BatcherMetrics.snapshot()["sheds"]`
SHEDS_KEPT = 64

# the engine call's context when no span is recorded
_UNTRACED = contextlib.nullcontext()


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


QUEUE_PHASES = ("queue_wait", "queue_held", "queue_behind", "queue_wake")


def _merge_phases(results) -> Optional[Dict[str, float]]:
    """Worst-case per-phase durations across split-request chunks — the
    chunk that waited longest is the one the caller experienced; the
    queue phases all come from the chunk that queued longest, so that
    its parts still sum to its wait."""
    merged: Dict[str, float] = {}
    longest: Dict[str, float] = {}
    for r in results:
        phases = r.phases_s or {}
        for phase, seconds in phases.items():
            merged[phase] = max(merged.get(phase, 0.0), seconds)
        if phases.get("queue_wait", -1.0) > longest.get("queue_wait", -1.0):
            longest = phases
    for phase in QUEUE_PHASES:
        if phase in longest:
            merged[phase] = longest[phase]
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
    # the batcher's held and busy clocks at the enqueue; at the pop, the
    # pop's time and the queue wait's seconds, all and held and behind
    held0: float = 0.0
    busy0: float = 0.0
    popped_at: float = 0.0
    queue_wait: float = 0.0
    queue_held: float = 0.0
    queue_behind: float = 0.0

    def queue_phases(self) -> Dict[str, float]:
        wait, held, behind = self.queue_wait, self.queue_held, \
            self.queue_behind
        return {"queue_wait": wait, "queue_held": held,
                "queue_behind": behind,
                "queue_wake": wait - held - behind}


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
    # the first enqueue: reruns keep it, so latency covers the whole wait
    enqueued_at: float
    # called with the chunk count before an OK answer is set
    answered: Callable[["_Aggregate", int], None]
    # the batcher's held and busy clocks at the first enqueue
    held0: float = 0.0
    busy0: float = 0.0
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
        self.answered(self, len(chunks))
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
        self._reruns = self.registry.counter(
            "serving_split_reruns_total",
            "split requests run again whole because their chunks ran on "
            "different steps (a hot swap between them)",
        )
        self.latency = self.registry.histogram(
            "serving_batch_latency_seconds",
            "enqueue-to-completion latency per request row group",
        )
        self.phase = self.registry.histogram(
            "serving_request_phase_seconds",
            "per-request serve-path phase latency "
            "(queue_wait = queue_held + queue_behind + queue_wake; "
            "batch_form/pad/compute/unpack/respond)",
            labelnames=("phase",),
        )
        # the queue phases' series, recorded a batch at a time (made at
        # the first batch, as `labels` makes a series at its first use)
        self._queue_phase: Optional[dict] = None
        # the newest sheds, each with the queue's and the dispatch
        # thread's state at the refusal
        self._sheds: deque = deque(maxlen=SHEDS_KEPT)
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

    def record_shed(self, record: Optional[dict] = None) -> None:
        """Count a shed; `record` is what the batcher saw at it."""
        self._rejected.labels(reason="shed").inc()
        if record is not None:
            self._sheds.append(record)

    @property
    def sheds(self) -> list:
        """The newest sheds' records, oldest first."""
        return list(self._sheds)

    def record_invalid(self) -> None:
        self._rejected.labels(reason="invalid").inc()

    def record_internal(self) -> None:
        self._rejected.labels(reason="internal").inc()

    def record_rerun(self) -> None:
        self._reruns.inc()

    def record_phase(self, phase: str, seconds: float) -> None:
        self.phase.labels(phase=phase).record(max(0.0, seconds))

    def record_queue_phases(self, items) -> None:
        """The queue phases of one batch's items (`_Item`), one
        histogram lock a phase."""
        series = self._queue_phase
        if series is None:
            series = self._queue_phase = {
                p: self.phase.labels(phase=p) for p in QUEUE_PHASES}
        wait, held, behind, wake = series.values()
        wait.record_many(max(0.0, i.queue_wait) for i in items)
        held.record_many(i.queue_held for i in items)
        behind.record_many(i.queue_behind for i in items)
        wake.record_many(max(0.0, i.queue_wait - i.queue_held
                             - i.queue_behind) for i in items)

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
            "split_reruns": self._reruns.value(),
            "latency_p50_s": lat["p50_s"],
            "latency_p99_s": lat["p99_s"],
            "latency_mean_s": lat["mean_s"],
            # not a scalar: the newest sheds' records (`sheds`)
            "sheds": self.sheds,
        }


class DynamicBatcher:
    def __init__(
        self,
        engine,
        max_latency_s: float = 0.01,
        max_batch: Optional[int] = None,
        max_queue_rows: Optional[int] = None,
        reject_oversized: bool = False,
        clock=time.perf_counter,
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
        # the phases' clock: time.perf_counter, the engine's and the span
        # recorder's, unless a test gives a fake
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
        now = clock()
        # Under the lock: whether the dispatch thread waits (EMPTY,
        # HELD) or not (BUSY, from a pop), since `_mark`; a held wait's
        # deadline, brought forward when the queue fills a batch; the
        # held and busy seconds up to `_mark` (the split clocks); and
        # whether the wait's span is recorded when it ends.
        self._wait = EMPTY
        self._mark = now
        self._held_until = now
        self._cum_held = 0.0
        self._cum_busy = 0.0
        self._wait_traced = False
        # The dispatch thread's own, written outside the lock: while
        # BUSY, FORM or ENGINE since `_busy_since` (written first), the
        # bucket inside the engine (0: none), and whether the busy
        # state's span is recorded when it ends.
        self._busy_since = now
        self._busy = FORM
        self._inflight = 0
        self._busy_traced = False
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
        traced = torch_profiler._is_profiler_enabled
        start = self._clock() if traced else None
        agg = _Aggregate(future=Future(), pending=0, features=features,
                         rows=rows, request_id=request_id,
                         rerun=self._rerun_split, enqueued_at=0.0,
                         answered=self._split_answered)
        # admission-check the WHOLE request before enqueuing any chunk:
        # partially admitting an oversized request sheds its own tail
        with self._cond:
            if self._stopped:
                return _resolved(SHUTTING_DOWN, "server is shutting down")
            queued = self._queued_rows
            if queued + rows > self._max_queue_rows:
                return self._shed(rows, request_id, start)
            now = agg.enqueued_at = self._clock()
            agg.held0, agg.busy0 = self._clocks_at(now)
            self._queue.extend(self._split_items(agg))
            self._queued_rows += rows
            self._due(now)
            self._cond.notify()
        if traced:
            self._admitted(start, now, queued, rows, request_id)
        return agg.future

    def _split_items(self, agg: _Aggregate) -> list:
        """`agg`'s request as max_batch-row chunk items, in order."""
        chunk, rows = self._max_batch, agg.rows
        agg.pending = (rows + chunk - 1) // chunk
        return [
            _Item(features={k: v[lo:lo + chunk]
                            for k, v in agg.features.items()},
                  rows=min(chunk, rows - lo), future=Future(),
                  enqueued_at=agg.enqueued_at, request_id=agg.request_id,
                  aggregate=agg, chunk_index=i, held0=agg.held0,
                  busy0=agg.busy0)
            for i, lo in enumerate(range(0, rows, chunk))
        ]

    def _rerun_split(self, agg: _Aggregate) -> None:
        """Queue all of a split request again, ahead of the rest (it was
        admitted once), after its chunks ran on different steps."""
        self.metrics.record_rerun()
        with self._cond:
            self._queue.extendleft(reversed(self._split_items(agg)))
            self._queued_rows += agg.rows
            self._cond.notify()

    def _split_answered(self, agg: _Aggregate, chunks: int) -> None:
        """A split request's final OK answer: one latency sample per
        chunk, each from the request's first enqueue."""
        wait = max(0.0, self._clock() - agg.enqueued_at)
        for _ in range(chunks):
            self.metrics.latency.record(wait)

    def _enqueue(self, features, rows: int, request_id: str = "") -> Future:
        traced = torch_profiler._is_profiler_enabled
        start = self._clock() if traced else None
        with self._cond:
            if self._stopped:
                return _resolved(SHUTTING_DOWN, "server is shutting down")
            queued = self._queued_rows
            if queued + rows > self._max_queue_rows:
                return self._shed(rows, request_id, start)
            now = self._clock()
            held0, busy0 = self._clocks_at(now)
            item = _Item(
                features=features, rows=rows, future=Future(),
                enqueued_at=now, request_id=request_id, held0=held0,
                busy0=busy0,
            )
            self._queue.append(item)
            self._queued_rows += rows
            self._due(now)
            self._cond.notify()
        if traced:
            self._admitted(start, now, queued, rows, request_id)
        return item.future

    def _due(self, now: float) -> None:
        """Under the lock, after an enqueue at `now`: where the queue
        now fills a batch, a held wait's deadline is `now`."""
        if self._queued_rows >= self._max_batch and self._wait is HELD \
                and now < self._held_until:
            self._held_until = now

    def _shed(self, rows: int, request_id: str,
              start: Optional[float]) -> Future:
        """Refuse a request the queue has no room for, under the lock:
        count it, with the queue's and the dispatch thread's state."""
        now = self._clock()
        state, since = self._dispatch_state()
        queued = self._queued_rows
        self.metrics.record_shed({
            "at_s": now, "request_id": request_id, "rows": rows,
            "queued_rows": queued, "bound_rows": self._max_queue_rows,
            "oldest_age_s": (now - self._queue[0].enqueued_at
                             if self._queue else 0.0),
            "state": state, "state_s": now - since,
            "bucket_in_flight": self._inflight,
        })
        if start is not None:
            SPANS.add("admit", start, now, ref=request_id,
                      attrs=self._admit_attrs(queued, rows, 0))
        return _resolved(OVERLOADED, f"queue full ({queued} rows queued)")

    def _admit_attrs(self, queued: int, rows: int, admitted: int) -> tuple:
        return (("queued", queued), ("rows", rows), ("admitted", admitted),
                ("bound", self._max_queue_rows))

    def _admitted(self, start: float, now: float, queued: int, rows: int,
                  request_id: str) -> None:
        SPANS.add("admit", start, now, ref=request_id,
                  attrs=self._admit_attrs(queued, rows, 1))

    # ---- the dispatch thread's state -------------------------------------

    def _dispatch_state(self):
        """(state, since) of the dispatch thread, under the lock."""
        if self._wait is not BUSY:
            return self._wait, self._mark
        while True:  # the busy state and its time, from one moment
            since, state = self._busy_since, self._busy
            if since == self._busy_since:
                # a pop the thread has not yet written is a new form
                return (state, since) if since >= self._mark \
                    else (FORM, self._mark)

    def _clocks_at(self, t: float):
        """(held, busy) seconds of the dispatch thread up to `t`, under
        the lock."""
        if self._wait is HELD:
            return (self._cum_held
                    + max(0.0, min(t, self._held_until) - self._mark),
                    self._cum_busy)
        if self._wait is EMPTY:
            return self._cum_held, self._cum_busy
        return self._cum_held, self._cum_busy + (t - self._mark)

    def _enter(self, wait: str, now: float, until: float = 0.0) -> None:
        """Under the lock, at `now`: the dispatch thread waits (EMPTY,
        HELD) or pops a batch (BUSY).  The segment it leaves goes to the
        held or the busy clock, and its span to the recorder."""
        prev = self._wait
        if prev is HELD:
            self._cum_held += max(0.0, min(now, self._held_until)
                                  - self._mark)
        elif prev is BUSY:
            self._cum_busy += now - self._mark
        recording = torch_profiler._is_profiler_enabled
        if prev is BUSY:
            if recording or self._busy_traced:
                self._trace_busy(now)
        elif recording or self._wait_traced:
            self._trace_wait(now)
        self._wait_traced = recording
        self._mark = now
        self._held_until = until
        self._wait = wait

    def _shift(self, busy: str, now: float) -> None:
        """Form <-> engine at `now`, on the dispatch thread, outside the
        lock (both are busy: the split clocks stay as they are)."""
        recording = torch_profiler._is_profiler_enabled
        if recording or self._busy_traced:
            self._trace_busy(now)
        self._busy_traced = recording
        self._busy_since = now
        self._busy = busy

    def _trace_busy(self, now: float) -> None:
        """Record the busy state that ends at `now`."""
        state = self._busy
        SPANS.add(state, self._busy_since, now,
                  attrs=(("bucket", self._inflight),) if state is ENGINE
                  else ())

    def _trace_wait(self, now: float) -> None:
        """Record the wait that ends at `now`, under the lock; its part
        after a batch fell due (the deadline, a full batch, the first
        request) as `dispatch.wake`."""
        due = now
        if self._wait is HELD:
            due = min(now, max(self._mark, self._held_until))
        elif self._queue:
            due = min(now, max(self._mark, self._queue[0].enqueued_at))
        SPANS.add(self._wait, self._mark, due)
        if due < now:
            SPANS.add(WAKE, due, now)

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
                    now = self._clock()
                    deadline = (
                        self._queue[0].enqueued_at + self._max_latency_s
                    )
                    if (
                        self._queued_rows >= self._max_batch
                        or now >= deadline
                        or self._stopped  # draining: don't wait out
                    ):                    # deadlines nobody benefits from
                        self._enter(BUSY, now)
                        return self._pop_batch(now)
                    if self._wait is not HELD:
                        self._enter(HELD, now, deadline)
                    self._cond.wait(timeout=max(0.0, deadline - now))
                elif self._stopped:
                    # the last state ends here (its span, if recorded)
                    self._enter(EMPTY, self._clock())
                    return None
                else:
                    self._enter(EMPTY, self._clock())
                    self._cond.wait()

    def _pop_batch(self, now: float):
        """Called under the lock, at the pop (`now`, BUSY entered): pop
        queued items that fit max_batch, each with the held and busy
        seconds of its wait."""
        held, busy = self._cum_held, self._cum_busy
        batch, rows = [], 0
        while self._queue and rows + self._queue[0].rows <= self._max_batch:
            item = self._queue.popleft()
            item.popped_at = now
            item.queue_wait = now - item.enqueued_at
            item.queue_held = held - item.held0
            item.queue_behind = busy - item.busy0
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

        # the pop's form (the pop recorded what came before it)
        self._busy_traced = torch_profiler._is_profiler_enabled
        self._busy_since = batch[0].popped_at
        self._busy = FORM
        groups = []
        for item in batch:
            f = form(item)
            if groups and groups[-1][0] == f:
                groups[-1][1].append(item)
            else:
                groups.append((f, [item]))
        for i, (_, group) in enumerate(groups):
            if i:
                # a later run's items queued on behind the earlier runs
                now = self._clock()
                for item in group:
                    item.queue_wait += now - item.popped_at
                    item.queue_behind += now - item.popped_at
                    item.popped_at = now
            self._execute_uniform(group)

    def _execute_uniform(self, batch) -> None:
        traced = torch_profiler._is_profiler_enabled
        rows = sum(item.rows for item in batch)
        # phase clock starts when the batch is cut: queue_wait ends
        # there, batch_form covers assembly, pad/compute/unpack come
        # back from the engine (docs/OBSERVABILITY.md "Request tracing")
        popped_at = batch[0].popped_at
        self.metrics.record_queue_phases(batch)
        features = {
            k: np.concatenate(
                [np.asarray(item.features[k]) for item in batch], axis=0
            )
            for k in batch[0].features
        }
        formed_at = self._clock()
        batch_form_s = max(0.0, formed_at - popped_at)
        self.metrics.record_phase("batch_form", batch_form_s)
        engine_phases: Dict[str, float] = {}

        def item_phases(item):
            phases = item.queue_phases()
            phases["batch_form"] = batch_form_s
            phases.update(engine_phases)
            return phases

        bucket = self._engine.bucket_for(rows)
        batch_id = self._trace_queue(batch) if traced else 0
        self._inflight = bucket or rows
        self._shift(ENGINE, formed_at)
        try:
            with SPANS.within(batch_id) if traced else _UNTRACED:
                if self._engine_traces:
                    preds, step = self._engine.predict(
                        features, rows, phase_out=engine_phases
                    )
                else:
                    preds, step = self._engine.predict(features, rows)
        except Exception as exc:  # engine failure: fail THIS batch only
            self._shift(FORM, self._clock())
            self._inflight = 0
            logger.exception("serving batch execution failed")
            self.metrics.record_internal()
            for item in batch:
                self._finish(item, ServingResult(
                    code=INTERNAL, error=f"execution failed: {exc}",
                    request_id=item.request_id,
                    phases_s=item_phases(item),
                ))
            return
        now = self._clock()
        self._shift(FORM, now)
        self._inflight = 0
        for phase, seconds in engine_phases.items():
            self.metrics.record_phase(phase, seconds)
        self.metrics.record_batch(rows, bucket)
        offset = 0
        for item in batch:
            if item.aggregate is None:
                # a split request's chunks record at its final answer
                self.metrics.latency.record(max(0.0,
                                                now - item.enqueued_at))
            self._finish(item, ServingResult(
                code=OK,
                predictions=preds[offset:offset + item.rows],
                model_step=step,
                request_id=item.request_id,
                phases_s=item_phases(item),
            ))
            offset += item.rows
        if traced:
            SPANS.add("batch", popped_at, self._clock(),
                      ref=f"b{batch_id}", span_id=batch_id,
                      attrs=(("rows", rows), ("bucket", bucket),
                             ("requests", len(batch))))

    def _trace_queue(self, batch) -> int:
        """Record each item's `queue` span under a new batch span's id
        (the batch span itself is recorded once it is answered)."""
        batch_id = SPANS.new_id()
        for item in batch:
            phases = item.queue_phases()
            SPANS.add("queue", item.enqueued_at, item.popped_at,
                      parent=batch_id, ref=item.request_id,
                      attrs=(("held_ns", ns(phases["queue_held"])),
                             ("behind_ns", ns(phases["queue_behind"])),
                             ("wake_ns", ns(phases["queue_wake"])),
                             ("rows", item.rows)))
        return batch_id

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
