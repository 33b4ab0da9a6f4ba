"""Step and phase timers of the training loop, the latency histogram of
the serving metrics and the profiler hooks (copies of `StepTimer`,
`PhaseTimer`, `LatencyHistogram`, `trace` and `annotate` from the JAX
package's common/profiler.py).  `trace` records with `torch.profiler`
where the JAX package records with `jax.profiler`, and writes a Chrome
trace.  The registry histogram behind PhaseTimer waits for its slice of
the port.

The port adds a span recorder (`SPANS`): the program's own boundaries
(the batcher's dispatch-thread states and requests, the engine's and the
trainer's host legs) as intervals on `time.perf_counter`'s clock, with a
parent and a request or batch reference, kept in a bounded buffer in
memory.  It records only while a torch profiler records
(`torch_profiler._is_profiler_enabled`, which torch sets when a profile
starts and clears when it stops): off, a boundary costs the read of
that one module attribute, and takes no lock, makes no allocation and
reads no clock.  `trace` writes the spans it saw into its Chrome trace,
on the trace's clock; a caller holding its own profile places them the
same way, by an annotation it reads on both clocks."""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as torch_profiler

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)


class StepTimer:
    """Rolling step-rate meter: `tick()` after each train step; reads
    are O(1).  Host time between ticks: with asynchronous device work a
    tick measures launch time unless the caller synchronizes."""

    def __init__(self, window: int = 100):
        self._times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def log(self, prefix: str = ""):
        logger.info("%ssteps/sec=%.2f", prefix, self.steps_per_sec)


#: The step-phase vocabulary: every phase a worker attributes step time
#: to.  `cold_gather` is the tiered store's host gather of admitted rows,
#: on its prefetch thread or at apply time (store/tiered.py).
STEP_PHASES = ("data_wait", "pack", "h2d_stage", "compute", "report",
               "cold_gather")


class PhaseTimer:
    """Attributes each train step's wall time to named phases.

    The worker loop wraps each region in `with timer.phase("compute"):`
    (or calls `add(name, seconds)` for regions timed elsewhere, e.g. on
    the prefetch producer thread) and calls `step_done()` once per
    executed step.  Every `flush_every` steps the accumulated breakdown
    is emitted as one `step_phases` span event.  Thread-safe: `add()`
    may run on the prefetch producer while the consumer runs `phase()`.
    """

    def __init__(self, phases=STEP_PHASES, flush_every: int = 50):
        self.phases = tuple(phases)
        self._flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        self._totals = {p: 0.0 for p in self.phases}      # job lifetime
        self._pending = {p: 0.0 for p in self.phases}     # since flush
        self._steps = 0
        self._pending_steps = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def add(self, name: str, seconds: float) -> None:
        if name not in self._totals:
            raise ValueError(f"unknown step phase {name!r}")
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._totals[name] += seconds
            self._pending[name] += seconds

    def _take_pending_locked(self):
        payload = {p: round(v, 6) for p, v in self._pending.items()}
        steps = self._pending_steps
        for p in self._pending:
            self._pending[p] = 0.0
        self._pending_steps = 0
        return payload, steps

    def step_done(self) -> None:
        """Count one executed step; flush a `step_phases` event at the
        flush interval."""
        with self._lock:
            self._steps += 1
            self._pending_steps += 1
            if self._pending_steps < self._flush_every:
                return
            payload, steps = self._take_pending_locked()
        events.emit(events.STEP_PHASES, phases=payload, steps=steps)

    def flush(self) -> None:
        """Emit what accumulated since the last flush (end of a task)."""
        with self._lock:
            if not self._pending_steps:
                return
            payload, steps = self._take_pending_locked()
        events.emit(events.STEP_PHASES, phases=payload, steps=steps)

    def totals_milli(self) -> dict:
        """{phase: cumulative milliseconds} as ints: the shape a task
        report's int64 telemetry can carry."""
        with self._lock:
            return {
                p: int(round(v * 1000.0)) for p, v in self._totals.items()
            }

    def snapshot(self) -> dict:
        """{phase: {"total_s", "mean_s", "share"}} over the job so far;
        `share` is the phase's fraction of all attributed time."""
        with self._lock:
            totals = dict(self._totals)
            steps = self._steps
        attributed = sum(totals.values())
        return {
            p: {
                "total_s": t,
                "mean_s": (t / steps) if steps else 0.0,
                "share": (t / attributed) if attributed else 0.0,
            }
            for p, t in totals.items()
        }


class LatencyHistogram:
    """Thread-safe log-bucketed latency histogram with quantile reads.

    Serving needs p50/p99 over an unbounded stream without keeping every
    sample; log-spaced buckets give a bounded-error quantile (each bucket
    spans `growth`x, so a reported quantile is within one growth factor of
    truth) at O(1) record cost under a lock — the batcher records from its
    dispatch threads while health readers query concurrently.
    """

    def __init__(self, min_s: float = 1e-4, max_s: float = 60.0,
                 growth: float = 1.25):
        self._min_s = min_s
        self._log_min = math.log(min_s)
        self._log_growth = math.log(growth)
        nbuckets = int(math.ceil(
            (math.log(max_s) - self._log_min) / self._log_growth
        )) + 1
        # bucket i covers [min_s * growth**i, min_s * growth**(i+1));
        # underflow clamps to 0, overflow to the last bucket
        self._uppers = [
            min_s * growth ** (i + 1) for i in range(nbuckets)
        ]
        self._counts = [0] * nbuckets
        self._total = 0
        self._sum_s = 0.0
        self._lock = threading.Lock()

    def _index(self, seconds: float) -> int:
        if seconds < self._min_s:
            return 0
        idx = int((math.log(seconds) - self._log_min) / self._log_growth)
        return min(idx, len(self._counts) - 1)

    def record(self, seconds: float) -> None:
        idx = self._index(seconds)
        with self._lock:
            self._counts[idx] += 1
            self._total += 1
            self._sum_s += seconds

    def record_many(self, values) -> None:
        """`record` each of `values`, under one acquisition of the lock."""
        with self._lock:
            for seconds in values:
                self._counts[self._index(seconds)] += 1
                self._total += 1
                self._sum_s += seconds

    def bucket_snapshot(self):
        """(uppers, counts, total, sum_s) copied under ONE lock
        acquisition — the consistent basis for quantiles."""
        with self._lock:
            return (
                list(self._uppers), list(self._counts),
                self._total, self._sum_s,
            )

    @staticmethod
    def _quantile_from(uppers, counts, total, q: float) -> float:
        if not total:
            return 0.0
        rank = q * (total - 1)
        seen = 0
        for idx, c in enumerate(counts):
            seen += c
            if seen > rank:
                return uppers[idx]
        return uppers[-1]

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile; 0.0 before
        any sample."""
        uppers, counts, total, _ = self.bucket_snapshot()
        return self._quantile_from(uppers, counts, total, q)

    def snapshot(self) -> dict:
        """{count, mean_s, p50_s, p99_s} — one consistent read: all four
        numbers derive from a single locked copy of the buckets."""
        uppers, counts, total, sum_s = self.bucket_snapshot()
        return {
            "count": total,
            "mean_s": (sum_s / total) if total else 0.0,
            "p50_s": self._quantile_from(uppers, counts, total, 0.5),
            "p99_s": self._quantile_from(uppers, counts, total, 0.99),
        }


# ---- the span recorder ---------------------------------------------------


class Span(NamedTuple):
    """One recorded interval, in nanoseconds of `time.perf_counter`'s
    clock.  `ref` is the request id (a request's spans) or
    "b<batch span id>" (a batch's); `attrs` a few (key, int) pairs."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int
    ref: str
    attrs: Tuple[Tuple[str, int], ...]


def ns(seconds: float) -> int:
    """A `time.perf_counter()` reading in the recorder's nanoseconds."""
    return round(seconds * 1e9)


class Legs:
    """The boundaries of one graph run (worker/graphs.py
    `ProgramGraphs.run`), for its caller's spans: `mark()` appends the
    clock's reading at the load's start, the replay's start, the
    replay's return and the finish's end, and the replay runs inside a
    `record_function` named `replay`, whose device-side range then
    covers the graph's kernels.  An eager run marks nothing."""

    __slots__ = ("replay", "clock", "marks")

    def __init__(self, replay: str, clock=time.perf_counter):
        self.replay = replay
        self.clock = clock
        self.marks: List[float] = []

    def mark(self) -> None:
        self.marks.append(self.clock())


#: Spans a recorder keeps (the newest): a 3-s traced serving slice
#: records ~5,000, a whole 51-s serving window ~20,000.
SPANS_KEPT = 1 << 16


class SpanRecorder:
    """Spans of the program's boundaries, the newest `SPANS_KEPT` kept.
    Callers record only while `torch_profiler._is_profiler_enabled`;
    `add` itself does not look.  A thread's current parent span and
    `Legs` (`within`) reach code below it that has no argument for them
    (the engine under the batcher, a graph run under the trainer)."""

    def __init__(self):
        self._spans: deque = deque(maxlen=SPANS_KEPT)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name: str, start_s: float, end_s: float, parent: int = 0,
            ref: str = "", attrs=(), span_id: int = 0) -> int:
        """Keep one span, from `time.perf_counter` readings (or a clock
        standing in for it); returns its id."""
        span_id = span_id or next(self._ids)
        self._spans.append(Span(name, ns(start_s), ns(end_s), span_id,
                                parent, ref, tuple(attrs)))
        return span_id

    def parent(self) -> int:
        """This thread's current parent span (0: none)."""
        return getattr(self._local, "parent", 0)

    def legs(self) -> Optional[Legs]:
        """This thread's `Legs` for the graph run below it, if any."""
        return getattr(self._local, "legs", None)

    def take_legs(self) -> Optional[Legs]:
        """This thread's `Legs`, which the caller takes: a graph run
        inside it finds none."""
        legs = self.legs()
        self._local.legs = None
        return legs

    @contextlib.contextmanager
    def within(self, parent: int, legs: Optional[Legs] = None):
        """Make `parent` (and `legs`) this thread's inside the block."""
        local = self._local
        saved = (self.parent(), self.legs())
        local.parent, local.legs = parent, legs
        try:
            yield
        finally:
            local.parent, local.legs = saved

    def spans(self, start_ns: Optional[int] = None,
              end_ns: Optional[int] = None) -> List[Span]:
        """The kept spans that overlap [start_ns, end_ns], oldest first."""
        kept = self._spans.copy()
        return [s for s in kept
                if (start_ns is None or s.end_ns >= start_ns)
                and (end_ns is None or s.start_ns <= end_ns)]

    def clear(self) -> None:
        self._spans.clear()


#: The process's span recorder.
SPANS = SpanRecorder()


#: The annotation `trace` wraps its block in, read on both clocks.
TRACE_MARK = "profiler.trace"


def place_spans(chrome_trace_path: str, host_start_ns: int,
                host_end_ns: int) -> int:
    """Add `SPANS`' spans between the two host readings to a Chrome
    trace, as async slices on the trace's clock: the `TRACE_MARK`
    annotation, which began just before `host_start_ns` and ended just
    after `host_end_ns`, gives the offset (the mean of its two ends').
    Returns the number of spans added."""
    with open(chrome_trace_path) as f:
        doc = json.load(f)
    trace_events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = [e for e in trace_events if e.get("name") == TRACE_MARK
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        logger.warning("no %r annotation in %s: spans not placed",
                       TRACE_MARK, chrome_trace_path)
        return 0
    ts, dur = float(marks[0]["ts"]), float(marks[0]["dur"])
    offset = ((ts * 1e3 - host_start_ns)
              + ((ts + dur) * 1e3 - host_end_ns)) / 2
    pid = marks[0].get("pid", 0)
    spans = SPANS.spans(host_start_ns, host_end_ns)
    for s in spans:
        args = {"span_id": s.span_id, "parent_id": s.parent_id,
                "ref": s.ref, **dict(s.attrs)}
        common = {"name": s.name, "cat": "program_span", "id": s.span_id,
                  "pid": pid, "tid": 0}
        trace_events.append(dict(common, ph="b",
                                 ts=(s.start_ns + offset) / 1e3, args=args))
        trace_events.append(dict(common, ph="e",
                                 ts=(s.end_ns + offset) / 1e3))
    with open(chrome_trace_path, "w") as f:
        json.dump(doc, f)
    return len(spans)


def _all_threads():
    """A profiler configuration that records every thread, or None where
    this torch has no such setting."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = False, name: str = "trace"):
    """Record the block with torch.profiler and write it as a Chrome
    trace, `<log_dir>/<name>.json` (chrome://tracing, Perfetto), with
    the span recorder's spans of the block on the trace's clock:

        with profiler.trace("/tmp/trace", cuda=True):
            loss = trainer.train_on_batch(state, batch)
            torch.cuda.synchronize()

    `cuda` adds the CUDA activity (kernels, copies, device time); the
    caller synchronizes inside the block, so the kernels it launched
    end before the trace closes.  Every thread's operations and ranges
    are recorded where torch can (`profile_all_threads`; else only this
    thread's), so a replay's range on the batcher's thread carries its
    name to the device.  Yields the path the trace goes to.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    with profile(activities=activities,
                 experimental_config=_all_threads()) as prof:
        with record_function(TRACE_MARK):
            host_start = time.perf_counter_ns()
            try:
                yield path
            finally:
                host_end = time.perf_counter_ns()
    prof.export_chrome_trace(path)
    place_spans(path, host_start, host_end)
    logger.info("Profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Name a region so it shows up in profiler timelines."""
    from torch.profiler import record_function

    with record_function(name):
        yield
