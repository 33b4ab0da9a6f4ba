"""Step and phase timers of the training loop, the latency histogram of
the serving metrics and the profiler hooks (copies of `StepTimer`,
`PhaseTimer`, `LatencyHistogram`, `trace` and `annotate` from the JAX
package's common/profiler.py).  `trace` records with `torch.profiler`
where the JAX package records with `jax.profiler`, and writes a Chrome
trace.  The registry histogram behind PhaseTimer waits for its slice of
the port."""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from collections import deque
from typing import Optional

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

    def record(self, seconds: float) -> None:
        if seconds < self._min_s:
            idx = 0
        else:
            idx = int((math.log(seconds) - self._log_min)
                      / self._log_growth)
            idx = min(idx, len(self._counts) - 1)
        with self._lock:
            self._counts[idx] += 1
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


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = False, name: str = "trace"):
    """Record the block with torch.profiler and write it as a Chrome
    trace, `<log_dir>/<name>.json` (chrome://tracing, Perfetto):

        with profiler.trace("/tmp/trace", cuda=True):
            loss = trainer.train_on_batch(state, batch)
            torch.cuda.synchronize()

    `cuda` adds the CUDA activity (kernels, copies, device time); the
    caller synchronizes inside the block, so the kernels it launched
    end before the trace closes.  Yields the path the trace goes to.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Name a region so it shows up in profiler timelines."""
    from torch.profiler import record_function

    with record_function(name):
        yield
