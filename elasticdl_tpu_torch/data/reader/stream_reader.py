"""Unbounded stream reader: event-time records -> bounded windows (the
port's copy of the JAX package's data/reader/stream_reader.py).

The batch readers in this package make a FINITE source shard-addressable
(`create_shards()` enumerates it once).  A stream never ends, so the
contract inverts: records arrive continuously with *event timestamps*,
the reader buffers them into bounded windows of `window_records`, and
each sealed window becomes shard-addressable exactly like one small
epoch — `(window_name, 0, n)` — which the perpetual task manager
(master/task_manager.py `arm_window`) turns into leaseable tasks.  The
loop that ties polling, arming, training, checkpointing and serving
together is the JAX package's online/pipeline.py; the port's waits for
its slice (ROADMAP.md queue 1, item 10(b)), and until then a caller
drives these steps itself.

Time discipline:

- The *clock* is injectable (policy.py/slo.py shape): event timestamps
  and lag computations read `clock()`, so chaos tests drive the stream
  with a fake clock and same-seed runs replay byte-identically.
- The *watermark* is the newest event timestamp sealed into a window.
  `watermark lag = clock() - watermark`: how far serving-visible
  training trails the stream head.  A stalled poll (injected
  `stream.poll` fault, common/faults.py) does not lose records — the
  source re-delivers on the next poll — it shows up as lag.

Backpressure: sealed windows wait in a bounded buffer
(`max_buffered_windows`).  The pipeline releases each window after
training it; if training falls so far behind that the buffer fills, the
OLDEST window is dropped (counted — `data_stream_windows_dropped_total`
should stay 0 in a healthy deployment — and announced with a
`stream_window_dropped` span event that triggers a flight-recorder
incident bundle) rather than growing host memory without bound.  A drop
is not necessarily a loss: because source content is a pure function of
(seed, record index), `restore_window` regenerates any un-acked
window's exact records on demand, which is how a restarted master
replays the windows its ledger says were never fully trained.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.reader.base import AbstractDataReader

logger = get_logger(__name__)


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 — the same per-index
    hash discipline store/host_tier.py uses for row init.  uint64
    wraparound is the algorithm (mod-2^64 multiply), not an accident —
    mute numpy's scalar-overflow warning for it."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class ClickStreamSource:
    """Seeded synthetic click-stream: (user, item, clicked) impressions.

    Record content is a pure function of (seed, record index) — record
    `i` of the stream is ALWAYS the same impression, computed by hashing
    the index, never by advancing a shared rng — so any record range can
    be regenerated on demand (`records(start, n)`).  That replayability
    is what lets a restarted master re-buffer un-acked windows instead
    of dropping them blind.  The clock only stamps `event_unix_s`.
    Clicks follow a stable per-(user, item) affinity, giving the online
    model a learnable signal rather than label noise.
    """

    def __init__(
        self,
        seed: int = 0,
        users: int = 512,
        items: int = 128,
        records_per_poll: int = 64,
        clock: Callable[[], float] = time.time,
    ):
        self.users = int(users)
        self.items = int(items)
        self.records_per_poll = int(records_per_poll)
        self._clock = clock
        rng = np.random.default_rng(int(seed) & 0xFFFFFFFF)
        # Per-user and per-item propensities drawn once: clicked ~
        # Bernoulli(sigmoid(u_bias + i_bias)), deterministic given seed.
        self._user_bias = rng.normal(0.0, 1.0, self.users)
        self._item_bias = rng.normal(0.0, 1.0, self.items)
        # Per-field salts keyed off the seed so user/item/click draws at
        # one index are independent streams.
        base = _mix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF))
        self._salts = tuple(
            _mix64(base ^ np.uint64(k)) for k in (1, 2, 3)
        )
        self.emitted = 0

    def records(self, start: int, n: int,
                event_unix_s: float = 0.0) -> List[dict]:
        """Records [start, start+n) of the stream — pure function of
        (seed, index), so replaying a lost window regenerates its exact
        training content."""
        if n <= 0:
            return []
        idx = np.arange(start, start + n, dtype=np.uint64)
        users = _mix64(idx ^ self._salts[0]) % np.uint64(self.users)
        items = _mix64(idx ^ self._salts[1]) % np.uint64(self.items)
        logits = self._user_bias[users] + self._item_bias[items]
        prob = 1.0 / (1.0 + np.exp(-logits))
        uniform = (
            (_mix64(idx ^ self._salts[2]) >> np.uint64(11)).astype(np.float64)
            * (2.0 ** -53)
        )
        clicked = (uniform < prob).astype(np.int64)
        return [
            {
                "user": int(users[i]),
                "item": int(items[i]),
                "clicked": int(clicked[i]),
                "event_unix_s": float(event_unix_s),
            }
            for i in range(n)
        ]

    def poll(self, max_records: Optional[int] = None) -> List[dict]:
        """Next batch of impressions, event-stamped at the current
        clock.  Deterministic content; never blocks."""
        n = self.records_per_poll if max_records is None else int(max_records)
        if n <= 0:
            return []
        records = self.records(self.emitted, n,
                               event_unix_s=float(self._clock()))
        self.emitted += n
        return records


class StreamWindow:
    """One sealed window: a finite, immutable slice of the stream.
    `start_index` is the absolute stream offset of its first record —
    the replay coordinate a restarted master hands back to
    `StreamReader.restore_window`."""

    __slots__ = (
        "name", "window_id", "records", "watermark_unix_s", "start_index",
    )

    def __init__(self, name: str, window_id: int, records: List[dict],
                 watermark_unix_s: float, start_index: int = 0):
        self.name = name
        self.window_id = window_id
        self.records = records
        self.watermark_unix_s = watermark_unix_s
        self.start_index = start_index


class StreamReader(AbstractDataReader):
    """Buffers an unbounded source into bounded, shard-addressable
    windows.  Thread-safe: the pipeline polls from its loop thread while
    training workers call `read_records` on leased tasks."""

    def __init__(
        self,
        source,
        window_records: int = 256,
        max_buffered_windows: int = 64,
        registry: Optional[metrics_lib.MetricsRegistry] = None,
        clock: Callable[[], float] = time.time,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if window_records < 1:
            raise ValueError("window_records must be >= 1")
        self._source = source
        self._window_records = int(window_records)
        self._max_buffered = max(1, int(max_buffered_windows))
        self._clock = clock
        self._lock = threading.Lock()
        self._current: List[dict] = []
        self._sealed: "OrderedDict[str, StreamWindow]" = OrderedDict()
        self._unclaimed: List[StreamWindow] = []  # sealed, not yet armed
        self._next_window_id = 0
        self._watermark_unix_s: Optional[float] = None

        self.metrics_registry = (
            registry if registry is not None else metrics_lib.MetricsRegistry()
        )
        self._records = self.metrics_registry.counter(
            "data_stream_records_total",
            "records pulled from the stream source",
        )
        self._polls = self.metrics_registry.counter(
            "data_stream_polls_total",
            "stream poll attempts (stalled or not)",
        )
        self._poll_faults = self.metrics_registry.counter(
            "data_stream_poll_faults_total",
            "polls stalled by an injected stream.poll fault",
        )
        self._sealed_total = self.metrics_registry.counter(
            "data_stream_windows_sealed_total",
            "bounded windows closed and made shard-addressable",
        )
        self._dropped_total = self.metrics_registry.counter(
            "data_stream_windows_dropped_total",
            "sealed windows evicted past the buffer cap",
        )
        self._replayed_total = self.metrics_registry.counter(
            "data_stream_windows_replayed_total",
            "un-acked windows regenerated from the replayable source",
        )
        self.metrics_registry.gauge_fn(
            "data_stream_watermark_lag_seconds",
            self.lag_s,
            "now minus the newest sealed event timestamp",
        )
        self.metrics_registry.gauge_fn(
            "data_stream_buffered_windows_count",
            lambda: float(len(self._sealed)),
            "sealed windows awaiting training",
        )

    # ---- streaming side -------------------------------------------------

    def poll(self, max_records: Optional[int] = None) -> int:
        """One pull from the source.  Returns records buffered (0 on an
        injected stall).  Fires `stream.poll` (common/faults.py): a
        raise/drop skips the pull — the source re-delivers next poll —
        so a scheduled fault reads as watermark lag, never data loss."""
        self._polls.inc()
        try:
            faults.fire(faults.POINT_STREAM_POLL)
        except faults.InjectedFault as exc:
            self._poll_faults.inc()
            logger.warning("stream poll stalled (%s)", exc)
            return 0
        records = self._source.poll(max_records)
        if not records:
            return 0
        sealed: List[StreamWindow] = []
        dropped: List[StreamWindow] = []
        with self._lock:
            self._current.extend(records)
            while len(self._current) >= self._window_records:
                chunk = self._current[: self._window_records]
                self._current = self._current[self._window_records:]
                sealed.append(self._seal_locked(chunk, dropped))
        self._records.inc(len(records))
        for window in sealed:
            self._sealed_total.inc()
            events.emit(
                events.STREAM_WINDOW_SEALED,
                window=window.window_id,
                records=len(window.records),
            )
            # Lineage seal stamp: ingest = the window's oldest event
            # time, at = now — ingest_wait is how long the window took
            # to fill (common/lineage.py).
            events.emit(
                events.WINDOW_SPAN,
                window_id=window.window_id,
                phase="ingest_wait",
                reason="sealed",
                at_unix_s=round(float(self._clock()), 6),
                ingest_unix_s=round(
                    min(
                        float(r.get("event_unix_s", 0.0))
                        for r in window.records
                    ), 6,
                ),
                records=len(window.records),
            )
        for window in dropped:
            # an incident, not a log line: the flight recorder captures
            # a bundle on this event (common/flight.py)
            events.emit(
                events.STREAM_WINDOW_DROPPED,
                window=window.window_id,
                name=window.name,
                records=len(window.records),
            )
        return len(records)

    def _seal_locked(self, chunk: List[dict],
                     dropped_out: List[StreamWindow]) -> StreamWindow:
        window_id = self._next_window_id
        self._next_window_id += 1
        watermark = max(
            float(r.get("event_unix_s", 0.0)) for r in chunk
        )
        if self._watermark_unix_s is None \
                or watermark > self._watermark_unix_s:
            self._watermark_unix_s = watermark
        # Windows seal in stream order at a fixed width, so window k
        # always covers source records [k*W, (k+1)*W) — the invariant
        # replay relies on.
        window = StreamWindow(
            f"stream:w{window_id:06d}", window_id, chunk, watermark,
            start_index=window_id * self._window_records,
        )
        self._sealed[window.name] = window
        self._unclaimed.append(window)
        while len(self._sealed) > self._max_buffered:
            name, evicted = self._sealed.popitem(last=False)
            self._unclaimed = [
                w for w in self._unclaimed if w.name != name
            ]
            self._dropped_total.inc()
            dropped_out.append(evicted)
            logger.warning(
                "stream window %s dropped (buffer cap %d; training is "
                "%d windows behind)", name, self._max_buffered,
                len(self._sealed),
            )
        return window

    def take_new_windows(self) -> List[StreamWindow]:
        """Windows sealed since the last call — the pipeline hands each
        to `TaskManager.arm_window` exactly once (re-offering itself on
        an injected re-arm fault)."""
        with self._lock:
            out, self._unclaimed = self._unclaimed, []
            return out

    def release_window(self, name: str) -> bool:
        """Free a fully-trained window's records."""
        with self._lock:
            return self._sealed.pop(name, None) is not None

    def restore_window(
        self,
        name: str,
        window_id: int,
        start_index: int,
        num_records: int,
        watermark_unix_s: float,
    ) -> bool:
        """Re-buffer an un-acked window from the replayable source —
        what a restarted master (or a drained buffer) calls instead of
        forfeiting the window.  The regenerated records are
        byte-identical to the originals because source content is a
        pure function of (seed, index).  Returns False when the source
        cannot replay (no `records` method).  The watermark never moves
        backward: replays restore data, not time."""
        source_records = getattr(self._source, "records", None)
        if source_records is None:
            return False
        chunk = source_records(
            int(start_index), int(num_records),
            event_unix_s=float(watermark_unix_s),
        )
        if len(chunk) != int(num_records):
            return False
        window = StreamWindow(
            name, int(window_id), chunk, float(watermark_unix_s),
            start_index=int(start_index),
        )
        with self._lock:
            if name in self._sealed:
                return True
            self._sealed[name] = window
        self._replayed_total.inc()
        events.emit(
            events.STREAM_WINDOW_RESTORED,
            window=int(window_id),
            name=name,
            records=int(num_records),
        )
        # Replay stamp: carries the ORIGINAL journaled watermark as the
        # ingest time, so a lineage consumer that missed the seal still
        # attributes the replayed window to its original ingest — it
        # never re-stamps a window the consumer already opened.
        events.emit(
            events.WINDOW_SPAN,
            window_id=int(window_id),
            phase="ingest_wait",
            reason="replayed",
            at_unix_s=round(float(self._clock()), 6),
            ingest_unix_s=round(float(watermark_unix_s), 6),
            records=int(num_records),
        )
        return True

    # ---- lag ------------------------------------------------------------

    @property
    def watermark_unix_s(self) -> Optional[float]:
        with self._lock:
            return self._watermark_unix_s

    def lag_s(self) -> float:
        """clock() - watermark; 0.0 before the first sealed window."""
        watermark = self.watermark_unix_s
        if watermark is None:
            return 0.0
        return max(0.0, float(self._clock()) - watermark)

    # ---- AbstractDataReader contract ------------------------------------

    def read_records(self, task) -> Iterator[dict]:
        with self._lock:
            window = self._sealed.get(task.shard.name)
            records = list(window.records) if window is not None else []
        if not records:
            raise LookupError(
                f"stream window {task.shard.name!r} is no longer "
                "buffered (trained and released, or dropped past the "
                "buffer cap)"
            )
        end = min(task.shard.end, len(records))
        for i in range(task.shard.start, end):
            yield records[i]

    def create_shards(self) -> List[Tuple[str, int, int]]:
        """The currently-buffered sealed windows.  Unlike batch readers
        this is a moving view — the perpetual task manager consumes
        windows incrementally via `take_new_windows` instead."""
        with self._lock:
            return [
                (w.name, 0, len(w.records))
                for w in self._sealed.values()
            ]

    @property
    def metadata(self) -> dict:
        return {"unbounded": True, "window_records": self._window_records}

    def snapshot(self) -> dict:
        """Clock-free-ish health summary (lag is clock-derived) for the
        pipeline's snapshot()/varz."""
        with self._lock:
            buffered = len(self._sealed)
            pending = len(self._current)
            next_id = self._next_window_id
        return {
            "windows_sealed": next_id,
            "buffered_windows": buffered,
            "pending_records": pending,
            "records": int(self._records.value()),
            "polls": int(self._polls.value()),
            "poll_faults": int(self._poll_faults.value()),
            "dropped_windows": int(self._dropped_total.value()),
            "replayed_windows": int(self._replayed_total.value()),
            "watermark_lag_s": round(self.lag_s(), 6),
        }
