"""Metric history: ring-buffered samples of metric registries (the
port's copy of the JAX package's common/history.py).

Every telemetry surface so far (/metrics, /varz, Master.snapshot) is a
point-in-time read — nothing can answer "what was the p99 over the last
five minutes" or "how fast is this counter burning".  `MetricHistory`
closes that gap: it samples a set of `MetricsRegistry` objects on a
policy-engine-style loop (injectable clock, `interval_s=0` disables the
thread so tests tick by hand) and keeps a fixed-capacity ring buffer of
(timestamp, value) points per series.

Three read surfaces feed the SLO layer (common/slo.py):

- **Gauge series** — the raw windowed points plus an exceedance ratio
  (fraction of samples over a bound).
- **Counters** — windowed deltas/rates that survive process restarts:
  a sample lower than its predecessor is treated as a counter reset and
  contributes its full post-reset value, the standard increase() rule.
- **Histograms** — per-bucket cumulative counts are sampled alongside
  the flat `_p50`/`_p99` quantile series, so windowed quantiles and
  windowed exceedance ratios come from bucket *deltas* (what happened
  in the window), not lifetime aggregates that never recover.

Thread-safety: `tick()` mutates the ring under `self._lock`; reads copy
under the same lock.  The sampled registries use their own locks, so a
concurrent /metrics scrape and a history sample never tear each other.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.profiler import LatencyHistogram

logger = get_logger(__name__)


class MetricHistory:
    """Fixed-capacity ring-buffer recorder over metric registries."""

    def __init__(
        self,
        registries: Sequence[object] = (),
        capacity: int = 512,
        interval_s: float = 0.0,
        clock: Callable[[], float] = time.time,
    ):
        self.capacity = max(2, int(capacity))
        self.interval_s = float(interval_s)
        self._clock = clock
        self._registries = list(registries)
        self._lock = threading.Lock()
        # series key -> ring of (ts, value)
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}
        # histogram series key -> (uppers, ring of (ts, cumulative counts))
        self._buckets: Dict[
            str, Tuple[List[float], Deque[Tuple[float, List[int]]]]
        ] = {}
        self._samples_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- wiring ---------------------------------------------------------

    def add_registry(self, registry) -> None:
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    # ---- sampling loop (policy-engine style) ----------------------------

    def start(self) -> bool:
        """Background sampling; False when interval_s <= 0 (tests tick
        by hand) or already started."""
        if self.interval_s <= 0 or self._thread is not None:
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="metric-history", daemon=True
        )
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("metric-history sample failed")

    def tick(self) -> None:
        """Take one sample of every registry now."""
        now = float(self._clock())
        with self._lock:
            registries = list(self._registries)
        scalars: Dict[str, float] = {}
        hists: List[Tuple[str, List[float], List[int]]] = []
        for registry in registries:
            scalars.update(registry.snapshot())
            for fam in registry.families():
                if not isinstance(fam, metrics_lib._HistogramFamily):
                    continue
                for key, child in fam.child_items():
                    labelpairs = tuple(zip(fam.labelnames, key))
                    series = metrics_lib._series_key(fam.name, labelpairs)
                    uppers, counts, _total, _sum = child.bucket_snapshot()
                    hists.append((series, uppers, counts))
        with self._lock:
            self._samples_total += 1
            for name, value in scalars.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self.capacity)
                ring.append((now, float(value)))
            for name, uppers, counts in hists:
                entry = self._buckets.get(name)
                if entry is None or entry[0] != uppers:
                    entry = self._buckets[name] = (
                        uppers, deque(maxlen=self.capacity)
                    )
                entry[1].append((now, counts))

    # ---- reads ----------------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            return list(ring) if ring else []

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def window(self, name: str,
               window_s: float) -> List[Tuple[float, float]]:
        """Points within the trailing window (inclusive cutoff)."""
        cutoff = float(self._clock()) - float(window_s)
        return [(ts, v) for ts, v in self.series(name) if ts >= cutoff]

    def counter_delta(self, name: str, window_s: float) -> float:
        """Reset-aware increase over the window: a sample lower than its
        predecessor means the counter restarted, so its full value is
        the increment (a fresh sampler sees no phantom delta either —
        one point yields 0)."""
        points = self.window(name, window_s)
        delta = 0.0
        for (_, prev), (_, cur) in zip(points, points[1:]):
            delta += cur - prev if cur >= prev else cur
        return delta

    def rate(self, name: str, window_s: float) -> float:
        """counter_delta / elapsed-sample-span, per second."""
        points = self.window(name, window_s)
        if len(points) < 2:
            return 0.0
        span = points[-1][0] - points[0][0]
        if span <= 0:
            return 0.0
        return self.counter_delta(name, window_s) / span

    def exceedance_ratio(self, name: str, bound: float,
                         window_s: float) -> Optional[float]:
        """Fraction of windowed gauge samples strictly over `bound`;
        None when the window holds no samples."""
        points = self.window(name, window_s)
        if not points:
            return None
        bad = sum(1 for _, v in points if v > bound)
        return bad / len(points)

    # ---- histogram reads ------------------------------------------------

    def histogram_window(
        self, name: str, window_s: float,
    ) -> Optional[Tuple[List[float], List[int], int]]:
        """(uppers, windowed per-bucket counts, total) from cumulative
        bucket deltas over the window, reset-aware like counter_delta.
        None when fewer than one bucket sample exists in the window."""
        cutoff = float(self._clock()) - float(window_s)
        with self._lock:
            entry = self._buckets.get(name)
            if entry is None:
                return None
            uppers, ring = entry[0], [
                (ts, counts) for ts, counts in entry[1] if ts >= cutoff
            ]
        if not ring:
            return None
        deltas = [0] * len(uppers)
        for (_, prev), (_, cur) in zip(ring, ring[1:]):
            reset = any(c < p for p, c in zip(prev, cur))
            for i, c in enumerate(cur):
                deltas[i] += c if reset else c - prev[i]
        return uppers, deltas, sum(deltas)

    def histogram_quantile(self, name: str, q: float,
                           window_s: float) -> Optional[float]:
        """Bounded-error quantile of the observations made *inside* the
        window (None without data) — unlike the flat `_p99` series,
        which is a lifetime aggregate."""
        win = self.histogram_window(name, window_s)
        if win is None or win[2] == 0:
            return None
        uppers, counts, total = win
        return LatencyHistogram._quantile_from(uppers, counts, total, q)

    def histogram_exceedance(
        self, name: str, bound: float, window_s: float,
    ) -> Optional[Tuple[int, int]]:
        """(observations possibly over `bound`, total observations) in
        the window.  A bucket counts as bad when its upper edge exceeds
        the bound — conservative by at most one log bucket."""
        win = self.histogram_window(name, window_s)
        if win is None:
            return None
        uppers, counts, total = win
        bad = sum(c for u, c in zip(uppers, counts) if u > bound)
        return bad, total

    # ---- introspection --------------------------------------------------

    def snapshot(self) -> dict:
        """Clock-free health summary for Master.snapshot()/varz."""
        with self._lock:
            return {
                "series": len(self._series),
                "histograms": len(self._buckets),
                "samples": self._samples_total,
                "capacity": self.capacity,
                "interval_s": self.interval_s,
            }
