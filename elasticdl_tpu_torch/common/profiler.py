"""Latency histogram shared by the serving metrics (a copy of
`LatencyHistogram` from the JAX package's common/profiler.py; the step
and phase timers there wait for the training slice)."""

from __future__ import annotations

import math
import threading


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
