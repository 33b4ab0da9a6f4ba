"""Master-side recovery time (the port of the JAX package's
master/recovery.py).

BASELINE.md's elasticity metric is recovery time: the preemption signal
to the first post-restore optimizer step.  The master sees both ends on
one clock: the pod manager stamps the membership loss, the servicer the
first training progress after it (a report_version from the rebuilt
group, or a successful task report).  Counts and durations live in the
clock's metrics registry, so snapshot() and /metrics read one series;
`history` keeps the raw durations.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)


class RecoveryClock:
    def __init__(self, registry: Optional[metrics_lib.MetricsRegistry] = None,
                 clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._pending_since: Optional[float] = None
        self.history: List[float] = []
        self.metrics_registry = registry or metrics_lib.MetricsRegistry()
        self._losses = self.metrics_registry.counter(
            "master_recovery_losses_total",
            "worker membership losses observed (preemption/failure/scale)",
        )
        self._recoveries = self.metrics_registry.counter(
            "master_recoveries_total",
            "closed outages: loss -> first post-restore training progress",
        )
        self._duration = self.metrics_registry.histogram(
            "master_recovery_seconds",
            "elastic recovery duration (loss -> first progress)",
            min_value=0.01,
            max_value=600.0,
        )
        self.metrics_registry.gauge_fn(
            "master_recovery_pending_count",
            lambda: 1.0 if self._pending_since is not None else 0.0,
            "1 while an outage is open (loss seen, no progress yet)",
        )

    @property
    def losses(self) -> int:
        return int(self._losses.value())

    def mark_loss(self) -> None:
        """A worker left the membership.  The earliest pending loss wins,
        so an outage of several losses is measured end to end."""
        with self._lock:
            self._losses.inc()
            opened = self._pending_since is None
            if opened:
                self._pending_since = self._clock()
        if opened:
            events.emit(events.RECOVERY_STARTED)

    def mark_progress(self) -> Optional[float]:
        """Training progressed: close a pending outage and return its
        seconds (None when nothing was pending)."""
        with self._lock:
            if self._pending_since is None:
                return None
            elapsed = self._clock() - self._pending_since
            self._pending_since = None
            self.history.append(elapsed)
            self._recoveries.inc()
            self._duration.record(elapsed)
        logger.info("elastic recovery: %.2fs (worker loss -> first "
                    "post-restore training progress)", elapsed)
        events.emit(events.RECOVERY_DONE, duration_s=round(elapsed, 6))
        return elapsed

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "losses": int(self._losses.value()),
                "recoveries": len(self.history),
                "recovery_durations_s": list(self.history),
                "pending": self._pending_since is not None,
            }
