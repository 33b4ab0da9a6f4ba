"""Train-to-serve freshness: how stale is the model a Predict hit? (the
port's copy of the JAX package's master/freshness.py)

The trainer's `CheckpointSaver` stamps every manifest with the producer
`model_step` and wall time (the `produced` key); the serving engine
carries the stamp through each hot swap.  This tracker closes the loop
master-side: the fleet manager notes every newly produced checkpoint
(`note_produced`), the `FleetRouter` reports the `model_step` echoed in
each Predict response (`observe_response`), and the gap between the two
is the end-to-end staleness ROADMAP's online-learning item calls for:

    staleness_steps   = latest produced step - step served
    staleness_seconds = now - produced time of the latest step
                        (0 when the response already serves the latest)

Both feed bounded-error histograms
(`master_train_to_serve_staleness_{steps,seconds}`) whose windowed
bucket deltas the shipped `staleness_p99` SLO (common/slo.py) evaluates
via MetricHistory.  Injectable clock; `produced_time_fn` lets the
master read the manifest's own wall-time stamp
(`common/save_utils.py::read_produced_meta`) instead of observing late.

The online loop (online/pipeline.py) builds one beside its serving
fleet, whose router scores every response through it; a cluster job's
master (master/main.py) builds one with its serving fleet.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

from elasticdl_tpu_torch.common import metrics as metrics_lib


class FreshnessTracker:
    """Thread-safe latest-produced reference + staleness histograms."""

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        produced_time_fn: Optional[Callable[[int], Optional[float]]] = None,
        on_first_serve: Optional[Callable[[int, float], None]] = None,
    ):
        # `on_first_serve(model_step, at_unix_s)` fires once per distinct
        # model step the first time a Predict response echoes it — the
        # serve-side stamp window lineage joins against (called outside
        # the tracker's lock; must not call back into observe_response).
        self._clock = clock
        self._produced_time_fn = produced_time_fn
        self.on_first_serve = on_first_serve
        self._lock = threading.Lock()
        self._latest_step = 0
        self._latest_unix_s: Optional[float] = None
        self._served_steps: set = set()
        self._observations = 0
        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._steps_hist = self.metrics_registry.histogram(
            "master_train_to_serve_staleness_steps",
            "Producer model_step minus the model_step echoed per Predict "
            "response",
            min_value=1.0, max_value=65536.0, growth=2.0,
        )
        self._seconds_hist = self.metrics_registry.histogram(
            "master_train_to_serve_staleness_seconds",
            "Seconds since the newest checkpoint was produced while a "
            "Predict response still served an older step",
            min_value=1e-3, max_value=3600.0, growth=1.5,
        )

    def note_produced(self, step: int,
                      produced_unix_s: Optional[float] = None) -> bool:
        """Record a newly produced checkpoint step; returns True when it
        advances the latest-known step.  The wall time comes from (in
        order): the explicit argument, `produced_time_fn(step)` (the
        manifest stamp), or the injected clock."""
        step = int(step)
        if produced_unix_s is None and self._produced_time_fn is not None:
            produced_unix_s = self._produced_time_fn(step)
        if produced_unix_s is None:
            produced_unix_s = float(self._clock())
        with self._lock:
            if step <= self._latest_step:
                return False
            self._latest_step = step
            self._latest_unix_s = float(produced_unix_s)
            return True

    def latest(self) -> Tuple[int, Optional[float]]:
        with self._lock:
            return self._latest_step, self._latest_unix_s

    def observe_response(self, model_step: int) -> Tuple[int, float]:
        """Score one Predict response; returns the (steps, seconds)
        staleness recorded into the histograms."""
        latest_step, latest_unix_s = self.latest()
        steps = max(0, latest_step - int(model_step))
        if steps == 0 or latest_unix_s is None:
            seconds = 0.0
        else:
            seconds = max(0.0, float(self._clock()) - latest_unix_s)
        self._steps_hist.record(float(steps))
        self._seconds_hist.record(seconds)
        first_serve = False
        with self._lock:
            self._observations += 1
            if int(model_step) not in self._served_steps:
                self._served_steps.add(int(model_step))
                first_serve = True
        if first_serve and self.on_first_serve is not None:
            try:
                self.on_first_serve(
                    int(model_step), float(self._clock())
                )
            except Exception:  # lineage must never fail the serve path
                pass
        return steps, seconds

    def quantiles(self) -> dict:
        """p50/p99 staleness over the tracker's lifetime (bench detail)."""
        return {
            "staleness_p50_steps": self._steps_hist.quantile(0.5),
            "staleness_p99_steps": self._steps_hist.quantile(0.99),
            "staleness_p50_s": round(self._seconds_hist.quantile(0.5), 6),
            "staleness_p99_s": round(self._seconds_hist.quantile(0.99), 6),
        }

    def snapshot(self) -> dict:
        """Clock-free summary for Master.snapshot()/varz (the produced
        wall time stays out so chaos snapshots diff byte-stable)."""
        with self._lock:
            latest_step = self._latest_step
            observations = self._observations
        out = {"latest_step": latest_step, "observations": observations}
        out.update(self.quantiles())
        return out
