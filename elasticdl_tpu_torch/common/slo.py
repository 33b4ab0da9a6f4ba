"""Declarative SLOs with multi-window burn-rate alerting (the port's copy
of the JAX package's common/slo.py).

`MetricHistory` (common/history.py) records what happened; this module
judges it.  An `SloSpec` states an objective over one history series
and the evaluator turns windowed evidence into a burn rate — how fast
the error budget is being spent — using the standard multi-window rule:

    bad_ratio(window) = fraction of bad observations in the window
    burn_rate(window) = bad_ratio / (1 - target)

A burn rate of 1.0 spends exactly the budget the target allows; 14x
over a short window means the budget is gone within hours.  The state
machine: `breach` when the fast-window burn crosses `fast_burn` or the
slow-window burn crosses `slow_burn`; recovery back to `ok` only once
the fast-window burn drops under 1.0 (fully inside budget again) —
hysteresis so a breach does not flap while the budget is still being
spent.  `no_data` before any evidence exists.

Three spec kinds cover the shipped SLOs:

- `gauge`: bad sample = windowed gauge sample over `objective`.
- `histogram`: bad observation = windowed bucket-delta observation over
  `objective` (so a past stall ages out of the window — a lifetime p99
  would never recover).
- `ratio`: bad/total counter deltas (e.g. request errors / requests).

Like the policy engine, the evaluator runs on an injectable clock
(`interval_s=0` disables the thread; tests tick by hand), keeps a
clock-free `decisions` list that is byte-comparable across same-seed
runs, and emits the `slo_breach`/`slo_recovered` span-event pair.

The SLO name vocabulary is closed (`SLO_NAMES`, like
`POLICY_ACTIONS`).  In a Local job nothing serves, so the four shipped
SLOs stay `no_data`; `staleness_p99` judges the samples a
`FreshnessTracker` (master/freshness.py) records.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.history import MetricHistory
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

# ---- closed SLO-name vocabulary ----------------------------------------

SLO_STALENESS_P99 = "staleness_p99"
SLO_FLEET_SKEW = "fleet_skew"
SLO_PREDICT_AVAILABILITY = "predict_availability"
SLO_PREDICT_SHED_RATIO = "predict_shed_ratio"

SLO_NAMES = frozenset({
    SLO_STALENESS_P99,
    SLO_FLEET_SKEW,
    SLO_PREDICT_AVAILABILITY,
    SLO_PREDICT_SHED_RATIO,
})

STATE_NO_DATA = "no_data"
STATE_OK = "ok"
STATE_BREACH = "breach"
STATES = (STATE_NO_DATA, STATE_OK, STATE_BREACH)

KINDS = ("gauge", "histogram", "ratio")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One objective over one history series."""

    name: str             # member of SLO_NAMES
    kind: str             # member of KINDS
    series: str           # gauge/histogram series; ratio: bad counter
    objective: float      # value bound (gauge/histogram); unused: ratio
    target: float = 0.99  # promised good fraction; budget = 1 - target
    total_series: str = ""    # ratio kind: the total counter
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.0
    slow_burn: float = 6.0

    def __post_init__(self):
        assert self.name in SLO_NAMES, self.name
        assert self.kind in KINDS, self.kind
        assert 0.0 < self.target < 1.0, self.target
        if self.kind == "ratio":
            assert self.total_series, "ratio kind needs total_series"


def shipped_specs(args=None) -> List[SloSpec]:
    """The SLOs every master evaluates, parameterized by flags."""
    staleness_s = float(getattr(args, "slo_staleness_p99_s", 60.0) or 60.0)
    skew = int(getattr(args, "serving_step_skew_slo", 0) or 0)
    return [
        SloSpec(
            name=SLO_STALENESS_P99,
            kind="histogram",
            series="master_train_to_serve_staleness_seconds",
            objective=staleness_s,
        ),
        SloSpec(
            name=SLO_FLEET_SKEW,
            kind="gauge",
            series="serving_fleet_model_step_skew_steps",
            objective=float(skew if skew > 0 else 8),
        ),
        SloSpec(
            name=SLO_PREDICT_AVAILABILITY,
            kind="ratio",
            series="rpc_fleet_request_errors_total",
            total_series="rpc_fleet_requests_total",
            objective=0.0,
            target=0.999,
        ),
        # A whole-fleet shed is a request the caller did not get served
        # even though no replica errored — admission control answering
        # for everyone.  Distinct from availability (errors) because the
        # remediation differs: sheds want capacity (the serving policy
        # engine scales on this burn), errors want repair.
        SloSpec(
            name=SLO_PREDICT_SHED_RATIO,
            kind="ratio",
            series="rpc_fleet_sheds_total",
            total_series="rpc_fleet_requests_total",
            objective=0.0,
            target=0.95,
            fast_burn=8.0,
        ),
    ]


class SloEvaluator:
    """Evaluates SloSpecs over a MetricHistory on an injectable-clock
    loop; exports `master_slo_status_info{slo,state}` one-hot gauges."""

    def __init__(
        self,
        history: MetricHistory,
        specs: Optional[Sequence[SloSpec]] = None,
        interval_s: float = 0.0,
        clock: Callable[[], float] = time.time,
        on_breach: Optional[Callable[[dict], None]] = None,
    ):
        self.history = history
        # Incident hook (common/flight.py): called once per new breach
        # decision, OUTSIDE the evaluator lock — the flight recorder's
        # capture walks Master.snapshot(), which re-enters this
        # evaluator's snapshot() and would deadlock under the lock.
        self._on_breach = on_breach
        self.specs = list(specs if specs is not None else shipped_specs())
        self.interval_s = float(interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state: Dict[str, str] = {
            spec.name: STATE_NO_DATA for spec in self.specs
        }
        self._last: Dict[str, dict] = {}
        self.decisions: List[dict] = []
        self.ticks = 0
        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._status = self.metrics_registry.gauge(
            "master_slo_status_info",
            "One-hot SLO state: 1 on the {slo,state} child matching the "
            "evaluator's current judgment, 0 elsewhere",
            labelnames=("slo", "state"),
        )
        for spec in self.specs:
            self._set_status_locked(spec.name, STATE_NO_DATA)

    # ---- loop (policy-engine style) -------------------------------------

    def start(self) -> bool:
        if self.interval_s <= 0 or self._thread is not None:
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="slo-evaluator", daemon=True
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
                logger.exception("slo evaluation failed")

    # ---- evaluation -----------------------------------------------------

    def tick(self) -> None:
        with self._lock:
            breaches = self._tick_locked()
        if self._on_breach is not None:
            for decision in breaches:
                try:
                    self._on_breach(dict(decision))
                except Exception:
                    logger.exception("slo on_breach hook failed")

    def _tick_locked(self) -> List[dict]:
        self.ticks += 1
        breaches: List[dict] = []
        for spec in self.specs:
            decision = self._evaluate_locked(spec)
            if decision is not None \
                    and decision.get("event") == events.SLO_BREACH:
                breaches.append(decision)
        return breaches

    def _bad_ratio(self, spec: SloSpec,
                   window_s: float) -> Optional[float]:
        if spec.kind == "gauge":
            return self.history.exceedance_ratio(
                spec.series, spec.objective, window_s
            )
        if spec.kind == "histogram":
            win = self.history.histogram_exceedance(
                spec.series, spec.objective, window_s
            )
            if win is None:
                return None
            bad, total = win
            return bad / total if total else 0.0
        # ratio: no traffic in the window burns nothing
        if self.history.latest(spec.total_series) is None:
            return None
        total = self.history.counter_delta(spec.total_series, window_s)
        if total <= 0:
            return 0.0
        bad = self.history.counter_delta(spec.series, window_s)
        return min(1.0, bad / total)

    def _evaluate_locked(self, spec: SloSpec) -> Optional[dict]:
        budget = max(1e-9, 1.0 - spec.target)
        fast_ratio = self._bad_ratio(spec, spec.fast_window_s)
        slow_ratio = self._bad_ratio(spec, spec.slow_window_s)
        prev = self._state[spec.name]
        if fast_ratio is None:
            state = STATE_NO_DATA if prev == STATE_NO_DATA else prev
            fast_burn = slow_burn = 0.0
        else:
            fast_burn = fast_ratio / budget
            slow_burn = (slow_ratio or 0.0) / budget
            if (fast_burn >= spec.fast_burn
                    or slow_burn >= spec.slow_burn):
                state = STATE_BREACH
            elif prev == STATE_BREACH:
                # hysteresis: recover only once fully inside budget
                state = STATE_OK if fast_burn < 1.0 else STATE_BREACH
            else:
                state = STATE_OK
        evidence = {
            "slo": spec.name,
            "state": state,
            "fast_burn": round(fast_burn, 4),
            "slow_burn": round(slow_burn, 4),
            "fast_window_s": spec.fast_window_s,
            "slow_window_s": spec.slow_window_s,
            "objective": spec.objective,
            "target": spec.target,
        }
        self._last[spec.name] = evidence
        if state == prev:
            return None
        self._state[spec.name] = state
        self._set_status_locked(spec.name, state)
        if state == STATE_BREACH:
            return self._record_locked(events.SLO_BREACH, evidence)
        if prev == STATE_BREACH:
            return self._record_locked(events.SLO_RECOVERED, evidence)
        return None

    def _set_status_locked(self, slo: str, state: str) -> None:
        assert state in STATES, state
        for candidate in STATES:
            self._status.labels(slo=slo, state=candidate).set(
                1.0 if candidate == state else 0.0
            )

    def _record_locked(self, event: str, evidence: dict) -> dict:
        assert event in events.VOCABULARY, event
        decision = dict(evidence)
        decision["event"] = event
        decision["tick"] = self.ticks
        self.decisions.append(decision)
        events.emit(event, **evidence)
        logger.info("slo %s: %s", evidence["slo"], event)
        return decision

    # ---- reads ----------------------------------------------------------

    def state(self, slo: str) -> str:
        with self._lock:
            return self._state[slo]

    def report(self) -> List[dict]:
        """Per-SLO state + burn rates + window evidence, spec order —
        the payload `elasticdl slo` renders."""
        with self._lock:
            out = []
            for spec in self.specs:
                row = self._last.get(spec.name) or {
                    "slo": spec.name,
                    "state": self._state[spec.name],
                    "fast_burn": 0.0,
                    "slow_burn": 0.0,
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                    "objective": spec.objective,
                    "target": spec.target,
                }
                out.append(dict(row))
            return out

    def max_burn(self) -> float:
        """Largest fast-window burn rate across SLOs right now (bench)."""
        with self._lock:
            return max(
                (row.get("fast_burn", 0.0) for row in self._last.values()),
                default=0.0,
            )

    def set_on_breach(self, fn: Optional[Callable[[dict], None]]) -> None:
        """Attach (or replace) the breach hook after construction — the
        online pipeline builds its evaluator before any flight recorder
        exists to capture on it."""
        self._on_breach = fn

    def burn_rates(self) -> Dict[str, float]:
        """Per-SLO fast-window burn rates right now — the signal surface
        the serving policy engine reads when it wants to attribute a
        scale decision to one SLO rather than the fleet-wide max."""
        with self._lock:
            return {
                name: row.get("fast_burn", 0.0)
                for name, row in sorted(self._last.items())
            }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "states": dict(self._state),
                "slos": [dict(self._last.get(s.name, {"slo": s.name}))
                         for s in self.specs],
                "decisions": list(self.decisions),
            }
