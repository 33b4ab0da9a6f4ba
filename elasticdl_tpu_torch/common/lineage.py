"""Window lineage: end-to-end freshness decomposition per stream window
(the port's copy of the JAX package's common/lineage.py).

The SLOs can say THAT train->serve staleness breached; this module says
WHERE the time went.  Every hop of a window's life emits a
`window_span` event (closed vocabularies in `common/events.py`) carrying
the window id, the phase the hop CLOSES, and an `at_unix_s` stamp drawn
from the hop's injectable clock — which is what keeps the whole lineage
byte-stable under a fake clock:

    ingest (first record event time, stamped at stream seal)
      -> sealed      closes ingest_wait   (StreamReader)
      -> armed       closes arm_wait      (TaskManager.arm_window)
      -> trained     closes train         (per leased task, max wins)
      -> admitted    closes admission     (tiered-store fold, max wins)
      -> produced    closes checkpoint    (CheckpointSaver manifest stamp)
      -> reloaded    closes reload_wait   (first fleet reload >= the step)
      -> served      closes serve_wait    (first Predict >= the step)

`WindowLineage` is a pure consumer tapped on the event stream
(`events.add_observer`, the flight-recorder pattern): it joins the
stamps into per-window decompositions, feeds the
`master_window_phase_seconds{phase=...}` histograms, and keeps a bounded
ring of completed lineage records.  Because every boundary is a stamp on
ONE monotone clock, the seven phase durations sum to the window's
measured end-to-end staleness (served - ingest) exactly.

In the port, the stream reader stamps the seal and replay and the task
manager the arm; the train, admission, checkpoint, reload and serve
stamps come from the online loop (`online/pipeline.py`), which waits for
its slice of the port (ROADMAP.md queue 1, item 10(b)).  Until then
`decompose` leaves a window open at `train`.

Replay attribution: a window replayed after a master restart keeps its
FIRST-SEEN ingest/seal stamps; the replay stamp only fills them in when
the original seal was never observed (it carries the journaled
watermark, i.e. the original event time), so replayed windows are
always attributed to their original ingest timestamps.

The module-level helpers (`new_state` / `apply_stamp` / `decompose` /
`from_events`) are the same joining logic run offline over an event log
(the JAX package's `elasticdl lineage`, `trace` and `incident` CLIs;
the port's wait for ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib

#: Phase order IS the window's life order: each entry names the segment
#: that ends at the matching boundary stamp.
PHASE_ORDER = (
    "ingest_wait", "arm_wait", "train", "admission", "checkpoint",
    "reload_wait", "serve_wait",
)

#: Boundary stamp that closes each phase, in the same order.
_PHASE_CLOSERS = (
    "sealed_unix_s", "armed_unix_s", "trained_unix_s", "admitted_unix_s",
    "produced_unix_s", "reloaded_unix_s", "served_unix_s",
)


def new_state(window_id: int) -> dict:
    """Empty per-window join state: boundary stamps + attribution flags."""
    return {
        "window_id": int(window_id),
        "ingest_unix_s": None,
        "sealed_unix_s": None,
        "armed_unix_s": None,
        "trained_unix_s": None,
        "admitted_unix_s": None,
        "produced_unix_s": None,
        "reloaded_unix_s": None,
        "served_unix_s": None,
        "step": 0,              # max model step a trained stamp carried
        "produced_step": None,  # checkpoint step that covered the window
        "tasks_trained": 0,
        "records": 0,
        "replayed": False,
        "rearmed": False,
        "dropped": False,
    }


def apply_stamp(state: dict, record: dict) -> None:
    """Fold one `window_span` event into the join state.  First stamp
    wins every boundary except trained/admitted (per-task, last task
    wins) — which is exactly what pins replayed windows to their
    original ingest/arm times."""
    reason = record.get("reason")
    at = record.get("at_unix_s")
    at = float(at) if at is not None else None
    if reason == "sealed":
        if state["sealed_unix_s"] is None:
            state["sealed_unix_s"] = at
            ingest = record.get("ingest_unix_s", at)
            state["ingest_unix_s"] = (
                float(ingest) if ingest is not None else at
            )
            state["records"] = int(record.get("records", 0))
    elif reason == "replayed":
        state["replayed"] = True
        if state["ingest_unix_s"] is None:
            # Original seal never observed: the replay stamp carries the
            # journaled watermark = the original event time.
            ingest = record.get("ingest_unix_s")
            if ingest is not None:
                state["ingest_unix_s"] = float(ingest)
                state["sealed_unix_s"] = float(ingest)
    elif reason in ("armed", "rearmed"):
        if reason == "rearmed":
            state["rearmed"] = True
        if state["armed_unix_s"] is None:
            state["armed_unix_s"] = at
    elif reason == "trained":
        if at is not None:
            prev = state["trained_unix_s"]
            state["trained_unix_s"] = at if prev is None else max(prev, at)
        state["step"] = max(state["step"], int(record.get("step", 0)))
        state["tasks_trained"] += 1
    elif reason == "admitted":
        if at is not None:
            prev = state["admitted_unix_s"]
            state["admitted_unix_s"] = (
                at if prev is None else max(prev, at)
            )
    elif reason == "produced":
        if state["produced_unix_s"] is None:
            state["produced_unix_s"] = at
            state["produced_step"] = int(record.get("step", 0))
    elif reason == "reloaded":
        if state["reloaded_unix_s"] is None:
            state["reloaded_unix_s"] = at
    elif reason == "served":
        if state["served_unix_s"] is None:
            state["served_unix_s"] = at
    elif reason == "dropped":
        state["dropped"] = True


def decompose(state: dict, now: Optional[float] = None) -> dict:
    """Phase durations for one window.  Complete windows carry all seven
    phases and `e2e_s` = served - ingest (== the phase sum, same monotone
    clock).  Open windows carry the closed phases plus the CURRENT
    blocked phase's elapsed wait against `now` (defaults to the last
    stamp seen) — so a mid-incident postmortem can still name the phase
    the fleet is stuck in."""
    phases: Dict[str, float] = {}
    prev = state["ingest_unix_s"]
    blocked = None
    for phase, closer in zip(PHASE_ORDER, _PHASE_CLOSERS):
        at = state[closer]
        if prev is None:
            break
        if at is None:
            blocked = phase
            if now is not None and now > prev:
                phases[phase] = round(now - prev, 6)
            break
        phases[phase] = round(max(0.0, at - prev), 6)
        prev = at
    complete = state["served_unix_s"] is not None and (
        state["ingest_unix_s"] is not None
    )
    out = {
        "window_id": state["window_id"],
        "phases": phases,
        "complete": complete,
        "blocked_phase": blocked,
        "replayed": state["replayed"],
        "rearmed": state["rearmed"],
        "dropped": state["dropped"],
        "tasks": state["tasks_trained"],
        "records": state["records"],
        "step": state["produced_step"],
    }
    if state["ingest_unix_s"] is not None:
        # present even for open windows: replay-attribution checks need
        # the original ingest stamp before the window completes
        out["ingest_unix_s"] = round(state["ingest_unix_s"], 6)
    if complete:
        out["served_unix_s"] = round(state["served_unix_s"], 6)
        out["e2e_s"] = round(
            max(0.0, state["served_unix_s"] - state["ingest_unix_s"]), 6
        )
    else:
        out["e2e_s"] = round(sum(phases.values()), 6)
    return out


def from_events(evts: List[dict]) -> Dict[int, dict]:
    """Offline join: fold an event log's `window_span` (and the buffer's
    `stream_window_dropped`) records into per-window states, keyed by
    window id."""
    states: Dict[int, dict] = {}
    for record in evts:
        event = record.get("event")
        if event == events.WINDOW_SPAN:
            wid = record.get("window_id")
            if wid is None:
                continue
            wid = int(wid)
            state = states.get(wid)
            if state is None:
                state = states[wid] = new_state(wid)
            apply_stamp(state, record)
        elif event == events.STREAM_WINDOW_DROPPED:
            wid = record.get("window")
            if wid is None:
                continue
            wid = int(wid)
            state = states.get(wid)
            if state is None:
                state = states[wid] = new_state(wid)
            state["dropped"] = True
    return states


def dominant_phase(decomps: List[dict]) -> Optional[str]:
    """The phase holding the most total seconds across the given
    decompositions — the postmortem's one-line attribution."""
    totals = {p: 0.0 for p in PHASE_ORDER}
    for d in decomps:
        for phase, seconds in d.get("phases", {}).items():
            if phase in totals:
                totals[phase] += float(seconds)
    best = max(PHASE_ORDER, key=lambda p: totals[p])
    return best if totals[best] > 0.0 else None


def _p99(values: List[float]) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(0.99 * len(ordered)))
    return round(ordered[idx], 6)


class WindowLineage:
    """Live lineage aggregator: an event-stream tap (install/close, the
    flight-recorder pattern) joining `window_span` stamps into completed
    lineage records, per-phase histograms, and the join queries the
    pipeline uses to fan broadcast hops (checkpoint / reload / first
    serve) out into per-window stamps."""

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        capacity: int = 256,
        registry: Optional[metrics_lib.MetricsRegistry] = None,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._open: Dict[int, dict] = {}
        self._completed: deque = deque(maxlen=int(capacity))
        self._traced_total = 0
        self._replayed_total = 0
        self._dropped_total = 0
        self.registry = registry or metrics_lib.MetricsRegistry()
        self._phase_hist = self.registry.histogram(
            "master_window_phase_seconds",
            "one window-lineage phase duration, labeled by phase "
            "(the staleness decomposition)",
            max_value=3600.0,
            labelnames=("phase",),
        )
        self._e2e_hist = self.registry.histogram(
            "master_window_e2e_seconds",
            "stream ingest to first post-reload serve, per window",
            max_value=3600.0,
        )
        self._traced = self.registry.counter(
            "master_lineage_windows_total",
            "windows whose lineage completed (first serve observed)",
        )
        self._installed = False

    # ---- event tap ------------------------------------------------------

    def install(self) -> None:
        if not self._installed:
            events.add_observer(self.observe)
            self._installed = True

    def close(self) -> None:
        if self._installed:
            events.remove_observer(self.observe)
            self._installed = False

    def observe(self, record: dict) -> None:
        """Event-stream tap; must never raise (events.emit contract)."""
        event = record.get("event")
        if event == events.WINDOW_SPAN:
            wid = record.get("window_id")
            if wid is None:
                return
            self._stamp(int(wid), record)
        elif event == events.STREAM_WINDOW_DROPPED:
            wid = record.get("window")
            if wid is None:
                return
            with self._lock:
                state = self._open.get(int(wid))
                if state is not None:
                    state["dropped"] = True
                    self._finalize_dropped_locked(int(wid), state)

    def _stamp(self, wid: int, record: dict) -> None:
        with self._lock:
            state = self._open.get(wid)
            if state is None:
                state = self._open[wid] = new_state(wid)
            apply_stamp(state, record)
            if record.get("reason") == "dropped":
                self._finalize_dropped_locked(wid, state)
            elif state["served_unix_s"] is not None:
                self._finalize_locked(wid, state)

    def _finalize_dropped_locked(self, wid: int, state: dict) -> None:
        """A dropped/forfeited window ends its life incomplete: its
        partial decomposition joins the ring flagged `dropped` (no
        histogram samples — it never reached serving)."""
        self._completed.append(decompose(state))
        self._dropped_total += 1
        del self._open[wid]

    def _finalize_locked(self, wid: int, state: dict) -> None:
        decomp = decompose(state)
        self._completed.append(decomp)
        self._traced_total += 1
        if decomp["replayed"]:
            self._replayed_total += 1
        del self._open[wid]
        self._traced.inc()
        for phase, seconds in decomp["phases"].items():
            self._phase_hist.labels(phase=phase).record(float(seconds))
        self._e2e_hist.record(float(decomp["e2e_s"]))

    # ---- pipeline join queries ------------------------------------------
    # The checkpoint / reload / first-serve hops are fleet-level facts;
    # the pipeline asks which open windows each one covers and emits one
    # per-window stamp for each, so the on-disk event stream stays fully
    # per-window (trace/lineage can replay it with no extra state).

    def windows_awaiting_checkpoint(self, step: int) -> List[int]:
        with self._lock:
            return sorted(
                wid for wid, s in self._open.items()
                if s["trained_unix_s"] is not None
                and s["produced_unix_s"] is None
                and s["step"] <= int(step)
            )

    def windows_awaiting_reload(self, step: int) -> List[int]:
        with self._lock:
            return sorted(
                wid for wid, s in self._open.items()
                if s["produced_unix_s"] is not None
                and s["reloaded_unix_s"] is None
                and s["produced_step"] is not None
                and s["produced_step"] <= int(step)
            )

    def windows_awaiting_serve(self, model_step: int) -> List[int]:
        with self._lock:
            return sorted(
                wid for wid, s in self._open.items()
                if s["reloaded_unix_s"] is not None
                and s["served_unix_s"] is None
                and s["produced_step"] is not None
                and s["produced_step"] <= int(model_step)
            )

    def discard(self, window_id: int) -> None:
        """Forget a forfeited window's open state (its `dropped` stamp
        already flagged the loss on the stream)."""
        with self._lock:
            self._open.pop(int(window_id), None)

    # ---- reads ----------------------------------------------------------

    def records(self) -> List[dict]:
        """Completed lineage records, oldest first — every field comes
        off the injectable clock, so under a fake clock this list is
        byte-stable across same-seed replays."""
        with self._lock:
            return [dict(d) for d in self._completed]

    def open_decompositions(self) -> List[dict]:
        """In-flight windows with their current blocked phase charged up
        to now — the mid-incident view."""
        now = self._clock()
        with self._lock:
            states = [dict(s) for s in self._open.values()]
        return [decompose(s, now=now) for s in states]

    def snapshot(self) -> dict:
        with self._lock:
            completed = list(self._completed)
            open_count = len(self._open)
            traced = self._traced_total
            replayed = self._replayed_total
            dropped = self._dropped_total
        phase_values: Dict[str, List[float]] = {p: [] for p in PHASE_ORDER}
        for d in completed:
            for phase, seconds in d["phases"].items():
                phase_values[phase].append(float(seconds))
        decomps = completed or self.open_decompositions()
        return {
            "windows_traced": traced,
            "windows_open": open_count,
            "replayed": replayed,
            "dropped": dropped,
            "e2e_p99_s": _p99(
                [d["e2e_s"] for d in completed if d["complete"]]
            ),
            "dominant_phase": dominant_phase(decomps),
            "phase_p99_s": {
                p: _p99(v) for p, v in phase_values.items() if v
            },
        }
