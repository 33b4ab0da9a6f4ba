"""Task tracing: append-only JSONL span events (the port's copy of the JAX
package's common/events.py).

Each emit appends one JSON object per line to the configured file
(O_APPEND; a line is far under PIPE_BUF, so concurrent appends from
several processes do not interleave):

    {"ts": ..., "role": "local", "pid": ..., "event": "task_dispatched",
     "task_id": 7, "worker_id": 0}

A task's life is the chain `task_dispatched -> task_claimed ->
task_trained -> task_reported`, filtered by task_id.  Checkpoint,
serving, stream-window, SLO and incident events share the stream, so an
operator can line a latency spike up against what caused it.

In-process observers (`add_observer`) see every emit, whether or not a
log file is configured: the incident flight recorder (common/flight.py)
and window lineage (common/lineage.py) hang off that tap.  An observer
never raises into the emitter.  `configure(..., max_bytes=)` rolls a
full log to `<path>.1` (one generation).  The log path travels to
subprocesses in `ELASTICDL_EVENT_LOG` (`export_env=True`,
`configure_from_env`).  Unconfigured, unobserved processes pay one
None-check per emit.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

ENV_EVENT_LOG = "ELASTICDL_EVENT_LOG"

TASK_DISPATCHED = "task_dispatched"    # master leased the task
TASK_CLAIMED = "task_claimed"          # worker received it
TASK_TRAINED = "task_trained"          # worker finished the shard
TASK_REPORTED = "task_reported"        # master recorded the result
CHECKPOINT_SAVED = "checkpoint_saved"
CHECKPOINT_RESTORED = "checkpoint_restored"
SERVING_RELOADED = "serving_reloaded"  # the reloader swapped a new step in
RECOVERY_STARTED = "recovery_started"  # worker loss opened an outage
RECOVERY_DONE = "recovery_done"        # first post-restore progress
STEP_PHASES = "step_phases"            # worker phase-time breakdown flush
STRAGGLER_DETECTED = "straggler_detected"  # master flagged a slow worker
POLICY_DECISION = "policy_decision"    # master policy engine acted
SERVING_REPLICA_RELAUNCHED = "serving_replica_relaunched"  # fleet replaced
FLEET_RELOAD_STEP = "fleet_reload_step"        # one replica hot-swapped
FLEET_RELOAD_REFUSED = "fleet_reload_refused"  # skew SLO blocked a reload
SLO_BREACH = "slo_breach"          # burn rate crossed an alert threshold
SLO_RECOVERED = "slo_recovered"    # burn rate back inside the budget
PREDICT_SPAN = "predict_span"      # one traced serve request, all phases
INCIDENT_CAPTURED = "incident_captured"  # flight recorder wrote a bundle
STORE_GROWN = "store_grown"        # tiered store lazily grew vocab rows
STORE_TIER_SWAPPED = "store_tier_swapped"  # serving adopted tier metadata
STREAM_WINDOW_SEALED = "stream_window_sealed"  # a stream window filled
STREAM_WINDOW_ARMED = "stream_window_armed"    # window became queue tasks
STREAM_WINDOW_DROPPED = "stream_window_dropped"  # bounded buffer lost one
STREAM_WINDOW_RELEASED = "stream_window_released"  # ledger acked trained
STREAM_WINDOW_RESTORED = "stream_window_restored"  # un-acked replayed
STORE_SHARD_HANDOFF = "store_shard_handoff"  # row range moved to successor
SERVING_SCALE = "serving_scale"    # serving policy engine scaled the fleet
WINDOW_SPAN = "window_span"        # one window-lineage phase stamp
PROGRAM_COMPILED = "program_compiled"  # a registered program compiled
RECOMPILE_STORM = "recompile_storm"    # a program blew its signature budget

#: Every event name this stream may carry; `emit` refuses any other.
VOCABULARY = frozenset({
    TASK_DISPATCHED, TASK_CLAIMED, TASK_TRAINED, TASK_REPORTED,
    CHECKPOINT_SAVED, CHECKPOINT_RESTORED, SERVING_RELOADED,
    RECOVERY_STARTED, RECOVERY_DONE, STEP_PHASES, STRAGGLER_DETECTED,
    POLICY_DECISION, SERVING_REPLICA_RELAUNCHED, FLEET_RELOAD_STEP,
    FLEET_RELOAD_REFUSED, SLO_BREACH, SLO_RECOVERED, PREDICT_SPAN,
    INCIDENT_CAPTURED, STORE_GROWN, STORE_TIER_SWAPPED,
    STREAM_WINDOW_SEALED, STREAM_WINDOW_ARMED, STREAM_WINDOW_DROPPED,
    STREAM_WINDOW_RELEASED, STREAM_WINDOW_RESTORED, STORE_SHARD_HANDOFF,
    SERVING_SCALE, WINDOW_SPAN, PROGRAM_COMPILED, RECOMPILE_STORM,
})

#: Closed `action` / `reason` vocabularies of POLICY_DECISION events.
POLICY_ACTIONS = frozenset({"evict", "scale_up", "scale_down"})
POLICY_REASONS = frozenset({
    "straggler", "backlog", "data_wait", "stream_lag",
})

#: Closed `action` / `reason` vocabularies of SERVING_SCALE events;
#: `scale_aborted` records an action the fleet.scale fault point aborted.
SERVING_SCALE_ACTIONS = frozenset({
    "scale_up", "scale_down", "scale_aborted",
})
SERVING_SCALE_REASONS = frozenset({
    "burn_rate", "shed_ratio", "batch_fill", "idle", "reload_guard",
    "fault",
})

#: Closed vocabularies of the serve-path PREDICT_SPAN event: `phase`
#: names one timed hop inside a request (the keys a span's `phases_s`
#: may carry); `reason` is the routing outcome ("sampled", or one of
#: the always-captured error/shed/failover outcomes).
SPAN_PHASES = frozenset({
    "route", "queue_wait", "batch_form", "pad", "compute",
    "unpack", "respond",
    # queue_wait's parts, by what the batcher's dispatch thread was doing
    # (they sum to it): waiting out the oldest request's deadline, busy
    # with other batches, and late to wake for a due batch
    "queue_held", "queue_behind", "queue_wake",
})

#: Names of the in-process span recorder's spans (common/profiler.py
#: `SPANS`): the request phases above, the batcher's dispatch-thread
#: states and request spans, the engine's and the trainer's host legs.
#: A graph replay's range is `serve.replay.b<bucket>` or `train.replay`.
RECORDER_SPANS = SPAN_PHASES | frozenset({
    "dispatch.empty", "dispatch.held", "dispatch.wake", "dispatch.form",
    "dispatch.engine", "admit", "queue", "batch", "copy_in",
    "serve.replay", "train.stage", "train.call", "train.check",
    "train.load", "train.replay", "train.finish",
})
SPAN_REASONS = frozenset({
    "sampled", "error", "shed", "failover", "invalid", "internal",
})

#: Closed vocabularies of the train-path WINDOW_SPAN event, the lineage
#: twin of PREDICT_SPAN.  Each emit stamps the hop that CLOSES one named
#: phase of a window's ingest -> first-serve life; common/lineage.py
#: joins the stamps.  `reason` names the hop: "sealed" / "replayed"
#: (ingest), "armed" / "rearmed" (first arm vs a journal replay after a
#: restart), "trained" / "admitted" per task, "produced" / "reloaded" /
#: "served" for the checkpoint -> fleet -> first-predict tail, and
#: "dropped" when the window is forfeited.
WINDOW_PHASES = frozenset({
    "ingest_wait", "arm_wait", "train", "admission", "checkpoint",
    "reload_wait", "serve_wait",
})
WINDOW_REASONS = frozenset({
    "sealed", "replayed", "armed", "rearmed", "trained", "admitted",
    "produced", "reloaded", "served", "dropped",
})

#: Triggers the incident flight recorder (common/flight.py) captures
#: on; the `reason` of every INCIDENT_CAPTURED event and bundle manifest
#: draws from this set.
INCIDENT_TRIGGERS = frozenset({
    "slo_breach", "policy_eviction", "reload_refused", "manual",
    "tier1_failure", "window_dropped", "recompile_storm",
})

_lock = threading.Lock()
_fh = None
_path: Optional[str] = None
_role = ""
_worker_id: Optional[int] = None
_max_bytes: Optional[int] = None
# In-process taps: each observer is called with every emitted record,
# whether or not a log file is configured.  Observers must be cheap.
_observers: List = []


def add_observer(fn) -> None:
    """Register an in-process tap on the event stream: `fn(record)` is
    called for every emit, also when no log file is configured."""
    with _lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_observer(fn) -> None:
    with _lock:
        if fn in _observers:
            _observers.remove(fn)


def rotated_path(path: str) -> str:
    """Where `configure(max_bytes=...)` rolls a full log to."""
    return path + ".1"


def configure(path: Optional[str], role: str = "",
              worker_id: Optional[int] = None,
              export_env: bool = False,
              max_bytes: Optional[int] = None) -> None:
    """Point this process's event stream at `path` (None disables).
    `export_env=True` also publishes the path to the environment, so
    subprocesses launched later inherit it.  `max_bytes` caps the file:
    past the cap the log rolls to `<path>.1` (one generation)."""
    global _fh, _path, _role, _worker_id, _max_bytes
    with _lock:
        if _fh is not None:
            try:
                _fh.close()
            except OSError:
                pass
            _fh = None
        _path = path or None
        _role = role
        _worker_id = worker_id
        _max_bytes = int(max_bytes) if max_bytes else None
        if _path:
            directory = os.path.dirname(_path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            _fh = open(_path, "a", buffering=1)
    if export_env and path:
        os.environ[ENV_EVENT_LOG] = path


def _maybe_rotate_locked() -> None:
    """Roll `<path>` to `<path>.1` when past the size cap.  The caller
    holds `_lock`.  A failed rotation never breaks emit."""
    global _fh
    if _max_bytes is None or _fh is None or _path is None:
        return
    try:
        if _fh.tell() < _max_bytes:
            return
        _fh.close()
        os.replace(_path, rotated_path(_path))
        _fh = open(_path, "a", buffering=1)
    except OSError:
        try:
            if _fh is None or _fh.closed:
                _fh = open(_path, "a", buffering=1)
        except OSError:
            _fh = None


def configure_from_env(role: str = "",
                       worker_id: Optional[int] = None) -> bool:
    """Subprocess wire: trace when the parent exported a log path.
    Returns True when tracing is on."""
    path = os.environ.get(ENV_EVENT_LOG, "")
    if path:
        configure(path, role=role, worker_id=worker_id)
    return bool(path)


def enabled() -> bool:
    return _fh is not None


def emit(event: str, **fields) -> None:
    """Append one span event and feed the in-process observers.  A no-op
    unless configured or observed; an observer's exception and a failed
    write are swallowed: tracing must not fail the training loop."""
    if event not in VOCABULARY:
        raise ValueError(f"unknown span event {event!r}")
    fh = _fh
    observers = _observers
    if fh is None and not observers:
        return
    record = {
        "ts": time.time(),
        "role": _role,
        "pid": os.getpid(),
        "event": event,
    }
    if _worker_id is not None and "worker_id" not in fields:
        record["worker_id"] = _worker_id
    record.update(fields)
    for observer in list(observers):
        try:
            observer(record)
        except Exception:   # an observer never fails the emitter
            pass
    if fh is None:
        return
    try:
        line = json.dumps(record, sort_keys=True, default=str)
        with _lock:
            if _fh is not None:
                _fh.write(line + "\n")
                _maybe_rotate_locked()
    except (OSError, ValueError, TypeError):
        pass


def _read_one(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out


def read_events(path: str) -> List[dict]:
    """Parse an event log; malformed lines (torn writes from a killed
    process) are skipped.  A rolled generation (`<path>.1`) is read
    first, so the list stays in emit order."""
    return _read_one(rotated_path(path)) + _read_one(path)


def task_chain(events: List[dict], task_id: int) -> List[str]:
    """The ordered event names recorded for one task."""
    return [
        e["event"] for e in sorted(
            (e for e in events if e.get("task_id") == task_id),
            key=lambda e: e.get("ts", 0.0),
        )
    ]
