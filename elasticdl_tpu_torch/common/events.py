"""Task tracing: append-only JSONL span events (a subset of the JAX
package's common/events.py: `configure`, `emit`, `read_events`,
`task_chain` and the task, checkpoint, serving, tiered-store and
straggler event names).

Each emit appends one JSON object per line to the configured file:

    {"ts": ..., "role": "local", "pid": ..., "event": "task_dispatched",
     "task_id": 7, "worker_id": 0}

A task's life is the chain `task_dispatched -> task_claimed ->
task_trained -> task_reported`, filtered by task_id.  Unconfigured
processes pay one None-check per emit.  The environment wire to
subprocess workers, log rotation and in-process observers wait for the
cluster slice of the port.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

TASK_DISPATCHED = "task_dispatched"    # master leased the task
TASK_CLAIMED = "task_claimed"          # worker received it
TASK_TRAINED = "task_trained"          # worker finished the shard
TASK_REPORTED = "task_reported"        # master recorded the result
CHECKPOINT_SAVED = "checkpoint_saved"
CHECKPOINT_RESTORED = "checkpoint_restored"
STEP_PHASES = "step_phases"            # worker phase-time breakdown flush
SERVING_RELOADED = "serving_reloaded"  # the reloader swapped a new step in
PREDICT_SPAN = "predict_span"          # one traced serve request, all phases
STORE_GROWN = "store_grown"            # tiered store lazily grew vocab rows
STORE_TIER_SWAPPED = "store_tier_swapped"  # serving adopted tier metadata
STRAGGLER_DETECTED = "straggler_detected"  # master flagged a slow worker

VOCABULARY = frozenset({
    TASK_DISPATCHED, TASK_CLAIMED, TASK_TRAINED, TASK_REPORTED,
    CHECKPOINT_SAVED, CHECKPOINT_RESTORED, STEP_PHASES, SERVING_RELOADED,
    PREDICT_SPAN, STORE_GROWN, STORE_TIER_SWAPPED, STRAGGLER_DETECTED,
})

_lock = threading.Lock()
_fh = None
_role = ""


def configure(path: Optional[str], role: str = "") -> None:
    """Point this process's event stream at `path` (None disables)."""
    global _fh, _role
    with _lock:
        if _fh is not None:
            _fh.close()
            _fh = None
        _role = role
        if path:
            directory = os.path.dirname(path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            _fh = open(path, "a", buffering=1)


def emit(event: str, **fields) -> None:
    """Append one span event; a no-op unless configured."""
    if event not in VOCABULARY:
        raise ValueError(f"unknown span event {event!r}")
    if _fh is None:
        return
    record = {
        "ts": time.time(),
        "role": _role,
        "pid": os.getpid(),
        "event": event,
    }
    record.update(fields)
    line = json.dumps(record, sort_keys=True, default=str)
    with _lock:
        if _fh is not None:
            _fh.write(line + "\n")


def read_events(path: str) -> List[dict]:
    """Parse an event log; malformed lines (torn writes from a killed
    process) are skipped."""
    out: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def task_chain(events: List[dict], task_id: int) -> List[str]:
    """The ordered event names recorded for one task."""
    return [
        e["event"] for e in sorted(
            (e for e in events if e.get("task_id") == task_id),
            key=lambda e: e.get("ts", 0.0),
        )
    ]
