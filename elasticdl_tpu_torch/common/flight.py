"""Incident flight recorder: bounded rings of recent forensic evidence,
snapshotted into self-contained bundles when something goes wrong (the
port's copy of the JAX package's common/flight.py).

The observability stack records continuously (metrics, span events,
`MetricHistory` windows) but until now a breach captured nothing: by the
time an operator looked, the stalled-window requests and the decisions
that preceded them had rotated out of every buffer.  The
`FlightRecorder` closes that gap the way an aircraft recorder does —
always listening, dumping state at the moment of the incident:

- It taps the in-process span-event stream (`events.add_observer`) and
  keeps bounded rings of recent `predict_span` records, `window_span`
  lineage stamps, and decision-class events (policy decisions, fleet
  reloads/refusals, replica relaunches, SLO transitions).
- Triggers — an `slo_breach`, a policy eviction, a `reload_refused` —
  queue a capture; `flush()` (called from the SLO evaluator's
  `on_breach` hook, from `Master.stop()`, or by hand in tests) writes
  each queued capture as one incident bundle: a directory of JSON files
  (manifest + rings + `MetricHistory` windows + `Master.snapshot()` +
  fault-injection stats), rotation-capped so soak runs cannot fill the
  disk.
- `list_bundles` / `load_bundle` read bundles back; the `incident`
  command (client/incident.py) lists them and renders a postmortem
  report from one.
- With a program registry (common/programs.py), a recompile storm pends
  an immediate capture through the registry's `on_storm` hook, and
  every bundle gains `programs.json`: the registry's clock-free
  `forensics()` ledger.

Trigger detection is event-driven but capture is deferred to `flush()`
on purpose: decision events are emitted under their component's lock
(the fleet manager records inside `_maybe_reload_locked`), and a
synchronous capture would re-enter that lock through
`Master.snapshot()`.  The SLO evaluator's `on_breach` hook runs outside
its lock, so the breach path flushes immediately — the acceptance
scenario (a staleness burn) captures its bundle in the same tick the
breach is decided, deterministically.

Determinism: bundle names come from a per-recorder sequence counter
(never wall time), every JSON file is written `sort_keys=True`, and the
process-specific `ts`/`pid` fields are stripped from each record — a
same-seed chaos run produces byte-identical bundles (the same
discipline as the clock-free `decisions` lists).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

MANIFEST_NAME = "manifest.json"
BUNDLE_FORMAT = 1

#: Record fields that vary run-to-run (emit wall time, process id) and
#: are stripped from everything a bundle persists — forensics keys on
#: request ids, ticks, and phase durations, not on when the log line
#: happened to be written.
VOLATILE_KEYS = frozenset({"ts", "pid"})

#: Decision-class events the recorder rings alongside request spans.
DECISION_EVENTS = frozenset({
    events.POLICY_DECISION,
    events.STRAGGLER_DETECTED,
    events.SERVING_REPLICA_RELAUNCHED,
    events.FLEET_RELOAD_STEP,
    events.FLEET_RELOAD_REFUSED,
    events.SLO_BREACH,
    events.SLO_RECOVERED,
    events.SERVING_SCALE,
    # recompile_storm carries only deterministic fields (program,
    # signature count, budget) — unlike program_compiled, whose wall
    # seconds would break byte-stable bundles, so that one stays out.
    events.RECOMPILE_STORM,
})


def _stable(value):
    """Recursive copy with VOLATILE_KEYS dropped from every dict."""
    if isinstance(value, dict):
        return {
            k: _stable(v) for k, v in value.items()
            if k not in VOLATILE_KEYS
        }
    if isinstance(value, (list, tuple)):
        return [_stable(v) for v in value]
    return value


def _write_json(path: str, payload) -> None:
    with open(path, "w") as fh:
        json.dump(payload, fh, sort_keys=True, indent=2, default=str)
        fh.write("\n")


class FlightRecorder:
    """Bounded forensic rings + SLO/eviction/refusal-triggered bundles.

    `install()` taps the event stream; `close()` removes the tap.  The
    recorder is safe to construct without an incident_dir (rings still
    fill; captures are skipped) so wiring it is never the thing that
    breaks a master."""

    def __init__(
        self,
        incident_dir: Optional[str] = None,
        ring_capacity: int = 256,
        max_bundles: int = 8,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        history=None,
        program_registry=None,
    ):
        self._dir = incident_dir or None
        self._max_bundles = max(1, int(max_bundles))
        self._snapshot_fn = snapshot_fn
        self._history = history
        self._program_registry = program_registry
        if program_registry is not None:
            # the registry's storm hook runs with no locks held (on the
            # dispatching thread, after its ledger lock is released), so
            # an immediate pend+flush is a safe point, as for on_breach
            program_registry.set_on_storm(self.storm)
        capacity = max(1, int(ring_capacity))
        self._spans: deque = deque(maxlen=capacity)
        self._decisions: deque = deque(maxlen=capacity)
        self._lineage: deque = deque(maxlen=capacity)
        # RLock: capture emits INCIDENT_CAPTURED, which re-enters
        # observe() on this same thread through the event tap.
        self._lock = threading.RLock()
        self._pending: List[Tuple[str, tuple, dict]] = []
        self._armed_out: set = set()  # keys already captured, not re-armed
        self._seq = 0
        self._captured: List[str] = []

    # ---- event tap ------------------------------------------------------

    def install(self) -> "FlightRecorder":
        events.add_observer(self.observe)
        return self

    def close(self) -> None:
        events.remove_observer(self.observe)

    def observe(self, record: dict) -> None:
        """Event-stream tap: ring the record, queue trigger captures.
        Must never raise (it runs inside events.emit)."""
        event = record.get("event")
        with self._lock:
            if event == events.PREDICT_SPAN:
                self._spans.append(dict(record))
            elif event == events.WINDOW_SPAN:
                # the train-path lineage ring: a staleness postmortem
                # needs the window stamps that preceded the breach
                self._lineage.append(dict(record))
            elif event in DECISION_EVENTS:
                self._decisions.append(dict(record))
            if event == events.SLO_BREACH:
                self._pend_locked(
                    "slo_breach", ("slo_breach", record.get("slo")), record
                )
            elif event == events.SLO_RECOVERED:
                # the breach cleared: re-arm so the next one captures
                self._armed_out.discard(
                    ("slo_breach", record.get("slo"))
                )
            elif (event == events.POLICY_DECISION
                    and record.get("action") == "evict"):
                self._pend_locked(
                    "policy_eviction",
                    ("policy_eviction", record.get("worker_id")),
                    record,
                )
            elif event == events.FLEET_RELOAD_REFUSED:
                self._pend_locked(
                    "reload_refused",
                    ("reload_refused", record.get("pending_step")),
                    record,
                )
            elif event == events.STREAM_WINDOW_DROPPED:
                # a silently lost training window is an incident, not a
                # log line: bundle the rings around the drop
                self._pend_locked(
                    "window_dropped",
                    ("window_dropped", record.get("window")),
                    record,
                )
            elif event == events.RECOMPILE_STORM:
                # one bundle per storming program: the per-program key
                # plus _armed_out dedupe means a storm that keeps
                # retracing does not spam the incident dir
                self._pend_locked(
                    "recompile_storm",
                    ("recompile_storm", record.get("program")),
                    record,
                )

    def _pend_locked(self, trigger: str, key: tuple,
                     evidence: dict) -> None:
        assert trigger in events.INCIDENT_TRIGGERS, trigger
        if key in self._armed_out:
            return
        if any(k == key for _, k, _ in self._pending):
            return
        self._armed_out.add(key)
        self._pending.append((trigger, key, dict(evidence)))

    # ---- capture --------------------------------------------------------

    def breach(self, decision: dict) -> List[str]:
        """SloEvaluator `on_breach` wiring: queue (deduped against the
        tap's copy of the same breach) and capture immediately — the
        hook runs outside the evaluator lock, so this is a safe point."""
        with self._lock:
            self._pend_locked(
                "slo_breach", ("slo_breach", decision.get("slo")), decision
            )
        return self.flush()

    def storm(self, record: dict) -> List[str]:
        """The program registry's `on_storm` hook: queue (deduped
        against the tap's copy of the same storm event) and capture in
        the same tick; the hook holds no registry locks."""
        with self._lock:
            self._pend_locked(
                "recompile_storm",
                ("recompile_storm", record.get("program")),
                record,
            )
        return self.flush()

    def flush(self) -> List[str]:
        """Write one bundle per queued trigger; returns bundle paths.
        Call from a context that holds no component locks."""
        with self._lock:
            pending, self._pending = self._pending, []
        return [
            path
            for trigger, _key, evidence in pending
            for path in [self.capture(trigger, evidence)]
            if path is not None
        ]

    def capture(self, trigger: str,
                evidence: Optional[dict] = None) -> Optional[str]:
        """Snapshot rings + history + master state into one bundle dir.
        Returns the path, or None when no incident_dir is configured or
        the write failed (capture must never take the serving path
        down with it)."""
        assert trigger in events.INCIDENT_TRIGGERS, trigger
        if self._dir is None:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
            spans = [_stable(r) for r in self._spans]
            decisions = [_stable(r) for r in self._decisions]
            lineage = [_stable(r) for r in self._lineage]
        name = f"incident-{seq:04d}-{trigger}"
        path = os.path.join(self._dir, name)
        try:
            sections: Dict[str, object] = {
                "spans": spans,
                "decisions": decisions,
                "lineage": lineage,
                "faults": _stable(faults.stats()),
            }
            if self._history is not None:
                sections["history"] = _stable(self._history.snapshot())
            if self._snapshot_fn is not None:
                sections["master"] = _stable(self._snapshot_fn())
            if self._program_registry is not None:
                sections["programs"] = _stable(
                    self._program_registry.forensics())
            os.makedirs(path, exist_ok=True)
            files = []
            for section in sorted(sections):
                filename = f"{section}.json"
                _write_json(
                    os.path.join(path, filename), sections[section]
                )
                files.append(filename)
            _write_json(os.path.join(path, MANIFEST_NAME), {
                "format": BUNDLE_FORMAT,
                "bundle": name,
                "seq": seq,
                "trigger": trigger,
                "evidence": _stable(evidence or {}),
                "counts": {
                    "spans": len(spans),
                    "decisions": len(decisions),
                    "lineage": len(lineage),
                },
                "files": files,
            })
        except Exception:
            logger.exception("incident capture failed: %s", name)
            return None
        with self._lock:
            self._captured.append(name)
        self._rotate()
        events.emit(
            events.INCIDENT_CAPTURED, trigger=trigger, bundle=name
        )
        logger.warning("incident bundle captured: %s", path)
        return path

    def _rotate(self) -> None:
        """Keep at most max_bundles on disk, oldest-first eviction (the
        seq-prefixed names sort in capture order)."""
        try:
            bundles = sorted(
                entry for entry in os.listdir(self._dir)
                if entry.startswith("incident-")
                and os.path.isdir(os.path.join(self._dir, entry))
            )
            for stale in bundles[:-self._max_bundles]:
                shutil.rmtree(
                    os.path.join(self._dir, stale), ignore_errors=True
                )
        except OSError:
            pass

    # ---- reads ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "incident_dir": self._dir,
                "spans_buffered": len(self._spans),
                "decisions_buffered": len(self._decisions),
                "lineage_buffered": len(self._lineage),
                "pending": len(self._pending),
                "captured": list(self._captured),
            }


# ---- bundle reads ------------------------------------------------------

def list_bundles(incident_dir: str) -> List[dict]:
    """Manifests of every bundle under `incident_dir`, capture order;
    each dict gains a `path` key.  Unreadable entries are skipped."""
    out: List[dict] = []
    try:
        entries = sorted(os.listdir(incident_dir))
    except OSError:
        return []
    for entry in entries:
        path = os.path.join(incident_dir, entry)
        manifest_path = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(manifest_path):
            continue
        try:
            with open(manifest_path) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            continue
        manifest["path"] = path
        out.append(manifest)
    return out


def load_bundle(path: str) -> dict:
    """One bundle as {section: payload}, manifest under "manifest"."""
    out: Dict[str, object] = {}
    manifest_path = os.path.join(path, MANIFEST_NAME)
    with open(manifest_path) as fh:
        out["manifest"] = json.load(fh)
    for filename in out["manifest"].get("files", []):
        section = filename[:-len(".json")]
        try:
            with open(os.path.join(path, filename)) as fh:
                out[section] = json.load(fh)
        except (OSError, ValueError):
            continue
    return out
