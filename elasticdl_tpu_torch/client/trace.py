"""`trace`: event log -> Chrome trace-event JSON / summaries (the port of
the JAX package's client/trace.py).

The span-event log (common/events.py, --event_log) carries every
timestamp needed to reconstruct a task's life; this module re-shapes
that JSONL into the Chrome trace-event format so Perfetto
(https://ui.perfetto.dev) or chrome://tracing renders the job on one
timeline:

  * one process track per role (master / worker / serving), one thread
    track per worker id;
  * every completed task as a duration slice on its worker's track,
    with nested child slices splitting dispatch->claim (queue),
    claim->trained (training) and trained->reported (report);
  * checkpoint saves/restores, serving hot-reloads, straggler flags and
    per-window step-phase breakdowns as instant events;
  * each elastic-recovery outage as a slice on the master track;
  * every stream window's lifecycle (`window_span` lineage stamps) as
    one slice per window on the "windows" track with nested phase
    segments, dropped/replayed windows flagged in the slice name;
  * every `program_compiled` event as a slice on the "programs" track
    (one row per program), recompile storms as instants.

`--summary` skips the JSON and prints per-worker task-latency quantiles,
the slowest K tasks, the aggregate step-phase breakdown, the serve
request phases and the compile summary.  Standard library only, like
`top`.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import lineage as lineage_lib

# Task-lifecycle chain, in causal order.  A task slice needs at least
# the first and one later timestamp to have an extent.
_CHAIN = (
    events.TASK_DISPATCHED,
    events.TASK_CLAIMED,
    events.TASK_TRAINED,
    events.TASK_REPORTED,
)
# Child-slice names for consecutive chain segments.
_SEGMENTS = ("claim_wait", "train", "report_wait")

_ROLE_PIDS = {"master": 1, "worker": 2, "serving": 3}
_INSTANT_EVENTS = frozenset({
    events.CHECKPOINT_SAVED,
    events.CHECKPOINT_RESTORED,
    events.SERVING_RELOADED,
    events.STRAGGLER_DETECTED,
    events.STEP_PHASES,
    events.SLO_BREACH,
    events.SLO_RECOVERED,
    events.INCIDENT_CAPTURED,
})

#: Serve-path phase rendering order (the request's causal hop order —
#: a subset of events.SPAN_PHASES may be present on any one span).
_PHASE_ORDER = (
    "route", "queue_wait", "batch_form", "pad", "compute", "unpack",
    "respond",
)


def _role_pid(role: str) -> int:
    return _ROLE_PIDS.get(role, 9)


def _us(ts: float, t0: float) -> float:
    """Seconds-since-epoch -> microseconds relative to the log start."""
    return round((ts - t0) * 1e6, 3)


def _task_spans(evts: List[dict]) -> Dict[int, Dict[str, dict]]:
    """task_id -> {event_name: first event record} for chain events."""
    spans: Dict[int, Dict[str, dict]] = {}
    for e in evts:
        name = e.get("event")
        task_id = e.get("task_id")
        if name in _CHAIN and isinstance(task_id, int):
            spans.setdefault(task_id, {}).setdefault(name, e)
    return spans


def task_durations(evts: List[dict]) -> List[Tuple[int, int, float]]:
    """Completed tasks as (task_id, worker_id, dispatch->report seconds).
    Tasks missing either endpoint (in flight when the log was read, or
    lost to a crash) are skipped."""
    out = []
    for task_id, chain in sorted(_task_spans(evts).items()):
        first = chain.get(events.TASK_DISPATCHED)
        last = chain.get(events.TASK_REPORTED)
        if not first or not last:
            continue
        worker_id = _worker_of(chain)
        out.append(
            (task_id, worker_id, float(last["ts"]) - float(first["ts"]))
        )
    return out


def _request_spans(evts: List[dict]) -> Dict[str, dict]:
    """request_id -> one merged serve-request span.  A routed request
    can emit up to two predict_span halves — the servicer's (queue/
    batch/compute/respond phases) and the router's (the route phase +
    the routing outcome) — correlated here by request_id.  Requests the
    sampler skipped never minted a wire request_id, so they are simply
    absent."""
    spans: Dict[str, dict] = {}
    for e in evts:
        if e.get("event") != events.PREDICT_SPAN:
            continue
        request_id = e.get("request_id")
        if not request_id or not isinstance(e.get("ts"), (int, float)):
            continue
        span = spans.setdefault(str(request_id), {
            "request_id": str(request_id),
            "end_ts": float(e["ts"]),
            "reason": "sampled",
            "phases": {},
        })
        span["end_ts"] = max(span["end_ts"], float(e["ts"]))
        reason = e.get("reason")
        # the router's outcome (error/shed/failover) outranks the
        # servicer half's default "sampled"
        if reason and reason != "sampled":
            span["reason"] = str(reason)
        phases = e.get("phases_s")
        if isinstance(phases, dict):
            for phase, seconds in phases.items():
                span["phases"][phase] = max(
                    span["phases"].get(phase, 0.0), float(seconds)
                )
        for key in ("code", "model_step", "rows", "error"):
            if key in e:
                span.setdefault(key, e[key])
    return spans


def _worker_of(chain: Dict[str, dict]) -> int:
    for name in _CHAIN:
        e = chain.get(name)
        if e is not None and e.get("worker_id") is not None:
            return int(e["worker_id"])
    return -1


def build_chrome_trace(evts: List[dict]) -> dict:
    """Re-shape parsed span events into a Chrome trace-event document.
    Timestamps are microseconds relative to the earliest event, so the
    UI opens at t=0 instead of the unix epoch."""
    evts = sorted(
        (e for e in evts if isinstance(e.get("ts"), (int, float))),
        key=lambda e: e["ts"],
    )
    out: List[dict] = []
    if not evts:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t0 = float(evts[0]["ts"])

    seen_tracks = set()

    def track(role: str, worker_id: Optional[int]) -> Tuple[int, int]:
        pid = _role_pid(role or "")
        tid = int(worker_id) if worker_id is not None else 0
        if (pid, tid) not in seen_tracks:
            seen_tracks.add((pid, tid))
            out.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": role or "unknown"},
            })
            thread = (
                f"worker {tid}" if role == "worker" else (role or "main")
            )
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": thread},
            })
        return pid, tid

    # Task lifecycle -> nested duration slices on the worker's track.
    for task_id, chain in sorted(_task_spans(evts).items()):
        stamps = [
            (name, float(chain[name]["ts"]))
            for name in _CHAIN if name in chain
        ]
        if len(stamps) < 2:
            continue  # no extent to draw
        worker_id = _worker_of(chain)
        pid, tid = track("worker", worker_id)
        start, end = stamps[0][1], stamps[-1][1]
        args = {"task_id": task_id, "worker_id": worker_id}
        trained = chain.get(events.TASK_TRAINED)
        if trained is not None and "records" in trained:
            args["records"] = trained["records"]
        out.append({
            "ph": "X", "name": f"task {task_id}", "cat": "task",
            "pid": pid, "tid": tid,
            "ts": _us(start, t0), "dur": _us(end, t0) - _us(start, t0),
            "args": args,
        })
        by_name = dict(stamps)
        for seg, (a, b) in zip(
            _SEGMENTS, zip(_CHAIN[:-1], _CHAIN[1:])
        ):
            if a in by_name and b in by_name:
                out.append({
                    "ph": "X", "name": seg, "cat": "task",
                    "pid": pid, "tid": tid,
                    "ts": _us(by_name[a], t0),
                    "dur": _us(by_name[b], t0) - _us(by_name[a], t0),
                    "args": {"task_id": task_id},
                })

    # Routed serve requests -> nested duration slices on the serving
    # track, one child slice per recorded phase in causal hop order.
    # The span event stamps the END of the request; the extent is the
    # sum of its phase durations laid back-to-back up to that stamp.
    for request_id, span in sorted(_request_spans(evts).items()):
        phases = [
            (phase, span["phases"][phase])
            for phase in _PHASE_ORDER if phase in span["phases"]
        ]
        pid, tid = track("serving", None)
        total = sum(seconds for _, seconds in phases)
        end = span["end_ts"]
        args = {
            k: span[k]
            for k in ("request_id", "reason", "code", "model_step",
                      "rows", "error")
            if k in span
        }
        if total <= 0.0:
            # no timed extent (e.g. a decode rejection): still visible
            out.append({
                "ph": "i", "name": f"request {request_id}",
                "cat": "request", "s": "t", "pid": pid, "tid": tid,
                "ts": _us(end, t0), "args": args,
            })
            continue
        out.append({
            "ph": "X", "name": f"request {request_id}", "cat": "request",
            "pid": pid, "tid": tid,
            "ts": _us(end - total, t0), "dur": round(total * 1e6, 3),
            "args": args,
        })
        cursor = end - total
        for phase, seconds in phases:
            out.append({
                "ph": "X", "name": phase, "cat": "request",
                "pid": pid, "tid": tid,
                "ts": _us(cursor, t0), "dur": round(seconds * 1e6, 3),
                "args": {"request_id": request_id},
            })
            cursor += seconds

    # Window lifecycle -> one slice per stream window on the "windows"
    # process track (one thread row per window id), nested phase
    # segments in life order, dropped/replayed windows flagged in the
    # slice name.  Lineage stamps ride the components' INJECTABLE clock
    # (`at_unix_s`), which under a fake-clock chaos run is a different
    # epoch from the emit wall time — so window slices are positioned
    # against the earliest window stamp (under a real clock the two
    # epochs coincide and the tracks line up with everything else).
    states = lineage_lib.from_events(evts)
    window_anchors = [
        s["ingest_unix_s"] for s in states.values()
        if s["ingest_unix_s"] is not None
    ]
    if window_anchors:
        win_pid = 4
        out.append({
            "ph": "M", "name": "process_name", "pid": win_pid, "tid": 0,
            "args": {"name": "windows"},
        })
        t0w = min(window_anchors)
        for wid, state in sorted(states.items()):
            start = state["ingest_unix_s"]
            if start is None:
                continue
            decomp = lineage_lib.decompose(state)
            phases = [
                (p, decomp["phases"][p])
                for p in lineage_lib.PHASE_ORDER
                if p in decomp["phases"]
            ]
            tid = int(wid)
            out.append({
                "ph": "M", "name": "thread_name", "pid": win_pid,
                "tid": tid, "args": {"name": f"window {wid}"},
            })
            flags = [
                f for f in ("dropped", "replayed", "rearmed")
                if decomp[f]
            ]
            name = f"window {wid}" + (
                f" [{'+'.join(flags)}]" if flags else ""
            )
            args = {
                "window_id": int(wid),
                "complete": decomp["complete"],
                "dropped": decomp["dropped"],
                "replayed": decomp["replayed"],
                "rearmed": decomp["rearmed"],
                "tasks": decomp["tasks"],
                "records": decomp["records"],
                "e2e_s": decomp["e2e_s"],
            }
            if decomp["blocked_phase"]:
                args["blocked_phase"] = decomp["blocked_phase"]
            total = sum(seconds for _, seconds in phases)
            if total <= 0.0:
                # sealed-only (or dropped at seal): no extent to draw
                out.append({
                    "ph": "i", "name": name, "cat": "window", "s": "t",
                    "pid": win_pid, "tid": tid,
                    "ts": _us(start, t0w), "args": args,
                })
                continue
            out.append({
                "ph": "X", "name": name, "cat": "window",
                "pid": win_pid, "tid": tid,
                "ts": _us(start, t0w), "dur": round(total * 1e6, 3),
                "args": args,
            })
            cursor = start
            for phase, seconds in phases:
                out.append({
                    "ph": "X", "name": phase, "cat": "window",
                    "pid": win_pid, "tid": tid,
                    "ts": _us(cursor, t0w),
                    "dur": round(seconds * 1e6, 3),
                    "args": {"window_id": int(wid)},
                })
                cursor += seconds

    # Compiles -> one slice per program_compiled event on the
    # "programs" process track (one thread row per program name); the
    # event stamps the END of the compile and carries its wall seconds,
    # so the slice is laid back from the stamp.  Recompile storms show
    # as flagged instants on the storming program's row.
    compile_evts = [
        e for e in evts
        if e.get("event") in (events.PROGRAM_COMPILED,
                              events.RECOMPILE_STORM)
        and e.get("program")
    ]
    if compile_evts:
        prog_pid = 5
        out.append({
            "ph": "M", "name": "process_name", "pid": prog_pid, "tid": 0,
            "args": {"name": "programs"},
        })
        prog_tids = {
            name: tid for tid, name in enumerate(
                sorted({str(e["program"]) for e in compile_evts}), 1
            )
        }
        for name, tid in sorted(prog_tids.items()):
            out.append({
                "ph": "M", "name": "thread_name", "pid": prog_pid,
                "tid": tid, "args": {"name": name},
            })
        for e in compile_evts:
            name = str(e["program"])
            tid = prog_tids[name]
            ts = float(e["ts"])
            if e["event"] == events.RECOMPILE_STORM:
                out.append({
                    "ph": "i", "name": f"recompile storm: {name}",
                    "cat": "compile", "s": "g", "pid": prog_pid,
                    "tid": tid, "ts": _us(ts, t0),
                    "args": {
                        "program": name,
                        "signatures": e.get("signatures"),
                        "budget": e.get("budget"),
                    },
                })
                continue
            dur = float(e.get("seconds", 0.0))
            args = {
                k: e[k]
                for k in ("program", "signature", "flops", "bytes",
                          "signatures")
                if k in e
            }
            out.append({
                "ph": "X", "name": f"compile {name}", "cat": "compile",
                "pid": prog_pid, "tid": tid,
                "ts": _us(ts - dur, t0), "dur": round(dur * 1e6, 3),
                "args": args,
            })

    # Point events + recovery outage slices.
    for e in evts:
        name = e.get("event")
        ts = float(e["ts"])
        if name in _INSTANT_EVENTS:
            pid, tid = track(e.get("role", ""), e.get("worker_id"))
            args = {
                k: v for k, v in e.items()
                if k not in ("ts", "event", "role", "pid")
            }
            out.append({
                "ph": "i", "name": name, "cat": "ops", "s": "t",
                "pid": pid, "tid": tid, "ts": _us(ts, t0), "args": args,
            })
        elif name == events.RECOVERY_DONE:
            # The outage extent rides the done event (duration_s), so a
            # lost recovery_started line can't orphan the slice.
            dur = float(e.get("duration_s", 0.0))
            pid, tid = track(e.get("role", "master"), None)
            out.append({
                "ph": "X", "name": "elastic recovery", "cat": "ops",
                "pid": pid, "tid": tid,
                "ts": _us(ts - dur, t0), "dur": round(dur * 1e6, 3),
                "args": {},
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def summarize(evts: List[dict], slowest_k: int = 5) -> str:
    """Operator summary: per-worker task-latency quantiles, slowest-K
    tasks, aggregate step-phase breakdown."""
    lines: List[str] = []
    durations = task_durations(evts)
    by_worker: Dict[int, List[float]] = {}
    for _, worker_id, dur in durations:
        by_worker.setdefault(worker_id, []).append(dur)
    lines.append(f"tasks completed: {len(durations)}")
    if by_worker:
        lines.append("")
        lines.append(
            "worker".ljust(8) + "tasks".rjust(7) + "p50_s".rjust(9)
            + "p90_s".rjust(9) + "p99_s".rjust(9) + "mean_s".rjust(9)
        )
        for worker_id in sorted(by_worker):
            vals = sorted(by_worker[worker_id])
            lines.append(
                str(worker_id).ljust(8)
                + str(len(vals)).rjust(7)
                + f"{_quantile(vals, 0.50):.3f}".rjust(9)
                + f"{_quantile(vals, 0.90):.3f}".rjust(9)
                + f"{_quantile(vals, 0.99):.3f}".rjust(9)
                + f"{sum(vals) / len(vals):.3f}".rjust(9)
            )
    if durations and slowest_k > 0:
        lines.append("")
        lines.append(f"slowest {min(slowest_k, len(durations))} tasks:")
        for task_id, worker_id, dur in sorted(
            durations, key=lambda t: -t[2]
        )[:slowest_k]:
            lines.append(
                f"  task {task_id} (worker {worker_id}): {dur:.3f}s"
            )

    # Aggregate phase breakdown across every step_phases flush window.
    phase_totals: Dict[str, float] = {}
    phase_steps = 0
    for e in evts:
        if e.get("event") != events.STEP_PHASES:
            continue
        phases = e.get("phases")
        if not isinstance(phases, dict):
            continue
        phase_steps += int(e.get("steps", 0))
        for phase, seconds in phases.items():
            phase_totals[phase] = (
                phase_totals.get(phase, 0.0) + float(seconds)
            )
    if phase_totals:
        total = sum(phase_totals.values()) or 1.0
        lines.append("")
        lines.append(f"step phases ({phase_steps} steps):")
        for phase in sorted(phase_totals, key=phase_totals.get,
                            reverse=True):
            mean = (
                phase_totals[phase] / phase_steps if phase_steps else 0.0
            )
            lines.append(
                f"  {phase:<10} {phase_totals[phase]:9.3f}s total  "
                f"{mean * 1e3:8.2f} ms/step  "
                f"{100.0 * phase_totals[phase] / total:5.1f}%"
            )

    # Serve-path request spans (predict_span events), per-phase.
    spans = _request_spans(evts)
    if spans:
        outcomes = sorted(
            s["request_id"] for s in spans.values()
            if s["reason"] != "sampled"
        )
        lines.append("")
        lines.append(
            f"serve requests traced: {len(spans)} "
            f"({len(outcomes)} forensic: error/shed/failover)"
        )
        by_phase: Dict[str, List[float]] = {}
        for span in spans.values():
            for phase, seconds in span["phases"].items():
                by_phase.setdefault(phase, []).append(seconds)
        if by_phase:
            lines.append(
                "phase".ljust(12) + "n".rjust(6) + "p50_ms".rjust(10)
                + "p99_ms".rjust(10) + "mean_ms".rjust(10)
            )
            for phase in _PHASE_ORDER:
                if phase not in by_phase:
                    continue
                vals = sorted(by_phase[phase])
                lines.append(
                    phase.ljust(12)
                    + str(len(vals)).rjust(6)
                    + f"{_quantile(vals, 0.50) * 1e3:.3f}".rjust(10)
                    + f"{_quantile(vals, 0.99) * 1e3:.3f}".rjust(10)
                    + f"{sum(vals) / len(vals) * 1e3:.3f}".rjust(10)
                )
        for request_id in outcomes[:5]:
            span = spans[request_id]
            lines.append(
                f"  {request_id}: {span['reason']}"
                + (f" code={span['code']}" if "code" in span else "")
                + (f" error={span['error']}" if "error" in span else "")
            )

    # Compile summary (program_compiled events): where compile wall time
    # went, per program, plus any storms.
    compiles: Dict[str, List[float]] = {}
    storms: Dict[str, int] = {}
    for e in evts:
        if e.get("event") == events.PROGRAM_COMPILED and e.get("program"):
            compiles.setdefault(str(e["program"]), []).append(
                float(e.get("seconds", 0.0))
            )
        elif (e.get("event") == events.RECOMPILE_STORM
                and e.get("program")):
            storms[str(e["program"])] = storms.get(str(e["program"]), 0) + 1
    if compiles:
        lines.append("")
        lines.append(
            "program compiles: {n} across {p} programs, "
            "{s:.3f}s total".format(
                n=sum(len(v) for v in compiles.values()),
                p=len(compiles),
                s=sum(sum(v) for v in compiles.values()),
            )
        )
        for name in sorted(compiles, key=lambda n: -sum(compiles[n])):
            vals = compiles[name]
            storm_text = (
                f"  STORMS={storms[name]}" if name in storms else ""
            )
            lines.append(
                f"  {name:<24} {len(vals):3d} compiles  "
                f"{sum(vals):8.3f}s total  "
                f"{max(vals):7.3f}s max{storm_text}"
            )

    stragglers = [
        e for e in evts if e.get("event") == events.STRAGGLER_DETECTED
    ]
    if stragglers:
        lines.append("")
        lines.append(f"straggler flags: {len(stragglers)}")
        for e in stragglers[-5:]:
            lines.append(
                "  worker {w}: {m:.3f}s/task vs fleet median "
                "{md:.3f}s ({r:.1f}x)".format(
                    w=e.get("worker_id", "?"),
                    m=float(e.get("mean_task_s", 0.0)),
                    md=float(e.get("median_task_s", 0.0)),
                    r=float(e.get("ratio", 0.0)),
                )
            )
    return "\n".join(lines)


def trace(args) -> int:
    """Entry point for `elasticdl trace`."""
    evts = events.read_events(args.event_log)
    if not evts:
        print(f"elasticdl trace: no events in {args.event_log!r}")
        return 1
    wrote = False
    if getattr(args, "chrome", ""):
        doc = build_chrome_trace(evts)
        with open(args.chrome, "w") as fh:
            json.dump(doc, fh)
        slices = sum(
            1 for e in doc["traceEvents"] if e.get("cat") == "task"
        )
        print(
            f"wrote {args.chrome}: {len(doc['traceEvents'])} trace "
            f"events ({slices} task slices) — open in "
            "https://ui.perfetto.dev or chrome://tracing"
        )
        wrote = True
    if getattr(args, "summary", False) or not wrote:
        print(summarize(evts, slowest_k=getattr(args, "slowest", 5)))
    return 0
