"""`lineage`: event log -> per-window freshness waterfalls (the port of
the JAX package's client/lineage.py).

It joins the `window_span` stamps of an event log (common/lineage.py
does the same join the live master does) and renders where each stream
window's ingest-to-first-serve time went:

  * a phase table (p50/p99/total per lineage phase, share of all
    traced window time);
  * the slowest-K windows with their dominant phase named;
  * an ASCII waterfall per slowest window (and `--window` for any
    specific one), one bar per phase, dropped/replayed flags inline.

Open (incomplete) windows are charged up to the newest stamp in the
log, attributed to the phase they are blocked in.  Standard library
only, like `top`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import lineage as lineage_lib

_BAR_WIDTH = 32


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _flags(decomp: dict) -> str:
    flags = [
        f for f in ("dropped", "replayed", "rearmed") if decomp[f]
    ]
    return f" [{'+'.join(flags)}]" if flags else ""


def _dominant(decomp: dict) -> Optional[str]:
    phases = decomp.get("phases") or {}
    if not phases:
        return None
    return max(phases, key=phases.get)


def _decompositions(evts: List[dict]) -> List[dict]:
    """Every window's decomposition, window-id order.  Open windows are
    charged against the newest lineage stamp in the log."""
    states = lineage_lib.from_events(evts)
    stamps = [
        float(e["at_unix_s"]) for e in evts
        if e.get("event") == events.WINDOW_SPAN
        and e.get("at_unix_s") is not None
    ]
    now = max(stamps) if stamps else None
    return [
        lineage_lib.decompose(states[wid], now=now)
        for wid in sorted(states)
    ]


def waterfall(decomp: dict) -> List[str]:
    """One window's phases as proportional ASCII bars."""
    phases = [
        (p, decomp["phases"][p])
        for p in lineage_lib.PHASE_ORDER if p in decomp["phases"]
    ]
    total = sum(seconds for _, seconds in phases)
    header = (
        f"window {decomp['window_id']}{_flags(decomp)}: "
        f"{decomp['e2e_s']:.3f}s"
        + ("" if decomp["complete"] else
           f" (open, blocked in {decomp['blocked_phase'] or '?'})")
    )
    lines = [header]
    for phase, seconds in phases:
        share = seconds / total if total > 0 else 0.0
        bar = "#" * max(1 if seconds > 0 else 0,
                        int(round(share * _BAR_WIDTH)))
        lines.append(
            f"  {phase:<12}{seconds:9.3f}s {share * 100:5.1f}%  {bar}"
        )
    return lines


def render(evts: List[dict], slowest_k: int = 3,
           window_id: Optional[int] = None) -> str:
    """The full `elasticdl lineage` report text."""
    decomps = _decompositions(evts)
    if not decomps:
        return "no window_span events found"
    if window_id is not None:
        match = [d for d in decomps if d["window_id"] == int(window_id)]
        if not match:
            return f"window {window_id} has no lineage stamps"
        return "\n".join(waterfall(match[0]))

    complete = [d for d in decomps if d["complete"]]
    open_ = [d for d in decomps if not d["complete"]]
    dropped = [d for d in decomps if d["dropped"]]
    replayed = [d for d in decomps if d["replayed"]]
    lines = [
        f"windows traced: {len(decomps)} ({len(complete)} complete, "
        f"{len(open_)} open, {len(dropped)} dropped, "
        f"{len(replayed)} replayed)"
    ]
    e2e = sorted(d["e2e_s"] for d in complete)
    if e2e:
        lines.append(
            f"ingest->first-serve: p50={_quantile(e2e, 0.5):.3f}s "
            f"p99={_quantile(e2e, 0.99):.3f}s"
        )
    dominant = lineage_lib.dominant_phase(decomps)
    if dominant:
        lines.append(f"dominant phase: {dominant}")

    by_phase: Dict[str, List[float]] = {}
    for d in decomps:
        for phase, seconds in d["phases"].items():
            by_phase.setdefault(phase, []).append(float(seconds))
    grand_total = sum(sum(v) for v in by_phase.values()) or 1.0
    lines.append("")
    lines.append(
        "phase".ljust(12) + "n".rjust(6) + "p50_s".rjust(10)
        + "p99_s".rjust(10) + "total_s".rjust(10) + "share".rjust(8)
    )
    for phase in lineage_lib.PHASE_ORDER:
        if phase not in by_phase:
            continue
        vals = sorted(by_phase[phase])
        total = sum(vals)
        lines.append(
            phase.ljust(12)
            + str(len(vals)).rjust(6)
            + f"{_quantile(vals, 0.5):.3f}".rjust(10)
            + f"{_quantile(vals, 0.99):.3f}".rjust(10)
            + f"{total:.3f}".rjust(10)
            + f"{100.0 * total / grand_total:5.1f}%".rjust(8)
        )

    if slowest_k > 0:
        slowest = sorted(
            decomps, key=lambda d: -d["e2e_s"]
        )[:slowest_k]
        lines.append("")
        lines.append(f"slowest {len(slowest)} windows:")
        for d in slowest:
            dom = _dominant(d)
            lines.append(
                f"  window {d['window_id']}{_flags(d)}: "
                f"{d['e2e_s']:.3f}s"
                + (f", dominant phase {dom}" if dom else "")
            )
        for d in slowest:
            lines.append("")
            lines.extend(waterfall(d))
    return "\n".join(lines)


def lineage(args) -> int:
    """Entry point for `elasticdl lineage`."""
    evts = events.read_events(args.event_log)
    spans = [
        e for e in evts if e.get("event") == events.WINDOW_SPAN
    ]
    if not spans:
        print(
            f"elasticdl lineage: no window_span events in "
            f"{args.event_log!r}"
        )
        return 1
    window_id = getattr(args, "window", None)
    print(render(
        evts,
        slowest_k=getattr(args, "slowest", 3),
        window_id=window_id if window_id is not None else None,
    ))
    return 0
