"""`incident`: postmortem reports from flight-recorder bundles (the port
of the JAX package's client/incident.py).

The master's incident flight recorder (common/flight.py) writes one
self-contained JSON bundle per trigger under `--incident_dir`; this
command is the read side.  With just the directory it lists every
bundle (seq, trigger, counts); with `--bundle` it renders one: what
tripped the capture, which SLOs were burning, the decisions before the
incident, the slowest request spans in the ring, the window lineage
tail with its dominant freshness phase, and the fault injections that
were active.  Standard library only, like `top`.
"""

from __future__ import annotations

from typing import Dict, List

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import flight
from elasticdl_tpu_torch.common import lineage as lineage_lib


def _window_decompositions(records: List[dict]) -> List[dict]:
    """Per-window freshness decompositions from the bundle's lineage
    ring, window-id order.  Open windows are charged up to the newest
    stamp in the ring, attributed to the phase they are blocked in —
    that is what lets a mid-stall bundle name the guilty phase."""
    states = lineage_lib.from_events(records)
    stamps = [
        float(r["at_unix_s"]) for r in records
        if r.get("event") == events.WINDOW_SPAN
        and r.get("at_unix_s") is not None
    ]
    now = max(stamps) if stamps else None
    return [
        lineage_lib.decompose(states[wid], now=now)
        for wid in sorted(states)
    ]


def _span_total_s(span: dict) -> float:
    phases = span.get("phases_s")
    if not isinstance(phases, dict):
        return 0.0
    return sum(float(v) for v in phases.values())


def format_listing(bundles: List[dict]) -> str:
    """One row per bundle, capture order."""
    lines = [
        "bundle".ljust(34) + "trigger".ljust(18)
        + "spans".rjust(7) + "decisions".rjust(11) + "lineage".rjust(9)
    ]
    for manifest in bundles:
        counts = manifest.get("counts", {})
        lines.append(
            str(manifest.get("bundle", "?")).ljust(34)
            + str(manifest.get("trigger", "?")).ljust(18)
            + str(counts.get("spans", 0)).rjust(7)
            + str(counts.get("decisions", 0)).rjust(11)
            + str(counts.get("lineage", 0)).rjust(9)
        )
    return "\n".join(lines)


def format_report(bundle: Dict[str, object], spans_k: int = 10) -> str:
    """The postmortem report for one loaded bundle."""
    manifest = bundle.get("manifest", {})
    lines: List[str] = []
    lines.append(f"incident {manifest.get('bundle', '?')}")
    lines.append(f"  trigger: {manifest.get('trigger', '?')}")
    evidence = manifest.get("evidence") or {}
    if evidence:
        detail = ", ".join(
            f"{k}={evidence[k]}" for k in sorted(evidence)
            if k not in ("event",)
        )
        lines.append(f"  evidence: {detail}")

    # SLO states at capture time (the master snapshot's slo section).
    master = bundle.get("master") or {}
    slo = master.get("slo") if isinstance(master, dict) else None
    if isinstance(slo, dict):
        lines.append("")
        lines.append("slo states at capture:")
        for row in slo.get("slos", []):
            if not isinstance(row, dict) or "state" not in row:
                continue
            lines.append(
                f"  {row.get('slo', '?'):<24} {row.get('state', '?'):<9}"
                f" fast_burn={row.get('fast_burn', 0.0)}"
                f" slow_burn={row.get('slow_burn', 0.0)}"
            )

    decisions = bundle.get("decisions") or []
    if decisions:
        lines.append("")
        lines.append(f"decisions before the incident ({len(decisions)}):")
        for record in decisions[-10:]:
            if not isinstance(record, dict):
                continue
            event = record.get("event", "?")
            detail = ", ".join(
                f"{k}={record[k]}" for k in sorted(record)
                if k not in ("event", "role", "worker_id")
            )
            lines.append(f"  {event}: {detail}")

    spans = [s for s in (bundle.get("spans") or []) if isinstance(s, dict)]
    if spans:
        forensic = [s for s in spans if s.get("reason") != "sampled"]
        lines.append("")
        lines.append(
            f"request spans in the ring: {len(spans)} "
            f"({len(forensic)} forensic: error/shed/failover)"
        )
        slowest = sorted(spans, key=_span_total_s, reverse=True)
        for span in slowest[:spans_k]:
            phases = span.get("phases_s") or {}
            detail = " ".join(
                f"{phase}={float(phases[phase]) * 1e3:.2f}ms"
                for phase in sorted(phases)
            )
            lines.append(
                f"  {span.get('request_id', '?')}"
                f" [{span.get('reason', '?')}]"
                f" total={_span_total_s(span) * 1e3:.2f}ms {detail}"
            )

    lineage_records = [
        r for r in (bundle.get("lineage") or []) if isinstance(r, dict)
    ]
    if lineage_records:
        decomps = _window_decompositions(lineage_records)
        if decomps:
            complete = sum(1 for d in decomps if d["complete"])
            open_ = sum(1 for d in decomps if not d["complete"])
            dropped = sum(1 for d in decomps if d["dropped"])
            lines.append("")
            lines.append(
                f"window lineage in the ring: {len(decomps)} windows "
                f"({complete} complete, {open_} open, {dropped} dropped)"
            )
            dominant = lineage_lib.dominant_phase(decomps)
            if dominant:
                lines.append(f"  dominant phase: {dominant}")
            for d in decomps[-5:]:
                flags = "+".join(
                    f for f in ("dropped", "replayed", "rearmed") if d[f]
                )
                phases = d.get("phases") or {}
                dom = max(phases, key=phases.get) if phases else None
                state = (
                    "" if d["complete"]
                    else f", blocked in {d['blocked_phase'] or '?'}"
                )
                lines.append(
                    f"  window {d['window_id']}"
                    + (f" [{flags}]" if flags else "")
                    + f": {d['e2e_s']:.3f}s"
                    + (f", dominant {dom}" if dom else "")
                    + state
                )

    faults = bundle.get("faults") or {}
    if isinstance(faults, dict) and faults.get("injected"):
        lines.append("")
        lines.append(
            f"fault injections active: {faults.get('injected', 0)}"
            f"/{faults.get('planned', 0)} planned"
        )
        by_action = faults.get("by_action")
        if isinstance(by_action, dict) and by_action:
            lines.append("  " + ", ".join(
                f"{action}={by_action[action]}"
                for action in sorted(by_action)
            ))
    return "\n".join(lines)


def incident(args) -> int:
    """Entry point for `elasticdl incident`."""
    bundles = flight.list_bundles(args.incident_dir)
    if not bundles:
        print(
            f"elasticdl incident: no bundles under {args.incident_dir!r}"
        )
        return 1
    wanted = getattr(args, "bundle", "")
    if not wanted:
        print(format_listing(bundles))
        return 0
    matches = [
        m for m in bundles
        if str(m.get("bundle", "")).startswith(wanted)
    ]
    if not matches:
        print(
            f"elasticdl incident: no bundle matches {wanted!r} "
            f"(have: {', '.join(str(m.get('bundle')) for m in bundles)})"
        )
        return 1
    if len(matches) > 1:
        print(
            f"elasticdl incident: {wanted!r} is ambiguous "
            f"({', '.join(str(m.get('bundle')) for m in matches)})"
        )
        return 1
    bundle = flight.load_bundle(matches[0]["path"])
    print(format_report(bundle, spans_k=getattr(args, "spans", 10)))
    return 0
