"""The program's own spans in a traced slice, on the trace's clock.

The port records spans inside itself while a torch profiler records
(`elasticdl_tpu_torch.common.profiler.SPANS`, on `time.perf_counter`'s
clock, the harness's too).  `slice_spans` keeps those that overlap the
traced slice and places them on the profile's clock by the offset that
`trace.Profiler.stop` gives the harness's own spans (the slice's
annotation read on both clocks); `idle_within` measures the device's
idle time inside spans of some names with `trace.py`'s union
arithmetic.  A program without the recorder, or a slice in which it
recorded nothing, gives None: the metric is then left out.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from benchmark.harness.trace import union_ns


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from elasticdl_tpu_torch.common import profiler
    except ImportError:
        return None
    return getattr(profiler, "SPANS", None)


def slice_spans(rec) -> Optional[list]:
    """The recorded spans that overlap the traced slice, as (name,
    start_ns, end_ns, span_id, parent_id, ref, attrs) on the profile's
    clock, clipped to the slice; None without a profile or spans."""
    prof = rec.profile
    spans = recorder()
    if prof is None or spans is None:
        return None
    host_start, host_end = prof.host_start * 1e9, prof.host_end * 1e9
    offset = ((prof.start_ns - host_start) + (prof.end_ns - host_end)) / 2
    out = []
    for s in spans.spans(int(host_start), int(host_end)):
        start = max(int(s.start_ns + offset), prof.start_ns)
        end = min(int(s.end_ns + offset), prof.end_ns)
        if end >= start:
            out.append((s.name, start, end, s.span_id, s.parent_id, s.ref,
                        dict(s.attrs)))
    return out or None


def idle_within(rec, match: Callable[[str], bool]):
    """Percent of the traced slice in which the device ran nothing while
    a span whose name `match` accepts was open; None without spans."""
    found = slice_spans(rec)
    if found is None or rec.profile.window_s <= 0:
        return None
    busy = [(s, e) for _, s, e in rec.profile.clipped_ops()]
    inside = [(s, e) for name, s, e, *_ in found if match(name)]
    idle_ns = union_ns(busy + inside) - union_ns(busy)
    return 100.0 * idle_ns / (rec.profile.end_ns - rec.profile.start_ns)


def queue_phase_s(rec, attr: str) -> List[float]:
    """Per request answered in the slice (its `queue` span ends there),
    seconds of one part of its queue wait (`held_ns`, `behind_ns`,
    `wake_ns`); a split request's chunk that queued longest."""
    found = slice_spans(rec) or []
    end = rec.profile.end_ns if rec.profile is not None else 0
    longest = {}
    for name, s, e, span_id, _, ref, attrs in found:
        if name != "queue" or e >= end:
            continue
        key = ref or f"span{span_id}"
        if key not in longest or e - s > longest[key][0]:
            longest[key] = (e - s, attrs[attr])
    return [value / 1e9 for _, value in longest.values()]
