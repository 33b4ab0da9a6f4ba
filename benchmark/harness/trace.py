"""The harness's spans and the device trace of a traced run.

Spans are recorded from the harness's own files, around each call into
a layer of the program: a host-clock interval per call, from whichever
thread makes it, kept in memory (`Spans`).  In a `--trace 1` run a slice
at the end of the window runs under `torch.profiler`; `read_profile`
keeps, of that trace, the device's operations (kernels, copies, sets)
and the device-side ranges of the program's own annotations (such as
`Optimizer.step#Adam.step`), and the spans are placed on the trace's
clock by the slice's own annotation, whose start and end the harness
also reads on the host clock.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."


class Spans:
    """Host-clock spans by name, from any thread."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, start, time.perf_counter()))


@dataclass
class Profile:
    """A traced slice: device operations and harness annotations, as
    (name, start_ns, end_ns) on the profiler's clock, and the slice's
    bounds there and on the host clock."""
    device_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    # the harness's spans, on the trace's clock
    annotations: List[Tuple[str, int, int]] = field(default_factory=list)
    # device-side ranges of the program's record_function annotations
    device_ranges: List[Tuple[str, int, int]] = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0
    host_start: float = 0.0
    host_end: float = 0.0
    parse_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def clipped_ops(self) -> List[Tuple[str, int, int]]:
        return [(n, max(s, self.start_ns), min(e, self.end_ns))
                for n, s, e in self.device_ops
                if e > self.start_ns and s < self.end_ns]

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.clipped_ops()]) / 1e9

    def op_seconds(self, match) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name
        `match(name)` accepts, inside the slice."""
        total, count = 0, 0
        for name, s, e in self.clipped_ops():
            if match(name):
                total += e - s
                count += 1
        return total / 1e9, count

    def seconds_within(self, prefix: str) -> Tuple[float, int]:
        """(device seconds, ranges) of the operations inside the
        device-side ranges whose name starts with `prefix`."""
        ranges = [(s, e) for n, s, e in self.device_ranges
                  if n.startswith(prefix)]
        total = 0
        for _, s, e in self.device_ops:
            if any(s >= a and e <= b for a, b in ranges):
                total += e - s
        return total / 1e9, len(ranges)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, e in self.clipped_ops():
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Seconds of device idleness inside the slice, by the harness
        span the host was in (the innermost that covers the moment;
        "host.outside_spans" where none did)."""
        gaps = _complement(
            union_list([(s, e) for _, s, e in self.clipped_ops()]),
            self.start_ns, self.end_ns)
        spans = sorted(((s, e, n) for n, s, e in self.annotations),
                       key=lambda t: t[0])
        by: Dict[str, int] = {}
        for g0, g1 in gaps:
            covered = []
            for s, e, n in spans:
                if s >= g1:
                    break
                lo, hi = max(s, g0), min(e, g1)
                if hi > lo:
                    covered.append((lo, hi, e - s, n))
            # each moment goes to the innermost (shortest) span over it
            assigned = []
            for lo, hi, _, n in sorted(covered, key=lambda c: c[2]):
                inside = [(max(a, lo), min(b, hi)) for a, b in assigned
                          if b > lo and a < hi]
                by[n] = by.get(n, 0) + (hi - lo) - union_ns(inside)
                assigned.append((lo, hi))
            rest = g1 - g0 - union_ns(assigned)
            if rest > 0:
                by["host.outside_spans"] = by.get("host.outside_spans",
                                                  0) + rest
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in top]


def union_list(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def union_ns(intervals) -> int:
    return sum(e - s for s, e in union_list(intervals))


def _complement(merged, lo: int, hi: int):
    out, cursor = [], lo
    for s, e in merged:
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return [(s, e) for s, e in out if e > s]


class Profiler:
    """torch.profiler over a slice of the window, started and stopped by
    the entry; `stop()` returns the `Profile`."""

    SLICE = SPAN_PREFIX + "slice"

    def __init__(self, device_kind: str):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device_kind == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._torch = torch
        self._mark = None
        self.host_start = self.host_end = 0.0

    def start(self) -> None:
        self._prof.__enter__()
        self._mark = self._torch.profiler.record_function(self.SLICE)
        self._mark.__enter__()
        self.host_start = time.perf_counter()

    def stop(self, spans: Optional[Spans] = None) -> Profile:
        """The slice's `Profile`, with `spans` inside it placed on the
        trace's clock."""
        self.host_end = time.perf_counter()
        self._mark.__exit__(None, None, None)
        t0 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        prof = read_profile(self._prof)
        prof.parse_s = time.perf_counter() - t0
        prof.host_start, prof.host_end = self.host_start, self.host_end
        # the slice's annotation read on both clocks: the mean offset
        offset = ((prof.start_ns - self.host_start * 1e9)
                  + (prof.end_ns - self.host_end * 1e9)) / 2
        for name, s, e in (spans.records if spans else ()):
            if s >= self.host_start and e <= self.host_end:
                prof.annotations.append((name, int(s * 1e9 + offset),
                                         int(e * 1e9 + offset)))
        return prof


def read_profile(prof) -> Profile:
    from torch.autograd import DeviceType
    out = Profile()
    slice_bounds: Optional[Tuple[int, int]] = None
    events = list(prof.profiler.kineto_results.events())
    # a record_function range shows on the device too, under its name
    annotations = {evt.name() for evt in events
                   if evt.device_type() == DeviceType.CPU
                   and evt.is_user_annotation()}
    for evt in events:
        start = int(evt.start_ns())
        end = start + int(evt.duration_ns())
        name = evt.name()
        if evt.device_type() == DeviceType.CPU:
            if name == Profiler.SLICE:
                slice_bounds = (start, end)
        elif name in annotations or name.startswith(SPAN_PREFIX):
            out.device_ranges.append((name, start, end))
        else:
            out.device_ops.append((name, start, end))
    if slice_bounds is None:
        raise RuntimeError("the traced slice's annotation is missing")
    out.start_ns, out.end_ns = slice_bounds
    return out
