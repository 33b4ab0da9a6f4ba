"""Labeled Counters / Gauges / Histograms in thread-safe registries —
the part of the JAX package's common/metrics.py that the serving
engine, the batcher, the wire packers, the stream reader, the task
manager and the judgment layer (common/history.py, slo.py) use.  The
registry IS the storage: a component registers a metric once and
increments it; snapshots read the same objects.

* `default_registry()`: one per process, for process-wide series (the
  wire packers' byte and row counters).
* per-component `MetricsRegistry()` instances: components that can be
  instantiated many times in one process (batcher, engine) keep
  instance-scoped values.

`render_text` gives the Prometheus text exposition and `varz` the debug
JSON over one or more registries; the telemetry server
(common/telemetry.py) serves both.

Naming contract: every metric is `subsystem_name_unit`, lower_snake_case,
with the subsystem in `KNOWN_SUBSYSTEMS` and the unit suffix in
`ALLOWED_UNIT_SUFFIXES`.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from elasticdl_tpu_torch.common.profiler import LatencyHistogram

_NAME_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)+$")
_LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# First `_`-separated token of every metric name.
KNOWN_SUBSYSTEMS = frozenset(
    {"master", "worker", "serving", "data", "rpc", "faults", "process",
     "store", "traffic"}
)

# Trailing unit token(s).  `_total` marks counters (Prometheus convention),
# `_seconds`/`_bytes` mark measured quantities (histogram or gauge),
# the rest are dimensionless gauge units kept explicit so a reader never
# has to guess what a number means.
ALLOWED_UNIT_SUFFIXES = (
    "_total",
    "_seconds",
    "_bytes",
    "_ratio",
    "_per_sec",
    "_count",
    "_rows",
    "_step",
    "_steps",  # a step-distance (e.g. cross-replica skew), not a position
    "_epoch",
    "_info",
)

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def validate_metric_name(name: str) -> Optional[str]:
    """Returns an error string when `name` violates the naming contract,
    None when it is valid."""
    if not _NAME_RE.match(name):
        return f"{name!r} is not lower_snake_case with >= 2 tokens"
    subsystem = name.split("_", 1)[0]
    if subsystem not in KNOWN_SUBSYSTEMS:
        return (
            f"{name!r} does not start with a known subsystem "
            f"({', '.join(sorted(KNOWN_SUBSYSTEMS))})"
        )
    if not name.endswith(ALLOWED_UNIT_SUFFIXES):
        return (
            f"{name!r} does not end with a unit suffix "
            f"({', '.join(ALLOWED_UNIT_SUFFIXES)})"
        )
    suffix = max(
        (s for s in ALLOWED_UNIT_SUFFIXES if name.endswith(s)), key=len
    )
    if not name[len(subsystem):-len(suffix)].strip("_"):
        return (
            f"{name!r} is only a subsystem and a unit — a metric also "
            "needs a name between them (subsystem_name_unit)"
        )
    return None


def _check_labels(labelnames: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(labelnames)
    for label in names:
        if not _LABEL_RE.match(label):
            raise ValueError(f"invalid label name {label!r}")
    return names


class _Child:
    """One (metric, label-values) series: a float cell under a lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def value(self) -> float:
        with self._lock:
            return self._value


class _Family:
    """A named metric family: unlabeled (one implicit child) or labeled
    (children created on first use of each label-value combination)."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = _check_labels(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child()

    # ---- child access ---------------------------------------------------

    def labels(self, **labelvalues) -> _Child:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labelvalues)}, "
                f"declared {list(self.labelnames)}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child()
            return child

    def _default_child(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {list(self.labelnames)}; "
                "use .labels(...)"
            )
        return self._children[()]

    # unlabeled convenience surface
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def value(self, **labelvalues) -> float:
        if self.labelnames:
            if labelvalues:
                return self.labels(**labelvalues).value()
            # no labels given on a labeled family: the family total
            return sum(self.child_values().values())
        return self._default_child().value()

    def child_values(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return {key: c.value() for key, c in self._children.items()}

    def reset(self) -> None:
        """Drop every recorded value (tests and per-run stats)."""
        with self._lock:
            for child in self._children.values():
                child.set(0.0)
            if self.labelnames:
                self._children.clear()

    def samples(self) -> List[Tuple[Tuple[Tuple[str, str], ...], float]]:
        out = []
        for key, value in sorted(self.child_values().items()):
            out.append((tuple(zip(self.labelnames, key)), value))
        return out


class _GaugeFnFamily:
    """A gauge whose value is read from a callable at collection time —
    the component's existing state stays authoritative (queue depths,
    alive-worker counts) with zero double bookkeeping."""

    kind = GAUGE
    labelnames: Tuple[str, ...] = ()

    def __init__(self, name: str, fn: Callable[[], float], help: str):
        self.name = name
        self.help = help
        self._fn = fn

    def value(self) -> float:
        try:
            return float(self._fn())
        except Exception:
            return 0.0

    def samples(self):
        return [((), self.value())]


class _HistogramFamily:
    """Log-bucketed histogram family reusing LatencyHistogram's bucket
    scheme (bounded-error quantiles, O(1) observe under a lock).

    Unlabeled (the default) it is a drop-in for a bare LatencyHistogram.
    With `labelnames`, each label-value combination gets its own child
    histogram created on first `.labels(...)` — the shape
    `worker_step_phase_seconds{phase="compute"}` needs."""

    kind = HISTOGRAM

    def __init__(self, name: str, help: str, min_value: float = 1e-4,
                 max_value: float = 60.0, growth: float = 1.25,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = _check_labels(labelnames)
        self._hist_args = dict(
            min_s=min_value, max_s=max_value, growth=growth
        )
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], LatencyHistogram] = {}
        if not self.labelnames:
            self._children[()] = LatencyHistogram(**self._hist_args)

    def labels(self, **labelvalues) -> LatencyHistogram:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labelvalues)}, "
                f"declared {list(self.labelnames)}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = LatencyHistogram(
                    **self._hist_args
                )
            return child

    def child_items(self):
        """[(label-value tuple, child histogram)] in sorted label order."""
        with self._lock:
            return sorted(self._children.items())

    def _default_child(self) -> LatencyHistogram:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {list(self.labelnames)}; "
                "use .labels(...)"
            )
        return self._children[()]

    # LatencyHistogram-compatible surface so a registry histogram is a
    # drop-in for a bare LatencyHistogram
    def record(self, value: float) -> None:
        self._default_child().record(value)

    def snapshot(self) -> dict:
        return self._default_child().snapshot()

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)


class MetricsRegistry:
    """Thread-safe get-or-create registry of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, object] = {}

    def _register(self, name: str, factory):
        err = validate_metric_name(name)
        if err is not None:
            raise ValueError(f"bad metric name: {err}")
        with self._lock:
            existing = self._families.get(name)
            if existing is None:
                existing = self._families[name] = factory()
            return existing

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        fam = self._register(
            name, lambda: _Family(name, COUNTER, help, labelnames)
        )
        if getattr(fam, "kind", None) != COUNTER:
            raise ValueError(f"{name} already registered as {fam.kind}")
        return fam

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        fam = self._register(
            name, lambda: _Family(name, GAUGE, help, labelnames)
        )
        if getattr(fam, "kind", None) != GAUGE:
            raise ValueError(f"{name} already registered as {fam.kind}")
        return fam

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "") -> _GaugeFnFamily:
        fam = self._register(name, lambda: _GaugeFnFamily(name, fn, help))
        if not isinstance(fam, _GaugeFnFamily):
            raise ValueError(f"{name} already registered as {fam.kind}")
        # Latest registrant wins: a re-created component (get-or-create
        # registries outlive job-scoped objects) must not leave the
        # gauge reading a dead instance.
        fam._fn = fn
        return fam

    def histogram(self, name: str, help: str = "", min_value: float = 1e-4,
                  max_value: float = 60.0, growth: float = 1.25,
                  labelnames: Sequence[str] = ()) -> _HistogramFamily:
        fam = self._register(
            name,
            lambda: _HistogramFamily(name, help, min_value, max_value,
                                     growth, labelnames),
        )
        if not isinstance(fam, _HistogramFamily):
            raise ValueError(f"{name} already registered as {fam.kind}")
        return fam

    # ---- reads ----------------------------------------------------------

    def families(self) -> List[object]:
        with self._lock:
            return list(self._families.values())

    def value(self, name: str) -> float:
        """A counter's or gauge's value (a labeled family's total); 0.0
        for a name never registered."""
        with self._lock:
            fam = self._families.get(name)
        return 0.0 if fam is None else fam.value()

    def snapshot(self) -> Dict[str, float]:
        """Flat {series: value} view of every family.
        Histograms contribute `<name>_count`, `<name>_sum`, and bounded-
        error p50/p99 series."""
        out: Dict[str, float] = {}
        for fam in self.families():
            if isinstance(fam, _HistogramFamily):
                for key, hist in fam.child_items():
                    labelpairs = tuple(zip(fam.labelnames, key))
                    uppers, counts, total, sum_v = hist.bucket_snapshot()
                    out[_series_key(f"{fam.name}_count", labelpairs)] = \
                        float(total)
                    out[_series_key(f"{fam.name}_sum", labelpairs)] = \
                        float(sum_v)
                    out[_series_key(f"{fam.name}_p50", labelpairs)] = \
                        hist._quantile_from(uppers, counts, total, 0.5)
                    out[_series_key(f"{fam.name}_p99", labelpairs)] = \
                        hist._quantile_from(uppers, counts, total, 0.99)
                continue
            for labelpairs, value in fam.samples():
                out[_series_key(fam.name, labelpairs)] = value
        return out


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry for singleton subsystems."""
    return _default_registry


def _series_key(name: str, labelpairs) -> str:
    if not labelpairs:
        return name
    inner = ",".join(f'{ln}="{lv}"' for ln, lv in labelpairs)
    return f"{name}{{{inner}}}"


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _flatten(registries) -> List[MetricsRegistry]:
    """Accepts registries and zero-arg callables returning registries (or
    lists of registries) — late binding for components built after the
    telemetry server starts."""
    out: List[MetricsRegistry] = []
    for item in registries:
        if callable(item) and not isinstance(item, MetricsRegistry):
            item = item()
        if item is None:
            continue
        if isinstance(item, MetricsRegistry):
            out.append(item)
        else:
            out.extend(r for r in item if isinstance(r, MetricsRegistry))
    return out


def _label_text(labelpairs) -> str:
    return ",".join(f'{ln}="{_escape_label_value(str(lv))}"'
                    for ln, lv in labelpairs)


def render_text(registries: Iterable) -> str:
    """Prometheus text exposition (format 0.0.4) over one or more
    registries.  When several registries define the same family name the
    samples concatenate; an identical (name, labels) series from a later
    registry replaces the earlier one (one process = one truth)."""
    families: Dict[str, List[object]] = {}
    for registry in _flatten(registries):
        for fam in registry.families():
            families.setdefault(fam.name, []).append(fam)

    lines: List[str] = []
    for name in sorted(families):
        group = families[name]
        head = group[0]
        help_text = next((f.help for f in group if f.help), "")
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {head.kind}")
        if head.kind == HISTOGRAM:
            for fam in group:
                for key, hist in fam.child_items():
                    inner = _label_text(zip(fam.labelnames, key))
                    sep = "," if inner else ""
                    uppers, counts, total, sum_v = hist.bucket_snapshot()
                    cumulative = 0
                    for upper, count in zip(uppers, counts):
                        cumulative += count
                        lines.append(
                            f'{name}_bucket{{{inner}{sep}'
                            f'le="{upper:.6g}"}} {cumulative}'
                        )
                    lines.append(
                        f'{name}_bucket{{{inner}{sep}le="+Inf"}} {total}'
                    )
                    if inner:
                        lines.append(f"{name}_sum{{{inner}}} {sum_v:.9g}")
                        lines.append(f"{name}_count{{{inner}}} {total}")
                    else:
                        lines.append(f"{name}_sum {sum_v:.9g}")
                        lines.append(f"{name}_count {total}")
            continue
        seen: Dict[str, str] = {}
        for fam in group:
            for labelpairs, value in fam.samples():
                series = (f"{name}{{{_label_text(labelpairs)}}}"
                          if labelpairs else name)
                seen[series] = f"{series} {value:.9g}"
        lines.extend(seen[k] for k in sorted(seen))
    return "\n".join(lines) + "\n"


def varz(registries: Iterable, role: str = "",
         extra: Optional[dict] = None) -> str:
    """Debug JSON snapshot served at /varz: flat metric series plus
    whatever structured extras the role wants to expose."""
    merged: Dict[str, float] = {}
    for registry in _flatten(registries):
        merged.update(registry.snapshot())
    doc = {
        "role": role,
        "pid": os.getpid(),
        "time_unix_s": time.time(),
        "metrics": merged,
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, sort_keys=True, default=str)
