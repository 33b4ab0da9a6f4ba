"""What one run of a cell recorded, for the metric readers; and the
process clock that `setup_s` starts from."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from benchmark.harness.trace import Profile, Spans

# run.py sets this as its first statement; a process that imports the
# harness some other way (a test) starts it here
PROCESS_START = [time.perf_counter()]


@dataclass
class Record:
    cell: Any
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup_s: float = 0.0
    # host seconds from the window's start to the end of its work
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    spans: Spans = field(default_factory=Spans)
    profile: Optional[Profile] = None
    # training: examples done in the window and in the traced slice
    examples: int = 0
    slice_examples: int = 0
    slice_s: float = 0.0
    # {kernel: [call kwargs, ...]} of the work inside the traced slice
    kernel_calls: Dict[str, List[dict]] = field(default_factory=dict)
    # {quantity: value} the model's counts give the readers
    counts: Dict[str, float] = field(default_factory=dict)
    # serving: one entry per request, seconds
    latency_s: List[float] = field(default_factory=list)
    late_s: List[float] = field(default_factory=list)
    queue_wait_s: List[float] = field(default_factory=list)
    batcher: Dict[str, float] = field(default_factory=dict)
    # every number the comparison gives, and those the limits hold
    numbers: Dict[str, dict] = field(default_factory=dict)
    checks: Dict[str, dict] = field(default_factory=dict)
    correct: bool = False
    memory_peak_bytes: int = 0
    notes: Dict[str, Any] = field(default_factory=dict)
