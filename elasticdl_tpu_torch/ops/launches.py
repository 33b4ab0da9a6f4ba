"""The hand kernels' launch counts, and what a CUDA graph's capture does
to them.

Each wrapper counts a launch through `count(name, variant)` where it
launches its kernel.  The counts live where they always have:
`flash_attention.launches`, `flash_attention.backward_launches`, their
per-variant `..._by_kernel` dicts, and `scatter_add.launches`; each
wrapper's module names its counters here (`register`).

A launch made while the current stream is being captured into a CUDA
graph is recorded into the graph, not run.  Inside `capturing()` such a
launch goes to the capture's tally instead of the counts; the graph
keeps the tally, and each replay adds it (`add`), so the counts mean
what they mean without graphs.  The stream, not the thread, tells a
captured launch: a captured backward launches its kernels from the
autograd engine's device thread, onto the capturing stream.  Captures
are serialized in the process (worker/graphs.py), so one tally is open
at a time, and a launch on another thread's stream, outside the
capture, is counted as it runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

_LOCK = threading.Lock()
# name -> (owner, attribute of the total, attribute of the per-variant
# dict or None)
_COUNTERS: Dict[str, Tuple[object, str, Optional[str]]] = {}
# the tally of the capture under way, if any
_TALLY: Optional[Dict[str, int]] = None


def register(name: str, owner, attr: str,
             by_kernel: Optional[str] = None) -> None:
    """Name a wrapper's counters: `owner.attr` the total and, where the
    kernel has variants, `owner.by_kernel` the {variant: count} dict."""
    _COUNTERS[name] = (owner, attr, by_kernel)


def stream_capturing() -> bool:
    """Whether the calling thread's current stream is being captured."""
    return torch.cuda.is_current_stream_capturing()


def count(name: str, variant: Optional[str] = None) -> None:
    """One launch of kernel `name` (of `variant`): into the open capture's
    tally when the current stream is being captured, else the counts."""
    captured = _TALLY is not None and stream_capturing()
    owner, attr, by_kernel = _COUNTERS[name]
    with _LOCK:
        tally = _TALLY
        if captured and tally is not None:
            tally[name] = tally.get(name, 0) + 1
            if variant is not None:
                key = f"{name}.{variant}"
                tally[key] = tally.get(key, 0) + 1
            return
        setattr(owner, attr, getattr(owner, attr) + 1)
        if variant is not None:
            getattr(owner, by_kernel)[variant] += 1


def _loaded() -> None:
    # the wrappers' modules register their counters when imported
    from elasticdl_tpu_torch.ops import flash_attention  # noqa: F401
    from elasticdl_tpu_torch.ops import scatter_add  # noqa: F401


def snapshot() -> Dict[str, int]:
    """Every launch count, flat ("scatter_add", "flash_attention_fwd",
    "flash_attention_fwd.sm90_wgmma", ...)."""
    _loaded()
    out = {}
    with _LOCK:
        for name, (owner, attr, by_kernel) in _COUNTERS.items():
            out[name] = getattr(owner, attr)
            if by_kernel is not None:
                for variant, n in getattr(owner, by_kernel).items():
                    out[f"{name}.{variant}"] = n
    return out


def add(delta: Dict[str, int]) -> None:
    """Add a graph's tally (`delta`, keyed as `snapshot`) to the counts:
    one replay's launches."""
    _loaded()
    with _LOCK:
        for key, n in delta.items():
            name, _, variant = key.partition(".")
            owner, attr, by_kernel = _COUNTERS[name]
            if variant:
                getattr(owner, by_kernel)[variant] += n
            else:
                setattr(owner, attr, getattr(owner, attr) + n)


@contextlib.contextmanager
def capturing():
    """Open the tally of one capture (the caller holds the process's
    capture lock); yields it, a {name: launches} dict keyed as
    `snapshot`."""
    global _TALLY
    tally: Dict[str, int] = {}
    with _LOCK:
        if _TALLY is not None:
            raise RuntimeError("a capture's launch tally is already open: "
                               "captures must not overlap")
        _TALLY = tally
    try:
        yield tally
    finally:
        with _LOCK:
            _TALLY = None
