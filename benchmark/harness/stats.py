"""Arithmetic the metric readers share."""

from __future__ import annotations

import importlib

import numpy as np

from benchmark.costs import peaks


def percentile_ms(seconds, q: float):
    """The q-th percentile (numpy's linear interpolation) in ms; None
    for no samples."""
    if not seconds:
        return None
    return float(np.percentile(np.asarray(seconds, np.float64), q)) * 1e3


def idle_share(profile):
    """Percent of a traced slice with no device operation running."""
    if profile is None or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s() / profile.window_s)


def roofline(rec, kernel: str, names):
    """Percent of the roofline reached by `kernel`'s calls in the traced
    slice: the sum of their least times (benchmark/costs/<kernel>.py at
    each call's shapes) over the device time of the launches whose name
    holds one of `names`."""
    calls = rec.kernel_calls.get(kernel)
    if rec.profile is None or not calls:
        return None
    seconds, launches = rec.profile.op_seconds(
        lambda n: any(s in n for s in names))
    if not launches:
        return None
    cost = importlib.import_module(f"benchmark.costs.{kernel}").cost
    least = 0.0
    for kw in calls:
        flops, nbytes = cost(**kw)
        least += peaks.least_seconds(
            flops, nbytes, "bf16" if kw["elem_bytes"] == 2 else "f32")
    return 100.0 * least / seconds
