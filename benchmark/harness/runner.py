"""One run of one cell: the entry, then its metrics, its result line and
its comparison's numbers."""

from __future__ import annotations

import importlib
import json
import math
import sys
from pathlib import Path
from typing import Optional

from benchmark.harness import isolation, spec

CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "bench_cache"


def kernel_cache(path: Path = CACHE_DIR / "kernels") -> None:
    """The program's nvcc builds go to a fixed directory of the
    checkout, so that only a checkout's first run builds."""
    from elasticdl_tpu_torch.ops import _build
    _build.set_cache_dir(str(path))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench_dir: Path = spec.BENCH_DIR,
             bench_json: Optional[Path] = None, hooks=None):
    """(result dict, record).  Does not look for a chip: `device` is
    what the entry runs on."""
    import torch

    cell = spec.load_cell(name, bench_dir, bench_json)
    entry = importlib.import_module(
        f"benchmark.entries.{spec.checked_name(cell.workload['entry'])}")
    rec = entry.run(cell, int(seed), float(seconds), bool(trace),
                    torch.device(device), hooks=hooks)
    return result(cell, rec, device), rec


def _device_info(device, rec) -> dict:
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind, "count": rec.cell.chips,
            "memory_peak_bytes": rec.memory_peak_bytes}
    if rec.trace and rec.profile is not None:
        info["busy_s"] = rec.profile.busy_s()
        info["window_s"] = rec.profile.window_s
    return info


def result(cell, rec, device) -> dict:
    wanted = cell.per_layer if rec.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_code(cell.bench_dir, "metrics", m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(rec.correct), "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics,
           "device": _device_info(device, rec)}
    if rec.trace and rec.profile is not None:
        out["breakdown"] = {"device_ops": rec.profile.top_ops(10),
                            "idle_gaps": rec.profile.idle_gaps(10)}
    out["checks"] = rec.checks
    return out


def emit(out: dict, rec) -> int:
    """Print the notes and the checks on stderr (the checks last) and
    the result as the last line of stdout; 3 without a result where the
    process holds JAX or the JAX package."""
    found = isolation.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"notes": rec.notes, "setup_s": rec.setup_s,
                      "numbers": {k: v["value"]
                                  for k, v in rec.numbers.items()},
                      "window_s": rec.window_s,
                      "profile_parse_s": getattr(rec.profile, "parse_s",
                                                 None)},
                     default=str), file=sys.stderr)
    for name, entry in out["checks"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
