"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

It loads, warms up, measures for `--seconds` and prints one JSON line
(see benchmark/README.md).  It needs CUDA and the cell's number of
cards, and exits non-zero without a result otherwise.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
_REEXEC = "_BENCH_PROCESS_START"


def _reexec() -> float:
    """The process's start on the monotonic clock.  The first time,
    re-execute with the caches of the checkout in the environment:
    Python's bytecode (the card's Python writes none by default, so each
    process would compile torch's sources again) and any kernel cache a
    library keeps.  No library reads its cache from the environment
    before this."""
    if _REEXEC in os.environ:
        return float(os.environ[_REEXEC])
    env = dict(os.environ)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    env.update({
        _REEXEC: repr(_START),
        "PYTHONPYCACHEPREFIX": str(CACHE / "pycache"),
        "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
        "TRITON_CACHE_DIR": str(CACHE / "triton"),
        "CUDA_CACHE_PATH": str(CACHE / "cuda"),
        # libraries that load JAX on their own when it is installed
        "USE_FLAX": "0", "USE_JAX": "0",
    })
    os.execve(sys.executable, [sys.executable, *sys.argv], env)
    return _START  # not reached


def main(argv=None) -> int:
    start = _reexec()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the checkout's root, in place of benchmark/ itself
    sys.path[0] = str(ROOT)
    from benchmark.harness import record, runner, spec

    record.PROCESS_START[0] = start
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner.kernel_cache()
    out, rec = runner.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda:0")
    return runner.emit(out, rec)


if __name__ == "__main__":
    sys.exit(main())
