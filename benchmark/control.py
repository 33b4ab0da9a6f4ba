"""The readings that the limits of `correct` are set from, on the card
at a cell's own size (the benchmark's own runs never run this):

    python3 benchmark/control.py --workload <cell> --program-seeds 12 \
        --control-seeds 3 [--faults half_batch,unchanged] [--seconds 4] \
        [--out FILE]

- program: the cell's comparison numbers over the given seeds, from
  its set-up and first steps (training: no window; serving: a window of
  `--seconds` at the cell's load);
- control: the same numbers with the reference itself in the program's
  place, computed one precision below the configuration's (bf16 parts
  in fp8, f32 parts in bf16; benchmark/reference/precision.py), against
  the plain reference: for serving, over the seed's first requests'
  rows, as many as a run samples;
- faults: the numbers of the program with each named fault planted
  (benchmark/harness/faults.py).

It prints one JSON line: every reading, and by number the largest the
program gave and the smallest the control and each fault gave.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED_BASE = 4_100_000_000


def _flat(numbers: dict) -> dict:
    """Each number's value, and beside it any other reading it carries
    (as `<number>.<reading>`)."""
    out = {}
    for name, entry in numbers.items():
        out[name] = entry["value"]
        out.update({f"{name}.{k}": v for k, v in entry.items()
                    if k != "value" and isinstance(v, (int, float))})
    return out


def _numbers(rec):
    return _flat(rec.numbers)


def control_training(cell, seed: int, device) -> dict:
    import torch
    from benchmark.harness import compare, inputs, spec
    from benchmark.harness.weights import make_weights
    from benchmark.entries.train import CHECK_CALLS, device_batch
    from benchmark.reference import steps
    from benchmark.reference.precision import CONTROL, REFERENCE, no_tf32

    no_tf32()
    ref_model, _ = spec.model_modules(cell)
    cfg, traffic = cell.config, cell.traffic
    k = int(traffic["steps_per_call"])
    compared = CHECK_CALLS * k
    pool = inputs.training_pool(cfg, dict(traffic, pool_batches=compared),
                                seed, device)
    batches = [device_batch(b, device) for b in pool]
    weights = make_weights(ref_model.param_spec(cfg), seed, device)
    low = steps.train_steps(ref_model, cfg, weights, batches, CONTROL,
                            compared, None, keep_change=True)
    ref = steps.train_steps(ref_model, cfg, weights, batches, REFERENCE,
                            compared, low.pop("change_tensors"),
                            other_first_grad=low.pop("first_grad_tensors"))
    out = _flat(compare.training(low, ref, cfg.get("head_leaves", ())))
    del weights, batches, low, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def control_serving(cell, seed: int, device, rows: int) -> dict:
    import torch
    from benchmark.harness import compare, inputs, spec
    from benchmark.harness.weights import make_weights
    from benchmark.reference import steps
    from benchmark.reference.precision import CONTROL, REFERENCE, no_tf32

    no_tf32()
    ref_model, _ = spec.model_modules(cell)
    feats = inputs.request_features(cell.config, cell.traffic, seed, rows,
                                    device)
    feats = {k: torch.from_numpy(v).to(device) for k, v in feats.items()}
    weights = make_weights(ref_model.param_spec(cell.config), seed, device)
    low = steps.logits(ref_model, cell.config, weights, feats, CONTROL)
    ref = steps.logits(ref_model, cell.config, weights, feats, REFERENCE)
    out = _flat(compare.serving(low, ref))
    del weights, feats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seed-base", type=int, default=SEED_BASE)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    import importlib

    import torch
    from benchmark.harness import faults, runner, spec

    runner.kernel_cache()
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    entry = importlib.import_module(
        f"benchmark.entries.{cell.workload['entry']}")
    serving = cell.workload["entry"] == "serve"
    seconds = args.seconds if serving else 0.0
    seeds = [args.seed_base + i for i in range(args.program_seeds)]
    report = {"workload": args.workload, "device":
              torch.cuda.get_device_name(0), "program": [], "control": [],
              "faults": {}}
    sample_rows = []
    for seed in seeds:
        t = time.perf_counter()
        rec = entry.run(cell, seed, seconds, False, device)
        report["program"].append({"seed": seed, **_numbers(rec),
                                  "correct": rec.correct,
                                  "s": time.perf_counter() - t})
        sample_rows.append(rec.notes.get("sample_rows", 0))
        print(json.dumps(report["program"][-1]), file=sys.stderr)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    rows = max(sample_rows) if serving and sample_rows else 600
    control_seeds = [args.seed_base + i for i in range(args.control_seeds)]
    for seed in control_seeds:
        numbers = (control_serving(cell, seed, device, rows) if serving
                   else control_training(cell, seed, device))
        report["control"].append({"seed": seed, **numbers})
        print(json.dumps(report["control"][-1]), file=sys.stderr)
    for name in [f for f in args.faults.split(",") if f]:
        report["faults"][name] = []
        for seed in control_seeds:
            rec = entry.run(cell, seed, seconds, False, device,
                            hooks=faults.hooks(name))
            report["faults"][name].append({"seed": seed, **_numbers(rec),
                                           "correct": rec.correct})
            print(json.dumps(report["faults"][name][-1]), file=sys.stderr)
            del rec
            gc.collect()
            torch.cuda.empty_cache()
    rows = (report["program"] or report["control"])
    names = [k for k in rows[0] if k not in ("seed", "correct", "s")]
    summary = {}
    for n in names:
        summary[n] = {}
        if report["program"]:
            summary[n]["program_max"] = max(r[n] for r in report["program"])
        if report["control"]:
            summary[n]["control_min"] = min(r[n] for r in report["control"])
        for f, rows_ in report["faults"].items():
            summary[n][f"{f}_min"] = min(r[n] for r in rows_)
    report["summary"] = summary
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
