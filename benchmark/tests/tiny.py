"""A copy of the benchmark with tiny cells beside the real ones, for
runs on the CPU: the tiny BERT cells keep their full-size counterparts'
traffic parameters and metrics at widths a test can hold; the tiny
DeepFM cell trains the zoo's DeepFM two steps a call, so that the
comparison covers a call of more than one step.  Each holds numbers of
its own, with limits set between readings at this size: the program's
largest over 12 seeds and the smallest of the control and of the faults
over 3 (seeds 7e9, 8e9 and 9e9 onward, two CPU threads):

- tiny.bert.train: head_grad_gap 0.0192 / control 0.0508; grad_gap
  0.0841 / half batch 0.570, unchanged 1; change_gap 0.206 / unchanged 1;
- tiny.deepfm.train (the change after three calls of two steps):
  grad_diff_gap 0.00404 / control 0.0172; grad_gap 0.00452 / half batch
  0.209, unchanged 1; change_gap 0.0161 / stale batches 0.255, first
  batch only 0.324, unchanged 1;
- tiny.bert.serve: logit_spread_gap 0.0170 / control 0.208, altered
  answer 37.0.

Tiny models read noisier than full-size ones, so these limits are the
tests' own; the cells' limits come from readings on the card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness.spec import BENCH_DIR

TINY_BERT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, max_position_embeddings=16,
                 vocab_size=100)
# DeepFM as the port's zoo builds it, at a table of 4096 rows
TINY_DEEPFM = {
    "name": "tiny-deepfm", "source": "a tiny DeepFM for CPU tests",
    "num_dense": 13, "num_sparse": 26, "embed_dim": 16,
    "mlp_dims": [256, 128], "vocab_capacity": 4096, "reduced": [],
    "model_def": "deepfm.deepfm_functional_api.custom_model",
    "model_params": {"vocab_capacity": 4096, "embed_dim": 16, "bf16": True,
                     "lr": 0.005},
    "use_bf16": True, "compute_dtype": "bf16",
    "optimizer": {"kind": "adam", "lr": 0.005, "betas": [0.9, 0.999],
                  "eps": 1e-08},
    "reference": "deepfm", "costs": "deepfm"}
# two steps a call; ids zipf(1.2) over each field's own cardinality
TINY_CRITEO = {
    "kind": "train", "batch": 256, "steps_per_call": 2, "pool_batches": 16,
    "trace_slice_s": 0.3,
    "features": {
        "dense": {"shape": [13], "dtype": "float32", "dist": "exponential",
                  "scale": 1.0},
        "sparse": {"shape": [26], "dtype": "int32", "dist": "zipf",
                   "a": 1.2, "mod": [7 + 40 * i for i in range(26)]}},
    "labels": {"dtype": "int32", "dist": "planted_fm", "dense": "dense",
               "sparse": "sparse", "planted_seed": 7, "ids_per_field": 1024,
               "id_scale": 0.6, "id_coef": 0.3, "dense_scale": 0.25,
               "pair": [0, 1, 7], "pair_coef": 0.8, "bias": -0.5,
               "gain": 2.0}}
TINY_LIMITS = {
    "tiny.bert.train": {"head_grad_gap": 0.03, "grad_gap": 0.3,
                        "change_gap": 0.45},
    "tiny.deepfm.train": {"grad_diff_gap": 0.01, "grad_gap": 0.06,
                          "change_gap": 0.1},
    "tiny.bert.serve": {"logit_spread_gap": 0.09},
}
# tiny cell -> (the full-size cell whose metrics it reports, tiny config,
# tiny traffic)
CELLS = {
    "tiny.bert.train": ("bert-base.train.seq512", "tiny-bert",
                        "tiny.train.seq"),
    "tiny.deepfm.train": ("bert-base.train.seq512", "tiny-deepfm",
                          "tiny.train.criteo"),
    "tiny.bert.serve": ("bert-base.serve.poisson", "tiny-bert",
                        "tiny.serve"),
}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def tiny_bench(root: Path, bf16: bool = True):
    """(bench dir, BENCHMARK.json path) of a copy of the benchmark under
    `root`, with the tiny cells added as new files and entries."""
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    dtype = "bf16" if bf16 else "f32"
    bert = json.loads((BENCH_DIR / "configs/bert-base.json").read_text())
    bert.update(TINY_BERT, compute_dtype=dtype, model_params={
        "hidden": 32, "num_layers": 2, "heads": 2, "mlp_dim": 64,
        "max_len": 16, "vocab_size": 100, "bf16": bf16, "lr": 2e-05})
    _dump(bert, bench_dir / "configs/tiny-bert.json")
    dfm = dict(TINY_DEEPFM, use_bf16=bf16, compute_dtype=dtype,
               model_params=dict(TINY_DEEPFM["model_params"], bf16=bf16))
    _dump(dfm, bench_dir / "configs/tiny-deepfm.json")

    t = json.loads((BENCH_DIR / "traffic/train.seq512.json").read_text())
    t.update(batch=4, pool_batches=8, trace_slice_s=0.3)
    t["features"]["input_ids"]["shape"] = [16]
    _dump(t, bench_dir / "traffic/tiny.train.seq.json")
    _dump(TINY_CRITEO, bench_dir / "traffic/tiny.train.criteo.json")
    t = json.loads((BENCH_DIR / "traffic/serve.poisson.json").read_text())
    t.update(rate_per_s=40.0, buckets=[1, 4, 16], trace_slice_s=0.3,
             sample_per_bucket=4)
    t["rows"]["high"] = 16
    t["features"]["input_ids"]["shape"] = [16]
    _dump(t, bench_dir / "traffic/tiny.serve.json")

    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for name, (full, config, traffic) in CELLS.items():
        workload = json.loads(
            (BENCH_DIR / "workloads" / f"{full}.json").read_text())
        workload.update(config=config, traffic=traffic,
                        limits=TINY_LIMITS[name])
        _dump(workload, bench_dir / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a tiny copy for CPU tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if full in metric.get("workloads", ()):
                metric["workloads"].append(name)
    bench_json = root / "BENCHMARK.json"
    _dump(bench, bench_json)
    return bench_dir, bench_json
