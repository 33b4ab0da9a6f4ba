"""The comparison that decides `correct`, against a broken program and
against the control, on the CPU at tiny sizes: the harness's run goes
on as on the card (its look for a card skipped), the timed path broken
underneath, and `correct` comes out false.  The same readings at each
cell's own size come from benchmark/control.py on the card (the `card`
test below)."""

import json
import subprocess
import sys

import pytest

from benchmark import control
from benchmark.harness import faults, runner, spec
from benchmark.harness.compare import judge

CASES = [("tiny.bert.train", "unchanged"), ("tiny.bert.train", "half_batch"),
         ("tiny.deepfm.train", "unchanged"),
         ("tiny.deepfm.train", "half_batch"),
         ("tiny.deepfm.train", "first_batch_only"),
         ("tiny.deepfm.train", "stale_batches"),
         ("tiny.bert.serve", "altered_answer")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_program_is_not_correct(tiny, cell, fault):
    bench_dir, bench_json = tiny
    out, rec = runner.run_cell(cell, 2 ** 31 + 99, 0.3, False, "cpu",
                               bench_dir, bench_json,
                               hooks=faults.hooks(fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny.bert.train", "tiny.deepfm.train",
                                  "tiny.bert.serve"])
def test_the_control_is_not_correct(tiny, cell):
    import torch
    bench_dir, bench_json = tiny
    c = spec.load_cell(cell, bench_dir, bench_json)
    for seed in (1, 2 ** 31 + 5, 3_000_000_007):
        if c.workload["entry"] == "serve":
            numbers = control.control_serving(c, seed, torch.device("cpu"),
                                              64)
        else:
            numbers = control.control_training(c, seed, torch.device("cpu"))
        entries = {k: {"value": v} for k, v in numbers.items()}
        ok, _ = judge(entries, c.limits)
        assert not ok, (seed, numbers)


@pytest.mark.card
@pytest.mark.parametrize("cell,fault,seconds", [
    ("bert-base.train.seq512", "half_batch", "0"),
    ("bert-base.serve.poisson", "altered_answer", "8")])
def test_the_control_and_the_faults_fail_at_the_cells_own_size(
        card, tmp_path, cell, fault, seconds):
    out = tmp_path / "control.json"
    proc = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "control.py"), "--workload",
         cell, "--program-seeds", "3", "--control-seeds", "3", "--faults",
         fault, "--seconds", seconds, "--out", str(out)],
        capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(out.read_text())
    limits = spec.load_cell(cell).limits
    for row in report["control"] + report["faults"][fault]:
        assert any(row[k] > limits[k] for k in limits), row
    for row in report["program"]:
        assert row["correct"], row
