"""The harness on the CPU: cells, metrics and traffic found from files
alone, seeded inputs, the trace arithmetic and the result line."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, runner, spec
from benchmark.harness.trace import Profile
from benchmark.harness.weights import make_weights
from benchmark.reference import bert as ref_bert
from benchmark.tests.tiny import TINY_CRITEO, TINY_DEEPFM

NEW_METRIC = '''"""Steps a call took in the window (a test's metric)."""


def read(rec):
    return rec.examples / rec.attempted if rec.attempted else None
'''


def test_a_new_cell_config_traffic_and_metric_need_only_new_files(tiny):
    bench_dir, bench_json = tiny
    # a new traffic mix, cell and per-layer metric, as files and entries
    traffic = json.loads((bench_dir / "traffic/tiny.train.seq.json")
                         .read_text())
    traffic.update(batch=2)
    (bench_dir / "traffic/tiny.train.pairs.json").write_text(
        json.dumps(traffic))
    workload = json.loads((bench_dir / "workloads/tiny.bert.train.json")
                          .read_text())
    workload.update(traffic="tiny.train.pairs")
    (bench_dir / "workloads/tiny.bert.pairs.json").write_text(
        json.dumps(workload))
    (bench_dir / "metrics/rows_per_call.test.py").write_text(NEW_METRIC)
    bench = json.loads(bench_json.read_text())
    bench["workloads"].append({"name": "tiny.bert.pairs",
                               "config": "tiny-bert",
                               "traffic": "tiny.train.pairs", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "rows_per_call.test", "unit": "rows",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer step",
                               "moves": "train_examples_per_s",
                               "workloads": ["tiny.bert.pairs"]})
    for metric in bench["end_to_end"]:
        if "workloads" in metric and metric["name"] == \
                "train_examples_per_s":
            metric["workloads"].append("tiny.bert.pairs")
    bench_json.write_text(json.dumps(bench))

    out, rec = runner.run_cell("tiny.bert.pairs", 2 ** 31 + 17, 0.3, True,
                               "cpu", bench_dir, bench_json)
    assert out["correct"], out["checks"]
    # the per-layer metrics BENCHMARK.json lists for this cell, no other
    assert out["metrics"] == {"rows_per_call.test": {"value": 2.0,
                                                     "unit": "rows"}}
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    out, _ = runner.run_cell("tiny.bert.pairs", 5, 0.3, False, "cpu",
                             bench_dir, bench_json)
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny.bert.train", "tiny.deepfm.train",
                                  "tiny.bert.serve"])
def test_each_entry_runs_and_proves_correct_on_the_cpu(tiny, cell):
    bench_dir, bench_json = tiny
    out, rec = runner.run_cell(cell, 3_000_000_123, 0.3, False, "cpu",
                               bench_dir, bench_json)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert "setup_s" in out["metrics"]


def test_names_that_leave_the_folder_are_refused(tiny):
    bench_dir, bench_json = tiny
    for name in ("../BENCHMARK", "a/b", "", "x" * 65):
        with pytest.raises(ValueError):
            spec.load_cell(name, bench_dir, bench_json)


def test_the_schedule_is_the_seeds_and_offers_every_seed_the_same_work():
    traffic = json.loads(
        (spec.BENCH_DIR / "traffic/serve.poisson.json").read_text())
    due, rows = inputs.schedule(traffic, 2 ** 33 + 1, 10.0)
    again = inputs.schedule(traffic, 2 ** 33 + 1, 10.0)
    other = inputs.schedule(traffic, 7, 10.0)
    assert np.array_equal(due, again[0]) and np.array_equal(rows, again[1])
    assert len(due) == inputs.request_count(traffic, 10.0)
    assert np.all(np.diff(due) > 0) and 0 < due[0] and due[-1] < 10.0
    # the same sizes and gaps, in another order
    assert not np.array_equal(rows, other[1])
    assert np.array_equal(np.sort(rows), np.sort(other[1]))
    # the gaps: one multiset of n + 1, of which each order leaves one out
    gaps = Counter(np.round(np.diff(np.concatenate([[0.0], due])), 9))
    other_gaps = Counter(np.round(np.diff(np.concatenate([[0.0],
                                                          other[0]])), 9))
    assert sum((gaps & other_gaps).values()) >= len(due) - 1
    assert rows.min() >= 1 and rows.max() <= 64


def test_pools_and_weights_repeat_by_seed_and_differ_across_seeds():
    traffic = dict(TINY_CRITEO, batch=64, pool_batches=2)
    cfg = TINY_DEEPFM
    a = inputs.training_pool(cfg, traffic, 11, "cpu")
    b = inputs.training_pool(cfg, traffic, 11, "cpu")
    c = inputs.training_pool(cfg, traffic, 12, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x["features"]["sparse"], y["features"]["sparse"])
        assert np.array_equal(x["labels"], y["labels"])
    assert not np.array_equal(a[0]["features"]["sparse"],
                              c[0]["features"]["sparse"])
    assert not np.array_equal(a[0]["features"]["sparse"],
                              a[1]["features"]["sparse"])
    # each field's ids under its own cardinality
    assert np.all(a[0]["features"]["sparse"].max(axis=0)
                  < TINY_CRITEO["features"]["sparse"]["mod"])
    assert 0.05 < a[0]["labels"].mean() < 0.95
    cfg_b = json.loads((spec.BENCH_DIR / "configs/bert-base.json").read_text())
    cfg_b.update(vocab_size=50, num_hidden_layers=1, hidden_size=8,
                 num_attention_heads=2, intermediate_size=16,
                 max_position_embeddings=4)
    w1 = make_weights(ref_bert.param_spec(cfg_b), 2 ** 40, "cpu")
    w2 = make_weights(ref_bert.param_spec(cfg_b), 2 ** 40, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert torch.allclose(w1["LayerNorm_0.weight"].mean(),
                          torch.tensor(1.0), atol=0.1)


def test_trace_arithmetic_busy_idle_and_gaps():
    prof = Profile(
        device_ops=[("gemm", 0, 40), ("gemm", 30, 50), ("copy", 70, 80),
                    ("early", -10, 5)],
        annotations=[("stage", 50, 75), ("train_call", 45, 100)],
        start_ns=0, end_ns=100)
    assert prof.busy_s() == pytest.approx(60e-9)
    assert prof.window_s == pytest.approx(100e-9)
    # launches add up, overlapping or not
    assert prof.op_seconds(lambda n: n == "gemm") == (pytest.approx(60e-9),
                                                      2)
    gaps = dict(prof.idle_gaps())
    # 50..70: inside `stage` (the innermost); 80..100: `train_call`
    assert gaps == {"stage": pytest.approx(20e-9),
                    "train_call": pytest.approx(20e-9)}
    top = prof.top_ops()
    assert top[0][0] == "gemm" and top[0][1] == pytest.approx(60e-9)
