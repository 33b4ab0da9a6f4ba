"""Each count of benchmark/costs against a hand count at small shapes."""

import json

import pytest
import torch

from benchmark.costs import adam, bert, deepfm, flash_bwd, flash_fwd, peaks
from benchmark.costs import scatter_add
from benchmark.harness.record import Record
from benchmark.harness.spec import BENCH_DIR
from benchmark.harness.stats import roofline
from benchmark.harness.trace import Profile
from benchmark.tests.tiny import TINY_DEEPFM

SHAPE = dict(batch=2, q_len=8, k_len=8, heads=3, dim=4, elem_bytes=2)


def test_flash_forward_by_hand():
    # QK^T and PV: 2 products x 2 flops x B*H*Lq*Lk*D; q, k, v, O in
    # bf16 and the f32 lse
    assert flash_fwd.cost(**SHAPE) == (2 * 2 * 2 * 3 * 8 * 8 * 4,
                                       4 * 192 * 2 + 2 * 8 * 3 * 4)
    flops, _ = flash_fwd.cost(**dict(SHAPE, causal=True))
    assert flops == 2 * 2 * 2 * 3 * 36 * 4


def test_flash_backward_by_hand():
    # five products; q, O, dO, dQ and k, dK, v, dV, and the lse
    assert flash_bwd.cost(**SHAPE) == (5 * 2 * 2 * 3 * 8 * 8 * 4,
                                       8 * 192 * 2 + 2 * 8 * 3 * 4)


def test_scatter_add_and_adam_by_hand():
    # 10 ids of 4 floats into 3 touched rows: ids, grads, rows in and out
    assert scatter_add.cost(10, 4, 3) == (40, 40 + 160 + 2 * 3 * 16)
    assert adam.cost(100) == (1200, 2800)


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 1.0, "f32") == pytest.approx(1.0)


def _bert_cfg():
    cfg = json.loads((BENCH_DIR / "configs/bert-base.json").read_text())
    cfg.update(hidden_size=8, intermediate_size=16, num_hidden_layers=1,
               num_attention_heads=2, vocab_size=4,
               max_position_embeddings=4)
    return cfg


def test_bert_model_flops_and_calls_by_hand():
    cfg = _bert_cfg()
    ids = torch.tensor([[1, 2, 2, 0], [3, 1, 5, 6]])
    # a token, a layer: QKV, out, FFN in and out (2*8*(24+8+32)) plus
    # QK^T and PV over 4 positions (4*4*8); 4 tokens, the classifier
    per_row = 4 * (2 * 8 * 64 + 4 * 4 * 8) + 2 * 8 * 2
    assert bert.forward_flops_per_row(cfg, 4) == per_row
    assert bert.train_flops_per_example(cfg, {"input_ids": ids}) == \
        3 * per_row
    calls = bert.train_kernel_calls(cfg, {"input_ids": ids})
    assert calls["flash_fwd"] == [dict(batch=2, q_len=4, k_len=4, heads=2,
                                       dim=4, elem_bytes=2)]
    # rows 1, 2, 0, 3, 1, 2 (5 and 6 mod 4): four touched of eight ids
    assert calls["scatter_add"] == [dict(n=8, dim=8, touched=4)]
    assert bert.param_count(cfg) == (4 * 8 + 4 * 8 + 2 * 8 + 24 * 8 + 24
                                     + 8 * 8 + 8 + 2 * 8 + 16 * 8 + 16
                                     + 8 * 16 + 8 + 2 * 8 + 2 * 8 + 2)


def test_deepfm_model_flops_and_calls_by_hand():
    cfg = dict(TINY_DEEPFM, vocab_capacity=2 ** 25)
    width = 13 + 26 * 16
    mlp = 2 * (width * 256 + 256 * 128 + 128)
    assert deepfm.forward_flops_per_row(cfg) == \
        mlp + 3 * 26 * 16 + 3 * 16 + 2 * 13 + 26
    sparse = torch.zeros((3, 26), dtype=torch.int32)
    sparse[1] = 5
    calls = deepfm.train_kernel_calls(cfg, {"sparse": sparse})
    # rows 0 and 2 touch the same 26 rows, row 1 another 26 (each field
    # offsets its ids)
    assert calls["scatter_add"] == [dict(n=78, dim=16, touched=52),
                                    dict(n=78, dim=1, touched=52)]


def test_a_roofline_reads_100_when_the_kernel_takes_its_least_time():
    flops, nbytes = flash_fwd.cost(**SHAPE)
    least_ns = int(round(peaks.least_seconds(flops, nbytes, "bf16") * 1e9
                         * 1000))
    rec = Record(cell=None, seed=0, seconds=1, trace=True, device=None)
    rec.kernel_calls["flash_fwd"] = [SHAPE] * 1000
    rec.profile = Profile(device_ops=[("flash_fwd_sm90_kernel", 0, least_ns),
                                      ("gemm", 0, 10)],
                          start_ns=0, end_ns=10 * least_ns)
    assert roofline(rec, "flash_fwd", ("flash_fwd",)) == \
        pytest.approx(100.0, rel=1e-3)
