"""The port's xDeepFM (elasticdl_tpu_torch/model_zoo/deepfm/xdeepfm.py)
against the flax zoo's on the CPU: the CIN alone, the carried init, the
forward on each wire format, a few Adam steps of the JAX Trainer, and
the two scatter-adds a step.

Tolerances: XLA contracts the CIN's einsum without the outer product and
the port builds it and runs one matmul, so the sums run in different
orders; each bound states what was measured."""

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_parity import carried_states, carry, step_gaps, trainers
from elasticdl_tpu_torch.layers import embedding as port_embedding
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_functional_api as fm
from elasticdl_tpu_torch.model_zoo.deepfm import xdeepfm as port
from elasticdl_tpu_torch.model_zoo.deepfm.data import record_rows
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.worker.trainer import _to_device
from model_zoo.deepfm import xdeepfm as jax_x

torch.set_num_threads(2)

MODEL = "deepfm.xdeepfm.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;cin_widths=(16, 8);lr=0.005"
# CIN outputs from the same weights: measured 3.0e-8 at up to 0.13
CIN_TOL = 1e-6
# logits from the same weights: measured 3.6e-7 at up to 1.8; on the
# compact and dedup wire formats, whose dense features are bf16-rounded,
# 1.6e-3
FWD_TOL = 1e-5
BF16_WIRE_TOL = 1e-2
# per-step losses over 4 Adam steps (batch 64): measured 1.2e-7 at
# 0.58-0.66; the logits after them 1.3e-5
LOSS_TOL = 1e-5
PRED_TOL = 2e-4


def _batch(n=64, seed=0):
    dense, sparse, labels = synthetic_criteo(n, seed=seed)
    return {"features": {"dense": dense, "sparse": sparse},
            "labels": labels.astype(np.int32)}


def _model_pair(**kwargs):
    batch = _batch()
    model = jax_x.custom_model(**kwargs)
    variables = model.init(jax.random.PRNGKey(0), batch["features"])
    ported = carry(port.custom_model(**kwargs), variables["params"])
    return model, variables, ported


def test_cin_matches_flax():
    x0 = np.random.RandomState(0).randn(8, 26, 16).astype(np.float32) * .1
    cin = jax_x.CIN((32, 16))
    variables = cin.init(jax.random.PRNGKey(1), x0)
    ported = carry(port.CIN(26, (32, 16)), variables["params"])
    assert tuple(ported.w_0.shape) == (32, 26, 26)
    assert tuple(ported.w_1.shape) == (16, 32, 26)
    got = ported(torch.from_numpy(x0)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(cin.apply(variables, x0)),
                               atol=CIN_TOL, rtol=1e-5)
    # the flax glorot_uniform bound, fan_in = H_prev * H, fan_out = m * H;
    # the draw comes from a seeded generator, so the check does not hang
    # on what other tests drew from torch's global one, and it holds the
    # float32 draw to float32(limit): a draw can round to that value,
    # one float32 ulp above the float64 bound
    fresh = port.CIN(26, (64, 64))
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    limit = np.float32(np.sqrt(6.0 / (26 * 64 + 26 * 64)))
    assert float(fresh.w_0.detach().abs().max()) <= limit


def test_forward_matches_flax_on_every_wire_format():
    model, variables, ported = _model_pair(vocab_capacity=4096, embed_dim=8,
                                           cin_widths=(16, 8))
    assert fm.DEDUP_VOCAB_CAPACITY == 4096
    batch = _batch(seed=3)
    want = np.asarray(model.apply(variables, batch["features"]))
    rows = record_rows(batch["features"]["dense"],
                       batch["features"]["sparse"], batch["labels"])
    sizes = np.full(len(rows), fm.RECORD_BYTES)
    for feed in (port.feed_bulk, port.feed_bulk_compact,
                 port.feed_bulk_dedup):
        features = feed(rows.reshape(-1), sizes)["features"]
        got = ported(_to_device(features, torch.device("cpu")))
        tol = FWD_TOL if feed is port.feed_bulk else BF16_WIRE_TOL
        np.testing.assert_allclose(got.detach().numpy(), want, atol=tol,
                                   rtol=tol)


def test_shares_deepfm_record_format_and_feeds():
    for name in ("feed", "feed_bulk", "feed_bulk_compact", "feed_bulk_dedup",
                 "loss", "optimizer"):
        assert getattr(port, name) is getattr(fm, name)


def test_training_steps_match_the_jax_trainer(monkeypatch):
    _, jt, _, pt = trainers(MODEL, PARAMS)
    batches = [_batch(seed=s) for s in range(5)]
    jstate, pstate = carried_states(jt, pt, batches[0]["features"])
    calls = []
    real = port_embedding.scatter_add_forward

    def counted(*args, **kwargs):
        calls.append(tuple(args[2].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_embedding, "scatter_add_forward", counted)
    gaps, losses, jstate, pstate = step_gaps(jt, pt, jstate, pstate,
                                             batches[:4])
    assert max(gaps) < LOSS_TOL, (gaps, losses)
    assert sorted(calls) == sorted([(26 * 64, 8), (26 * 64, 1)] * 4)
    x = batches[4]["features"]
    np.testing.assert_allclose(pt.predict_on_batch(pstate, x),
                               np.asarray(jt.predict_on_batch(jstate, x)),
                               atol=PRED_TOL, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_custom_model_options(bf16):
    model = port.custom_model(vocab_capacity=1024, embed_dim=4, bf16=bf16,
                              cin_widths=(8,))
    assert model.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
    out = model(_to_device(_batch(8)["features"], torch.device("cpu")))
    assert out.dtype == torch.float32 and tuple(out.shape) == (8,)
