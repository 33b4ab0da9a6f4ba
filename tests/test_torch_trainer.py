"""The port's Trainer (elasticdl_tpu_torch/worker/trainer.py) on DeepFM
against the JAX package's Trainer, on the CPU, from the carried flax
init: the loss trajectory and the final parameters over 8 f32 steps,
predictions with the bf16 feature cast, the K-step stack against flat
steps bit for bit, and a short convergence run.

The JAX Trainer runs on the 8-device CPU mesh of tests/conftest.py and
splits each batch over `data`, so its gradient sums run in another
order than the port's single-device ones; hence tolerances, not bits,
between the two packages.
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.common.metrics import auc
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.worker import trainer as port_trainer

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
BATCH = 64
STEPS = 8
# Per-step losses: the two frameworks' forward and gradient sums differ
# in order (mesh split vs one device; oneDNN vs XLA products); measured
# 1.4e-6 over 8 steps at a loss of ~0.7.
LOSS_TOL = 1e-5
# Parameters after 8 Adam steps.  Adam divides each moment by its own
# root mean square, so where a gradient element is near zero a rounding
# difference in it moves that element's update by up to ~lr per step.
# Measured: all but 4 of 127,000 elements within 7.5e-6; those 4 (3 table
# elements, 1 mlp_1 weight) at up to 3.5e-4.  So: all but a 1e-3 share
# within PARAM_TOL, and every element within the 2 * lr * steps that
# Adam's bounded update allows.
PARAM_TOL = 2e-5
PARAM_OUTLIER_SHARE = 1e-3
ADAM_BOUND = 2 * 0.005 * STEPS
# bf16 MLP predictions from the same weights: see
# tests/test_torch_deepfm.py (one or two bf16 rounding steps).
BF16_PRED_TOL = 1e-2


def _batches(n_steps, batch=BATCH, seed=0):
    dense, sparse, labels = synthetic_criteo(n_steps * batch, seed=seed)
    return [
        {"features": {"dense": dense[sl], "sparse": sparse[sl]},
         "labels": labels[sl].astype(np.int32)}
        for sl in (slice(i * batch, (i + 1) * batch)
                   for i in range(n_steps))
    ]


def _trainers(params=PARAMS, use_bf16=False):
    js = jax_spec("model_zoo", MODEL, model_params=params)
    jt = JaxTrainer(js.model, js.optimizer, js.loss, use_bf16=use_bf16)
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                     model_params=params)
    pt = port_trainer.Trainer(ps.model, ps.optimizer, ps.loss,
                              use_bf16=use_bf16, device="cpu")
    return jt, pt


def _carried_states(jt, pt, sample):
    jstate = jt.init_state(jax.random.PRNGKey(0), sample)
    pstate = pt.init_state(0, sample)
    flat = flatten_params(jax.tree.map(np.asarray, jstate.params["params"]))
    pstate.model.load_state_dict(params_from_jax(pstate.model, flat),
                                 strict=True)
    return jstate, pstate


def test_trajectory_and_params_match_jax_trainer_f32():
    batches = _batches(STEPS)
    jt, pt = _trainers()
    jstate, pstate = _carried_states(jt, pt, batches[0]["features"])
    initial_table = pstate.params["fm_embedding.embedding"].detach().clone()
    jlosses, plosses = [], []
    for b in batches:
        jstate, jl = jt.train_on_batch(jstate, b)
        pstate, pl = pt.train_on_batch(pstate, b)
        jlosses.append(float(jl))
        plosses.append(float(pl))
    assert pstate.step == STEPS == int(jstate.step)
    np.testing.assert_allclose(plosses, jlosses, rtol=0, atol=LOSS_TOL)
    flat = flatten_params(jax.tree.map(np.asarray, jstate.params["params"]))
    want = params_from_jax(pstate.model, flat)
    for name, got in pstate.params.items():
        diff = np.abs(got.detach().numpy() - want[name].numpy())
        assert diff.max() <= ADAM_BOUND, name
        assert (diff > PARAM_TOL).mean() <= PARAM_OUTLIER_SHARE, name
    # the table moved, and only at rows the batches touched
    moved = (pstate.params["fm_embedding.embedding"].detach()
             != initial_table).any(1)
    assert 0 < int(moved.sum()) < 4096


def test_bf16_cast_predictions_match_jax_trainer():
    batches = _batches(2, seed=3)
    jt, pt = _trainers(PARAMS + ";bf16=True", use_bf16=True)
    jstate, pstate = _carried_states(jt, pt, batches[0]["features"])
    feats = batches[1]["features"]
    feats["dense"] = feats["dense"] * 37.0   # counts that bf16 rounds
    want = np.asarray(jt.predict_on_batch(jstate, feats))
    got = pt.predict_on_batch(pstate, feats)
    assert got.dtype == np.float32 and got.shape == (BATCH,)
    np.testing.assert_allclose(got, want, rtol=BF16_PRED_TOL,
                               atol=BF16_PRED_TOL)
    # the cast is what makes them agree: f32 features miss by more
    pt.use_bf16 = False
    off = np.abs(pt.predict_on_batch(pstate, feats) - want).max()
    assert off > np.abs(got - want).max()


def test_stack_bitwise_equals_flat_steps():
    batches = _batches(4, seed=5)
    _, pt = _trainers()
    a = pt.init_state(7, batches[0]["features"])
    b = pt.init_state(7, batches[0]["features"])
    for (name, pa), pb in zip(a.params.items(), b.params.values()):
        assert torch.equal(pa, pb), name
    a, stacked = pt.train_on_batch_stack(a, batches)
    flat = []
    for batch in batches:
        b, loss = pt.train_on_batch(b, batch)
        flat.append(loss)
    assert stacked.shape == (4,) and a.step == b.step == 4
    assert torch.equal(stacked, torch.stack(flat))
    for (name, pa), pb in zip(a.params.items(), b.params.values()):
        assert torch.equal(pa, pb), name


def test_init_state_is_seeded_and_draws_flax_distributions():
    sample = _batches(1)[0]["features"]
    _, pt = _trainers("vocab_capacity=16384;embed_dim=16")
    s0 = pt.init_state(0, sample)
    s1 = pt.init_state(torch.Generator().manual_seed(0), sample)
    s2 = pt.init_state(1, sample)
    table = s0.params["fm_embedding.embedding"].detach().clone()
    assert torch.equal(table, s1.params["fm_embedding.embedding"])
    assert not torch.equal(table, s2.params["fm_embedding.embedding"])
    assert abs(float(table.std()) - 0.05) < 0.001
    w = s0.params["mlp_0.weight"].detach()
    assert abs(float(w.std()) - (13 + 26 * 16) ** -0.5) < 0.002
    assert not s0.params["mlp_0.bias"].detach().any()
    # each state owns its model: training one leaves the other
    s0, _ = pt.train_on_batch(s0, _batches(1)[0])
    assert torch.equal(s1.params["fm_embedding.embedding"], table)
    assert pt.model.fm_embedding.embedding is not \
        s1.params["fm_embedding.embedding"]


def test_stage_batch_places_tensors():
    _, pt = _trainers()
    staged = pt.stage_batch(_batches(1)[0])
    assert staged["features"]["sparse"].dtype == torch.int32
    assert staged["labels"].device.type == "cpu"
    state = pt.init_state(0, staged["features"])
    state, loss = pt.train_on_batch(state, staged)
    assert loss.shape == () and torch.isfinite(loss)


def test_short_convergence_run_learns():
    """The _deepfm_auc protocol of bench.py at a CPU size: vocab 2^14,
    dim 8, bf16 MLP, lr 5e-3, 32 steps of 512, AUC on 4096 held-out
    rows.  Measured 0.78; chance is 0.5 and the planted structure's
    Bayes AUC ~0.85."""
    dense, sparse, labels = synthetic_criteo(32 * 512, seed=0)
    _, pt = _trainers("vocab_capacity=16384;embed_dim=8;bf16=True;lr=0.005",
                      use_bf16=True)
    state = pt.init_state(0, {"dense": dense[:512], "sparse": sparse[:512]})
    for i in range(32):
        sl = slice(i * 512, (i + 1) * 512)
        state, _ = pt.train_on_batch(state, {
            "features": {"dense": dense[sl], "sparse": sparse[sl]},
            "labels": labels[sl].astype(np.int32)})
    vd, vs, vy = synthetic_criteo(4096, seed=1000)
    assert auc(vy, pt.predict_on_batch(state, {"dense": vd,
                                                "sparse": vs})) > 0.74


def test_trainer_runs_on_the_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                       model_params="vocab_capacity=64")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_trainer.Trainer(spec.model, spec.optimizer, spec.loss)
    assert port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                device="cpu").device.type == "cpu"
