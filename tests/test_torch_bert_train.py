"""Training the port's BERT (elasticdl_tpu_torch/model_zoo/bert) against
the JAX package's, on the CPU.

Small configuration, as tests/test_torch_bert.py: hidden 64, 2 layers, 4
heads, MLP 128, L 128, vocab 512, batch 8.  The JAX Trainer runs on the
8-device CPU mesh of tests/conftest.py (ring attention with a seq axis
of 1: the Pallas flash kernel in interpret mode, and its jnp backward);
the port's Trainer runs on the CPU, where flash attention takes its
plain forward and backward.  The JAX init is carried into the port with
`params_from_jax`; batches come from numpy with a seed.

- step parity: per-step losses of 5 AdamW steps, the gradients of step
  1 and the parameters after it, in f32 and bf16, with a control at a
  tenth of the learning rate that the loss limit rejects;
- AdamW: torch's decoupled decay against optax.adamw on the same
  parameters and gradients;
- remat: bitwise the same losses and gradients as without, the same
  state_dict keys, and the flash forward twice per block per step;
- the zoo's data writer and eval metrics against the JAX zoo's;
- the Trainer's timed steps.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.bert import bert_finetune as port_bert
from elasticdl_tpu_torch.model_zoo.bert import data as port_data
from elasticdl_tpu_torch.ops import flash_attention as port_flash
from elasticdl_tpu_torch.worker.trainer import Trainer
from model_zoo.bert import bert_finetune as jax_bert
from model_zoo.bert import data as jax_data

torch.set_num_threads(2)

MODEL = "bert.bert_finetune.custom_model"
LR = 1e-3
PARAMS = ("hidden=64;num_layers=2;heads=4;mlp_dim=128;max_len=128;"
          f"vocab_size=512;lr={LR}")
HIDDEN = 64
LAYERS = 2
BATCH = 8
STEPS = 5

# Per-step losses.  f32: the two frameworks sum in another order (the
# JAX step also splits the batch over the 8-device mesh); measured 8.6e-6
# over 5 steps at a loss of ~1.  bf16: Dense, GELU and the block
# LayerNorms round to bf16 at other places (tests/test_torch_bert.py),
# and the Pallas forward rounds P to bf16 where the plain one does not;
# measured 0.019 over 5 steps.  For scale: JAX's own bf16 losses are
# 0.0125 from its f32 ones, and the port's bf16 losses 0.0061 from JAX's
# f32 ones.  The loss itself moves far more than the limit: the
# control, the port at a tenth of the learning rate (steps that barely
# train), is 1.38 from JAX's losses in both precisions (1.59 without
# any training), so 0.05 sits between the measured error and the
# control's, and the test asserts that the control fails it.
LOSS_TOL = {"f32": 5e-5, "bf16": 0.05}
CONTROL_LR = LR / 10
# Gradients of step 1, per parameter: |g_port - g_jax| / |g_jax| over
# the whole tensor (the key bias aside, below).  f32: measured 5.5e-7.
# bf16: measured 0.057 at worst (layer_0.Dense_0.weight; median 0.022).
# The port's bf16 gradients are 0.055 from its f32 ones where JAX's are
# 0.016 from its own: the port rounds more often in bf16 (eager ops
# each round their output, XLA fuses them).  A gradient off by a tenth
# of its size fails the bf16 limit.
GRAD_TOL = {"f32": 1e-5, "bf16": 0.1}
# The key bias of the QKV projection has a zero gradient in exact
# arithmetic (it adds the same q.b to every logit of a row): both
# packages give rounding noise there, measured 9e-9 apart in f32 and
# 1.1e-4 in bf16, at a gradient scale of ~0.2.
KEY_BIAS_TOL = {"f32": 1e-6, "bf16": 1e-3}
# Parameters after step 1.  Adam's first update is lr * g / (|g| + eps):
# +-lr wherever |g| >> eps, whatever g's size, so this checks the signs
# of the gradients (their sizes are checked above).  A gradient element
# that is rounding noise around zero moves its parameter by +-lr in
# either package; the key bias is all such noise.  The rest: measured 2
# of 108,162 elements beyond 1e-5 in f32 (share 1.8e-5); in bf16, where
# more gradients round across zero, 1.5%.
PARAM_TOL = 1e-5
OUTLIER_SHARE = {"f32": 1e-4, "bf16": 0.03}


def _batches(n=STEPS, batch=BATCH, length=128, vocab=512, seed=0):
    rng = np.random.RandomState(seed)
    return [{"features": {"input_ids": rng.randint(
                 0, vocab, (batch, length)).astype(np.int32)},
             "labels": rng.randint(0, 2, batch).astype(np.int32)}
            for _ in range(n)]


def _carried(params, sample):
    """(JAX trainer, JAX state, port trainer, port state) from the same
    flax init."""
    js = jax_spec("model_zoo", MODEL, model_params=params)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    param_sharding_fn=js.param_sharding)
    jstate = jt.init_state(jax.random.PRNGKey(0), sample)
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                     model_params=params)
    pt = Trainer(ps.model, ps.optimizer, ps.loss, device="cpu")
    pstate = pt.init_state(0, sample)
    flat = flatten_params(jax.tree.map(np.asarray, jstate.params["params"]))
    pstate.model.load_state_dict(params_from_jax(pstate.model, flat),
                                 strict=True)
    return jt, jstate, pt, pstate


def _key_bias_mask(name, shape):
    """True where a parameter element is the key part of a QKV bias."""
    mask = np.zeros(shape, bool)
    if name.endswith("attention.qkv.bias"):
        mask[HIDDEN:2 * HIDDEN] = True
    return mask


def _jax_grads(jt, jstate, batch):
    """(loss, flat gradients) of the JAX Trainer's loss at its state, on
    its mesh: the gradients its first step feeds optax."""
    mesh_lib.set_current_mesh(jt.mesh)
    sharded = mesh_lib.shard_batch(batch, jt.mesh)

    def loss_of(params):
        logits = jt.model.apply({"params": params}, sharded["features"])
        return jax_bert.loss(sharded["labels"], logits.astype(jnp.float32))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        jstate.params["params"])
    return float(loss), flatten_params(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_adamw_steps_match_the_jax_trainer(precision):
    params = PARAMS + (";bf16=True" if precision == "bf16" else "")
    batches = _batches()
    jt, jstate, pt, pstate = _carried(params, batches[0]["features"])
    assert isinstance(pstate.optimizer, torch.optim.AdamW)
    init = {n: p.detach().clone() for n, p in pstate.params.items()}
    grad_loss, jgrads = _jax_grads(jt, jstate, batches[0])
    jgrads = params_from_jax(pstate.model, jgrads)
    jlosses, plosses = [], []
    for i, batch in enumerate(batches):
        jstate, jl = jt.train_on_batch(jstate, batch)
        pstate, pl = pt.train_on_batch(pstate, batch)
        jlosses.append(float(jl))
        plosses.append(float(pl))
        if i > 0:
            continue
        # the gradients are the Trainer's: the same loss
        np.testing.assert_allclose(grad_loss, float(jl), rtol=0, atol=1e-6)
        for name, p in pstate.model.named_parameters():
            got, want = p.grad.numpy(), jgrads[name].numpy()
            key = _key_bias_mask(name, got.shape)
            rel = (np.linalg.norm((got - want)[~key])
                   / np.linalg.norm(want[~key]))
            assert rel <= GRAD_TOL[precision], (name, rel)
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=KEY_BIAS_TOL[precision])
        flat = flatten_params(
            jax.tree.map(np.asarray, jstate.params["params"]))
        want = params_from_jax(pstate.model, flat)
        diffs = []
        for name, got in pstate.params.items():
            diff = np.abs(got.detach().numpy() - want[name].numpy())
            diffs.append(diff[~_key_bias_mask(name, diff.shape)])
        share = float((np.concatenate(diffs) > PARAM_TOL).mean())
        assert share <= OUTLIER_SHARE[precision], share
    assert pstate.step == STEPS == int(jstate.step)
    np.testing.assert_allclose(plosses, jlosses, rtol=0,
                               atol=LOSS_TOL[precision])
    # the control: from the same init at a tenth of the learning rate,
    # the losses leave the limit
    control = _port_trainer(params.replace(f"lr={LR}", f"lr={CONTROL_LR}"))
    cstate = control.init_state(0, batches[0]["features"])
    cstate.model.load_state_dict(init, strict=True)
    closses = []
    for batch in batches:
        cstate, cl = control.train_on_batch(cstate, batch)
        closses.append(float(cl))
    assert np.abs(np.subtract(closses, jlosses)).max() > \
        LOSS_TOL[precision]


def test_adamw_matches_optax_adamw_on_the_same_gradients():
    """The zoo's optimizer against optax.adamw(lr, weight_decay=0.01)
    over 3 steps on every parameter (optax's default mask decays all).
    optax adds wd * p to the update; torch first multiplies p by
    (1 - lr * wd): equal in exact arithmetic, apart by about a rounding
    step of p (2^-23 |p|) per step: within 4 such steps (rtol 5e-7;
    measured 1.5 steps at |p| ~ 4) after 3, and 1e-7 where p is near
    zero."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(1000).astype(np.float32)
    grads = [rng.randn(1000).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tx = optax.adamw(LR, weight_decay=0.01)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = port_bert.optimizer(lr=LR)([param])
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                               rtol=5e-7, atol=1e-7)


def _port_trainer(params):
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                     model_params=params)
    return Trainer(ps.model, ps.optimizer, ps.loss, device="cpu")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_remat_is_bitwise_the_plain_model_and_recomputes_the_forward(
        precision, monkeypatch):
    """remat=True (a non-reentrant checkpoint per block) changes memory,
    not numbers: the same losses and gradients bit for bit, the same
    parameter names, so checkpoints move between the two.  The JAX
    package's twin is tests/test_bert.py::
    test_remat_matches_nonremat_and_shares_param_tree."""
    forward_calls, backward_calls = [], []
    real_fwd = port_flash.flash_attention_forward
    real_bwd = port_flash.flash_attention_backward

    def spy_fwd(*args, **kwargs):
        forward_calls.append(torch.is_grad_enabled())
        return real_fwd(*args, **kwargs)

    def spy_bwd(*args, **kwargs):
        backward_calls.append(1)
        return real_bwd(*args, **kwargs)

    monkeypatch.setattr(port_flash, "flash_attention_forward", spy_fwd)
    monkeypatch.setattr(port_flash, "flash_attention_backward", spy_bwd)
    params = PARAMS + (";bf16=True" if precision == "bf16" else "")
    batches = _batches(n=3, seed=4)
    runs = {}
    for tag, extra in (("plain", ""), ("remat", ";remat=True")):
        trainer = _port_trainer(params + extra)
        state = trainer.init_state(0, batches[0]["features"])
        forward_calls.clear()
        backward_calls.clear()
        losses, grads = [], []
        for batch in batches:
            state, loss = trainer.train_on_batch(state, batch)
            losses.append(loss)
            grads.append({n: p.grad.clone()
                          for n, p in state.model.named_parameters()})
        runs[tag] = (state, losses, grads, len(forward_calls),
                     len(backward_calls))
    plain, remat = runs["plain"], runs["remat"]
    assert remat[0].model.remat and not plain[0].model.remat
    assert list(plain[0].model.state_dict()) == \
        list(remat[0].model.state_dict())
    for a, b in zip(plain[1], remat[1]):
        assert torch.equal(a, b)
    for ga, gb in zip(plain[2], remat[2]):
        for name in ga:
            assert torch.equal(ga[name], gb[name]), name
    for (name, pa), pb in zip(plain[0].params.items(),
                              remat[0].params.values()):
        assert torch.equal(pa, pb), name
    steps = len(batches)
    # the init's no-grad forward runs before the counts start
    assert plain[3] == LAYERS * steps and plain[4] == LAYERS * steps
    assert remat[3] == 2 * LAYERS * steps and remat[4] == LAYERS * steps
    # a remat checkpoint loads into the plain model, strictly
    fresh = port_bert.custom_model(hidden=64, num_layers=2, heads=4,
                                   mlp_dim=128, max_len=128,
                                   vocab_size=512)
    fresh.load_state_dict(remat[0].model.state_dict(), strict=True)


def test_remat_is_inactive_without_grad():
    trainer = _port_trainer(PARAMS + ";remat=True")
    batch = _batches(n=1)[0]
    state = trainer.init_state(0, batch["features"])
    preds = trainer.predict_on_batch(state, batch["features"])
    state.model.remat = False
    np.testing.assert_array_equal(
        preds, trainer.predict_on_batch(state, batch["features"]))


@pytest.mark.parametrize("kwargs", [
    dict(n_train=300, n_val=50, max_len=32, vocab=16, seed=0),
    dict(n_train=64, n_val=16, max_len=128, vocab=8192, seed=7),
])
def test_write_dataset_writes_the_jax_zoos_bytes(kwargs):
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        want = jax_data.write_dataset(a, **kwargs)
        got = port_data.write_dataset(b, **kwargs)
        for wdir, gdir in zip(want, got):
            assert os.path.basename(wdir) == os.path.basename(gdir)
            names = sorted(os.listdir(wdir))
            assert names == sorted(os.listdir(gdir))
            for name in names:
                with open(os.path.join(wdir, name), "rb") as f:
                    wbytes = f.read()
                with open(os.path.join(gdir, name), "rb") as f:
                    assert f.read() == wbytes, name


def test_synthetic_pairs_match_the_jax_zoo():
    for seed in (0, 3):
        want = jax_data.synthetic_pairs(500, 16, 8, seed)
        got = port_data.synthetic_pairs(500, 16, 8, seed)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
    ids, labels = got
    assert ((ids[:, 0] == ids[:, -1]) == (labels == 1)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_metrics_equal_the_jax_zoos(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(257, 2).astype(np.float32)
    # ties in logit1 - logit0, which AUC averages
    logits[:40] = np.round(logits[:40])
    labels = rng.randint(0, 2, 257).astype(np.int32)
    want = jax_bert.eval_metrics_fn()
    got = port_bert.eval_metrics_fn()
    assert sorted(got) == sorted(want) == ["accuracy", "auc"]
    for name in want:
        assert got[name](labels, logits) == want[name](labels, logits)


def test_timed_steps_per_sec_warms_once_and_advances_the_state():
    trainer = _port_trainer(PARAMS)
    batch = _batches(n=1)[0]
    state = trainer.init_state(0, batch["features"])
    rate = trainer.timed_steps_per_sec(state, batch, iters=2)
    assert rate > 0 and state.step == 3     # 1 warm-up + 2 timed
    trainer.timed_steps_per_sec(state, batch, iters=2)
    assert state.step == 5                   # warmed already


def test_trainer_init_draws_every_bert_parameter_from_the_seed():
    """The position table (the one parameter of no submodule) is drawn
    from the seed too, not from the global generator: two inits with
    one seed are equal, two seeds differ."""
    batch = _batches(n=1)[0]
    trainer = _port_trainer(PARAMS)
    torch.manual_seed(123)
    a = trainer.init_state(0, batch["features"])
    torch.manual_seed(456)
    b = trainer.init_state(0, batch["features"])
    c = trainer.init_state(1, batch["features"])
    for (name, pa), pb, pc in zip(a.params.items(), b.params.values(),
                                  c.params.values()):
        assert torch.equal(pa, pb), name
        if pa.std() > 0:
            assert not torch.equal(pa, pc), name
    pos = a.params["position_embedding"].detach()
    assert abs(float(pos.std()) - 0.02) < 0.002
