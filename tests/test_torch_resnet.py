"""The port's ResNet (elasticdl_tpu_torch/model_zoo/cifar10/resnet.py)
and the layers under it (layers/linen.py `Conv`, `BatchNorm`) against
the flax zoo's on the CPU, from the carried flax init: the forward in
eval and train mode, the running statistics a train step leaves, a few
SGD-momentum steps of the JAX Trainer, and the traps of the carry (the
strided SAME padding, the biased running variance, the HWIO -> OIHW
kernel).  Parity runs at stage_sizes=(1, 1); the full (3, 4, 6, 3) model
takes one port-only step.

Tolerances: XLA and oneDNN sum the convolutions and the batch reductions
in different orders, so f32 results differ by rounding; each bound
below states what was measured beside it.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.layers.linen import BatchNorm, Conv
from elasticdl_tpu_torch.model_zoo.cifar10 import data as port_data
from elasticdl_tpu_torch.model_zoo.cifar10 import resnet as port_resnet
from elasticdl_tpu_torch.worker import trainer as port_trainer
from model_zoo.cifar10 import data as jax_data
from model_zoo.cifar10 import resnet as jax_resnet

torch.set_num_threads(2)

MODEL = "cifar10.resnet.custom_model"
SMALL = "stage_sizes=(1, 1)"
BATCH = 8
# logits from the same weights, eval mode (running statistics) and train
# mode (batch statistics): measured 1.3e-7 / 7.6e-7 at logits up to 0.28
FWD_TOL = 1e-5
# running statistics after one train-mode forward: measured 7.2e-7
STAT_TOL = 1e-5
# per-step losses over 3 SGD-momentum steps at lr 0.1: measured 9.5e-7
# at a loss of 4.6; the running statistics after them 2.0e-6, and the
# eval-mode predictions 3.0e-7
LOSS_TOL = 1e-5
AFTER_STEPS_TOL = 1e-4


def _batch(n=BATCH, seed=0):
    xs, ys = jax_data.synthetic_cifar(n, seed=seed)
    return jax_resnet.feed([x.tobytes() + bytes([int(y)])
                            for x, y in zip(xs, ys)])


def _carry(model, variables):
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    stats = flatten_params(jax.tree.map(np.asarray,
                                        variables["batch_stats"]))
    model.load_state_dict(params_from_jax(model, flat, batch_stats=stats),
                          strict=True)
    return model


def _small_pair(seed=0):
    flax_model = jax_resnet.custom_model(stage_sizes=(1, 1))
    x = _batch()["features"]
    variables = flax_model.init(jax.random.PRNGKey(seed), x, train=False)
    port = _carry(port_resnet.custom_model(stage_sizes=(1, 1)), variables)
    return flax_model, variables, port


def test_module_names_and_init_match_flax():
    flax_model, variables, port = _small_pair()
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    names = {k.replace("/", ".").replace("kernel", "weight")
             .replace("scale", "weight") for k in flat}
    assert names == set(dict(port.named_parameters()))
    # projection convs exist exactly where flax made them
    assert "BottleneckBlock_1/Conv_3/kernel" in flat
    assert port.BottleneckBlock_1.project
    # the last BatchNorm of each block starts at scale 0, in both
    assert not np.any(flat["BottleneckBlock_0/BatchNorm_2/scale"])
    fresh = port_resnet.custom_model(stage_sizes=(1, 1))
    assert not fresh.BottleneckBlock_0.BatchNorm_2.weight.any()
    assert fresh.BottleneckBlock_0.BatchNorm_0.weight.eq(1).all()


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax(train):
    flax_model, variables, port = _small_pair()
    x = _batch(seed=1)["features"]
    if train:
        want, updates = flax_model.apply(variables, x, train=True,
                                         mutable=["batch_stats"])
    else:
        want = flax_model.apply(variables, x, train=False)
    got = port(torch.from_numpy(x), train=train).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)
    if train:
        stats = flatten_params(jax.tree.map(np.asarray,
                                            updates["batch_stats"]))
        buffers = dict(port.named_buffers())
        for path, value in stats.items():
            name = path.replace("/", ".").replace(
                ".mean", ".running_mean").replace(".var", ".running_var")
            np.testing.assert_allclose(buffers[name].numpy(), value,
                                       atol=STAT_TOL, rtol=STAT_TOL)
    else:
        # eval reads the statistics and leaves them
        for name, buf in port.named_buffers():
            assert buf.eq(0 if name.endswith("mean") else 1).all()


def test_strided_same_padding_is_flax_asymmetric():
    """3x3, stride 2, 32 -> 16: flax pads (0, 1); Conv2d(padding=1) pads
    (1, 1) and gives the same shape with other numbers."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 5).astype(np.float32)
    conv = fnn.Conv(7, (3, 3), strides=(2, 2), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(variables, x))              # (2,16,16,7)
    port = Conv(5, 7, (3, 3), (2, 2), use_bias=False)
    kernel = np.asarray(variables["params"]["kernel"])
    port.load_state_dict(params_from_jax(port, {"kernel": kernel}))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    symmetric = torch.nn.functional.conv2d(xt, port.weight, stride=2,
                                           padding=1)
    assert tuple(symmetric.shape) == tuple(got.transpose(0, 3, 1, 2).shape)
    assert np.abs(symmetric.permute(0, 2, 3, 1).detach().numpy()
                  - want).max() > 0.1


def test_running_variance_is_the_biased_batch_variance():
    """flax moves `var` by the biased E[x^2] - E[x]^2 with momentum 0.9;
    torch's BatchNorm2d would move it by the unbiased one."""
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 3, 3, 6) * 3 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = bn.init(jax.random.PRNGKey(0), x)
    y, updates = bn.apply(variables, x, mutable=["batch_stats"])
    port = BatchNorm(6)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt, train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-5, rtol=1e-5)
    want_var = np.asarray(updates["batch_stats"]["var"])
    np.testing.assert_allclose(port.running_var.numpy(), want_var,
                               rtol=1e-6)
    np.testing.assert_allclose(
        port.running_mean.numpy(),
        np.asarray(updates["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    biased = x.reshape(-1, 6).var(axis=0)
    np.testing.assert_allclose(want_var, 0.9 + 0.1 * biased, rtol=1e-5)
    ref = torch.nn.BatchNorm2d(6, momentum=0.1)
    ref.train()
    ref(xt)
    assert np.abs(ref.running_var.numpy() - want_var).max() > 1e-2


def test_hwio_kernel_carries_to_oihw_with_distinct_taps():
    """A 3x3 kernel whose nine taps differ: `.T` would pass the shape
    check and transpose the taps; the carry maps HWIO -> OIHW."""
    kernel = np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(3, 3, 2, 4)
    kernel = kernel / kernel.size - 0.5
    port = Conv(2, 4, (3, 3), use_bias=False)
    carried = params_from_jax(port, {"kernel": kernel})["weight"]
    assert tuple(carried.shape) == (4, 2, 3, 3)
    assert tuple(kernel.T.shape) == (4, 2, 3, 3)      # the trap
    for h in range(3):
        for w in range(3):
            np.testing.assert_array_equal(carried[:, :, h, w].numpy(),
                                          kernel[h, w].T)
    x = np.random.RandomState(2).randn(1, 5, 5, 2).astype(np.float32)
    want = fnn.Conv(4, (3, 3), use_bias=False).apply(
        {"params": {"kernel": kernel}}, x)
    port.load_state_dict({"weight": carried})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5)
    port.weight.data.copy_(torch.from_numpy(np.ascontiguousarray(kernel.T)))
    wrong = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(wrong.permute(0, 2, 3, 1).detach().numpy()
                  - np.asarray(want)).max() > 0.1


def test_params_from_jax_refuses_without_batch_stats():
    _, variables, port = _small_pair()
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    with pytest.raises(ValueError, match="batch_stats"):
        params_from_jax(port, flat)


def test_sgd_momentum_is_optax_sgd_step_for_step():
    """torch's SGD(momentum=0.9, dampening=0) against optax.sgd(0.1,
    momentum=0.9) on the same gradients: the same trace and updates."""
    rng = np.random.RandomState(3)
    param = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) for _ in range(6)]
    tx = optax.sgd(0.1, momentum=0.9)
    jp = jnp.asarray(param)
    opt_state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(param.copy()))
    opt = port_resnet.optimizer()([p])
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)


def test_training_steps_match_the_jax_trainer():
    js = jax_spec("model_zoo", MODEL, model_params=SMALL)
    jt = JaxTrainer(js.model, js.optimizer, js.loss)
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                     model_params=SMALL)
    pt = port_trainer.Trainer(ps.model, ps.optimizer, ps.loss, device="cpu")
    batches = [_batch(seed=s) for s in range(3)]
    jstate = jt.init_state(jax.random.PRNGKey(0), batches[0]["features"])
    pstate = pt.init_state(0, batches[0]["features"])
    _carry(pstate.model, {"params": jstate.params["params"],
                          "batch_stats": jstate.model_state["batch_stats"]})
    for batch in batches:
        jstate, jloss = jt.train_on_batch(jstate, batch)
        pstate, ploss = pt.train_on_batch(pstate, batch)
        assert abs(float(jloss) - float(ploss)) < LOSS_TOL, (jloss, ploss)
    # the running statistics moved in training, as the JAX ones did
    stats = flatten_params(jax.tree.map(
        np.asarray, jstate.model_state["batch_stats"]))
    buffers = dict(pstate.model.named_buffers())
    moved = buffers["BatchNorm_0.running_mean"].abs().max()
    assert float(moved) > 1e-3
    for path, value in stats.items():
        name = path.replace("/", ".").replace(
            ".mean", ".running_mean").replace(".var", ".running_var")
        np.testing.assert_allclose(buffers[name].numpy(), value,
                                   atol=AFTER_STEPS_TOL, rtol=0)
    x = _batch(seed=9)["features"]
    np.testing.assert_allclose(pt.predict_on_batch(pstate, x),
                               np.asarray(jt.predict_on_batch(jstate, x)),
                               atol=AFTER_STEPS_TOL, rtol=0)


def test_full_depth_resnet50_takes_a_step_on_the_cpu():
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL)
    pt = port_trainer.Trainer(ps.model, ps.optimizer, ps.loss, device="cpu")
    batch = _batch(n=2)
    state = pt.init_state(0, batch["features"])
    assert sum(p.numel() for p in state.model.parameters()) == 23_520_842
    blocks = [m for m in state.model.modules()
              if isinstance(m, port_resnet.BottleneckBlock)]
    assert len(blocks) == 16 and sum(b.project for b in blocks) == 4
    before = state.model.BatchNorm_0.running_var.clone()
    state, loss = pt.train_on_batch(state, batch)
    assert np.isfinite(float(loss)) and state.step == 1
    assert not torch.equal(before, state.model.BatchNorm_0.running_var)
    preds = pt.predict_on_batch(state, batch["features"])
    assert preds.shape == (2, 10) and np.all(np.isfinite(preds))


def test_data_and_feeds_match_the_jax_zoo(tmp_path):
    xs, ys = port_data.synthetic_cifar(16, seed=4)
    jx, jy = jax_data.synthetic_cifar(16, seed=4)
    np.testing.assert_array_equal(xs, jx)
    np.testing.assert_array_equal(ys, jy)
    records = [x.tobytes() + bytes([int(y)]) for x, y in zip(xs, ys)]
    want = jax_resnet.feed(records)
    for got in (port_resnet.feed(records), port_resnet.feed_bulk(
            np.frombuffer(b"".join(records), np.uint8),
            np.full(16, port_resnet.RECORD_BYTES))):
        np.testing.assert_array_equal(got["features"], want["features"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    port_dirs = port_data.write_dataset(str(tmp_path / "p"), 20, 6, seed=1)
    jax_dirs = jax_data.write_dataset(str(tmp_path / "j"), 20, 6, seed=1)
    for pd, jd in zip(port_dirs, jax_dirs):
        for name in sorted(os.listdir(jd)):
            with open(os.path.join(pd, name), "rb") as a, \
                    open(os.path.join(jd, name), "rb") as b:
                assert a.read() == b.read()
