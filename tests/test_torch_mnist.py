"""The port's MNIST models (elasticdl_tpu_torch/model_zoo/mnist/, both
styles) against the flax zoo's on the CPU: the feeds and data bit for
bit, the carried init, the forward, the NHWC flatten order, and a few
Adam steps of the JAX Trainer.

Tolerances: XLA and oneDNN order the convolution sums differently, so
f32 results differ by rounding; each bound states what was measured."""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_parity import carried_states, carry, step_gaps, trainers
from elasticdl_tpu_torch.model_zoo.mnist import data as port_data
from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional_api as port
from elasticdl_tpu_torch.model_zoo.mnist import mnist_subclass
from model_zoo.mnist import data as jax_data
from model_zoo.mnist import mnist_functional_api as jax_mnist
from model_zoo.mnist import mnist_subclass as jax_subclass

torch.set_num_threads(2)

FUNCTIONAL = "mnist.mnist_functional_api.custom_model"
SUBCLASS = "mnist.mnist_subclass.custom_model"
# logits from the same weights: measured 5.1e-7 (functional) and 3.6e-7
# (subclass) at logits up to ~1
FWD_TOL = 1e-5
# per-step losses over 4 Adam steps (lr 1e-3, batch 32): measured 1.7e-5
# at losses of 2.0-4.0 (the first Adam steps move every weight by ~lr,
# and the loss jumps); the logits after them 3.1e-5 at up to 4.3
LOSS_TOL = 1e-4
PRED_TOL = 3e-4


def _records(n, seed=0):
    xs, ys = jax_data.synthetic_mnist(n, seed=seed)
    return [x.tobytes() + bytes([int(y)]) for x, y in zip(xs, ys)]


def test_feeds_and_data_match_the_jax_zoo(tmp_path):
    xs, ys = port_data.synthetic_mnist(20, seed=3)
    jx, jy = jax_data.synthetic_mnist(20, seed=3)
    np.testing.assert_array_equal(xs, jx)
    np.testing.assert_array_equal(ys, jy)
    records = _records(20, seed=3)
    want = jax_mnist.feed(records)
    buffer = np.frombuffer(b"".join(records), np.uint8)
    dicts = [{"image": x, "label": int(y)} for x, y in zip(xs, ys)]
    for got in (port.feed(records), port.feed(dicts),
                port.feed_bulk(buffer, np.full(20, port.RECORD_BYTES))):
        np.testing.assert_array_equal(got["features"], want["features"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    with pytest.raises(ValueError, match="785-byte"):
        port.feed_bulk(buffer[:-1], np.full(1, 784))
    # the grain:// factory serves the TFRecord files' 785-byte records
    # (tests/test_torch_grain_reader.py holds it against the JAX one)
    assert port_data.grain_dataset(n=20, seed=3) == records
    port_dirs = port_data.write_dataset(str(tmp_path / "p"), 30, 10, seed=2)
    jax_dirs = jax_data.write_dataset(str(tmp_path / "j"), 30, 10, seed=2)
    for pd, jd in zip(port_dirs, jax_dirs):
        for name in sorted(os.listdir(jd)):
            with open(os.path.join(pd, name), "rb") as a, \
                    open(os.path.join(jd, name), "rb") as b:
                assert a.read() == b.read()


@pytest.mark.parametrize("flax_model,port_model", [
    (jax_mnist.custom_model, port.custom_model),
    (jax_subclass.custom_model, mnist_subclass.custom_model),
])
def test_forward_matches_flax(flax_model, port_model):
    x = jax_mnist.feed(_records(16, seed=1))["features"]
    model = flax_model()
    variables = model.init(jax.random.PRNGKey(0), x)
    ported = carry(port_model(), variables["params"])
    want = np.asarray(model.apply(variables, x))
    got = ported(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_flatten_runs_in_flax_nhwc_order():
    """The carried `Dense_0` kernel reads its 12,544 inputs in H, W, C
    order: flattening the NCHW maps directly keeps the shape and breaks
    the numbers."""
    x = jax_mnist.feed(_records(4, seed=2))["features"]
    model = jax_mnist.custom_model()
    variables = model.init(jax.random.PRNGKey(1), x)
    ported = carry(port.custom_model(), variables["params"])
    want = np.asarray(model.apply(variables, x))
    maps = torch.rand(2, 64, 14, 14)
    flat = port.flatten_nhwc(maps)
    np.testing.assert_array_equal(
        flat.numpy(), maps.permute(0, 2, 3, 1).numpy().reshape(2, -1))
    with torch.no_grad():
        xt = torch.from_numpy(x).reshape(-1, 1, 28, 28)
        pooled = port.max_pool(torch.relu(ported.Conv_1(torch.relu(
            ported.Conv_0(xt)))), (2, 2), (2, 2))
        nchw = ported.Dense_1(torch.relu(ported.Dense_0(
            pooled.reshape(4, -1))))
        nhwc = ported.Dense_1(torch.relu(ported.Dense_0(
            port.flatten_nhwc(pooled))))
    np.testing.assert_allclose(nhwc.numpy(), want, atol=FWD_TOL)
    assert np.abs(nchw.numpy() - want).max() > 10 * FWD_TOL


@pytest.mark.parametrize("model_def", [FUNCTIONAL, SUBCLASS])
def test_training_steps_match_the_jax_trainer(model_def):
    _, jt, _, pt = trainers(model_def)
    batches = [jax_mnist.feed(_records(32, seed=s)) for s in range(4)]
    jstate, pstate = carried_states(jt, pt, batches[0]["features"])
    gaps, losses, jstate, pstate = step_gaps(jt, pt, jstate, pstate,
                                             batches)
    assert max(gaps) < LOSS_TOL, (gaps, losses)
    assert losses[-1] < losses[0]
    x = jax_mnist.feed(_records(16, seed=9))["features"]
    np.testing.assert_allclose(pt.predict_on_batch(pstate, x),
                               np.asarray(jt.predict_on_batch(jstate, x)),
                               atol=PRED_TOL, rtol=0)


def test_prediction_outputs_processor_collects_batches():
    proc = port.PredictionOutputsProcessor()
    proc.process(np.zeros((3, 10)), 0)
    proc.process(np.ones((2, 10)), 1)
    assert [(w, p.shape) for w, p in proc.batches] == [(0, (3, 10)),
                                                       (1, (2, 10))]
