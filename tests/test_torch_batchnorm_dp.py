"""A BatchNorm model on 2 data ranks: the port's BatchNorm sums its
moments over the `data` axis, so its statistics cover the global batch,
as the JAX step computes them over its global arrays.  A world of 2
gloo ranks trains the shallow ResNet (cifar10.resnet, stage_sizes (1,
1)) from the JAX init, against the JAX Trainer on a data=2 mesh.

Tolerance: tests/test_torch_resnet.py's, measured there on one device:
losses within 1e-5, running statistics and parameters within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from model_zoo.cifar10 import data as jax_data
from model_zoo.cifar10 import resnet as jax_resnet

torch.set_num_threads(2)

MODEL = "cifar10.resnet.custom_model"
SMALL = "stage_sizes=(1, 1)"
LOSS_TOL = 1e-5
AFTER_STEPS_TOL = 1e-4


def _batch(seed):
    xs, ys = jax_data.synthetic_cifar(8, seed=seed)
    return jax_resnet.feed([x.tobytes() + bytes([int(y)])
                            for x, y in zip(xs, ys)])


@pytest.fixture(scope="module")
def bn_world(tmp_path_factory):
    batches = [_batch(s) for s in range(3)]
    js = jax_spec("model_zoo", MODEL, model_params=SMALL)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    mesh=jax_mesh.create_mesh(jax.devices()[:2], data=2))
    state = jt.init_state(jax.random.PRNGKey(0), batches[0]["features"])
    flat = flatten_params(jax.tree.map(np.asarray, state.params["params"]))
    stats = flatten_params(jax.tree.map(
        np.asarray, state.model_state["batch_stats"]))

    def jax_steps():
        nonlocal state
        losses = []
        for batch in batches:
            state, loss = jt.train_on_batch(state, batch)
            losses.append(float(loss))
        template = get_model_spec(ZOO_DIR, MODEL, model_params=SMALL).model
        return losses, params_from_jax(
            template,
            flatten_params(jax.tree.map(np.asarray,
                                        state.params["params"])),
            batch_stats=flatten_params(jax.tree.map(
                np.asarray, state.model_state["batch_stats"])))

    got, (losses, final) = run_world(
        2, "_torch_parallel_ranks:train_on_mesh",
        (dict(data=2), MODEL, SMALL, flat, stats, batches),
        tmp_path_factory.mktemp("bn_world"), meanwhile=jax_steps)
    return losses, final, got


def test_two_data_ranks_match_the_jax_global_batch(bn_world):
    losses, _, got = bn_world
    for result in got:
        np.testing.assert_allclose(result["losses"], losses, atol=LOSS_TOL,
                                   rtol=0)
    assert got[0]["losses"] == got[1]["losses"]


def test_running_statistics_and_parameters_match(bn_world):
    _, final, got = bn_world
    moved = got[0]["state"]["BatchNorm_0.running_mean"].abs().max()
    assert float(moved) > 1e-3
    for name, want in final.items():
        for result in got:
            np.testing.assert_allclose(result["state"][name].numpy(),
                                       want.numpy(), atol=AFTER_STEPS_TOL,
                                       rtol=0, err_msg=name)
        # one model: the ranks agree bit for bit
        assert torch.equal(got[0]["state"][name], got[1]["state"][name])
