"""GPipe (elasticdl_tpu_torch/ops/pipeline.py, layers/pipeline.py)
against the JAX package's `_sequential` on the same stacked weights: at
pipe = 1 in one process, and on a world of 4 gloo ranks (data=2,
pipe=2), where each stage holds half of the 4-layer stack and the
explicit backward schedule runs over send/recv: outputs, each stage's
stack gradients and the input's gradient, plain and with remat.

Tolerance: f32 tanh layers in the same order, 1e-5 on outputs and
1e-4 on gradients (measured about 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.ops.pipeline import _sequential as jax_sequential
from elasticdl_tpu_torch.common.weights import shard_tensor
from elasticdl_tpu_torch.layers.linen import Dense
from elasticdl_tpu_torch.layers.pipeline import (
    GPipeBlocks,
    pipeline_param_sharding,
)
from elasticdl_tpu_torch.ops.pipeline import _sequential, gpipe_spmd
from elasticdl_tpu_torch.parallel.mesh import ProcessMesh

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _stack(num_layers=4, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(num_layers, dim, dim) * 0.3).astype(np.float32),
            "b": (rng.randn(num_layers, dim) * 0.1).astype(np.float32)}


def _jax_apply(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _torch_apply(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _jax_reference(stack, x, w):
    def loss(s, xx):
        out = jax_sequential(_jax_apply, s, xx)
        return (out * w).sum(), out

    (gs, gx), out = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in stack.items()}, jnp.asarray(x))
    return (np.asarray(out), {k: np.asarray(v) for k, v in gs.items()},
            np.asarray(gx))


def test_pipe_one_is_the_sequential_stack():
    stack, x = _stack(3), np.random.RandomState(3).randn(8, 8).astype(
        np.float32)
    w = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    out, grads, dx = _jax_reference(stack, x, w)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in stack.items()}
    xs = torch.tensor(x, requires_grad=True)
    for mesh in (None, ProcessMesh(2, 0, axis_sizes=dict(data=2))):
        y = gpipe_spmd(_torch_apply, leaves, xs, mesh, num_microbatches=4)
        assert torch.equal(y, _sequential(_torch_apply, leaves, xs))
    np.testing.assert_allclose(y.detach().numpy(), out, atol=OUT_TOL)
    (y * torch.tensor(w)).sum().backward()
    for k, g in grads.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, atol=GRAD_TOL)
    np.testing.assert_allclose(xs.grad.numpy(), dx, atol=GRAD_TOL)


def test_the_stack_is_one_subtree_sharded_over_pipe():
    blocks = GPipeBlocks(lambda: Dense(4, 4), num_layers=6,
                         num_microbatches=2)
    shapes = {n: tuple(p.shape) for n, p in blocks.named_parameters()}
    assert shapes == {"gpipe_stack.weight": (6, 4, 4),
                      "gpipe_stack.bias": (6, 4)}
    assert pipeline_param_sharding("gpipe_stack.weight",
                                   blocks.gpipe_stack.weight) == (
        "pipe", None, None)
    assert pipeline_param_sharding("encoder.stack.weight",
                                   blocks.gpipe_stack.weight) is None
    # each layer drawn separately; the template is not a parameter
    weight = blocks.gpipe_stack.weight
    assert not torch.equal(weight[0], weight[1])
    assert len(list(blocks.parameters())) == 2
    mesh = ProcessMesh(4, 3, axis_sizes=dict(data=2, pipe=2))
    assert torch.equal(shard_tensor(weight, ("pipe", None, None), mesh),
                       weight[3:])


@pytest.fixture(scope="module")
def pipe_world(tmp_path_factory):
    stack = _stack()
    x = np.random.RandomState(1).randn(16, 3, 8).astype(np.float32)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    got = run_world(4, "_torch_parallel_ranks:gpipe", (stack, x, w, 4),
                    tmp_path_factory.mktemp("pipe_world"))
    return _jax_reference(stack, x, w), got


@pytest.mark.parametrize("mode", ["plain", "remat"])
def test_two_stages_match_the_sequential_stack(pipe_world, mode):
    (out, grads, dx), got = pipe_world
    for rank, result in enumerate(got):
        mesh = ProcessMesh(4, rank, axis_sizes=dict(data=2, pipe=2))
        assert result["coords"] == mesh.coords
        d, stage = mesh.coords["data"], mesh.coords["pipe"]
        rows = slice(8 * d, 8 * d + 8)
        mine = result[mode]
        # the last stage's output on every pipe rank
        np.testing.assert_allclose(mine["out"].numpy(), out[rows],
                                   atol=OUT_TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(mine["grads"][k].numpy(),
                                       g[2 * stage:2 * stage + 2],
                                       atol=GRAD_TOL, err_msg=k)
        np.testing.assert_allclose(mine["dx"].numpy(), dx[rows],
                                   atol=GRAD_TOL)


def test_layers_that_do_not_divide_raise(pipe_world):
    _, got = pipe_world
    for result in got:
        assert result["indivisible"] == "num_layers=3 not divisible by pipe=2"
    mesh = ProcessMesh(4, 0, axis_sizes=dict(data=2, pipe=2))
    leaves = {k: torch.tensor(v[:2]) for k, v in _stack().items()}
    with pytest.raises(ValueError, match="not divisible by "
                                         "num_microbatches=4"):
        gpipe_spmd(_torch_apply, leaves, torch.zeros(6, 8), mesh,
                   num_microbatches=4, num_layers=4)
