"""The Switch MoE layer (elasticdl_tpu_torch/layers/moe.py) against the
JAX package's `MoEMLP` on the same weights: in one process (ample
capacity, overflow, the aux loss, gradients, the Trainer adding the aux
loss), then expert-parallel on a world of 4 gloo ranks (data=2,
expert=2), whose output, aux loss and per-parameter gradients must be
the unsharded JAX layer's.  The world runs at capacity factor 1.0, so
tokens overflow and a token's slot depends on the data shards before it
(the global cumsum).

Tolerance: f32 einsums in another order, 1e-5 on outputs and the aux
loss, 1e-4 on gradients (measured about 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.layers.moe import MoEMLP as JaxMoE
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    params_from_jax,
    shard_tensor,
)
from elasticdl_tpu_torch.layers.moe import (
    MoEMLP,
    collect_aux_loss,
    expert_capacity,
    moe_param_sharding,
)
from elasticdl_tpu_torch.parallel.mesh import ProcessMesh

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _pair(num_experts=4, hidden=16, ffn=32, capacity_factor=4.0,
          aux_loss_coef=0.01, x=None, seed=0):
    jlayer = JaxMoE(num_experts=num_experts, ffn_dim=ffn,
                    capacity_factor=capacity_factor,
                    aux_loss_coef=aux_loss_coef)
    if x is None:
        x = np.random.RandomState(seed).randn(2, 8, hidden).astype(
            np.float32)
    params = jlayer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    flat = flatten_params(jax.tree.map(np.asarray, params["params"]))
    layer = MoEMLP(hidden, num_experts=num_experts, ffn_dim=ffn,
                   capacity_factor=capacity_factor,
                   aux_loss_coef=aux_loss_coef)
    layer.load_state_dict(params_from_jax(layer, flat), strict=True)
    return jlayer, params, layer, flat, x


def _jax_all(jlayer, params, x, w):
    """JAX output, aux loss and the gradients of sum(out * w) + aux."""
    def objective(p):
        out, state = jlayer.apply(p, jnp.asarray(x),
                                  mutable=["intermediates"])
        (aux,) = state["intermediates"]["moe_aux_loss"]
        return (out * w).sum() + aux, (out, aux)

    grads, (out, aux) = jax.jit(jax.grad(objective, has_aux=True))(params)
    return (np.asarray(out), float(aux),
            flatten_params(jax.tree.map(np.asarray, grads["params"])))


def _port_all(layer, x, w):
    for p in layer.parameters():
        p.grad = None
    out = layer(torch.tensor(x))
    aux = layer.aux_loss
    ((out * torch.tensor(w)).sum() + aux).backward()
    return out.detach().numpy(), float(aux.detach()), {
        n: p.grad for n, p in layer.named_parameters()}


def test_capacity_is_the_jax_formula():
    for n, experts, factor in ((16, 4, 4.0), (16, 2, 0.125), (64, 4, 1.25),
                               (7, 3, 1.25), (1, 8, 0.5)):
        assert expert_capacity(n, experts, factor) == max(
            1, int(-(-n * factor // experts)))


@pytest.mark.parametrize("factor", [4.0, 1.0, 0.5])
def test_output_aux_and_gradients_match_jax(factor):
    jlayer, params, layer, _, x = _pair(capacity_factor=factor)
    w = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    out, aux, grads = _jax_all(jlayer, params, x, w)
    pout, paux, pgrads = _port_all(layer, x, w)
    np.testing.assert_allclose(pout, out, atol=OUT_TOL, rtol=OUT_TOL)
    assert abs(paux - aux) < OUT_TOL
    want = params_from_jax(layer, grads)
    for name, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_ample_capacity_is_each_tokens_expert():
    """The dense reference of the JAX test: each token through its top-1
    expert, scaled by its gate."""
    _, _, layer, flat, x = _pair()
    tokens = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(torch.tensor(
        tokens @ flat["router/kernel"] + flat["router/bias"]), -1).numpy()
    ref = np.zeros_like(tokens)
    for i, e in enumerate(probs.argmax(-1)):
        h = np.maximum(tokens[i] @ flat["expert_w_in"][e]
                       + flat["expert_b_in"][e], 0.0)
        ref[i] = (h @ flat["expert_w_out"][e] + flat["expert_b_out"][e]) \
            * probs[i, e]
    with torch.no_grad():
        out = layer(torch.tensor(x)).numpy().reshape(tokens.shape)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_overflow_drops_tokens_to_zero():
    x = np.ones((1, 16, 4), np.float32)  # identical tokens, one expert
    jlayer, params, layer, _, _ = _pair(num_experts=2, hidden=4, ffn=8,
                                        capacity_factor=0.125, x=x)
    with torch.no_grad():
        out = layer(torch.tensor(x)).numpy().reshape(16, 4)
    assert (np.abs(out).sum(-1) > 0).sum() <= 2
    np.testing.assert_allclose(
        out, np.asarray(jlayer.apply(params, jnp.asarray(x))).reshape(16, 4),
        atol=OUT_TOL)


def test_the_trainer_adds_the_aux_loss():
    from elasticdl_tpu_torch.worker.trainer import Trainer

    x = np.random.RandomState(2).randn(8, 8, 16).astype(np.float32)
    batch = {"features": x, "labels": np.zeros((8,), np.float32)}
    losses, auxes = {}, {}
    for coef in (0.0, 0.5):
        _, _, layer, _, _ = _pair(aux_loss_coef=coef)
        trainer = Trainer(layer, lambda ps: torch.optim.SGD(ps, lr=0.0),
                          lambda labels, preds: (preds ** 2).mean(),
                          device="cpu")
        state = trainer.init_state(0, x)
        state.model.load_state_dict(layer.state_dict())
        with torch.no_grad():
            state.model(torch.tensor(x))
        auxes[coef] = float(collect_aux_loss(state.model))
        assert collect_aux_loss(state.model) is None   # read once
        losses[coef] = float(trainer.train_on_batch(state, batch)[1])
    assert auxes[0.5] >= 0.5 * 0.99       # coef * E * sum(d * p) >= coef
    assert losses[0.5] == pytest.approx(losses[0.0] + auxes[0.5],
                                        rel=1e-6)


def test_expert_stacks_shard_over_expert():
    _, _, layer, _, _ = _pair()
    specs = {n: moe_param_sharding(n, p) for n, p in
             layer.named_parameters()}
    assert specs["expert_w_in"] == ("expert", None, None)
    assert specs["expert_b_out"] == ("expert", None)
    assert specs["router.weight"] is None


@pytest.fixture(scope="module")
def expert_world(tmp_path_factory):
    x = np.random.RandomState(1).randn(8, 8, 16).astype(np.float32)
    w = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    jlayer, params, _, flat, _ = _pair(capacity_factor=1.0, x=x)
    kwargs = dict(hidden=16, num_experts=4, ffn_dim=32, capacity_factor=1.0,
                  aux_loss_coef=0.01)
    got, want = run_world(4, "_torch_parallel_ranks:moe_expert_parallel",
                          (flat, x, w, kwargs),
                          tmp_path_factory.mktemp("moe_world"),
                          meanwhile=lambda: _jax_all(jlayer, params, x, w))
    return want, got, kwargs


def test_expert_parallel_output_matches_the_unsharded_layer(expert_world):
    (out, aux, _), got, _ = expert_world
    for result in got:
        d = result["coords"]["data"]
        np.testing.assert_allclose(result["out"].numpy(), out[4 * d:4 * d + 4],
                                   atol=OUT_TOL, rtol=OUT_TOL)
        assert abs(result["aux"] - aux) < OUT_TOL
    # some tokens overflowed: the global slots matter
    assert (np.abs(out).sum(-1) == 0).any()


def test_expert_parallel_gradients_match_jax(expert_world):
    (_, _, grads), got, kwargs = expert_world
    full = params_from_jax(MoEMLP(**kwargs), grads)
    for rank, result in enumerate(got):
        mesh = ProcessMesh(4, rank, axis_sizes=dict(data=2, expert=2))
        assert result["coords"] == mesh.coords
        # each rank holds 2 of the 4 experts
        assert result["shapes"]["expert_w_in"] == (2, 16, 32)
        for name, g in result["grads"].items():
            want = shard_tensor(full[name],
                                moe_param_sharding(name, full[name]), mesh)
            np.testing.assert_allclose(g.numpy(), want.numpy(),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"rank {rank} {name}")
