"""The Switch MoE layer on tokens split over `seq`: a world of 4 gloo
ranks runs `MoEMLP` on seq=2 x expert=2 and on data=2 x seq=2, each rank
holding its rows' chunk of the positions, against the JAX `MoEMLP` on
the global (B, L, H) array; then tests/test_bert.py's tiny BERT with 2
experts trained on seq=2 x expert=2 (ring attention and the MoE FFN)
against the JAX model on one device.

The layer runs with ample capacity and with a capacity factor that
drops tokens: then which tokens get zeros is decided by their place in
the global (b, l) order, which interleaves the seq chunks of every row.

Tolerance: f32 einsums in another order, 1e-5 on outputs and the aux
loss, 1e-4 on gradients (tests/test_torch_moe.py); BERT's losses within
1e-5 (tests/test_torch_bert_parallel.py).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    params_from_jax,
    shard_tensor,
)
from elasticdl_tpu_torch.layers.moe import MoEMLP, moe_param_sharding
from elasticdl_tpu_torch.parallel.mesh import ProcessMesh
from test_torch_moe import GRAD_TOL, OUT_TOL, _jax_all, _pair

torch.set_num_threads(2)

BERT = "bert.bert_finetune.custom_model"
BERT_PARAMS = ("hidden=32;num_layers=2;heads=2;mlp_dim=64;max_len=16;"
               "vocab_size=64;moe_experts=2")
LOSS_TOL = 1e-5
LAYOUTS = {"seq2_expert2": dict(seq=2, expert=2),
           "data2_seq2": dict(data=2, seq=2)}
FACTORS = {"ample": 4.0, "overflow": 0.5}


def _bert_batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return {"features": {"input_ids": rng.randint(
        0, 64, size=(n, 16)).astype(np.int32)},
        "labels": rng.randint(0, 2, n).astype(np.int32)}


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    x = np.random.RandomState(4).randn(4, 8, 16).astype(np.float32)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    cases, refs = {}, {}
    for fname, factor in FACTORS.items():
        jlayer, params, _, flat, _ = _pair(capacity_factor=factor, x=x)
        kwargs = dict(hidden=16, num_experts=4, ffn_dim=32,
                      capacity_factor=factor, aux_loss_coef=0.01)
        refs[fname] = (jlayer, params, kwargs)
        for lname, axes in LAYOUTS.items():
            cases[f"{lname}/{fname}"] = (axes, flat, x, w, kwargs)
    batches = [_bert_batch(s) for s in range(3)]
    js = jax_spec("model_zoo", BERT, model_params=BERT_PARAMS)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    mesh=jax_mesh.create_mesh(jax.devices()[:1]),
                    param_sharding_fn=js.param_sharding)
    state = jt.init_state(jax.random.PRNGKey(0), batches[0]["features"])
    init = flatten_params(jax.tree.map(np.asarray, state.params["params"]))

    def jax_side():
        nonlocal state
        layers = {f: _jax_all(jl, p, x, w) for f, (jl, p, _) in refs.items()}
        losses = []
        for batch in batches:
            state, loss = jt.train_on_batch(state, batch)
            losses.append(float(loss))
        return layers, losses

    got, (layers, losses) = run_world(
        4, "_torch_parallel_ranks:moe_seq",
        (cases, (BERT_PARAMS, init, batches)),
        tmp_path_factory.mktemp("moe_seq_world"), meanwhile=jax_side)
    return x, refs, layers, losses, got


@pytest.mark.parametrize("factor", sorted(FACTORS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_output_and_aux_match_the_global_jax_layer(seq_world, layout,
                                                   factor):
    x, _, layers, _, got = seq_world
    out, aux, _ = layers[factor]
    if factor == "overflow":
        # tokens overflow, so the global order decides the zeros
        dropped = np.abs(out).sum(-1) == 0
        assert 0 < dropped.sum() < dropped.size
    for result in got:
        mine = result[f"{layout}/{factor}"]
        mesh = ProcessMesh(4, 0, axis_sizes=LAYOUTS[layout])
        rows = x.shape[0] // mesh.shape["data"]
        cols = x.shape[1] // mesh.shape["seq"]
        d, s = mine["coords"]["data"], mine["coords"]["seq"]
        want = out[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols]
        np.testing.assert_allclose(mine["out"].numpy(), want, atol=OUT_TOL,
                                   rtol=OUT_TOL)
        assert abs(mine["aux"] - aux) < OUT_TOL


@pytest.mark.parametrize("factor", sorted(FACTORS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gradients_match_the_global_jax_layer(seq_world, layout, factor):
    _, refs, layers, _, got = seq_world
    _, _, grads = layers[factor]
    full = params_from_jax(MoEMLP(**refs[factor][2]), grads)
    for rank, result in enumerate(got):
        mine = result[f"{layout}/{factor}"]
        mesh = ProcessMesh(4, rank, axis_sizes=LAYOUTS[layout])
        assert mine["coords"] == mesh.coords
        for name, g in mine["grads"].items():
            want = shard_tensor(full[name],
                                moe_param_sharding(name, full[name]), mesh)
            np.testing.assert_allclose(g.numpy(), want.numpy(),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"rank {rank} {name}")


def test_bert_with_experts_on_seq_matches_jax(seq_world):
    *_, losses, got = seq_world
    for result in got:
        bert = result["bert"]
        assert bert["shardings"]["layer_0.moe_mlp.expert_w_in"] == (
            "expert", None, None)
        np.testing.assert_allclose(bert["losses"], losses, atol=LOSS_TOL,
                                   rtol=0)
        assert bert["losses"] == got[0]["bert"]["losses"]
