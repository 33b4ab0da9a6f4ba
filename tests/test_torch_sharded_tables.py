"""DeepFM with its tables row-sharded over `model`: a world of 4 gloo
ranks (data=2, model=2) trains the port's zoo model through the
Trainer's global step from the JAX init, against the JAX Trainer on a
data=2 x model=2 mesh of the 8-device CPU mesh (tests/test_deepfm.py's
layout).

Checks: each rank holds half the rows of both tables; the step losses;
the final shards against JAX's final tables sliced the same way; rows
no step touched stay at their init bit for bit (Adam moves no row while
its moments are zero); the backward's scatter-add runs once per table
and step on each rank, at the shard's row count.

Tolerance: f32, the gradient sums in another order: losses within
1e-5, parameters within 1e-4 (tests/test_torch_spmd.py's FM_LOSS_TOL
and FM_PARAM_TOL for the data axis).
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
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    params_from_jax,
    shard_tensor,
)
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (
    hash_field_rows_host,
)
from elasticdl_tpu_torch.parallel.mesh import ProcessMesh

torch.set_num_threads(2)

DEEPFM = "deepfm.deepfm_functional_api.custom_model"
VOCAB = 1024
PARAMS = f"vocab_capacity={VOCAB};embed_dim=4;bf16=False;lr=0.005"
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STEPS = 4


def _batches(n=32):
    rng = np.random.RandomState(0)
    return [{"features": {
        "dense": rng.lognormal(size=(n, 13)).astype(np.float32),
        # ids from a narrow range: many rows of the table stay untouched
        "sparse": rng.randint(0, 24, size=(n, 26)).astype(np.int32)},
        "labels": rng.randint(0, 2, size=(n,)).astype(np.int32)}
        for _ in range(STEPS)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    batches = _batches()
    js = jax_spec("model_zoo", DEEPFM, model_params=PARAMS)
    jmesh = jax_mesh.create_mesh(jax.devices()[:4], data=2, model=2)
    jt = JaxTrainer(js.model, js.optimizer, js.loss, mesh=jmesh,
                    param_sharding_fn=js.param_sharding)
    state = jt.init_state(jax.random.PRNGKey(0), batches[0]["features"])
    init = flatten_params(jax.tree.map(np.asarray, state.params["params"]))

    def jax_steps():
        nonlocal state
        losses = []
        for batch in batches:
            state, loss = jt.train_on_batch(state, batch)
            losses.append(float(loss))
        return losses, flatten_params(jax.tree.map(
            np.asarray, state.params["params"]))

    got, (losses, final) = run_world(
        4, "_torch_parallel_ranks:train_on_mesh",
        (dict(data=2, model=2), DEEPFM, PARAMS, init, None, batches),
        tmp_path_factory.mktemp("tables_world"), meanwhile=jax_steps)
    template = get_model_spec(ZOO_DIR, DEEPFM, model_params=PARAMS).model
    return (batches, params_from_jax(template, init), losses,
            params_from_jax(template, final), got)


def test_each_rank_holds_half_of_each_table(sharded):
    *_, got = sharded
    for rank, result in enumerate(got):
        assert result["shardings"] == {
            "fm_embedding.embedding": ("model", None),
            "fm_linear.embedding": ("model", None)}
        assert tuple(result["state"]["fm_embedding.embedding"].shape) == (
            VOCAB // 2, 4)
        assert tuple(result["state"]["fm_linear.embedding"].shape) == (
            VOCAB // 2, 1)


def test_losses_match_jax_and_every_rank_agrees(sharded):
    _, _, losses, _, got = sharded
    for result in got:
        np.testing.assert_allclose(result["losses"], losses, atol=LOSS_TOL,
                                   rtol=0)
        assert result["losses"] == got[0]["losses"]


def test_final_shards_match_jax(sharded):
    _, _, _, final, got = sharded
    for rank, result in enumerate(got):
        mesh = ProcessMesh(4, rank, axis_sizes=dict(data=2, model=2))
        for name, want in final.items():
            want = shard_tensor(want, result["shardings"].get(name), mesh)
            np.testing.assert_allclose(result["state"][name].numpy(),
                                       want.numpy(), atol=PARAM_TOL, rtol=0,
                                       err_msg=f"rank {rank} {name}")


def test_untouched_rows_keep_their_init(sharded):
    batches, init, _, _, got = sharded
    touched = np.zeros(VOCAB, bool)
    for batch in batches:
        touched[hash_field_rows_host(batch["features"]["sparse"],
                                     VOCAB).ravel()] = True
    assert 0 < touched.sum() < VOCAB
    for rank, result in enumerate(got):
        mesh = ProcessMesh(4, rank, axis_sizes=dict(data=2, model=2))
        mine = shard_tensor(np.arange(VOCAB), ("model",), mesh)
        for name in ("fm_embedding.embedding", "fm_linear.embedding"):
            rows = result["state"][name].numpy()
            start = shard_tensor(init[name], ("model", None), mesh).numpy()
            still = ~touched[mine]
            assert np.array_equal(rows[still], start[still])
            assert not np.array_equal(rows[~still], start[~still])


def test_the_scatter_add_runs_on_the_shard(sharded):
    *_, got = sharded
    for result in got:
        # one per table and step, each into the shard's rows
        assert result["scatters"] == [[(VOCAB // 2, 1), (VOCAB // 2, 4)]
                                      ] * STEPS or result["scatters"] == [
            [(VOCAB // 2, 4), (VOCAB // 2, 1)]] * STEPS
