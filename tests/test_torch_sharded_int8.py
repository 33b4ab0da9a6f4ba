"""The int8 arena row-sharded over `model`: a world of 4 gloo ranks
trains the port's int8 DeepFM (`arena_dtype="int8"`) through the
Trainer's global step from the JAX init, on data=2 x model=2 and on
data=1 x model=4, against the JAX Trainer on a data=2 x model=2 mesh of
the 8-device CPU mesh and against the port's own one-rank run.

Checks: `q8`, `scale` and the carrier hold the same row block on each
rank; the losses against JAX and against one rank; every fold on the
mesh is the one-rank fold of the same gathered inputs, bit for bit (the
uniforms are drawn for the whole plane); on model=4, where no layout
splits the batch, the codes, scales and every other tensor are the
one-rank run's bit for bit; rows no step touched keep their codes; one
scatter-add per arena and step at the shard's row count; the gathered
checkpoint restores on the mesh and on one rank.

Tolerances.  Against JAX: the first step's loss within 1e-5
(tests/test_torch_quantized_arena.py: the same init, f32), later steps
within LOSS_TOL.  The two packages draw their rounding uniforms
differently (the port's counter-based draw, `arena.uniform_draw`, never
matched `jax.random`'s bits), and with different draws the losses part
by 1.5e-4 to 2.7e-4 after three folds (eight draws measured), so the
JAX run here folds with the port's uniforms (`_fold_with_port_draw`: the
JAX package's fold, its `jax.random.uniform` returning the port's draw):
the codes then differ only where an f32 sum lands on the other side of a
rounding boundary.  Against one
rank on data=2 x model=2: each gradient is summed over `data` in another
order, f32: losses within 1e-5 (tests/test_torch_sharded_tables.py's
LOSS_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.layers import arena as jax_arena
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.worker import trainer as jax_trainer
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.common.weights import flatten_params
from elasticdl_tpu_torch.layers import arena
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (
    hash_field_rows_host,
)
from elasticdl_tpu_torch.worker.trainer import Trainer

torch.set_num_threads(2)

DEEPFM = "deepfm.deepfm_functional_api.custom_model"
VOCAB = 1024
PARAMS = (f"vocab_capacity={VOCAB};embed_dim=4;bf16=False;lr=0.005;"
          "arena_dtype='int8'")
FIRST_LOSS_TOL = 1e-5
LOSS_TOL = 1e-4
ONE_RANK_LOSS_TOL = 1e-5
STEPS = 4
ARENAS = ("fm_embedding", "fm_linear")


def _batches(n=32):
    rng = np.random.RandomState(1)
    return [{"features": {
        "dense": rng.lognormal(size=(n, 13)).astype(np.float32),
        # ids from a narrow range: many rows of the tables stay untouched
        "sparse": rng.randint(0, 24, size=(n, 26)).astype(np.int32)},
        "labels": rng.randint(0, 2, size=(n,)).astype(np.int32)}
        for _ in range(STEPS)]


def _mix32_u32(x):
    """`arena._mix32` in wrapping uint32 arithmetic."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def _port_uniforms(step, path, rows, cols):
    """The port's `uniform_draw(fold_key(step, path), rows, cols)` in
    jnp (a step below 2**32)."""
    key = _mix32_u32(jnp.asarray(step, jnp.uint32)
                     ^ jnp.uint32(arena._SEED_MIX))
    key = _mix32_u32(key)
    key = _mix32_u32(key ^ jnp.uint32(arena._path_seed(path)))
    row_hash = _mix32_u32(jnp.arange(rows, dtype=jnp.uint32) ^ key)
    weyl = jnp.arange(cols, dtype=jnp.uint32) * jnp.uint32(arena._GOLDEN32)
    bits = _mix32_u32(row_hash[:, None] + weyl[None, :])
    return (bits >> 8).astype(jnp.float32) * (2.0 ** -24)


def _fold_with_port_draw(params, model_state, step):
    """The JAX package's `fold_quantized_updates`, whole, with only its
    uniforms replaced by the port's: while it runs, `jax.random.uniform`
    (which its `stochastic_round` calls) returns the port's draw for the
    step and the plane path the fold last keyed (`_path_seed`)."""
    paths = []
    path_seed, uniform = jax_arena._path_seed, jax.random.uniform

    def keyed(path):
        paths.append(path)
        return path_seed(path)

    def port_uniform(key, shape, dtype):
        return _port_uniforms(step, paths[-1], *shape).astype(dtype)

    jax_arena._path_seed, jax.random.uniform = keyed, port_uniform
    try:
        return jax_arena.fold_quantized_updates(params, model_state, step)
    finally:
        jax_arena._path_seed, jax.random.uniform = path_seed, uniform


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    batches = _batches()
    js = jax_spec("model_zoo", DEEPFM, model_params=PARAMS)
    jmesh = jax_mesh.create_mesh(jax.devices()[:4], data=2, model=2)
    jt = JaxTrainer(js.model, js.optimizer, js.loss, mesh=jmesh,
                    param_sharding_fn=js.param_sharding)
    state = jt.init_state(jax.random.PRNGKey(0), batches[0]["features"])
    flat = flatten_params(jax.tree.map(np.asarray, state.params["params"]))
    quantized = flatten_params(jax.tree.map(
        np.asarray, state.model_state["quantized"]))

    def jax_steps():
        nonlocal state
        losses = []
        fold = jax_trainer.fold_quantized_updates
        jax_trainer.fold_quantized_updates = _fold_with_port_draw
        try:
            for batch in batches:
                state, loss = jt.train_on_batch(state, batch)
                losses.append(float(loss))
        finally:
            jax_trainer.fold_quantized_updates = fold
        return losses

    tmp = tmp_path_factory.mktemp("int8_world")
    ckpt = str(tmp / "ckpt")
    got, losses = run_world(
        4, "_torch_parallel_ranks:int8_on_meshes",
        (DEEPFM, PARAMS, flat, quantized, batches, ckpt), tmp,
        meanwhile=jax_steps)
    return batches, losses, got, ckpt


def test_the_planes_shard_with_their_carrier(sharded):
    _, _, got, _ = sharded
    for layout, rows in (("dm", VOCAB // 2), ("m4", VOCAB // 4)):
        for result in (r[layout] for r in got):
            for name in ARENAS:
                for leaf in ("embedding", "q8", "scale"):
                    assert result["shardings"][f"{name}.{leaf}"] == (
                        "model", None)
                    assert result["shapes"][f"{name}.{leaf}"][0] == rows
            assert result["shapes"]["fm_embedding.q8"] == (rows, 4)
            assert result["shapes"]["fm_linear.scale"] == (rows, 1)


def test_losses_match_jax_and_one_rank(sharded):
    _, jax_losses, got, _ = sharded
    one = got[0]["one"]["losses"]
    for result in got:
        for layout in ("dm", "m4"):
            losses = result[layout]["losses"]
            assert abs(losses[0] - jax_losses[0]) <= FIRST_LOSS_TOL
            np.testing.assert_allclose(losses, jax_losses, atol=LOSS_TOL,
                                       rtol=0)
            assert losses == got[0][layout]["losses"]
        np.testing.assert_allclose(result["dm"]["losses"], one,
                                   atol=ONE_RANK_LOSS_TOL, rtol=0)


def test_every_fold_on_the_mesh_is_the_one_rank_fold(sharded):
    """data=2 x model=2: each step's gathered codes and scales are the
    unsharded fold of the gathered codes, scales and carrier delta
    before it, bit for bit, and the carrier ends zero."""
    _, _, got, _ = sharded
    folds = got[0]["dm"]["folds"]
    assert [f["step"] for f in folds] == list(range(STEPS))
    for result in got:
        assert [f["step"] for f in result["dm"]["folds"]] == list(
            range(STEPS))
    afters = [f["before"] for f in folds[1:]] + [got[0]["dm"]["state"]]
    for fold, after in zip(folds, afters):
        for name in ARENAS:
            before = fold["before"]
            key = arena.fold_key(fold["step"], (name, "embedding"))
            q8, scale = arena._requantize_plane(
                before[f"{name}.q8"], before[f"{name}.scale"],
                before[f"{name}.embedding"], key)
            assert torch.equal(q8, after[f"{name}.q8"])
            assert torch.equal(scale, after[f"{name}.scale"])
            assert before[f"{name}.embedding"].any()
    for result in got:
        for name in ARENAS:
            assert not result["dm"]["state"][f"{name}.embedding"].any()


def test_model4_is_the_one_rank_run_bit_for_bit(sharded):
    _, _, got, _ = sharded
    one = got[0]["one"]
    for result in got:
        assert result["m4"]["losses"] == one["losses"]
        for name, want in one["state"].items():
            assert torch.equal(result["m4"]["state"][name], want), name


def test_untouched_rows_keep_their_codes(sharded):
    batches, _, got, _ = sharded
    touched = np.zeros(VOCAB, bool)
    for batch in batches:
        touched[hash_field_rows_host(batch["features"]["sparse"],
                                     VOCAB).ravel()] = True
    assert 0 < touched.sum() < VOCAB
    first = got[0]["dm"]["folds"][0]["before"]
    for result in got:
        final = result["dm"]["state"]
        for name in ARENAS:
            for leaf in ("q8", "scale"):
                key = f"{name}.{leaf}"
                assert torch.equal(final[key][~touched],
                                   first[key][~touched])
            moved = (final[f"{name}.scale"] != first[f"{name}.scale"])[:, 0]
            assert moved[touched].all() and not moved[~touched].any()


def test_one_scatter_add_per_arena_and_step_at_the_shard(sharded):
    _, _, got, _ = sharded
    for layout, rows in (("dm", VOCAB // 2), ("m4", VOCAB // 4)):
        for result in got:
            for step in result[layout]["scatters"]:
                assert sorted(step) == [(rows, 1), (rows, 4)]


def test_the_gathered_checkpoint_restores_on_the_mesh_and_one_rank(
        sharded):
    batches, _, got, ckpt = sharded
    for result in got:
        assert result["dm"]["restored_step"] == STEPS
        mine = result["dm"]
        for name, shape in mine["shapes"].items():
            assert tuple(mine["restored"][name].shape) == shape
    # the whole tree, restored on one rank
    spec = get_model_spec(ZOO_DIR, DEEPFM, model_params=PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    state = trainer.init_state(5, batches[0]["features"])
    assert CheckpointSaver(ckpt).maybe_restore(state) is state
    assert state.step == STEPS
    for name, want in got[0]["dm"]["state"].items():
        assert torch.equal(state.model.state_dict()[name], want), name
    # and each rank's restored shard is its block of it
    for result in got:
        model = result["dm"]["coords"]["model"]
        for name, value in result["dm"]["restored"].items():
            spec_ = result["dm"]["shardings"].get(name)
            want = state.model.state_dict()[name]
            if spec_ is not None:
                rows = value.shape[0]
                want = want[model * rows:(model + 1) * rows]
            assert torch.equal(value, want), name
