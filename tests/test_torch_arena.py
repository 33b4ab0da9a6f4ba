"""The port's fused embedding arena (elasticdl_tpu_torch/layers/arena.py)
against the JAX package's, from the same carried table: row layout and
host hashing bit for bit, the forward and the table gradient on the dict
and prehashed paths.  The gradient is the scatter-add in row order on
both sides, so it too matches bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.layers import arena as jax_arena
from elasticdl_tpu_torch.layers import arena as port_arena

torch.set_num_threads(2)

FEATURES = (("user", 97), ("item", 256), ("tags", 31))
DIM = 8
BATCH = 6


def _ids(seed=0, pads=True):
    rng = np.random.RandomState(seed)
    ids = {
        "user": rng.randint(-2 ** 31, 2 ** 31 - 1, (BATCH,),
                            dtype=np.int64).astype(np.int32),
        "item": (rng.zipf(1.5, (BATCH, 3)) % 50).astype(np.int32),
        "tags": rng.randint(0, 10 ** 6, (BATCH, 2, 2)).astype(np.int32),
    }
    if pads:
        ids["item"][0, 1] = -1
        ids["tags"][2] = -1
    return ids


def _pair(hash_input=True):
    table = np.random.RandomState(1).randn(
        port_arena.arena_rows(FEATURES), DIM).astype(np.float32)
    jax_layer = jax_arena.EmbeddingArena(FEATURES, DIM,
                                         hash_input=hash_input)
    port_layer = port_arena.EmbeddingArena(FEATURES, DIM,
                                           hash_input=hash_input)
    with torch.no_grad():
        port_layer.embedding.copy_(torch.from_numpy(table))
    return jax_layer, jnp.asarray(table), port_layer


def test_offsets_and_rows_match():
    assert port_arena.arena_offsets(FEATURES) == \
        jax_arena.arena_offsets(FEATURES)
    assert port_arena.arena_rows(FEATURES) == jax_arena.arena_rows(FEATURES)
    layer = port_arena.EmbeddingArena(FEATURES, DIM)
    assert dict(layer.named_parameters()).keys() == {"embedding"}
    assert tuple(layer.embedding.shape) == (384, DIM)


@pytest.mark.parametrize("hash_input", [True, False])
def test_dict_path_forward_and_gradient_match_jax(hash_input):
    jax_layer, table, port_layer = _pair(hash_input)
    ids = _ids()
    rng = np.random.RandomState(2)
    weights = {name: rng.randn(*ids[name].shape, DIM).astype(np.float32)
               for name, _ in FEATURES}

    def jax_loss(t):
        out = jax_layer.apply({"params": {"embedding": t}},
                              {k: jnp.asarray(v) for k, v in ids.items()})
        return sum((out[k] * weights[k]).sum() for k in out), out

    (_, want_out), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        table)
    got_out = port_layer({k: torch.from_numpy(v) for k, v in ids.items()})
    for name, _ in FEATURES:
        assert tuple(got_out[name].shape) == ids[name].shape + (DIM,)
        np.testing.assert_array_equal(got_out[name].detach().numpy(),
                                      np.asarray(want_out[name]))
    assert not got_out["tags"][2].detach().any()   # pad ids are zeroed
    sum((got_out[k] * torch.from_numpy(weights[k])).sum()
        for k in got_out).backward()
    np.testing.assert_array_equal(port_layer.embedding.grad.numpy(),
                                  np.asarray(want_grad))


def test_prehashed_path_matches_the_dict_path_and_jax():
    jax_layer, table, port_layer = _pair()
    ids = _ids(seed=3, pads=False)
    flat_ids = {k: v.reshape(BATCH, -1) for k, v in ids.items()}
    rows = port_layer.arena_rows_host(flat_ids)
    np.testing.assert_array_equal(rows, jax_layer.arena_rows_host(flat_ids))
    assert rows.dtype == np.int32 and rows.shape == (BATCH, 1 + 3 + 4)
    cot = np.random.RandomState(4).randn(*rows.shape, DIM).astype(np.float32)
    out, vjp = jax.vjp(
        lambda t: jax_layer.apply({"params": {"embedding": t}},
                                  jnp.asarray(rows), prehashed=True), table)
    (want_grad,) = vjp(jnp.asarray(cot))
    got = port_layer(torch.from_numpy(rows), prehashed=True)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(port_layer.embedding.grad.numpy(),
                                  np.asarray(want_grad))
    # the same vectors as the dict path, column block by column block
    by_dict = port_layer({k: torch.from_numpy(v) for k, v in
                          flat_ids.items()})
    np.testing.assert_array_equal(
        got.detach().numpy(),
        torch.cat([by_dict[k] for k, _ in FEATURES], dim=1).detach().numpy())


def test_arena_rows_host_rejects_pad_ids():
    layer = port_arena.EmbeddingArena(FEATURES, DIM)
    with pytest.raises(ValueError, match="pad ids"):
        layer.arena_rows_host({k: v.reshape(BATCH, -1)
                               for k, v in _ids().items()})


def test_wrong_feature_names_raise():
    layer = port_arena.EmbeddingArena(FEATURES, DIM)
    ids = {k: torch.from_numpy(v) for k, v in _ids().items()}
    del ids["tags"]
    with pytest.raises(ValueError, match="arena expects ids"):
        layer(ids)


def test_int8_arena_is_queued_and_bad_dtypes_raise():
    with pytest.raises(NotImplementedError, match="int8 arena slice"):
        port_arena.EmbeddingArena(FEATURES, DIM, arena_dtype="int8")
    with pytest.raises(ValueError, match="arena_dtype must be one of"):
        port_arena.EmbeddingArena(FEATURES, DIM, arena_dtype="fp16")


def test_init_distribution_matches_flax_stddev():
    layer = port_arena.EmbeddingArena((("a", 4096),), 16)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(layer.embedding.detach().std()) - 0.05) < 0.002
