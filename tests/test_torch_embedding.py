"""The port's embedding layer (elasticdl_tpu_torch/layers/embedding.py)
against the JAX package's: id hashing bit for bit, the layer's gather,
pad masking, combiners and prehashed path on the same table, and the
lookup's backward (the scatter-add) against `jax.vjp`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.layers import embedding as jax_emb
from elasticdl_tpu_torch.layers import embedding as port_emb

torch.set_num_threads(2)

# negatives, ids >= vocab, the int32 extremes and a random spread
_IDS32 = np.concatenate([
    np.array([0, 1, -1, -2, 7, 8191, 8192, 8193, 65535, 65536,
              2 ** 31 - 1, -(2 ** 31), 123456789, -987654321], np.int32),
    np.random.RandomState(0).randint(-(2 ** 31), 2 ** 31 - 1, 500,
                                     dtype=np.int64).astype(np.int32),
])


@pytest.mark.parametrize("capacity", [8192, 1000, 7])
@pytest.mark.parametrize("mix", [True, False])
def test_hash_ids_bit_exact_int32(capacity, mix):
    got = port_emb.hash_ids(torch.from_numpy(_IDS32), capacity, mix=mix)
    assert got.dtype == torch.int32
    want_device = np.asarray(jax_emb.hash_ids(jnp.asarray(_IDS32), capacity,
                                              mix=mix))
    want_host = jax_emb.hash_ids_host(_IDS32, capacity, mix=mix)
    np.testing.assert_array_equal(got.numpy(), want_device)
    np.testing.assert_array_equal(got.numpy(), want_host)


@pytest.mark.parametrize("mix", [True, False])
def test_hash_ids_int64_matches_host_hash(mix):
    """int64 ids (beyond 2^32 too) reinterpret their low 32 bits, as the
    numpy host hash does."""
    ids = np.concatenate([
        _IDS32.astype(np.int64),
        np.array([2 ** 32, 2 ** 32 + 5, 2 ** 40 + 3, -(2 ** 33) - 1,
                  2 ** 63 - 1], np.int64),
    ])
    got = port_emb.hash_ids(torch.from_numpy(ids), 8192, mix=mix)
    np.testing.assert_array_equal(
        got.numpy(), jax_emb.hash_ids_host(ids, 8192, mix=mix))


def _layers(combiner, hash_input, capacity=64, dim=8):
    table = np.random.RandomState(1).randn(capacity, dim).astype(np.float32)
    jax_layer = jax_emb.DistributedEmbedding(
        capacity, dim, combiner=combiner, hash_input=hash_input)
    port_layer = port_emb.DistributedEmbedding(
        capacity, dim, combiner=combiner, hash_input=hash_input)
    with torch.no_grad():
        port_layer.embedding.copy_(torch.from_numpy(table))
    return jax_layer, {"params": {"embedding": jnp.asarray(table)}}, \
        port_layer


def _ids():
    ids = np.random.RandomState(2).randint(-5, 300, (4, 6)).astype(np.int32)
    ids[0, 3:] = -1          # padded bag
    ids[1, :] = -1           # empty bag: count clamps to 1
    ids[2, 0] = -3           # a negative id that is not the pad id
    return ids


@pytest.mark.parametrize("hash_input", [False, True])
@pytest.mark.parametrize("combiner", [None, "sum", "mean", "sqrtn"])
def test_distributed_embedding_matches_flax(combiner, hash_input):
    jax_layer, variables, port_layer = _layers(combiner, hash_input)
    ids = _ids()
    want = np.asarray(jax_layer.apply(variables, jnp.asarray(ids)))
    got = port_layer(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == want.shape
    if combiner is None:
        # a pure gather plus masking: bit for bit
        np.testing.assert_array_equal(got, want)
        assert not got[0, 3:].any()
    else:
        # sums of 6 rows in another order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unknown_combiner_raises():
    _, _, layer = _layers("max", False)
    with pytest.raises(ValueError, match="unknown combiner"):
        layer(torch.from_numpy(_ids()))


def test_init_distribution_matches_flax_stddev():
    layer = port_emb.DistributedEmbedding(4096, 16)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    std = float(layer.embedding.detach().std())
    assert abs(std - 0.05) < 0.002  # flax normal(stddev=0.05)


# ---- the lookup's backward: the scatter-add, in row order ----------------


def _lookup_inputs(rows=50, dim=8, n=400, seed=9):
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, dim).astype(np.float32)
    flat = (rng.zipf(1.5, n) % rows).astype(np.int32)   # heavy duplicates
    cot = rng.randn(n, dim).astype(np.float32)
    return table, flat, cot


@pytest.mark.parametrize("dim", [8, 1])
def test_lookup_backward_bitwise_equals_jax_vjp(dim):
    table, flat, cot = _lookup_inputs(dim=dim)
    out, vjp = jax.vjp(lambda t: jax_emb._lookup(t, jnp.asarray(flat)),
                       jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_(True)
    got_out = port_emb._lookup(t, torch.from_numpy(flat))
    np.testing.assert_array_equal(got_out.detach().numpy(), np.asarray(out))
    got_out.backward(torch.from_numpy(cot))
    # the same serial in-order sums on both sides: bit for bit
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("combiner", [None, "mean"])
def test_layer_gradient_matches_flax(combiner):
    jax_layer, variables, port_layer = _layers(combiner, True)
    ids = _ids()
    w = np.random.RandomState(3).randn(
        *(ids.shape[:1] if combiner else ids.shape), 8).astype(np.float32)

    def jax_loss(table):
        out = jax_layer.apply({"params": {"embedding": table}},
                              jnp.asarray(ids))
        return (out * w).sum()

    want = np.asarray(jax.grad(jax_loss)(variables["params"]["embedding"]))
    (port_layer(torch.from_numpy(ids)) * torch.from_numpy(w)).sum() \
        .backward()
    got = port_layer.embedding.grad.numpy()
    if combiner is None:
        np.testing.assert_array_equal(got, want)
    else:
        # the mean's division is fused differently: one rounding step
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("combiner", [None, "sum"])
def test_prehashed_path_matches_flax(combiner):
    jax_layer, variables, port_layer = _layers(combiner, True)
    rows = np.random.RandomState(4).randint(0, 64, (4, 6)).astype(np.int32)
    want = np.asarray(jax_layer.apply(variables, jnp.asarray(rows),
                                      prehashed=True))
    got = port_layer(torch.from_numpy(rows), prehashed=True).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if combiner is None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity", [8192, 1000, 7])
@pytest.mark.parametrize("mix", [True, False])
def test_port_hash_ids_host_bit_exact(capacity, mix):
    np.testing.assert_array_equal(
        port_emb.hash_ids_host(_IDS32, capacity, mix=mix),
        jax_emb.hash_ids_host(_IDS32, capacity, mix=mix))
