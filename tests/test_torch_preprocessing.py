"""The port's preprocessing layers (elasticdl_tpu_torch/preprocessing/)
against the JAX package's on the same seeded numpy inputs, on numpy and
on torch tensors.  Every output of these layers is an integer id or a
cast, so each one must equal the JAX layer's bit for bit."""

import numpy as np
import pytest
import torch

from elasticdl_tpu.preprocessing import layers as jax_layers
from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding
from elasticdl_tpu_torch.preprocessing import layers as port_layers

torch.set_num_threads(2)


def _words(rng, n):
    return np.array([f"w{v}" for v in rng.randint(0, 500, n)] + ["", "é"])


def _floats(rng, n):
    # a spread over orders of magnitude, both signs, exact halves and
    # exact boundaries, so round-half-even and side="right" are hit
    values = np.concatenate([
        rng.lognormal(0.0, 3.0, n) * rng.choice([-1, 1], n),
        np.arange(-3.0, 8.0, 0.5),
        np.array([0.0, 1.0, np.e, np.e ** 2, 10.0, 100.0, 1e6]),
    ])
    return values.astype(np.float32)


def _same(port_out, jax_out):
    port_np = (port_out.numpy() if isinstance(port_out, torch.Tensor)
               else port_out)
    jax_np = np.asarray(jax_out)
    assert port_np.dtype == jax_np.dtype, (port_np.dtype, jax_np.dtype)
    assert port_np.shape == jax_np.shape
    np.testing.assert_array_equal(port_np, jax_np)


def test_fnv1a_hash_matches_bit_for_bit():
    rng = np.random.RandomState(0)
    for word in list(_words(rng, 200)) + ["education=edu_3", "a" * 300]:
        assert port_layers.fnv1a_hash(word) == jax_layers.fnv1a_hash(word)


@pytest.mark.parametrize("bins", [1, 7, 1 << 20])
def test_hashing_strings_and_ints(bins):
    rng = np.random.RandomState(1)
    words = _words(rng, 300).reshape(-1, 2)
    ints = rng.randint(-(1 << 40), 1 << 40, size=(50, 3))
    port, ref = port_layers.Hashing(bins), jax_layers.Hashing(bins)
    _same(port(words), ref(words))
    _same(port(ints), ref(ints))
    _same(port(torch.from_numpy(ints)), ref(ints))
    with pytest.raises(ValueError):
        port_layers.Hashing(0)


@pytest.mark.parametrize("oov", [1, 3])
def test_index_lookup_with_oov_buckets(oov):
    rng = np.random.RandomState(2)
    vocab = [f"w{i}" for i in range(0, 500, 3)]
    words = _words(rng, 400).reshape(-1, 3)
    port = port_layers.IndexLookup(vocab, num_oov_indices=oov)
    ref = jax_layers.IndexLookup(vocab, num_oov_indices=oov)
    assert port.vocab_size == ref.vocab_size
    _same(port(words), ref(words))


def test_discretization_on_numpy_and_torch():
    rng = np.random.RandomState(3)
    x = _floats(rng, 500)
    bins = [-10.0, -0.5, 0.0, 0.5, 1.0, 2.5, 100.0]
    port, ref = port_layers.Discretization(bins), \
        jax_layers.Discretization(bins)
    _same(port(x), ref(x))
    _same(port(torch.from_numpy(x)), ref(x))
    # integer input is compared as f32, as the JAX layer casts it
    ints = rng.randint(-20, 200, 100)
    _same(port(ints), ref(ints))


def test_to_number_parses_with_defaults():
    text = np.array(["1.5", " 2 ", "", "x", "-3e2", "nan", "7"])
    for out_type, default in ((np.float32, 0), (np.float64, -1.0)):
        port = port_layers.ToNumber(out_type, default)
        ref = jax_layers.ToNumber(out_type, default)
        _same(port(text), ref(text))
        numeric = np.arange(6, dtype=np.int64)
        _same(port(numeric), ref(numeric))
        _same(port(torch.from_numpy(numeric)), ref(numeric))


@pytest.mark.parametrize("max_value", [1, 5, 1000])
def test_round_identity(max_value):
    x = _floats(np.random.RandomState(4), 300)
    port, ref = port_layers.RoundIdentity(max_value), \
        jax_layers.RoundIdentity(max_value)
    _same(port(x), ref(x))
    _same(port(torch.from_numpy(x)), ref(x))


@pytest.mark.parametrize("base", [np.e, 2.0, 10.0])
def test_log_round(base):
    x = _floats(np.random.RandomState(5), 1000)
    port, ref = port_layers.LogRound(64, base), \
        jax_layers.LogRound(64, base)
    _same(port(x), ref(x))
    _same(port(torch.from_numpy(x)), ref(x))


def test_concatenate_with_offset():
    rng = np.random.RandomState(6)
    cols = [rng.randint(0, 100, (20, k)) for k in (1, 3, 2)]
    offsets = [0, 100, 1 << 20]
    port = port_layers.ConcatenateWithOffset(offsets)
    ref = jax_layers.ConcatenateWithOffset(offsets)
    _same(port(cols), ref(cols))
    _same(port([torch.from_numpy(c) for c in cols]), ref(cols))
    with pytest.raises(ValueError, match="offsets"):
        port(cols[:2])


def test_sparse_embedding_is_a_bag_combining_embedding():
    emb = port_layers.SparseEmbedding(64, 4, combiner="mean")
    assert isinstance(emb, DistributedEmbedding)
    assert (emb.input_dim, emb.output_dim, emb.combiner) == (64, 4, "mean")
    ids = torch.tensor([[1, 2, -1], [3, -1, -1]])
    assert tuple(emb(ids).shape) == (2, 4)
