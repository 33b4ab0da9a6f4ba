"""The port's DeepFM zoo model (elasticdl_tpu_torch/model_zoo/deepfm)
against the JAX zoo's, on the CPU: logits from the carried flax init,
the integer id paths bit for bit, and the feeds, data and metrics byte
for byte.

Small configuration: vocab 4096, embed dim 8, MLP (256, 128), batch 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.common import metrics as port_metrics
from elasticdl_tpu_torch.model_zoo.deepfm import data as port_data
from elasticdl_tpu_torch.model_zoo.deepfm import (
    deepfm_functional_api as port_fm,
)
from model_zoo.common import metrics as jax_metrics
from model_zoo.deepfm import data as jax_data
from model_zoo.deepfm import deepfm_functional_api as jax_fm

torch.set_num_threads(2)

CFG = dict(vocab_capacity=4096, embed_dim=8)
BATCH = 64
# f32: the same arithmetic summed in another order (the MLP's products
# over 221 inputs); measured 2.4e-7 at a logit scale of 2.4.
F32_TOL = 1e-5
# bf16: the MLP rounds its inputs, weights and outputs to bf16 in both
# (measured 2.4e-7 here too), but where a sum lands near a rounding
# boundary the two may round apart by one bf16 step, 2^-8 relative at an
# MLP output of ~1: allow two such steps.
BF16_TOL = 1e-2


def _features(seed=0, batch=BATCH, pad=True):
    """Synthetic features with the int32 extremes in row 0; with `pad`,
    field 0 of row 0 is -1, the pad id (field 0's offset is 0), which
    the model masks to a zero vector."""
    dense, sparse, _ = port_data.synthetic_criteo(batch, seed=seed)
    sparse = sparse.copy()
    sparse[0, :4] = [-1 if pad else 5, 2 ** 31 - 1, -(2 ** 31), 123456789]
    return {"dense": dense, "sparse": sparse}


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def pair(request):
    bf16 = request.param
    jax_model = jax_fm.custom_model(**CFG, bf16=bf16)
    variables = jax_model.init(jax.random.PRNGKey(0), _features())
    port_model = port_fm.custom_model(**CFG, bf16=bf16)
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    port_model.load_state_dict(params_from_jax(port_model, flat),
                               strict=True)
    return bf16, jax_model, variables, port_model


def test_parameter_names_follow_flax_paths(pair):
    _, _, variables, port_model = pair
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    assert sorted(flat) == sorted([
        "dense_linear/bias", "dense_linear/kernel",
        "fm_embedding/embedding", "fm_linear/embedding",
        "mlp_0/bias", "mlp_0/kernel", "mlp_1/bias", "mlp_1/kernel",
        "mlp_out/bias", "mlp_out/kernel"])
    assert tuple(port_model.fm_embedding.embedding.shape) == (4096, 8)
    assert tuple(port_model.mlp_0.weight.shape) == (256, 13 + 26 * 8)


def test_logits_match_flax(pair):
    bf16, jax_model, variables, port_model = pair
    feats = _features(seed=1)
    want = np.asarray(jax_model.apply(variables, feats), np.float32)
    with torch.no_grad():
        got = port_model({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.dtype == torch.float32 and got.shape == (BATCH,)
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_field_offset_ids_bit_exact():
    sparse = _features()["sparse"]
    want = np.asarray(jax_fm.field_offset_ids(jnp.asarray(sparse)))
    got = port_fm.field_offset_ids(torch.from_numpy(sparse))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_field_rows_host_bit_exact():
    sparse = _features(pad=False)["sparse"]
    np.testing.assert_array_equal(
        port_fm.hash_field_rows_host(sparse, 4096),
        jax_fm.hash_field_rows_host(sparse, 4096))
    bad = sparse.copy()
    bad[1, 0] = -1          # field 0's offset is 0: the pad sentinel
    with pytest.raises(ValueError, match="pad sentinel"):
        port_fm.hash_field_rows_host(bad, 4096)


def test_prehashed_rows_give_the_same_logits(pair):
    _, _, _, port_model = pair
    feats = _features(seed=2, pad=False)
    rows = port_fm.hash_field_rows_host(feats["sparse"], 4096)
    dense = torch.from_numpy(feats["dense"])
    with torch.no_grad():
        emb = port_fm.arena_field_lookup(port_model.fm_embedding,
                                         torch.from_numpy(rows), True)
        first = port_fm.arena_field_lookup(port_model.fm_linear,
                                           torch.from_numpy(rows), True)
        got = port_fm.deepfm_tail(port_model, emb, first, dense,
                                  port_model.compute_dtype)
        want = port_model({"dense": dense,
                           "sparse": torch.from_numpy(feats["sparse"])})
    assert torch.equal(got, want)


def test_loss_matches_optax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(32) * 4).astype(np.float32)
    labels = rng.randint(0, 2, 32).astype(np.int32)
    want = float(optax.sigmoid_binary_cross_entropy(
        logits, labels.astype(np.float32)).mean())
    np.testing.assert_allclose(float(jax_fm.loss(labels, logits)), want)
    got = float(port_fm.loss(torch.from_numpy(labels),
                             torch.from_numpy(logits)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_synthetic_criteo_and_records_byte_equal():
    got = port_data.synthetic_criteo(500, seed=11, ids_per_field=300)
    want = jax_data.synthetic_criteo(500, seed=11, ids_per_field=300)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert list(port_data.records(*got)) == list(jax_data.records(*want))


def _assert_batches_equal(got, want):
    for key in ("dense", "sparse"):
        g, w = got["features"][key], want["features"][key]
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got["labels"].dtype == want["labels"].dtype
    np.testing.assert_array_equal(got["labels"], want["labels"])


def test_feed_and_feed_bulk_byte_equal():
    records = list(jax_data.records(*jax_data.synthetic_criteo(20, seed=4)))
    _assert_batches_equal(port_fm.feed(records), jax_fm.feed(records))
    buffer = b"".join(records)
    sizes = np.full(len(records), port_fm.RECORD_BYTES, np.int64)
    _assert_batches_equal(port_fm.feed_bulk(buffer, sizes),
                          jax_fm.feed_bulk(buffer, sizes))
    dicts = [{"dense": np.arange(13, dtype=np.float32) + i,
              "sparse": np.arange(26, dtype=np.int32) * i, "label": i % 2}
             for i in range(3)]
    _assert_batches_equal(port_fm.feed(dicts), jax_fm.feed(dicts))
    with pytest.raises(ValueError, match="157-byte"):
        port_fm.feed_bulk(buffer[:-1], np.append(sizes[:-1], 156))


@pytest.mark.parametrize("case", ["ties", "random", "one_class"])
def test_auc_and_accuracy_equal(case):
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 2, 300)
    scores = rng.randn(300).astype(np.float32)
    if case == "ties":
        scores = np.round(scores, 1)
    if case == "one_class":
        labels[:] = 1
    assert port_metrics.auc(labels, scores) == jax_metrics.auc(labels, scores)
    assert port_metrics.binary_accuracy(labels, scores) == \
        jax_metrics.binary_accuracy(labels, scores)


@pytest.mark.parametrize("sparse", [
    {"lo16": torch.zeros(2, 26), "hi6": torch.zeros(2, 20)},
    torch.zeros(2, 26, 3, dtype=torch.uint8),
])
def test_packed_wire_formats_are_queued(sparse):
    model = port_fm.custom_model(vocab_capacity=64, embed_dim=4)
    with pytest.raises(NotImplementedError, match="wire-decoder slice"):
        model({"dense": torch.zeros(2, 13), "sparse": sparse})


def test_int8_arena_is_queued():
    with pytest.raises(NotImplementedError, match="int8 arena slice"):
        port_fm.custom_model(vocab_capacity=64, arena_dtype="int8")


def test_get_model_spec_loads_the_port_zoo():
    spec = port_handler.get_model_spec(
        port_handler.ZOO_DIR, "deepfm.deepfm_functional_api.custom_model",
        model_params="vocab_capacity=1024;embed_dim=4;bf16=True;lr=0.005")
    assert isinstance(spec.model, port_fm.DeepFM)
    assert spec.model.mlp_0.dtype == torch.bfloat16
    assert spec.model.dense_linear.dtype is None   # f32, promoted
    opt = spec.optimizer(spec.model.parameters())
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["lr"] == 0.005
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8
    assert spec.feed_bulk is port_fm.feed_bulk
    assert spec.feed_bulk_compact is None and spec.feed_bulk_dedup is None
    assert set(spec.eval_metrics) == {"auc", "accuracy"}
