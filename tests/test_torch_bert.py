"""The port's BERT zoo model (elasticdl_tpu_torch/model_zoo/bert) against
the JAX zoo's, on the CPU.

Small configuration: hidden 64, 2 layers, 4 heads, MLP 128, L 128, vocab
512, batch 8 (a multiple of the 8-device CPU mesh from conftest, so the
JAX model runs its mesh path: ring_self_attention -> Pallas flash kernel
in interpret mode).  The JAX init is carried into the port with
`params_from_jax`; inputs come from numpy with a seed.
"""

import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    params_from_jax,
    torch_name,
)
from elasticdl_tpu_torch.layers import linen
from elasticdl_tpu_torch.model_zoo.bert import bert_finetune as port_bert
from model_zoo.bert import bert_finetune as jax_bert

torch.set_num_threads(2)

CFG = dict(hidden=64, num_layers=2, heads=4, mlp_dim=128, max_len=128,
           vocab_size=512)
BATCH = 8
# f32: the two frameworks sum in another order; measured ~1.5e-6 at a
# logit scale of ~4.6.
F32_TOL = 1e-4
# bf16: Dense, GELU and the block LayerNorms round to bf16 at different
# places in the two frameworks (flax's bf16 GELU rounds after each jnp
# op; the Pallas kernel rounds probabilities to bf16); measured ~0.026
# at a logit scale of ~4.6.
BF16_TOL = 0.1


def _ids(seed=0, batch=BATCH):
    ids = np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (batch, CFG["max_len"])).astype(np.int32)
    ids[0, 100:] = -1          # pad id: zero row, still attended over
    ids[1, :5] = 5000          # ids >= vocab wrap mod vocab
    return ids


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def pair(request):
    """(jax model, jax variables, port model loaded with them)."""
    bf16 = request.param
    jax_model = jax_bert.custom_model(**CFG, bf16=bf16)
    variables = jax_model.init(jax.random.PRNGKey(0), {"input_ids": _ids()})
    port_model = port_bert.custom_model(**CFG, bf16=bf16)
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    port_model.load_state_dict(params_from_jax(port_model, flat),
                               strict=True)
    return bf16, jax_model, variables, port_model


def test_params_from_jax_covers_every_leaf(pair):
    _, _, variables, port_model = pair
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    assert len(flat) == 30  # 2 layers: the whole tree model.init printed
    names = {torch_name(p) for p in flat}
    assert names == {n for n, _ in port_model.named_parameters()}
    got = params_from_jax(port_model, flat)
    np.testing.assert_array_equal(
        got["layer_0.attention.qkv.weight"].numpy(),
        flat["layer_0/attention/qkv/kernel"].T)
    np.testing.assert_array_equal(
        got["layer_1.LayerNorm_1.weight"].numpy(),
        flat["layer_1/LayerNorm_1/scale"])


def test_params_from_jax_rejects_missing_and_unused_leaves(pair):
    _, _, variables, port_model = pair
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    missing = dict(flat)
    del missing["classifier/bias"]
    with pytest.raises(ValueError, match="without a leaf.*classifier.bias"):
        params_from_jax(port_model, missing)
    extra = dict(flat, **{"layer_9/Dense_0/kernel": np.zeros((64, 128))})
    with pytest.raises(ValueError, match="unused leaves.*layer_9"):
        params_from_jax(port_model, extra)
    bad = dict(flat, **{"classifier/kernel": np.zeros((64, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(port_model, bad)


def test_logits_match_jax_mesh_path(pair):
    bf16, jax_model, variables, port_model = pair
    ids = _ids(seed=1)
    want = np.asarray(jax_model.apply(variables, {"input_ids": ids}),
                      np.float32)
    with torch.no_grad():
        got = port_model({"input_ids": torch.from_numpy(ids)})
    assert got.dtype == torch.float32  # the classifier stays f32
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_loss_matches_optax():
    rng = np.random.RandomState(3)
    logits = rng.randn(16, 2).astype(np.float32) * 3
    labels = rng.randint(0, 2, 16).astype(np.int32)
    want = float(jax_bert.loss(labels, logits))
    got = float(port_bert.loss(torch.from_numpy(labels),
                               torch.from_numpy(logits)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want_optax = float(optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean())
    np.testing.assert_allclose(got, want_optax, rtol=1e-6, atol=1e-6)


def _records(n=6, max_len=16):
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 8192, (n, max_len)).astype(np.int32)
    labels = rng.randint(0, 2, n).astype(np.uint8)
    return [ids[i].tobytes() + bytes([labels[i]]) for i in range(n)]


def _assert_batches_equal(got, want):
    for key in ("features", "labels"):
        g, w = got[key], want[key]
        if key == "features":
            g, w = g["input_ids"], w["input_ids"]
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("feed_name",
                         ["feed", "feed_bulk", "feed_bulk_compact"])
def test_feeds_match_jax_zoo(feed_name):
    records = _records()
    if feed_name == "feed":
        got = port_bert.feed(records, max_len=16)
        want = jax_bert.feed(records, max_len=16)
    else:
        buffer = b"".join(records)
        sizes = np.array([len(r) for r in records], np.int64)
        got = getattr(port_bert, feed_name)(buffer, sizes)
        want = getattr(jax_bert, feed_name)(buffer, sizes)
    _assert_batches_equal(got, want)


def test_feed_accepts_dict_records_like_jax():
    records = [{"input_ids": np.arange(16, dtype=np.int32) + i, "label": i}
               for i in range(3)]
    _assert_batches_equal(port_bert.feed(records, max_len=16),
                          jax_bert.feed(records, max_len=16))


def test_compact_ids_serve_like_int32_ids(pair):
    """feed_bulk_compact's uint16 ids give the model the same logits."""
    _, _, _, port_model = pair
    ids = np.random.RandomState(5).randint(0, 512, (2, 128))
    with torch.no_grad():
        a = port_model({"input_ids": torch.from_numpy(ids.astype(np.int32))})
        b = port_model({"input_ids": torch.from_numpy(
            ids.astype(np.uint16).astype(np.int64))})
    assert torch.equal(a, b)


# the parallel variants on one device: the MoE FFN (every expert local)
# and the GPipe stack (sequential), from the flax init, f32
@pytest.mark.parametrize("kwargs", [{"moe_experts": 4},
                                    {"pipeline_microbatches": 2},
                                    {"pipeline_microbatches": 2,
                                     "remat": True}])
def test_variants_match_flax_on_one_device(kwargs):
    cfg = dict(CFG, max_len=16)
    ids = _ids()[:, :16]
    jax_model = jax_bert.custom_model(**cfg, **kwargs)
    variables = jax_model.init(jax.random.PRNGKey(0), {"input_ids": ids})
    port_model = port_bert.custom_model(**cfg, **kwargs)
    flat = flatten_params(jax.tree.map(np.asarray, variables["params"]))
    port_model.load_state_dict(params_from_jax(port_model, flat),
                               strict=True)
    want = np.asarray(jax_model.apply(variables, {"input_ids": ids}))
    with torch.no_grad():
        got = port_model({"input_ids": torch.from_numpy(ids)}).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_get_model_spec_loads_port_zoo_by_qualified_name():
    before = list(sys.path)
    spec = port_handler.get_model_spec(
        port_handler.ZOO_DIR, "bert.bert_finetune.custom_model",
        model_params="hidden=32;num_layers=1;heads=2;mlp_dim=64;"
                     "max_len=16;vocab_size=64;bf16=True",
    )
    assert sys.path == before  # the port zoo never joins sys.path
    assert spec.module.__name__ == \
        "elasticdl_tpu_torch.model_zoo.bert.bert_finetune"
    assert isinstance(spec.model, port_bert.BertClassifier)
    assert spec.model.layer_0.Dense_0.dtype == torch.bfloat16
    opt = spec.optimizer(spec.model.parameters())
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.defaults["weight_decay"] == 0.01
    assert opt.defaults["eps"] == 1e-8
    assert os.path.isdir(port_handler.ZOO_DIR)


def test_init_parameters_follows_flax_initialisers():
    model = port_bert.custom_model(hidden=256, num_layers=1, heads=4,
                                   mlp_dim=512, max_len=64, vocab_size=128)
    linen.init_parameters(model, torch.Generator().manual_seed(0))
    w = model.layer_0.Dense_0.weight.detach()
    # lecun_normal: std 1/sqrt(fan_in), truncated at 2 std of the draw
    assert abs(float(w.std()) - 256 ** -0.5) < 0.003
    assert float(w.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978
    assert not model.layer_0.Dense_0.bias.detach().any()
    assert bool((model.layer_0.LayerNorm_0.weight.detach() == 1).all())
    assert abs(float(model.position_embedding.detach().std()) - 0.02) < 0.002
