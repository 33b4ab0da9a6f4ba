"""The port's Wide & Deep (elasticdl_tpu_torch/model_zoo/census/) against
the flax zoo's on the CPU: the data and the feed bit for bit (hashing,
column lookup by the reader's metadata, table rows), the carried init,
the forward and a few Adam steps of the JAX Trainer, and the two
scatter-adds a step (one per arena).

Tolerances: the two frameworks sum the MLP products and the embedding
gradients in different orders, so f32 results differ by rounding; each
bound states what was measured."""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_parity import carried_states, carry, step_gaps, trainers
from elasticdl_tpu_torch.layers import embedding as port_embedding
from elasticdl_tpu_torch.model_zoo.census import data as port_data
from elasticdl_tpu_torch.model_zoo.census import wide_and_deep as port
from elasticdl_tpu_torch.worker.trainer import to_tensor
from model_zoo.census import data as jax_data
from model_zoo.census import wide_and_deep as jax_wd

torch.set_num_threads(2)

MODEL = "census.wide_and_deep.custom_model"
PARAMS = "lr=0.005"
# logits from the same weights: measured 9.5e-7 at logits up to 8.2
FWD_TOL = 1e-5
# per-step losses over 4 Adam steps (batch 64): measured 5.2e-6 at
# 1.8-2.6; the logits after them 2.1e-5
LOSS_TOL = 5e-5
PRED_TOL = 2e-4


def _tensors(features):
    return {k: to_tensor(v, torch.device("cpu")) for k, v in
            features.items()}


def test_data_matches_the_jax_zoo(tmp_path):
    assert port_data.synthetic_census(300, seed=4) == \
        jax_data.synthetic_census(300, seed=4)
    port_dirs = port_data.write_dataset(str(tmp_path / "p"), 50, 20, seed=1)
    jax_dirs = jax_data.write_dataset(str(tmp_path / "j"), 50, 20, seed=1)
    for pd, jd in zip(port_dirs, jax_dirs):
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
        for name in os.listdir(jd):
            with open(os.path.join(pd, name), "rb") as a, \
                    open(os.path.join(jd, name), "rb") as b:
                assert a.read() == b.read()


def test_feed_matches_bit_for_bit_by_column_metadata(tmp_path):
    rows = jax_data.synthetic_census(200, seed=2)
    want = jax_wd.feed(rows, {"columns": jax_wd.COLUMNS})
    got = port.feed(rows, {"columns": port.COLUMNS})
    for key in ("numeric", "categorical", "cross"):
        np.testing.assert_array_equal(got["features"][key],
                                      want["features"][key])
        assert got["features"][key].dtype == want["features"][key].dtype
    np.testing.assert_array_equal(got["labels"], want["labels"])
    # no metadata: the default column order
    np.testing.assert_array_equal(port.feed(rows)["labels"], want["labels"])
    # columns in another order, found by name
    perm = np.random.RandomState(0).permutation(len(port.COLUMNS))
    shuffled_cols = [port.COLUMNS[i] for i in perm]
    shuffled = [[row[i] for i in perm] for row in rows]
    again = port.feed(shuffled, {"columns": shuffled_cols})
    for key in ("numeric", "categorical", "cross"):
        np.testing.assert_array_equal(again["features"][key],
                                      want["features"][key])
    # sqlite rows (tuples of TEXT) feed the same batch
    origin = port_data.write_table(str(tmp_path / "c.db"), "census", rows)
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.proto import messages as pb
    reader = create_data_reader(origin)
    name = reader.create_shards()[0][0]
    table_rows = list(reader.read_records(
        pb.Task(shard=pb.Shard(name=name, start=0, end=200))))
    from_table = port.feed(table_rows, reader.metadata)
    for key in ("numeric", "categorical", "cross"):
        np.testing.assert_array_equal(from_table["features"][key],
                                      want["features"][key])


def test_arena_layout_matches_flax():
    assert port.deep_arena_features(4096) == jax_wd.deep_arena_features(4096)
    assert port.wide_arena_features(4096) == jax_wd.wide_arena_features(4096)
    model = port.custom_model()
    assert tuple(model.deep_embedding.embedding.shape) == (4096, 8)
    assert tuple(model.wide_linear.embedding.shape) == (5120, 1)


@pytest.mark.parametrize("arena_dtype", ["float32", "int8"])
def test_forward_matches_flax(arena_dtype):
    batch = jax_wd.feed(jax_data.synthetic_census(64, seed=1))
    model = jax_wd.custom_model(arena_dtype=arena_dtype)
    variables = model.init(jax.random.PRNGKey(0), batch["features"])
    ported = port.custom_model(arena_dtype=arena_dtype)
    if arena_dtype == "int8":
        from elasticdl_tpu_torch.common.weights import (
            flatten_params,
            params_from_jax,
        )
        ported.load_state_dict(params_from_jax(
            ported,
            flatten_params(jax.tree.map(np.asarray, variables["params"])),
            quantized=flatten_params(jax.tree.map(
                np.asarray, variables["quantized"]))), strict=True)
    else:
        carry(ported, variables["params"])
    want = np.asarray(model.apply(variables, batch["features"]))
    got = ported(_tensors(batch["features"])).detach().numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_training_steps_match_the_jax_trainer(monkeypatch):
    _, jt, _, pt = trainers(MODEL, PARAMS)
    rows = jax_data.synthetic_census(64 * 5, seed=0)
    batches = [jax_wd.feed(rows[i * 64:(i + 1) * 64]) for i in range(5)]
    jstate, pstate = carried_states(jt, pt, batches[0]["features"])
    calls = []
    real = port_embedding.scatter_add_forward

    def counted(*args, **kwargs):
        calls.append(args[2].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_embedding, "scatter_add_forward", counted)
    gaps, losses, jstate, pstate = step_gaps(jt, pt, jstate, pstate,
                                             batches[:4])
    assert max(gaps) < LOSS_TOL, (gaps, losses)
    # one scatter-add per arena and step: 8 x 64 rows at D 8, 10 x 64 at 1
    assert calls == [(512, 8), (640, 1)] * 4 or \
        calls == [(640, 1), (512, 8)] * 4, calls
    x = batches[4]["features"]
    np.testing.assert_allclose(pt.predict_on_batch(pstate, x),
                               np.asarray(jt.predict_on_batch(jstate, x)),
                               atol=PRED_TOL, rtol=0)
