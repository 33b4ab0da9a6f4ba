"""The port's int8 arena (elasticdl_tpu_torch/layers/arena.py,
arena_dtype="int8") against the JAX package's, on the CPU, from
numpy-seeded inputs and the carried flax state:

- quantize/dequantize bit for bit (host twins too), the round-trip
  bound, stochastic rounding unbiased and exact on integers;
- the dequantized gather bit for bit, the model within the f32 bound;
- one training step from a shared state: carrier gradients, new scales,
  codes within one step of JAX's, untouched rows bit-stable, the carrier
  zero after the fold;
- the fold's determinism in (step, path), and its absence without
  quantized buffers;
- int8 checkpoints: bitwise save/restore, the manifest's arena entry,
  the dtype-mismatch error and both migrations bit for bit.

torch's random stream cannot equal jax.random's, so the codes after a
fold agree with JAX's within one rounding step and the rounding's
unbiasedness is checked statistically.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.layers import arena as jax_arena
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.save_utils import (
    ArenaDtypeMismatch,
    CheckpointSaver,
)
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.layers import arena as port_arena
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.worker import trainer as port_trainer

torch.set_num_threads(2)

FEATS = (("a", 64), ("b", 32))
DIM = 8
MODEL = "deepfm.deepfm_functional_api.custom_model"
SMALL = "vocab_capacity=4096;embed_dim=8;lr=0.01"
# one step from a shared state: the two frameworks sum each row's
# gradient in another order (the JAX step splits the batch over the
# 8-device CPU mesh), f32 in both; relative to the largest element
GRAD_RTOL = 1e-6
# Adam's update from the same gradients: optax computes the bias
# correction 1 - 0.999^t in f32 (1.3e-5 off at t = 1, so 6.4e-6 in the
# update through the square root), torch.optim.Adam in double; measured
# 6.8e-6 relative at lr 0.01
DELTA_RTOL = 1e-5
# new per-row scales from the same delta: the same f32 operations
SCALE_RTOL = 1e-6
# DeepFM logits from the same dequantized rows: tests/test_torch_deepfm.py
F32_TOL = 1e-5

as_np = functools.partial(jax.tree.map, np.asarray)


def _table(seed=0, rows=96):
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, DIM).astype(np.float32) * np.logspace(
        -3, 1, rows).reshape(-1, 1).astype(np.float32)
    table[17] = 0.0           # an all-zero row round-trips exactly
    return table


def _ids(seed=0, batch=16):
    rng = np.random.RandomState(seed)
    return {
        "a": rng.randint(0, 1 << 20, size=(batch,)).astype(np.int32),
        "b": rng.randint(0, 1 << 20, size=(batch, 3)).astype(np.int32),
    }


# ---- numerics -------------------------------------------------------------


def test_quantize_and_dequantize_match_jax_bit_for_bit():
    table = _table()
    q8, scale = port_arena.quantize_rows(torch.from_numpy(table))
    jq8, jscale = jax_arena.quantize_rows(table)
    assert q8.dtype == torch.int8 and tuple(scale.shape) == (96, 1)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    deq = port_arena.dequantize_rows(q8, scale)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_arena.dequantize_rows(jq8, jscale)))
    # the host twins, against JAX's and against the tensor versions
    hq8, hscale = port_arena.quantize_rows_host(table)
    jhq8, jhscale = jax_arena.quantize_rows_host(table)
    np.testing.assert_array_equal(hq8, jhq8)
    np.testing.assert_array_equal(hscale, jhscale)
    np.testing.assert_array_equal(hq8, q8.numpy())
    np.testing.assert_array_equal(
        port_arena.dequantize_rows_host(hq8, hscale),
        jax_arena.dequantize_rows_host(jhq8, jhscale))
    # round to nearest: per-element error <= that row's scale / 2
    err = np.abs(deq.numpy() - table)
    assert np.all(err <= scale.numpy() / 2 + 1e-7)
    assert not q8[17].any() and float(scale[17, 0]) == 1.0


def test_stochastic_round_is_unbiased_and_exact_on_integers():
    n = 200_000
    for key, value in enumerate((2.3, -5.7, 0.5)):
        x = torch.full((n,), value)
        got = port_arena.stochastic_round(x, key).double()
        frac = value - np.floor(value)
        sigma = np.sqrt(frac * (1 - frac) / n)
        assert abs(float(got.mean()) - value) < 3 * sigma
        assert set(torch.unique(got).tolist()) <= {np.floor(value),
                                                   np.floor(value) + 1}
    ints = torch.arange(-127, 128, dtype=torch.float32)
    for seed in range(3):
        assert torch.equal(port_arena.stochastic_round(ints, seed),
                           ints.to(torch.int8))


# ---- forward ----------------------------------------------------------------


def _carried_arena(seed=0):
    ids = _ids(seed)
    jax_layer = jax_arena.EmbeddingArena(FEATS, DIM, arena_dtype="int8")
    variables = jax_layer.init(jax.random.PRNGKey(seed), ids)
    port_layer = port_arena.EmbeddingArena(FEATS, DIM, arena_dtype="int8")
    port_layer.load_state_dict(params_from_jax(
        port_layer, flatten_params(as_np(variables["params"])),
        quantized=flatten_params(as_np(variables["quantized"]))),
        strict=True)
    return jax_layer, variables, port_layer, ids


def test_dequantized_gather_matches_jax_bit_for_bit():
    jax_layer, variables, port_layer, ids = _carried_arena()
    want = jax_layer.apply(variables, ids)
    got = port_layer({k: torch.from_numpy(v) for k, v in ids.items()})
    for name in want:
        np.testing.assert_array_equal(got[name].detach().numpy(),
                                      np.asarray(want[name]))
    flat = {k: v.reshape(16, -1) for k, v in ids.items()}
    rows = port_layer.arena_rows_host(flat)
    pre = port_layer(torch.from_numpy(rows), prehashed=True)
    np.testing.assert_array_equal(
        pre.detach().numpy(),
        np.asarray(jax_layer.apply(variables, rows, prehashed=True)))


def test_int8_is_exact_against_fp32_on_integer_rows():
    """Integer rows at scale 1: the int8 and fp32 arenas agree bit for
    bit on the same ids, as in the JAX package's test."""
    rows = port_arena.arena_rows(FEATS)
    codes = np.random.RandomState(1).randint(-127, 128, (rows, DIM))
    fp32 = port_arena.EmbeddingArena(FEATS, DIM)
    q = port_arena.EmbeddingArena(FEATS, DIM, arena_dtype="int8")
    with torch.no_grad():
        fp32.embedding.copy_(torch.from_numpy(codes.astype(np.float32)))
        q.q8.copy_(torch.from_numpy(codes.astype(np.int8)))
        q.scale.fill_(1.0)
    ids = {k: torch.from_numpy(v) for k, v in _ids(2).items()}
    a, b = fp32(ids), q(ids)
    for name in a:
        assert torch.equal(a[name], b[name])


def test_int8_backward_goes_through_the_scatter_add_wrapper(monkeypatch):
    """The carrier's gradient is the scatter-add of the output gradient,
    through ops/scatter_add.py's wrapper (the Hopper kernel on a CUDA
    tensor), equal to the fp32 arena's table gradient."""
    calls = []
    real = port_arena.scatter_add_forward

    def counting(*args, **kwargs):
        calls.append(args[1].numel())
        return real(*args, **kwargs)

    monkeypatch.setattr(port_arena, "scatter_add_forward", counting)
    _, _, q, ids = _carried_arena(seed=3)
    fp32 = port_arena.EmbeddingArena(FEATS, DIM)
    with torch.no_grad():
        fp32.embedding.copy_(port_arena.dequantize_rows(q.q8, q.scale))
    tensors = {k: torch.from_numpy(v) for k, v in ids.items()}
    weights = {k: torch.randn(v.shape + (DIM,), generator=torch.Generator()
                              .manual_seed(4)) for k, v in ids.items()}
    for layer in (q, fp32):
        out = layer(tensors)
        sum((out[k] * weights[k]).sum() for k in out).backward()
    assert calls == [16 + 16 * 3]
    assert torch.equal(q.embedding.grad, fp32.embedding.grad)
    assert not q.embedding.detach().any()      # forward never wrote it


# ---- one training step from a shared state ----------------------------------


def _criteo_batch(seed=0, batch=256):
    dense, sparse, labels = synthetic_criteo(batch, seed=seed)
    return {"features": {"dense": dense, "sparse": sparse},
            "labels": labels.astype(np.int32)}


def _pair_of_trainers(arena_dtype="int8"):
    params = f"{SMALL};arena_dtype='{arena_dtype}'"
    js = jax_spec("model_zoo", MODEL, model_params=params)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    param_sharding_fn=js.param_sharding)
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                     model_params=params)
    pt = port_trainer.Trainer(ps.model, ps.optimizer, ps.loss, device="cpu")
    sample = _criteo_batch()["features"]
    jstate = jt.init_state(jax.random.PRNGKey(0), sample)
    pstate = pt.init_state(0, sample)
    pstate.model.load_state_dict(params_from_jax(
        pstate.model, flatten_params(as_np(jstate.params["params"])),
        quantized=flatten_params(as_np(
            jstate.model_state["quantized"]))), strict=True)
    return js, jt, jstate, pt, pstate


def _jax_planes(jstate, arena):
    planes = jstate.model_state["quantized"][arena]["embedding"]
    return np.asarray(planes["q8"]), np.asarray(planes["scale"])


def test_one_step_from_a_shared_state_matches_jax():
    """From one carried state: the carrier gradients agree within
    GRAD_RTOL; Adam on those same gradients gives carrier deltas within
    DELTA_RTOL; the fold of the same delta gives new scales within
    SCALE_RTOL and codes within one rounding step of JAX's, keeps
    untouched rows bit-stable and leaves the carrier zero."""
    js, jt, jstate, pt, pstate = _pair_of_trainers()
    batch = _criteo_batch(seed=1)
    variables = {"params": jstate.params["params"], **jstate.model_state}

    def jax_loss(params):
        preds = js.model.apply({**variables, "params": params},
                               batch["features"])
        return js.loss(batch["labels"], preds)

    jgrads = jax.grad(jax_loss)(jstate.params["params"])
    feats = port_trainer._to_device(batch["features"], torch.device("cpu"))
    labels = torch.from_numpy(batch["labels"])
    pt.loss_fn(labels, pstate.model(feats)).backward()
    touched = {}
    for arena in ("fm_embedding", "fm_linear"):
        want = np.asarray(jgrads[arena]["embedding"])
        got = getattr(pstate.model, arena).embedding.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max())
        touched[arena] = np.any(want != 0, axis=1)
        assert 0 < touched[arena].sum() < 4096

    # Adam on the same gradients, in both
    shared = params_from_jax(
        pstate.model, flatten_params(as_np(jgrads)),
        quantized=flatten_params(as_np(jstate.model_state["quantized"])))
    for name, param in pstate.model.named_parameters():
        param.grad = shared[name]
    pstate.optimizer.step()
    updates, _ = jt.optimizer.update({"params": jgrads}, jstate.opt_state,
                                     jstate.params)
    params = optax.apply_updates(jstate.params, updates)
    for arena in touched:
        want = np.asarray(params["params"][arena]["embedding"])
        carrier = getattr(pstate.model, arena).embedding
        np.testing.assert_allclose(carrier.detach().numpy(), want,
                                   rtol=DELTA_RTOL, atol=0)
        # the fold from the same delta: JAX's
        with torch.no_grad():
            carrier.copy_(torch.from_numpy(want.copy()))
    # the fold at the step before the increment, as both steps run it
    port_arena.fold_quantized_updates(pstate.model, pstate.step)
    before = {a: _jax_planes(jstate, a) for a in touched}
    params, model_state = jax_arena.fold_quantized_updates(
        params, jstate.model_state, jstate.step)
    jstate = jstate.replace(params=params, model_state=model_state)
    for arena, rows in touched.items():
        q8_0, scale_0 = before[arena]
        jq8, jscale = _jax_planes(jstate, arena)
        layer = getattr(pstate.model, arena)
        q8, scale = layer.q8.numpy(), layer.scale.numpy()
        # untouched rows bit-stable in both
        for a, b in ((q8, q8_0), (scale, scale_0), (jq8, q8_0),
                     (jscale, scale_0)):
            np.testing.assert_array_equal(a[~rows], b[~rows])
        # touched rows: the same new scale, codes within one rounding
        np.testing.assert_allclose(scale[rows], jscale[rows],
                                   rtol=SCALE_RTOL)
        diff = np.abs(q8[rows].astype(np.int32) - jq8[rows].astype(np.int32))
        assert diff.max() <= 1
        assert (q8[rows] != q8_0[rows]).any()
        # the carrier is zero after the fold, in both
        assert not layer.embedding.detach().any()
        assert not np.asarray(jstate.params["params"][arena]["embedding"]
                              ).any()


def test_a_port_training_step_folds_like_the_jax_step():
    """The port's own Trainer step from the shared state (its own
    gradients): the same rows move, the codes stay within one rounding
    step of JAX's, and the carrier ends zero."""
    _, jt, jstate, pt, pstate = _pair_of_trainers()
    batch = _criteo_batch(seed=2)
    before = {a: _jax_planes(jstate, a) for a in ("fm_embedding",
                                                  "fm_linear")}
    jstate, jloss = jt.train_on_batch(jstate, batch)
    pstate, ploss = pt.train_on_batch(pstate, batch)
    assert abs(float(ploss) - float(jloss)) < 1e-5
    for arena, (q8_0, scale_0) in before.items():
        jq8, jscale = _jax_planes(jstate, arena)
        layer = getattr(pstate.model, arena)
        moved = (layer.scale.numpy() != scale_0)[:, 0]
        np.testing.assert_array_equal(moved, (jscale != scale_0)[:, 0])
        diff = np.abs(layer.q8.numpy().astype(np.int32) - jq8)
        assert diff.max() <= 1
        assert not layer.embedding.detach().any()


def _model_with_delta(step_seed=0):
    model = port_handler.get_model_spec(
        port_handler.ZOO_DIR, MODEL, model_params=SMALL + ";arena_dtype="
        "'int8'").model
    model.fm_embedding.reset_parameters(torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.fm_embedding.embedding.copy_(torch.randn(
            model.fm_embedding.embedding.shape,
            generator=torch.Generator().manual_seed(step_seed)) * 0.03)
    return model


def test_fold_is_deterministic_in_step_and_path():
    base = _model_with_delta()
    folded = {}
    for label, step in (("a", 11), ("b", 11), ("c", 12)):
        model = copy.deepcopy(base)
        assert port_arena.fold_quantized_updates(model, step) == 2
        folded[label] = model.fm_embedding.q8.clone()
        assert not model.fm_embedding.embedding.detach().any()
    assert torch.equal(folded["a"], folded["b"])
    assert not torch.equal(folded["a"], folded["c"])
    # the two arenas of one step draw from their own paths
    assert port_arena._path_seed(("fm_embedding", "embedding")) != \
        port_arena._path_seed(("fm_linear", "embedding"))
    assert port_arena._path_seed(("fm_embedding", "embedding")) == \
        jax_arena._path_seed(("fm_embedding", "embedding"))


def test_fold_keeps_untouched_rows_and_absorbs_the_delta():
    model = _model_with_delta()
    layer = model.fm_embedding
    with torch.no_grad():
        layer.embedding.zero_()
        touched = [0, 5, 40]
        layer.embedding[touched] = torch.randn(
            3, DIM, generator=torch.Generator().manual_seed(6)) * 0.05
    q8_0, scale_0 = layer.q8.clone(), layer.scale.clone()
    want = port_arena.dequantize_rows(q8_0, scale_0)[touched] + \
        layer.embedding.detach()[touched]
    port_arena.fold_quantized_updates(model, step=7)
    mask = torch.ones(layer.q8.shape[0], dtype=torch.bool)
    mask[touched] = False
    assert torch.equal(layer.q8[mask], q8_0[mask])
    assert torch.equal(layer.scale[mask], scale_0[mask])
    got = port_arena.dequantize_rows(layer.q8, layer.scale)[touched]
    assert torch.all((got - want).abs() <= layer.scale[touched] + 1e-7)


def test_fold_without_quantized_buffers_is_the_identity():
    spec = port_handler.get_model_spec(port_handler.ZOO_DIR, MODEL,
                                       model_params=SMALL)
    before = copy.deepcopy(spec.model.state_dict())
    assert port_arena.fold_quantized_updates(spec.model, step=3) == 0
    after = spec.model.state_dict()
    assert before.keys() == after.keys()
    for name, tensor in before.items():
        assert torch.equal(tensor, after[name]), name


def test_small_int8_deepfm_trains_with_the_carrier_staying_zero():
    spec = port_handler.get_model_spec(
        port_handler.ZOO_DIR, MODEL, model_params=SMALL + ";arena_dtype="
        "'int8'")
    trainer = port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                   device="cpu")
    batch = _criteo_batch(0)
    state = trainer.init_state(0, batch["features"])
    q8_0 = state.model.fm_embedding.q8.clone()
    losses = []
    for _ in range(4):
        state, loss = trainer.train_on_batch(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]       # a repeated batch: the loss drops
    for arena in (state.model.fm_embedding, state.model.fm_linear):
        assert not arena.embedding.detach().any()
    assert not torch.equal(state.model.fm_embedding.q8, q8_0)


def test_params_from_jax_wants_the_quantized_collection():
    _, variables, port_layer, _ = _carried_arena()
    with pytest.raises(ValueError, match="quantized"):
        params_from_jax(port_layer,
                        flatten_params(as_np(variables["params"])))


# ---- checkpoints ------------------------------------------------------------


def _trained(arena_dtype, steps=3, seed=0):
    spec = port_handler.get_model_spec(
        port_handler.ZOO_DIR, MODEL,
        model_params=f"{SMALL};arena_dtype='{arena_dtype}'")
    trainer = port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                   device="cpu")
    state = trainer.init_state(seed, _criteo_batch()["features"])
    for i in range(steps):
        state, _ = trainer.train_on_batch(state, _criteo_batch(i))
    return trainer, state


def _saved(tmp_path, state):
    saver = CheckpointSaver(str(tmp_path / "ckpt"))
    assert saver.save(state)
    saver.wait_until_finished()
    return saver


def _moments(state, name):
    param = dict(state.model.named_parameters())[name]
    opt_state = state.optimizer.state[param]
    return opt_state["exp_avg"], opt_state["exp_avg_sq"]


def test_int8_checkpoint_round_trips_bitwise_and_records_its_planes(
        tmp_path):
    trainer, state = _trained("int8")
    saver = _saved(tmp_path, state)
    manifest = json.load(open(saver._manifest_path(3)))
    assert manifest["arena"] == {"arena_dtype": "int8", "planes": {
        "fm_embedding/embedding": {"rows": 4096, "dim": 8,
                                   "scale_shape": [4096, 1]},
        "fm_linear/embedding": {"rows": 4096, "dim": 1,
                                "scale_shape": [4096, 1]}}}
    template = trainer.init_state(1, _criteo_batch()["features"])
    restored = saver.maybe_restore(template)
    assert restored.step == 3
    want = state.model.state_dict()
    for name, tensor in restored.model.state_dict().items():
        assert tensor.dtype == want[name].dtype
        assert torch.equal(tensor, want[name]), name
    for name in ("fm_embedding.embedding", "mlp_0.weight"):
        for got, w in zip(_moments(restored, name), _moments(state, name)):
            assert torch.equal(got, w)
    saver.close()


def test_fp32_manifest_records_no_planes(tmp_path):
    _, state = _trained("float32", steps=1)
    saver = _saved(tmp_path, state)
    assert json.load(open(saver._manifest_path(1)))["arena"] == {
        "arena_dtype": "float32", "planes": {}}
    saver.close()


@pytest.mark.parametrize("saved,configured", [("int8", "float32"),
                                              ("float32", "int8")])
def test_an_arena_dtype_mismatch_is_a_clear_error(tmp_path, saved,
                                                  configured):
    _, state = _trained(saved, steps=1)
    saver = _saved(tmp_path, state)
    trainer, _ = _trained(configured, steps=0)
    template = trainer.init_state(1, _criteo_batch()["features"])
    with pytest.raises(ArenaDtypeMismatch, match="arena_convert"):
        saver.restore_step(1, template)
    # maybe_restore surfaces it too, rather than falling back
    with pytest.raises(ArenaDtypeMismatch, match=f"--arena_dtype {saved}"):
        saver.maybe_restore(template)
    saver.close()


def test_checkpoint_migrates_fp32_to_int8_bitwise(tmp_path):
    _, state32 = _trained("float32")
    saver = _saved(tmp_path, state32)
    trainer8, _ = _trained("int8", steps=0)
    template = trainer8.init_state(1, _criteo_batch()["features"])
    restored = saver.restore_step(3, template, arena_convert=True)
    for arena in ("fm_embedding", "fm_linear"):
        table = dict(state32.model.named_parameters())[
            f"{arena}.embedding"].detach()
        q8, scale = port_arena.quantize_rows(table)
        layer = getattr(restored.model, arena)
        assert torch.equal(layer.q8, q8) and torch.equal(layer.scale, scale)
        assert not layer.embedding.detach().any()
        # Adam's moments of the table carry over to the carrier
        for got, want in zip(_moments(restored, f"{arena}.embedding"),
                             _moments(state32, f"{arena}.embedding")):
            assert torch.equal(got, want)
    restored, loss = trainer8.train_on_batch(restored, _criteo_batch(9))
    assert torch.isfinite(loss)
    saver.close()


def test_checkpoint_migrates_int8_to_fp32_bitwise(tmp_path):
    _, state8 = _trained("int8")
    saver = _saved(tmp_path, state8)
    trainer32, _ = _trained("float32", steps=0)
    template = trainer32.init_state(1, _criteo_batch()["features"])
    restored = saver.maybe_restore(template, arena_convert=True)
    assert not [k for k in restored.model.state_dict() if
                k.endswith((".q8", ".scale"))]
    for arena in ("fm_embedding", "fm_linear"):
        layer = getattr(state8.model, arena)
        want = port_arena.dequantize_rows(layer.q8, layer.scale)
        got = getattr(restored.model, arena).embedding.detach()
        assert torch.equal(got, want)
        for g, w in zip(_moments(restored, f"{arena}.embedding"),
                        _moments(state8, f"{arena}.embedding")):
            assert torch.equal(g, w)
    restored, loss = trainer32.train_on_batch(restored, _criteo_batch(9))
    assert torch.isfinite(loss)
    saver.close()


def test_state_dict_migrations_match_jax_tree_converters():
    """quantize_arena_tree / dequantize_arena_tree over the port's state
    dict equal the JAX converters over the flax trees."""
    table = _table(seed=8, rows=64)
    sd = {"arena.embedding": torch.from_numpy(table),
          "dense.weight": torch.ones(2, 2)}
    quant = port_arena.quantize_arena_tree(sd, ["arena"])
    jparams, jquant = jax_arena.quantize_arena_tree(
        {"arena": {"embedding": jnp.asarray(table)}},
        {"arena": {"embedding": {"q8": 0, "scale": 0}}})
    np.testing.assert_array_equal(
        quant["arena.q8"].numpy(),
        np.asarray(jquant["arena"]["embedding"]["q8"]))
    np.testing.assert_array_equal(
        quant["arena.scale"].numpy(),
        np.asarray(jquant["arena"]["embedding"]["scale"]))
    assert not quant["arena.embedding"].any()
    assert port_arena.plane_prefixes(quant) == ["arena"]
    for node in ({"q8": 0, "scale": 0}, {"q8": 0}, [], {"embedding": 0}):
        assert port_arena.is_quantized_planes(node) == \
            jax_arena.is_quantized_planes(node)
    back = port_arena.dequantize_arena_tree(quant)
    jback = jax_arena.dequantize_arena_tree(
        {"arena": {"embedding": jparams["arena"]["embedding"]}}, jquant)
    assert set(back) == {"arena.embedding", "dense.weight"}
    np.testing.assert_array_equal(back["arena.embedding"].numpy(),
                                  np.asarray(jback["arena"]["embedding"]))
