"""The int8 serving engine on the CPU: `ServingEngine.from_checkpoint(...,
arena_convert=True)` serves an fp32 DeepFM checkpoint through an
`arena_dtype="int8"` config and an int8 checkpoint through an fp32
config; in both directions the served predictions equal the converted
state's own forward bit for bit, and the hot reloader converts each new
step the same way.  Against the JAX int8 engine on the same converted
arrays (the JAX init, quantized by each side's converter, which agree
bit for bit) the predictions agree within INT8_TOL.
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.layers import arena as jax_arena
from elasticdl_tpu.serving.engine import ServingEngine as JaxEngine
from elasticdl_tpu_torch.common.export import feature_meta
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.save_utils import (
    ArenaDtypeMismatch,
    CheckpointSaver,
)
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.serving.engine import (
    ServingEngine,
    build_state_template,
)
from elasticdl_tpu_torch.serving.reloader import CheckpointReloader
from elasticdl_tpu_torch.worker.trainer import Trainer

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
SMALL = "vocab_capacity=4096;embed_dim=8;lr=0.01"
BUCKETS = (1, 4, 16)
# f32 on both sides on the same codes and scales; the JAX forward sums in
# another order (XLA's fusions): ~1e-6 on these logits.
INT8_TOL = 1e-4


def _spec(arena_dtype):
    return get_model_spec(ZOO_DIR, MODEL,
                          model_params=f"{SMALL};arena_dtype='{arena_dtype}'")


def _features(rows, seed):
    dense, sparse, _ = synthetic_criteo(rows, seed=seed)
    return {"dense": dense, "sparse": sparse}


def _padded(x, bucket):
    """Rows padded with zeros to the bucket, as the engine pads them."""
    rows = len(x["dense"])
    return {k: np.concatenate([v, np.zeros((bucket - rows,) + v.shape[1:],
                                            v.dtype)])
            for k, v in x.items()}


def _own_forward(model, x):
    model.eval()
    with torch.no_grad():
        return model({k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in x.items()}).numpy()


@pytest.fixture(scope="module")
def jax_init():
    sample = _features(2, seed=0)
    js = jax_spec("model_zoo", MODEL, model_params=SMALL)
    return sample, dict(js.model.init(jax.random.PRNGKey(0), sample))


def _checkpoint(tmp_path, arena_dtype, jax_variables, sample, step=3,
                jax_quantized=None):
    """A checkpoint at `step` of an `arena_dtype` model holding the JAX
    init's weights (int8: its planes from `jax_quantized`)."""
    spec = _spec(arena_dtype)
    state = Trainer(spec.model, spec.optimizer, spec.loss,
                    device="cpu").init_state(0, sample)
    state.model.load_state_dict(params_from_jax(
        state.model, flatten_params(jax.tree.map(np.asarray,
                                                 jax_variables)),
        quantized=None if jax_quantized is None else flatten_params(
            jax.tree.map(np.asarray, jax_quantized))), strict=True)
    state.step = step
    saver = CheckpointSaver(str(tmp_path))
    saver.save(state)
    saver.close()
    return state


def _jax_int8(jax_init):
    sample, variables = jax_init
    js8 = jax_spec("model_zoo", MODEL,
                   model_params=f"{SMALL};arena_dtype='int8'")
    template = js8.model.init(jax.random.PRNGKey(0), sample)["quantized"]
    params, quantized = jax_arena.quantize_arena_tree(
        variables["params"], template)
    return js8, params, quantized


@pytest.mark.parametrize("have,want", [("float32", "int8"),
                                       ("int8", "float32")])
def test_arena_convert_serves_the_converted_states_own_forward(
        tmp_path, jax_init, have, want):
    sample, variables = jax_init
    quantized = None
    if have == "int8":
        _, params, quantized = _jax_int8(jax_init)
        variables = {"params": params}
    _checkpoint(tmp_path, have, variables["params"], sample,
                jax_quantized=quantized)
    spec = _spec(want)
    with pytest.raises(ArenaDtypeMismatch, match="arena_convert=True"):
        ServingEngine.from_checkpoint(str(tmp_path), spec, sample,
                                      buckets=BUCKETS, device="cpu")
    engine = ServingEngine.from_checkpoint(
        str(tmp_path), spec, sample, buckets=BUCKETS, device="cpu",
        arena_convert=True)
    assert engine.step == 3 and engine.arena_convert
    served = engine.variables
    assert ("fm_embedding.q8" in served) == (want == "int8")
    # the converted state, restored on its own
    saver = CheckpointSaver(str(tmp_path))
    restored = saver.restore_step(
        3, build_state_template(spec, sample, "cpu"), arena_convert=True)
    saver.close()
    for name, tensor in restored.model.state_dict().items():
        assert torch.equal(served[name], tensor), name
    if want == "int8":
        assert served["fm_embedding.q8"].dtype == torch.int8
        assert not served["fm_embedding.embedding"].any()   # carrier
    for rows, bucket in ((1, 1), (3, 4), (16, 16), (9, 16)):
        x = _features(rows, seed=20 + rows)
        got, step = engine.predict(x, rows)
        assert step == 3
        want_preds = _own_forward(restored.model, _padded(x, bucket))[:rows]
        np.testing.assert_array_equal(got, want_preds)


def test_int8_engine_matches_the_jax_int8_engine(tmp_path, jax_init):
    sample, variables = jax_init
    js8, jparams, jquant = _jax_int8(jax_init)
    _checkpoint(tmp_path, "float32", variables["params"], sample)
    engine = ServingEngine.from_checkpoint(
        str(tmp_path), _spec("int8"), sample, buckets=BUCKETS,
        device="cpu", arena_convert=True)
    # the two converters give the same codes and scales
    for arena in ("fm_embedding", "fm_linear"):
        planes = jquant[arena]["embedding"]
        for leaf in ("q8", "scale"):
            np.testing.assert_array_equal(
                engine.variables[f"{arena}.{leaf}"].numpy(),
                np.asarray(planes[leaf]))
    jax_engine = JaxEngine(
        js8.model, {"params": jparams, "quantized": jquant}, step=3,
        feature_spec=feature_meta(sample), buckets=BUCKETS)
    for rows in (1, 3, 16):
        x = _features(rows, seed=40 + rows)
        got, _ = engine.predict(x, rows)
        want, _ = jax_engine.predict(x, rows)
        np.testing.assert_allclose(got, np.asarray(want), rtol=INT8_TOL,
                                   atol=INT8_TOL)


def test_the_reloader_converts_each_new_step(tmp_path, jax_init):
    """An int8 engine serving an fp32 job's directory hot-swaps the job's
    next step through the same conversion."""
    sample, variables = jax_init
    state = _checkpoint(tmp_path, "float32", variables["params"], sample)
    engine = ServingEngine.from_checkpoint(
        str(tmp_path), _spec("int8"), sample, buckets=BUCKETS,
        device="cpu", arena_convert=True)
    reloader = CheckpointReloader(engine, str(tmp_path))
    try:
        with torch.no_grad():
            state.model.fm_embedding.embedding.mul_(2.0)
        state.step = 4
        saver = CheckpointSaver(str(tmp_path))
        saver.save(state)
        saver.close()
        before = engine.variables["fm_embedding.scale"].clone()
        assert reloader.check_once()
        assert engine.step == 4 and reloader.rejected_count == 0
        after = engine.variables["fm_embedding.scale"]
        np.testing.assert_array_equal(after.numpy(), 2.0 * before.numpy())
    finally:
        reloader.stop()
