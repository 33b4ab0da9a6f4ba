"""Shared by the port's orbax tests: checkpoints that the JAX package's
own `CheckpointSaver` writes on the CPU, one per kind of stored tree,
and comparisons of the port's reading with the JAX package's.

Kinds (each at a small size):
- `deepfm_f32`, `deepfm_int8`: DeepFM with Adam's state, the int8 one
  with its `quantized` collection;
- `deepfm_tiered`: the tiered DeepFM's cache planes (fm_embedding,
  fm_linear) after two store plans, with the store's sidecar
  (tests/test_torch_tiered.py's `_driven_pair`);
- `resnet`: ResNet (stage sizes 1, 1) with SGD momentum's trace and its
  `batch_stats`;
- `bert_bf16`: a 2-layer BERT (bf16 compute) with AdamW's state, its
  parameters and moments stored as bfloat16;
- `legacy_stack`: a pipelined 2-layer BERT whose GPipe stack is stored
  under its legacy name `stack`, as a checkpoint from before the rename
  holds it.

Unless `train` is asked for, a state is the model's shapes filled from a
seeded RNG (`_filled`): every leaf distinct, and no train step compiled.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.common.save_utils import CheckpointSaver as JaxSaver
from elasticdl_tpu.common.save_utils import _swap_tree_keys
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker.trainer import TrainState as JaxState
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common import orbax_read
from elasticdl_tpu_torch.worker.trainer import Trainer as PortTrainer

DEEPFM = "deepfm.deepfm_functional_api.custom_model"
DEEPFM_SMALL = "vocab_capacity=1024;embed_dim=8;lr=0.005"
RESNET = "cifar10.resnet.custom_model"
RESNET_SMALL = "stage_sizes=(1, 1)"
BERT = "bert.bert_finetune.custom_model"
BERT_SMALL = ("hidden=32;num_layers=2;heads=2;mlp_dim=64;max_len=16;"
              "vocab_size=32")
PIPE_SMALL = BERT_SMALL + ";pipeline_microbatches=2"

MODELS = {
    "deepfm_f32": (DEEPFM, DEEPFM_SMALL),
    "deepfm_int8": (DEEPFM, DEEPFM_SMALL + ";arena_dtype='int8'"),
    "resnet": (RESNET, RESNET_SMALL),
    "bert_bf16": (BERT, BERT_SMALL + ";bf16=True"),
    "legacy_stack": (BERT, PIPE_SMALL),
}


def batches(kind: str, n: int, seed: int = 0, rows: int = 8):
    """n batches of the kind's model."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind.startswith("deepfm"):
            from elasticdl_tpu_torch.model_zoo.deepfm.data import (
                synthetic_criteo,
            )
            dense, sparse, labels = synthetic_criteo(
                rows, seed=int(rng.randint(1 << 30)))
            features = {"dense": dense, "sparse": sparse}
        elif kind == "resnet":
            features = rng.rand(rows, 32, 32, 3).astype(np.float32)
            labels = rng.randint(0, 10, rows)
        else:
            features = {"input_ids": rng.randint(
                0, 32, (rows, 16)).astype(np.int32)}
            labels = rng.randint(0, 2, rows)
        out.append({"features": features,
                    "labels": np.asarray(labels, np.int32)})
    return out


def trainers(kind: str):
    """(JAX Trainer, port Trainer on the CPU) of the kind's model."""
    model_def, params = MODELS[kind]
    js = jax_spec("model_zoo", model_def, model_params=params)
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, model_def,
                                     model_params=params)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    param_sharding_fn=js.param_sharding)
    pt = PortTrainer(ps.model, ps.optimizer, ps.loss, device="cpu")
    return jt, pt


def _bf16(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _filled(state, seed: int):
    """`state` with every float leaf of its parameters, optimizer state
    and model state drawn anew from a seeded RNG (Adam's `nu` kept
    positive), and its step and Adam count set to `seed`: a state with
    every leaf distinct, made without compiling a train step."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        if not hasattr(x, "dtype"):
            return x
        name = jax.tree_util.keystr(path)
        if x.dtype == jnp.int8:            # an int8 arena's codes
            return jnp.asarray(rng.randint(-127, 128, x.shape), jnp.int8)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.full(x.shape, seed, x.dtype) if "count" in name \
                else x
        value = rng.randn(*x.shape).astype(np.float32)
        if "nu" in name or "scale" in name or "var" in name:
            value = np.abs(value) * 1e-3 + 1e-6
        return jnp.asarray(value, x.dtype)

    return state.replace(
        step=jnp.asarray(seed, jnp.int32),
        params=jax.tree_util.tree_map_with_path(fill, state.params),
        opt_state=jax.tree_util.tree_map_with_path(fill, state.opt_state),
        model_state=jax.tree_util.tree_map_with_path(fill,
                                                     state.model_state))


def _shaped_state(jt, features):
    """A JAX TrainState shaped as `jt.init_state` makes it (the same
    tree), its values zeros until `_filled`: the model's init is only
    traced (`jax.eval_shape`), which takes a fraction of running it."""
    kwargs = {"train": False} if jt._has_train_kwarg else {}
    shapes = dict(jax.eval_shape(
        lambda rng, x: jt.model.init(rng, x, **kwargs),
        jax.random.PRNGKey(0), jt._cast(features)))
    variables = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    params = {"params": variables.pop("params")}
    return JaxState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=jt.optimizer.init(params),
                    model_state=variables)


def write_jax_checkpoint(kind: str, ckpt: str, steps=(2,),
                         train: bool = False) -> dict:
    """A checkpoint of `kind` saved by the JAX package's CheckpointSaver
    at each of `steps`: the state after that many train steps when
    `train`, else the init with every leaf filled from a seeded RNG
    (`_filled`).  Returns {"trainer", "state" (the last), "batches",
    "store" (tiered)}."""
    if kind == "deepfm_tiered":
        return _write_tiered(ckpt)
    jt, _ = trainers(kind)
    data = batches(kind, max(steps) + 4)
    state = jt.init_state(jax.random.PRNGKey(0), data[0]["features"]) \
        if train else _shaped_state(jt, data[0]["features"])
    saver = JaxSaver(ckpt, keep_max=None, async_save=False)
    done = 0
    for step in steps:
        if train:
            for batch in data[done:step]:
                state, _ = jt.train_on_batch(state, batch)
        else:
            state = _filled(state, step)
        done = step
        saved = state
        if kind == "bert_bf16":
            saved = state.replace(params=_bf16(state.params),
                                  opt_state=_bf16(state.opt_state))
        if kind == "legacy_stack":
            saved = _swap_tree_keys(state, "gpipe_stack", "stack")
        assert saver.save(saved, force=True)
    saver.wait_until_finished()
    saver.close()
    return {"trainer": jt, "state": state, "batches": data}


def _write_tiered(ckpt: str) -> dict:
    from test_torch_tiered import _driven_pair

    jstore, jstate, pstore, pstate = _driven_pair()
    jstate = jstate.replace(step=jnp.asarray(2, jnp.int32))
    saver = JaxSaver(ckpt, keep_max=None, async_save=False)
    saver.attach_tiered_store(jstore)
    assert saver.save(jstate, force=True)
    saver.wait_until_finished()
    saver.close()
    return {"state": jstate, "store": jstore, "port_state": pstate,
            "port_store": pstore}


def flat_leaves(tree, path=""):
    """[(path, leaf)] of a nested dict/list tree (None leaves kept)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flat_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def assert_trees_bitwise_equal(jax_tree, port_tree) -> int:
    """The port's tree equals the JAX tree leaf for leaf: the same
    containers, keys and leaf kinds, arrays of the same dtype and shape
    with the same bytes (bfloat16 by its bits).  Returns the leaf
    count."""
    def same(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert isinstance(b, list) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        elif a is None:
            assert b is None, path
        elif isinstance(a, (int, float)):
            assert type(a) is type(b) and a == b, path
        else:
            want = np.asarray(a)
            if want.dtype == jnp.bfloat16:
                want = want.view(np.uint16)
            got = orbax_read.as_numpy(b)
            assert (got.dtype, got.shape) == (want.dtype, want.shape), path
            assert got.tobytes() == want.tobytes(), path

    same(jax_tree, port_tree, "")
    return len(flat_leaves(jax_tree))


def step_dir(ckpt: str, step: int) -> str:
    return os.path.join(ckpt, str(step))
