"""Write the orbax checkpoints that the port reads in chip_smoke.py's
`orbax_restore` phase (the card's machine has no JAX to write them) and
that tests/test_torch_orbax*.py check.

Both are written by the JAX package on the CPU, with its own
`CheckpointSaver` (orbax; the version is recorded in `versions.json`),
from fixed seeds:

(a) `census/`: Wide & Deep (census) at the zoo's width (vocab_capacity
    4096, embed_dim 8, fp32, Adam at lr 1e-3), after 8 steps of the JAX
    Local runner over 512 `synthetic_census` records (batch 64, one
    task, one epoch, a checkpoint every 8 steps).  Beside it:
    `census_predictions.npy`, the JAX model's logits on the 256 records
    of `synthetic_census(256, seed=7)`, and `census_losses.npy`, the
    losses of 4 further JAX steps from the checkpoint on the batches of
    64 records of `synthetic_census(256, seed=9)`, in order.
(b) `deepfm_int8/`: DeepFM with the int8 arena (vocab_capacity 4096,
    embed_dim 16), after 2 JAX Trainer steps on `synthetic_criteo(128,
    seed=3)` (batch 64), saved at step 2.  Beside it:
    `deepfm_int8_predictions.npy`, its logits on `synthetic_criteo(64,
    seed=5)`.

Run from the repository's root (it writes tests/torch_fixtures/orbax/
unless given another directory):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_orbax_fixtures.py
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "torch_fixtures", "orbax")

CENSUS = "census.wide_and_deep.custom_model"
CENSUS_PARAMS = "vocab_capacity=4096;embed_dim=8"
CENSUS_RECORDS = 512
CENSUS_BATCH = 64
CENSUS_STEPS = 8
PREDICT_SEED, PREDICT_ROWS = 7, 256
CONTINUE_SEED, CONTINUE_STEPS = 9, 4

DEEPFM = "deepfm.deepfm_functional_api.custom_model"
DEEPFM_PARAMS = "vocab_capacity=4096;embed_dim=16;arena_dtype='int8'"
DEEPFM_BATCH, DEEPFM_STEPS = 64, 2
DEEPFM_TRAIN_SEED, DEEPFM_PREDICT_SEED = 3, 5


def census_batches(seed: int, steps: int, batch: int = CENSUS_BATCH):
    """The zoo feed's batches of `synthetic_census(steps * batch, seed)`
    (the port's feed and data give the same bits)."""
    from model_zoo.census import data, wide_and_deep

    rows = data.synthetic_census(steps * batch, seed=seed)
    return [wide_and_deep.feed(rows[i * batch:(i + 1) * batch])
            for i in range(steps)]


def criteo_features(rows: int, seed: int):
    from model_zoo.deepfm.data import synthetic_criteo

    dense, sparse, labels = synthetic_criteo(rows, seed=seed)
    return {"dense": dense, "sparse": sparse}, labels.astype("int32")


def _jax_trainer(model_def: str, params: str):
    from elasticdl_tpu.common.model_handler import get_model_spec
    from elasticdl_tpu.worker.trainer import Trainer

    spec = get_model_spec("model_zoo", model_def, model_params=params)
    return Trainer(spec.model, spec.optimizer, spec.loss)


def _restore(ckpt: str, trainer, sample):
    import jax

    from elasticdl_tpu.common.save_utils import CheckpointSaver

    saver = CheckpointSaver(ckpt, async_save=False)
    try:
        return saver.maybe_restore(
            trainer.init_state(jax.random.PRNGKey(0), sample))
    finally:
        saver.close()


def write_census(out: str, work: str) -> None:
    import numpy as np

    from elasticdl_tpu.client import main as jax_cli
    from model_zoo.census import data

    train_dir, _ = data.write_dataset(os.path.join(work, "census"),
                                      n_train=CENSUS_RECORDS, n_val=8)
    ckpt = os.path.join(out, "census")
    argv = ["elasticdl", "train", "--model_zoo", "model_zoo",
            "--model_def", CENSUS, "--model_params", CENSUS_PARAMS,
            "--distribution_strategy", "Local",
            "--training_data", train_dir, "--num_workers", "1",
            "--minibatch_size", str(CENSUS_BATCH), "--num_epochs", "1",
            "--records_per_task", str(CENSUS_RECORDS),
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(CENSUS_STEPS)]
    old = sys.argv
    sys.argv = argv
    try:
        if jax_cli.main() != 0:
            raise RuntimeError("the JAX Local census job failed")
    finally:
        sys.argv = old
    trainer = _jax_trainer(CENSUS, CENSUS_PARAMS)
    from model_zoo.census import wide_and_deep

    predict = wide_and_deep.feed(
        data.synthetic_census(PREDICT_ROWS, seed=PREDICT_SEED))["features"]
    state = _restore(ckpt, trainer, predict)
    if int(state.step) != CENSUS_STEPS:
        raise RuntimeError(f"the census checkpoint is at step "
                           f"{int(state.step)}, not {CENSUS_STEPS}")
    np.save(os.path.join(out, "census_predictions.npy"),
            np.asarray(trainer.predict_on_batch(state, predict), np.float32))
    losses = []
    for batch in census_batches(CONTINUE_SEED, CONTINUE_STEPS):
        state, loss = trainer.train_on_batch(state, batch)
        losses.append(float(loss))
    np.save(os.path.join(out, "census_losses.npy"),
            np.asarray(losses, np.float32))


def write_deepfm_int8(out: str) -> None:
    import jax
    import numpy as np

    from elasticdl_tpu.common.save_utils import CheckpointSaver

    trainer = _jax_trainer(DEEPFM, DEEPFM_PARAMS)
    features, labels = criteo_features(DEEPFM_BATCH * DEEPFM_STEPS,
                                       DEEPFM_TRAIN_SEED)
    state = trainer.init_state(jax.random.PRNGKey(0), features)
    for i in range(DEEPFM_STEPS):
        rows = slice(i * DEEPFM_BATCH, (i + 1) * DEEPFM_BATCH)
        state, _ = trainer.train_on_batch(state, {
            "features": {k: v[rows] for k, v in features.items()},
            "labels": labels[rows]})
    saver = CheckpointSaver(os.path.join(out, "deepfm_int8"),
                            async_save=False)
    saver.save(state, force=True)
    saver.wait_until_finished()
    saver.close()
    predict, _ = criteo_features(DEEPFM_BATCH, DEEPFM_PREDICT_SEED)
    np.save(os.path.join(out, "deepfm_int8_predictions.npy"),
            np.asarray(trainer.predict_on_batch(state, predict), np.float32))


def main(out: str = OUT) -> str:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import jax
    import orbax.checkpoint as ocp

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with tempfile.TemporaryDirectory() as work:
        write_census(out, work)
    write_deepfm_int8(out)
    with open(os.path.join(out, "versions.json"), "w") as f:
        json.dump({"orbax": ocp.__version__, "jax": jax.__version__}, f,
                  indent=1, sort_keys=True)
        f.write("\n")
    return out


if __name__ == "__main__":
    print(main(*sys.argv[1:]))
