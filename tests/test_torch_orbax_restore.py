"""The port's restore paths on checkpoint directories that the JAX
package's `CheckpointSaver` wrote, on the CPU at small sizes:

- each kind of tests/_torch_orbax.py restores into the port's
  TrainState as the flax tree maps onto it (`params_from_jax`, the
  tested carry of the zoo parity tests): parameters, int8 planes and
  batch statistics bit for bit, Adam's, AdamW's and SGD momentum's
  state, the step; the tiered store's sidecar with it; the legacy
  `stack` key through the JAX restore's shim;
- training goes on as the JAX Trainer's does from the same step;
- a corrupt or incomplete newest step sends the port and the JAX
  package back to the same earlier step;
- a port job that resumes from a JAX directory writes its `state.pt`
  steps beside the orbax steps and never removes one;
- `serve --checkpoint_dir` on a JAX directory predicts as the JAX
  engine does over the same variables, and hot-reloads a newer orbax
  step;
- the committed fixtures of chip_smoke.py's `orbax_restore` phase
  restore and predict, and train on, as the JAX package recorded.

Tolerances are the parity tests' own: DeepFM's f32 losses 1e-5
(tests/test_torch_trainer.py), Wide & Deep's forward 1e-5 and losses
5e-5 (tests/test_torch_census.py), serving 1e-4
(tests/test_torch_serving_e2e.py), int8 serving 1e-4
(tests/test_torch_serving_int8.py).
"""

import hashlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_orbax import (
    MODELS,
    _shaped_state,
    batches,
    step_dir,
    trainers,
    write_jax_checkpoint,
)
from elasticdl_tpu.common.save_utils import CheckpointSaver as JaxSaver
from elasticdl_tpu.serving.engine import ServingEngine as JaxEngine
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import save_utils, zstd
from elasticdl_tpu_torch.common.export import feature_meta
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.orbax_read import read_tree
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.census import data as census_data
from elasticdl_tpu_torch.model_zoo.census import wide_and_deep
from elasticdl_tpu_torch.model_zoo.deepfm.data import (
    synthetic_criteo,
    write_dataset,
)
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.proto.service import ServingStub
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.serving.server import (
    from_tensor_proto,
    make_predict_request,
)

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "orbax")
DEEPFM_LOSS_TOL = 1e-5
CENSUS_FWD_TOL = 1e-5
CENSUS_LOSS_TOL = 5e-5
SERVE_TOL = 1e-4
INT8_TOL = 1e-4
KINDS = ("deepfm_f32", "deepfm_int8", "resnet", "bert_bf16",
         "legacy_stack")


def _np(tree):
    """numpy leaves; a bfloat16 one (a torch tensor from the port's
    reader) widened to float32, exactly."""
    return jax.tree.map(lambda x: x.float().numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x),
                        tree)


def _expected_state(template, raw):
    """The port state dict and {name: moments} that `raw` (the JAX
    restore_raw tree) maps to."""
    model = template.model
    params = raw["params"]["params"]
    collections = raw.get("model_state") or {}
    quantized = collections.get("quantized")
    stats = collections.get("batch_stats")
    want = params_from_jax(
        model, flatten_params(_np(params)),
        quantized=None if quantized is None else flatten_params(
            _np(quantized)),
        batch_stats=None if stats is None else flatten_params(_np(stats)))
    moments = {}
    for entry in raw["opt_state"]:
        if isinstance(entry, dict) and "mu" in entry:
            mu = params_from_jax(model, flatten_params(_np(
                entry["mu"]["params"])), quantized=flatten_params(
                _np(quantized)) if quantized else None)
            nu = params_from_jax(model, flatten_params(_np(
                entry["nu"]["params"])), quantized=flatten_params(
                _np(quantized)) if quantized else None)
            moments = {"exp_avg": mu, "exp_avg_sq": nu,
                       "step": float(entry["count"])}
        elif isinstance(entry, dict) and "trace" in entry:
            trace = params_from_jax(
                model, flatten_params(_np(entry["trace"]["params"])),
                batch_stats=flatten_params(_np(stats)) if stats else None)
            moments = {"momentum_buffer": trace}
    return want, moments


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_restore")
    return {kind: str(root / kind) for kind in KINDS
            if write_jax_checkpoint(kind, str(root / kind)) is not None}


@pytest.mark.parametrize("kind", KINDS)
def test_each_kind_restores_as_the_flax_tree_maps(kinds, kind):
    ckpt = kinds[kind]
    _, pt = trainers(kind)
    sample = batches(kind, 1)[0]["features"]
    template = pt.init_state(0, sample)
    saver = save_utils.CheckpointSaver(ckpt)
    assert saver.all_steps() == [2] and save_utils.port_steps(ckpt) == []
    assert save_utils.restorable_step(ckpt) == 2
    restored = saver.maybe_restore(template)
    saver.close()
    assert restored is template and restored.step == 2
    raw = read_tree(step_dir(ckpt, 2))
    if kind == "legacy_stack":
        from elasticdl_tpu_torch.common.orbax_read import swap_tree_keys
        raw = swap_tree_keys(raw, "stack", "gpipe_stack")
    want, moments = _expected_state(template, raw)
    got = restored.model.state_dict()
    assert set(want) <= set(got)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    opt = restored.optimizer
    names = [n for n, _ in restored.model.named_parameters()]
    for i, (name, param) in enumerate(restored.model.named_parameters()):
        state = opt.state[param]
        for key, mapped in moments.items():
            if key == "step":
                assert float(state["step"]) == mapped
            else:
                assert torch.equal(state[key], mapped[name].to(
                    state[key].dtype)), (name, key)
    assert len(names) == len(opt.state)


def test_the_tiered_store_restores_its_sidecar_with_the_step(tmp_path):
    from test_torch_tiered import _port_state, PLANES, NUM_FIELDS, \
        CACHE_ROWS
    from elasticdl_tpu_torch.store.tiered import TieredStore as PortStore

    ckpt = str(tmp_path / "ckpt")
    written = write_jax_checkpoint("deepfm_tiered", ckpt)
    store = PortStore(PLANES, NUM_FIELDS, CACHE_ROWS)
    saver = save_utils.CheckpointSaver(ckpt)
    saver.attach_tiered_store(store)
    restored = saver.maybe_restore(_port_state())
    saver.close()
    assert restored.step == 2
    jstate = written["state"]
    for name in PLANES:
        np.testing.assert_array_equal(
            getattr(restored.model, name).embedding.detach().numpy(),
            np.asarray(jstate.params["params"][name]["embedding"]))
    jstore = written["store"]
    assert store.host.size == jstore.host.size
    np.testing.assert_array_equal(store.cache.row_of, jstore.cache.row_of)


def test_training_goes_on_as_the_jax_trainer_does(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    written = write_jax_checkpoint("deepfm_f32", ckpt, steps=(2,),
                                   train=True)
    jt, pt = trainers("deepfm_f32")
    jstate, data = written["state"], written["batches"]
    template = pt.init_state(0, data[0]["features"])
    saver = save_utils.CheckpointSaver(ckpt)
    pstate = saver.maybe_restore(template)
    saver.close()
    gaps = []
    for batch in data[2:5]:
        jstate, jloss = jt.train_on_batch(jstate, batch)
        pstate, ploss = pt.train_on_batch(pstate, batch)
        gaps.append(abs(float(jloss) - float(ploss)))
    assert pstate.step == int(jstate.step) == 5
    assert max(gaps) < DEEPFM_LOSS_TOL, gaps


def _digests(step_path):
    out = {}
    for root, _, files in os.walk(step_path):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, step_path)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.mark.parametrize("damage", ["flipped_byte", "removed_file",
                                    "unlisted_flip"])
def test_a_damaged_newest_step_sends_both_packages_to_the_same_step(
        tmp_path, damage):
    ckpt = str(tmp_path / "ckpt")
    write_jax_checkpoint("deepfm_f32", ckpt, steps=(1, 2, 3))
    newest = step_dir(ckpt, 3)
    data_dir = os.path.join(newest, "default", "ocdbt.process_0", "d")
    biggest = max(os.listdir(data_dir), key=lambda n: os.path.getsize(
        os.path.join(data_dir, n)))
    path = os.path.join(data_dir, biggest)
    if damage == "removed_file":
        os.remove(path)
    else:
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 3] ^= 0x40
        with open(path, "wb") as f:
            f.write(bytes(blob))
    if damage == "unlisted_flip":
        # no manifest: the readers alone must find the damage
        os.remove(os.path.join(ckpt, ".manifests", "3.json"))
    jt, pt = trainers("deepfm_f32")
    sample = batches("deepfm_f32", 1)[0]["features"]
    jsaver = JaxSaver(ckpt, async_save=False)
    try:
        jrestored = jsaver.maybe_restore(_shaped_state(jt, sample))
    finally:
        jsaver.close()
    saver = save_utils.CheckpointSaver(ckpt)
    restored = saver.maybe_restore(pt.init_state(0, sample))
    saver.close()
    # with its manifest, either damage fails the newest step's check;
    # without it, a flip inside a chunk's zstd frame (orbax writes them
    # with no content checksum) changes values that neither package can
    # see, and both restore that step alike
    want = {"flipped_byte": 2, "removed_file": 2, "unlisted_flip": 3}[damage]
    assert int(jrestored.step) == restored.step == want
    assert save_utils.restorable_step(ckpt) == want


def test_a_port_job_resuming_from_a_jax_directory_keeps_its_orbax_steps(
        tmp_path):
    ckpt = str(tmp_path / "ckpt")
    model_def, params = MODELS["deepfm_f32"]
    write_jax_checkpoint("deepfm_f32", ckpt, steps=(1, 2))
    before = {s: _digests(step_dir(ckpt, s)) for s in (1, 2)}
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=128,
                                 n_val=8)
    job = api.run_local(cli.parse_args([
        "train", "--distribution_strategy", "Local",
        "--model_def", model_def, "--model_params", params,
        "--minibatch_size", "32", "--records_per_task", "64",
        "--num_workers", "1", "--use_bf16", "false",
        "--training_data", train_dir, "--checkpoint_dir", ckpt,
        "--checkpoint_steps", "2", "--keep_checkpoint_max", "1",
        "--device", "cpu"]), "train")
    assert job.ok
    # resumed from the JAX step 2: four more steps, saved at 4 and 6,
    # and the sweep kept the newest port step only
    assert job.owner.step == 6
    assert save_utils.port_steps(ckpt) == [6]
    assert save_utils.committed_steps(ckpt) == [1, 2, 6]
    for step in (1, 2):
        assert _digests(step_dir(ckpt, step)) == before[step]
        assert save_utils.verify_step(ckpt, step)
    # and the JAX package still restores its own step
    jsaver = JaxSaver(ckpt, async_save=False)
    try:
        assert 2 in jsaver.all_steps()
    finally:
        jsaver.close()


def test_serve_a_jax_directory_as_the_jax_engine_does(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    model_def, params = MODELS["deepfm_f32"]
    written = write_jax_checkpoint("deepfm_f32", ckpt, steps=(1,))
    dense, sparse, _ = synthetic_criteo(8, seed=3)
    sample = {"dense": dense, "sparse": sparse}
    args = cli.parse_args([
        "serve", "--model_def", model_def, "--model_params", params,
        "--batch_buckets", "2,8", "--max_batch_latency_ms", "2",
        "--device", "cpu", "--checkpoint_dir", ckpt,
        "--feature_spec", __import__("json").dumps(feature_meta(sample)),
        "--reload_poll_seconds", "3600"])
    server = api.build_serving_server(args)
    jt = written["trainer"]

    def jax_predictions(step):
        jsaver = JaxSaver(ckpt, async_save=False)
        try:
            raw = jsaver.restore_raw(step)
        finally:
            jsaver.close()
        engine = JaxEngine(jt.model, {"params": raw["params"]["params"]},
                           step=step, feature_spec=feature_meta(sample),
                           buckets=(2, 8))
        return np.asarray(engine.predict(sample, 8)[0])

    try:
        port = server.start(0)
        stub = ServingStub(f"127.0.0.1:{port}", timeout=60.0)
        resp = stub.predict(make_predict_request(sample))
        assert resp.code == spb.SERVING_OK, resp.error
        assert resp.model_step == 1
        np.testing.assert_allclose(from_tensor_proto(resp.predictions),
                                   jax_predictions(1), rtol=SERVE_TOL,
                                   atol=SERVE_TOL)
        # the JAX job's next step lands: the reloader swaps onto it
        write_jax_checkpoint("deepfm_f32", str(tmp_path / "next"),
                             steps=(4,))
        shutil.copytree(step_dir(str(tmp_path / "next"), 4),
                        step_dir(ckpt, 4))
        assert server.reloader.check_once()
        resp = stub.predict(make_predict_request(sample))
        assert resp.model_step == 4
        np.testing.assert_allclose(from_tensor_proto(resp.predictions),
                                   jax_predictions(4), rtol=SERVE_TOL,
                                   atol=SERVE_TOL)
        stub.close()
    finally:
        server.stop()


def test_an_int8_jax_step_converts_only_when_asked(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    model_def, params = MODELS["deepfm_f32"]
    write_jax_checkpoint("deepfm_int8", ckpt)
    spec = get_model_spec(ZOO_DIR, model_def, model_params=params)
    sample = batches("deepfm_int8", 1)[0]["features"]
    with pytest.raises(save_utils.ArenaDtypeMismatch):
        ServingEngine.from_checkpoint(ckpt, spec, sample, buckets=(8,),
                                      device="cpu")
    engine = ServingEngine.from_checkpoint(ckpt, spec, sample, buckets=(8,),
                                           device="cpu", arena_convert=True)
    # the JAX package's own int8 -> fp32 conversion of the stored tree
    from elasticdl_tpu.layers.arena import dequantize_arena_tree

    raw = read_tree(step_dir(ckpt, 2))
    tables = dequantize_arena_tree(raw["params"]["params"],
                                   raw["model_state"]["quantized"])
    for arena in ("fm_embedding", "fm_linear"):
        np.testing.assert_array_equal(
            engine.variables[f"{arena}.embedding"].numpy(),
            np.asarray(tables[arena]["embedding"]))


# ---- the committed fixtures of chip_smoke.py's orbax_restore phase --------


def _census_argv(job, data, ckpt):
    flag = "--validation_data" if job == "evaluate" else "--training_data"
    return [job, "--distribution_strategy", "Local",
            "--model_def", "census.wide_and_deep.custom_model",
            "--model_params", "vocab_capacity=4096;embed_dim=8",
            "--minibatch_size", "64", "--use_bf16", "false", flag, data,
            "--records_per_task", "256", "--num_epochs", "1",
            "--checkpoint_dir_for_init", ckpt, "--device", "cpu"]


def test_fixture_a_predicts_and_trains_as_the_jax_package_recorded(
        tmp_path):
    """chip_smoke.py's orbax_restore path on the CPU: Local jobs from a
    copy of fixture (a) through --checkpoint_dir_for_init, an evaluate
    job's owner predicting the recorded logits, then a train job taking
    the 4 recorded steps with the recorded losses."""
    ckpt = str(tmp_path / "census")
    shutil.copytree(os.path.join(FIXTURES, "census"), ckpt)
    rows = census_data.synthetic_census(256, seed=7)
    predict_csv = census_data.write_csv(str(tmp_path / "predict.csv"), rows)
    ev = api.run_local(cli.parse_args(_census_argv(
        "evaluate", predict_csv, ckpt)), "evaluate")
    assert ev.exit_code == 0 and ev.owner.step == 8
    got = ev.owner.predict_batch(
        {"features": wide_and_deep.feed(rows)["features"]})
    np.testing.assert_allclose(
        np.asarray(got).reshape(-1),
        np.load(os.path.join(FIXTURES, "census_predictions.npy")),
        atol=CENSUS_FWD_TOL, rtol=0)
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    census_data.write_csv(str(train_dir / "census-train.csv"),
                          census_data.synthetic_census(4 * 64, seed=9))
    job = api.run_local(cli.parse_args(_census_argv(
        "train", str(train_dir), ckpt)), "train")
    assert job.exit_code == 0 and job.owner.step == 12
    losses = [float(loss) for w in job.workers for loss in w.losses]
    np.testing.assert_allclose(
        losses, np.load(os.path.join(FIXTURES, "census_losses.npy")),
        atol=CENSUS_LOSS_TOL, rtol=0)
    # the job wrote nothing into the directory it started from
    assert save_utils.committed_steps(ckpt) == [8]


def test_fixture_b_serves_its_int8_planes_as_recorded(tmp_path):
    ckpt = str(tmp_path / "deepfm_int8")
    shutil.copytree(os.path.join(FIXTURES, "deepfm_int8"), ckpt)
    spec = get_model_spec(
        ZOO_DIR, "deepfm.deepfm_functional_api.custom_model",
        model_params="vocab_capacity=4096;embed_dim=16;arena_dtype='int8'")
    dense, sparse, _ = synthetic_criteo(64, seed=5)
    sample = {"dense": dense, "sparse": sparse}
    zstd.reset_served()
    engine = ServingEngine.from_checkpoint(ckpt, spec, sample,
                                           buckets=(64,), device="cpu")
    assert zstd.served()["native"] > 0 and zstd.served()["python"] == 0
    assert engine.step == 2
    assert engine.variables["fm_embedding.q8"].dtype == torch.int8
    got, _ = engine.predict(sample, 64)
    np.testing.assert_allclose(
        got, np.load(os.path.join(FIXTURES, "deepfm_int8_predictions.npy")),
        atol=INT8_TOL, rtol=INT8_TOL)


def test_a_cluster_rank_and_the_master_cutoff_take_a_jax_directory(
        tmp_path):
    """A relaunched cluster rank (worker/spmd.py `_restore`, a world of
    one) and the master's journal cutoff (master/main.py
    `latest_model_checkpoint_step`) read the JAX directory: the newest
    orbax step, then the one before once the newest loses a file."""
    from elasticdl_tpu_torch.master.main import latest_model_checkpoint_step
    from elasticdl_tpu_torch.parallel.mesh import DataMesh
    from elasticdl_tpu_torch.worker.spmd import SPMDWorker

    ckpt = str(tmp_path / "ckpt")
    write_jax_checkpoint("deepfm_f32", ckpt, steps=(1, 2))
    _, pt = trainers("deepfm_f32")
    sample = batches("deepfm_f32", 1)[0]["features"]

    def restored():
        rank = SPMDWorker.__new__(SPMDWorker)
        rank.process_id = 0
        rank.mesh = DataMesh(1, 0, torch.device("cpu"), "", None)
        rank._saver = save_utils.CheckpointSaver(ckpt)
        rank.state = pt.init_state(0, sample)
        rank._restore(rank._check_newest_step())
        return rank.state

    state = restored()
    assert state.step == 2 and latest_model_checkpoint_step(ckpt) == 2
    want = save_utils.CheckpointSaver(ckpt).maybe_restore(
        pt.init_state(0, sample))
    for (name, a), b in zip(state.model.state_dict().items(),
                            want.model.state_dict().values()):
        assert torch.equal(a, b), name
    os.remove(os.path.join(step_dir(ckpt, 2), "default", "_METADATA"))
    assert restored().step == 1 and latest_model_checkpoint_step(ckpt) == 1
