"""The port's model export (elasticdl_tpu_torch/common/export.py) and the
engines built from it, on the CPU: a round trip, the metadata keys
against the JAX export's, the feature-key drift guard's message, the
refusal of a JAX export directory, `saved_model=True` writing a torch
export (`saved_model/model.pt2`) in the TF SavedModel's place, each of
MNIST, DeepFM and a small BERT exported, run in a process that imports
nothing of the zoo (serving/run_export.py) and held against the JAX
forward through `params_from_jax` at the tolerances of
tests/test_saved_model_export.py (1e-4 MNIST and DeepFM, 2e-3 BERT),
also at a batch of 3, a failed export recorded while the weights stand,
a Local `train --output` job that writes an export, and
`ServingEngine.from_export` against `from_checkpoint` of the same step,
bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import export as jax_export
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.worker.trainer import TrainState as JaxTrainState
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import export
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.deepfm.data import (
    synthetic_criteo,
    write_dataset,
)
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.worker.trainer import Trainer, TrainState
from tests import _torch_zoo_parity as zoo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
BUCKETS = (1, 4, 16)


def _features(rows, seed):
    dense, sparse, _ = synthetic_criteo(rows, seed=seed)
    return {"dense": dense, "sparse": sparse}


@pytest.fixture(scope="module")
def carried():
    """A port state and a JAX state holding the same weights (the JAX
    init carried across), at step 7."""
    sample = _features(2, seed=0)
    js = jax_spec("model_zoo", MODEL, model_params=PARAMS)
    variables = dict(js.model.init(jax.random.PRNGKey(0), sample))
    params = {"params": variables.pop("params")}
    jstate = JaxTrainState(
        step=jnp.asarray(7, jnp.int32), params=params,
        opt_state=js.optimizer.init(params), model_state=variables)
    spec = get_model_spec(ZOO_DIR, MODEL, model_params=PARAMS)
    state = Trainer(spec.model, spec.optimizer, spec.loss,
                    device="cpu").init_state(0, sample)
    state.model.load_state_dict(params_from_jax(
        state.model, flatten_params(jax.tree.map(
            np.asarray, params["params"]))), strict=True)
    state.step = 7
    return {"sample": sample, "js": js, "jstate": jstate, "spec": spec,
            "state": state}


def test_export_round_trips_every_parameter_and_buffer(carried, tmp_path):
    spec, state = carried["spec"], carried["state"]
    path = export.export_model(state, spec, str(tmp_path),
                               sample_features=carried["sample"])
    assert path == os.path.join(str(tmp_path), "params.pt")
    loaded = export.load_exported(str(tmp_path), template=state.model)
    want = state.model.state_dict()
    assert set(loaded) == set(want)
    for name, tensor in want.items():
        assert loaded[name].device.type == "cpu"
        assert torch.equal(loaded[name], tensor), name
    meta = export.read_export_meta(str(tmp_path))
    assert meta["step"] == 7 and meta["framework"] == "elasticdl-tpu-torch"
    assert meta["features"] == {
        "dense": {"shape": [13], "dtype": "float32"},
        "sparse": {"shape": [26], "dtype": "int32"}}
    # a template of another width is refused, naming what differs
    other = get_model_spec(ZOO_DIR, MODEL,
                           model_params="vocab_capacity=4096;embed_dim=4")
    with pytest.raises(ValueError, match="does not match the model"):
        export.load_exported(str(tmp_path), template=other.model)


def test_meta_keys_equal_the_jax_exports(carried, tmp_path):
    jax_export.export_model(carried["jstate"], carried["js"],
                            str(tmp_path / "jax"),
                            sample_features=carried["sample"])
    export.export_model(carried["state"], carried["spec"],
                        str(tmp_path / "port"),
                        sample_features=carried["sample"])
    with open(tmp_path / "jax" / "export_meta.json") as f:
        jmeta = json.load(f)
    meta = export.read_export_meta(str(tmp_path / "port"))
    assert set(meta) == set(jmeta)
    for key in ("step", "model_class", "features"):
        assert meta[key] == jmeta[key], key
    assert jmeta["framework"] == "elasticdl-tpu"
    assert meta["framework"] == "elasticdl-tpu-torch"


def test_drift_guard_message_matches_jax(carried, tmp_path):
    jax_dir, port_dir = str(tmp_path / "x"), str(tmp_path / "y")
    jax_export.export_model(carried["jstate"], carried["js"], jax_dir,
                            sample_features=carried["sample"])
    export.export_model(carried["state"], carried["spec"], port_dir,
                        sample_features=carried["sample"])
    for expected in (["dense"], {"dense": 0, "ids": 0},
                     np.zeros((1, 3))):
        with pytest.raises(ValueError) as jerr:
            jax_export.load_exported(jax_dir, None,
                                     expected_features=expected,
                                     check_only=True)
        with pytest.raises(ValueError) as perr:
            export.load_exported(port_dir, expected_features=expected,
                                 check_only=True)
        assert str(perr.value).replace(port_dir, "D") == \
            str(jerr.value).replace(jax_dir, "D")
    # keys that agree pass; so does an export without a signature
    assert export.load_exported(port_dir, expected_features=[
        "sparse", "dense"], check_only=True) is None
    bare = str(tmp_path / "bare")
    export.export_model(carried["state"], carried["spec"], bare)
    assert "features" not in export.read_export_meta(bare)
    export.load_exported(bare, expected_features=["x"])


def test_a_jax_export_directory_is_refused(carried, tmp_path):
    jax_dir = str(tmp_path / "jax")
    jax_export.export_model(carried["jstate"], carried["js"], jax_dir,
                            sample_features=carried["sample"])
    for call in (lambda: export.read_export_meta(jax_dir),
                 lambda: export.load_exported(jax_dir),
                 lambda: ServingEngine.from_export(
                     jax_dir, carried["spec"], device="cpu")):
        with pytest.raises(ValueError, match="params.msgpack"):
            call()
    # refused on the weights file alone too, whatever the meta says
    os.remove(os.path.join(jax_dir, "export_meta.json"))
    with pytest.raises(ValueError, match="elasticdl-tpu"):
        export.load_exported(jax_dir)


def test_saved_model_writes_a_torch_export(carried, tmp_path):
    export.export_model(carried["state"], carried["spec"], str(tmp_path),
                        saved_model=True, sample_features=carried["sample"])
    meta = export.read_export_meta(str(tmp_path))
    assert meta["saved_model"] == "ok"
    program = export.load_saved_model(str(tmp_path / "saved_model"))
    feats = {k: torch.from_numpy(v)
             for k, v in _features(5, seed=4).items()}
    with torch.no_grad():
        want = carried["state"].model(feats)
    assert torch.equal(program.module()(feats), want)
    # the weights export stands beside it
    export.load_exported(str(tmp_path), template=carried["state"].model)
    with pytest.raises(RuntimeError, match="no sample features"):
        export.export_model(carried["state"], carried["spec"],
                            str(tmp_path / "b"), saved_model=True)


def test_a_failed_torch_export_is_recorded_and_the_weights_stand(
        carried, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("cannot trace this model")

    monkeypatch.setattr(torch.export, "export", refuse)
    export.export_model(carried["state"], carried["spec"], str(tmp_path),
                        saved_model=True, sample_features=carried["sample"])
    meta = export.read_export_meta(str(tmp_path))
    assert meta["saved_model"] == "failed: cannot trace this model"
    assert not os.path.exists(tmp_path / "saved_model" / "model.pt2")
    export.load_exported(str(tmp_path), template=carried["state"].model)


def _mnist_case():
    js, _, ps, pt = zoo.trainers("mnist.mnist_functional_api.custom_model")
    rng = np.random.RandomState(0)
    sample = rng.rand(8, 784).astype(np.float32)
    variables = js.model.init(jax.random.PRNGKey(0), sample)
    state = pt.init_state(0, sample)
    zoo.carry(state.model, variables["params"])
    return (ps, state, sample, {"features": sample},
            lambda f: js.model.apply(variables, f["features"]), 1e-4)


def _deepfm_case():
    js, _, ps, pt = zoo.trainers(MODEL, PARAMS)
    sample = _features(8, seed=1)
    variables = js.model.init(jax.random.PRNGKey(1), sample)
    state = pt.init_state(0, sample)
    zoo.carry(state.model, variables["params"])
    return (ps, state, sample, sample,
            lambda f: js.model.apply(variables, f), 1e-4)


def _bert_case():
    from elasticdl_tpu_torch.model_zoo.bert import bert_finetune as port_bert
    from model_zoo.bert import bert_finetune as jax_bert

    cfg = dict(hidden=32, num_layers=2, heads=2, mlp_dim=64, max_len=16,
               vocab_size=64)
    ids = np.random.RandomState(2).randint(
        0, 64, (8, 16)).astype(np.int32)
    jmodel = jax_bert.custom_model(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(2), {"input_ids": ids})
    ps = get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                        model_params=";".join(f"{k}={v}"
                                              for k, v in cfg.items()))
    model = port_bert.custom_model(**cfg)
    zoo.carry(model, variables["params"])
    state = TrainState(step=0, model=model, optimizer=None)
    return (ps, state, {"input_ids": ids}, {"input_ids": ids},
            lambda f: jmodel.apply(variables, f), 2e-3)


@pytest.mark.parametrize("case", [_mnist_case, _deepfm_case, _bert_case],
                         ids=["mnist", "deepfm", "bert"])
def test_exports_run_without_the_zoo_and_match_the_jax_forward(case,
                                                               tmp_path):
    spec, state, sample, feats, jax_forward, tol = case()
    export.export_model(state, spec, str(tmp_path), saved_model=True,
                        sample_features=sample)
    assert export.read_export_meta(str(tmp_path))["saved_model"] == "ok"
    model = str(tmp_path / "saved_model" / "model.pt2")
    three = {k: v[:3] for k, v in feats.items()}
    argv = []
    for name, f in (("full", feats), ("three", three)):
        np.savez(tmp_path / f"{name}_in.npz", **f)
        argv += [model, str(tmp_path / f"{name}_in.npz"),
                 str(tmp_path / f"{name}_out.npz")]
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.run_export",
         "--device", "cpu", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not any(".model_zoo" in m for m in report["port_modules"])
    assert report["flash_launches"] == 0      # the CPU runs the plain op
    # rows are independent: the 3-row run is held against the JAX
    # forward's first 3 rows (the JAX BERT shards its batch over the
    # 8-device CPU mesh, so it takes no batch of 3)
    want = np.asarray(jax_forward(feats), np.float32)
    for name, rows in (("full", want), ("three", want[:3])):
        got = np.load(tmp_path / f"{name}_out.npz")["out"]
        assert got.shape == rows.shape
        np.testing.assert_allclose(got, rows, atol=tol)


@pytest.fixture(scope="module")
def trained_job(tmp_path_factory):
    """A Local `train --output` job at a small size with a checkpoint of
    its last step."""
    root = tmp_path_factory.mktemp("export_job")
    train_dir, val_dir = write_dataset(str(root / "data"), n_train=512,
                                       n_val=128)
    out, ckpt = str(root / "export"), str(root / "ckpt")
    args = cli.parse_args([
        "train", "--distribution_strategy", "Local", "--model_def", MODEL,
        "--model_params", PARAMS, "--minibatch_size", "64",
        "--records_per_task", "128", "--use_bf16", "false",
        "--training_data", train_dir, "--validation_data", val_dir,
        "--checkpoint_dir", ckpt, "--checkpoint_steps", "4",
        "--output", out, "--export_saved_model", "--device", "cpu"])
    job = api.run_local(args, "train")
    assert job.ok and job.owner.step == 8
    return job, out, ckpt


def test_local_train_output_writes_an_export(trained_job):
    job, out, _ = trained_job
    meta = export.read_export_meta(out)
    assert meta["step"] == 8
    assert meta["module"].endswith("deepfm.deepfm_functional_api")
    assert meta["model_class"] == "DeepFM"
    assert meta["saved_model"] == "ok"
    assert os.path.exists(os.path.join(out, "saved_model", "model.pt2"))
    assert set(meta["features"]) == {"dense", "sparse"}
    loaded = export.load_exported(out, template=job.owner.state.model)
    for name, tensor in job.owner.state.model.state_dict().items():
        assert torch.equal(loaded[name], tensor), name


def test_from_export_equals_from_checkpoint_bit_for_bit(trained_job):
    job, out, ckpt = trained_job
    spec = get_model_spec(ZOO_DIR, MODEL, model_params=PARAMS)
    sample = _features(1, seed=3)
    by_export = ServingEngine.from_export(out, spec, buckets=BUCKETS,
                                          sample_features=sample,
                                          device="cpu")
    by_ckpt = ServingEngine.from_checkpoint(ckpt, spec, sample,
                                            buckets=BUCKETS, device="cpu")
    assert by_export.step == by_ckpt.step == 8
    assert by_export.state_template is None
    assert by_ckpt.state_template is not None
    assert by_ckpt.produced_unix_s > 0 and by_export.produced_unix_s is None
    assert by_export.feature_spec == by_ckpt.feature_spec
    for bucket in BUCKETS:
        x = _features(bucket, seed=10 + bucket)
        a, _ = by_export.predict(x, bucket)
        b, _ = by_ckpt.predict(x, bucket)
        np.testing.assert_array_equal(a, b)
    # a sample whose keys drifted from the export's is refused up front
    with pytest.raises(ValueError, match="drifted since export"):
        ServingEngine.from_export(out, spec, sample_features={
            "dense": sample["dense"]}, device="cpu")
