"""The zoo's new models through the port's Local runner on the CPU
(`elasticdl train --distribution_strategy Local --device cpu`): Wide &
Deep from a CSV directory and from a SQLite table (the same rows, so the
same per-step losses bit for bit), both MNIST styles, served over
127.0.0.1 at the job's accuracy, and a shallow ResNet whose checkpoint
carries its BatchNorm statistics into an evaluate job."""

import json

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.model_zoo.census import data as census_data
from elasticdl_tpu_torch.model_zoo.cifar10 import data as cifar_data
from elasticdl_tpu_torch.model_zoo.mnist import data as mnist_data
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.proto.service import ServingStub
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.serving.server import (
    from_tensor_proto,
    make_predict_request,
)

torch.set_num_threads(2)


def _run(job, *argv):
    args = cli.parse_args([job, "--distribution_strategy", "Local",
                           "--device", "cpu", *argv])
    out = api.run_local(args, job)
    assert out.exit_code == 0
    assert out.master.task_manager.counters.as_dict()["failed"] == 0
    return out


def _losses(job):
    return [float(loss) for w in job.workers for loss in w.losses]


def test_census_from_csv_and_sqlite_train_alike(tmp_path):
    rows = census_data.synthetic_census(1024 + 512, seed=0)
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    census_data.write_csv(str(csv_dir / "train.csv"), rows[:1024])
    val = census_data.write_csv(str(tmp_path / "val.csv"), rows[1024:])
    table = census_data.write_table(str(tmp_path / "census.db"), "census",
                                    rows[:1024])
    common = ["--model_def", "census.wide_and_deep.custom_model",
              "--model_params", "lr=0.005", "--minibatch_size", "128",
              "--records_per_task", "256", "--num_epochs", "2",
              "--validation_data", val]
    from_csv = _run("train", "--training_data", str(csv_dir), *common)
    from_db = _run("train", "--training_data", table, *common)
    assert from_csv.owner.step == from_db.owner.step == 16
    assert _losses(from_csv) == _losses(from_db)
    assert len(_losses(from_csv)) == 16
    assert from_csv.metrics == from_db.metrics
    assert from_csv.metrics["auc"] > 0.6, from_csv.metrics


@pytest.mark.parametrize("model_def", ["mnist.mnist_functional_api",
                                       "mnist.mnist_subclass"])
def test_mnist_trains_and_serves_at_the_jobs_accuracy(tmp_path, model_def):
    train_dir, val_dir = mnist_data.write_dataset(str(tmp_path / "data"),
                                                  n_train=512, n_val=128)
    ckpt = str(tmp_path / "ckpt")
    job = _run("train", "--model_def", f"{model_def}.custom_model",
               "--training_data", train_dir, "--validation_data", val_dir,
               "--minibatch_size", "64", "--records_per_task", "128",
               "--num_epochs", "2", "--checkpoint_dir", ckpt,
               "--checkpoint_steps", "16")
    accuracy = job.metrics["accuracy"]
    assert job.owner.step == 16 and accuracy >= 0.9, job.metrics
    server = api.build_serving_server(cli.parse_args([
        "serve", "--model_def", f"{model_def}.custom_model",
        "--checkpoint_dir", ckpt, "--batch_buckets", "8,64", "--port", "0",
        "--device", "cpu", "--feature_spec",
        json.dumps({"features": {"shape": [784], "dtype": "float32"}})]))
    port = server.start(0)
    try:
        stub = ServingStub(f"127.0.0.1:{port}", timeout=60)
        images, labels = mnist_data.synthetic_mnist(128, seed=1)
        features = images.astype(np.float32) / 255.0
        preds = []
        for lo in range(0, 128, 64):
            resp = stub.predict(make_predict_request(
                {"features": features[lo:lo + 64]}))
            assert resp.code == spb.SERVING_OK, resp.error
            preds.append(from_tensor_proto(resp.predictions))
        served = float(np.mean(np.argmax(np.concatenate(preds), -1)
                               == labels))
    finally:
        server.stop()
    assert served == accuracy


def test_shallow_resnet_checkpoint_carries_running_statistics(tmp_path):
    train_dir, val_dir = cifar_data.write_dataset(
        str(tmp_path / "data"), n_train=128, n_val=64, seed=0, val_seed=9)
    ckpt = str(tmp_path / "ckpt")
    common = ["--model_def", "cifar10.resnet.custom_model",
              "--model_params", "stage_sizes=(1, 1)",
              "--minibatch_size", "32", "--records_per_task", "64"]
    train = _run("train", *common, "--training_data", train_dir,
                 "--validation_data", val_dir, "--checkpoint_dir", ckpt,
                 "--checkpoint_steps", "4")
    assert train.owner.step == 4
    stats = {k: v.clone() for k, v in
             train.owner.state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * 9       # the stem and 2 blocks of 4
    # the training steps moved every BatchNorm's statistics off their
    # init (mean 0, variance 1)
    for name, value in stats.items():
        init = 0.0 if name.endswith("mean") else 1.0
        assert not torch.all(value == init), name
    saved = CheckpointSaver(ckpt)
    assert saved.all_steps() == [4]
    evaluate = _run("evaluate", *common, "--validation_data", val_dir,
                    "--checkpoint_dir_for_init", ckpt)
    restored = evaluate.owner.state.model.state_dict()
    for name, value in stats.items():
        assert torch.equal(restored[name], value), name
    # the eval reads the restored statistics: the same metrics as the
    # train job's final round at the same step
    assert evaluate.owner.step == 4
    assert evaluate.metrics == train.metrics
    # and serving reads them too (the engine runs the forward with
    # train=False): its logits equal the evaluate job's, whose trainer
    # casts features to bf16 (--use_bf16 defaults to true)
    xs, _ = cifar_data.synthetic_cifar(8, seed=9)
    features = torch.from_numpy(xs.astype(np.float32) / 255.0 - 0.5)
    features = features.bfloat16().float().numpy()
    spec = get_model_spec(ZOO_DIR, "cifar10.resnet.custom_model",
                          model_params="stage_sizes=(1, 1)")
    engine = ServingEngine.from_checkpoint(ckpt, spec, features[:1],
                                           buckets=(8,), device="cpu")
    served, step = engine.predict({"features": features}, 8)
    assert step == 4
    np.testing.assert_array_equal(
        served, evaluate.owner.predict_batch({"features": features}))
