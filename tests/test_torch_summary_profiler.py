"""TensorBoard scalars (common/summary.py over torch.utils.tensorboard)
and the profiler hooks (common/profiler.py `trace`, `annotate` over
torch.profiler), alone and wired into a Local job on the CPU.

The tensorboard package is on this machine, and so is tensorflow, which
`torch.utils.tensorboard` then imports (slow, once per process).  It is
not blocked here: tensorboard resolves its tensorflow module once per
process, and a stub resolved under a block would stay for the JAX
package's TensorBoard test in the same process.
"""

import glob
import json
import os
import sys

import pytest
import torch

from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import profiler
from elasticdl_tpu_torch.common.summary import SummaryWriter
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_the_writer_writes_scalars_readable_by_tensorboard(tmp_path):
    writer = SummaryWriter(str(tmp_path / "tb"))
    assert writer.active and writer.reason == "writing"
    writer.scalars({"train/loss": 0.5, "eval/auc": 0.75}, step=3)
    writer.scalars({"train/loss": 0.25}, step=7)
    writer.flush()
    writer.close()
    assert _scalars(str(tmp_path / "tb")) == {
        "train/loss": [(3, 0.5), (7, 0.25)], "eval/auc": [(3, 0.75)]}


@pytest.mark.parametrize("blocked", [False, True])
def test_the_writer_is_inert_without_a_directory_or_its_package(
        tmp_path, monkeypatch, blocked):
    if blocked:
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        writer = SummaryWriter(str(tmp_path / "tb"))
        assert "tensorboard unavailable" in writer.reason
    else:
        writer = SummaryWriter(None)
        assert writer.reason == "no log directory"
    assert not writer.active
    writer.scalars({"train/loss": 1.0}, step=1)
    writer.flush()
    writer.close()
    assert not (tmp_path / "tb").exists()


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    x = torch.randn(64, 64)
    with profiler.trace(str(tmp_path / "prof"), name="unit") as path:
        with profiler.annotate("region-of-interest"):
            (x @ x).sum()
    assert path == str(tmp_path / "prof" / "unit.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "region-of-interest" in names
    assert "aten::mm" in names


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("criteo_tb")
    return write_dataset(str(root), n_train=256, n_val=64)


def test_a_local_job_writes_master_and_worker_scalars(data, tmp_path):
    """--tensorboard_log_dir: the master's job-level eval curve under
    master/, each worker's train loss and eval metrics under worker-<id>/
    (the layout of the JAX Local runner)."""
    train_dir, val_dir = data
    tb = tmp_path / "tb"
    job = api.run_local(cli.parse_args(
        ["train", "--distribution_strategy", "Local", "--model_def", MODEL,
         "--model_params", PARAMS, "--minibatch_size", "32",
         "--records_per_task", "64", "--use_bf16", "false",
         "--training_data", train_dir, "--validation_data", val_dir,
         "--evaluation_steps", "4", "--device", "cpu",
         "--tensorboard_log_dir", str(tb)]), "train")
    assert job.exit_code == 0
    master = _scalars(str(tb / "master"))
    worker = _scalars(str(tb / "worker-0"))
    history = job.master.evaluation_service.history
    # the master's last write for each version is that version's metric
    auc = {step: value for step, value in master["eval/auc"]}
    assert set(auc) == set(history)
    for version, metrics in history.items():
        assert auc[version] == pytest.approx(metrics["auc"], rel=1e-6)
    assert [s for s, _ in worker["train/loss"]] == [2, 4, 6, 8]
    assert float(job.workers[0].losses[-1]) == pytest.approx(
        worker["train/loss"][-1][1], rel=1e-6)
    assert "train/steps_per_sec" in worker and "eval/auc" in worker
    assert sorted(os.listdir(tb)) == ["master", "worker-0"]
    assert glob.glob(str(tb / "worker-0" / "events.out.tfevents.*"))
