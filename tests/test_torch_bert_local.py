"""BERT through the port's Local runner on the CPU (elasticdl_tpu_torch/
client/api.py and the master, worker and checkpoint modules under it).

The configuration of the JAX package's tests/test_bert.py::
test_bert_ring_attention_learns_long_range: hidden 64, 2 layers, 4 heads,
MLP 128, L 32, vocab 16, lr 3e-3, 4096 planted-pairs records (label 1
iff the first and last tokens match) in tasks of 512, 6 epochs of
batches of 64.  The job must learn the long-range task to an accuracy
above 0.9, as the JAX test asserts; its eval metrics come from the zoo's
eval_metrics_fn over (B, 2) logits; its checkpoint holds AdamW's
moments; and an evaluate job from that checkpoint reproduces the
metrics exactly (the same weights and the same CPU arithmetic on the
same rows).
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.model_zoo.bert.data import write_dataset

torch.set_num_threads(2)

MODEL = "bert.bert_finetune.custom_model"
PARAMS = ("hidden=64;num_layers=2;heads=4;mlp_dim=128;max_len=32;"
          "vocab_size=16;lr=0.003")
N_TRAIN = 4096
EPOCHS = 6
BATCH = 64
STEPS = N_TRAIN * EPOCHS // BATCH          # 384


@pytest.fixture(scope="module")
def pairs_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert_pairs")
    return write_dataset(str(root), n_train=N_TRAIN, n_val=256, max_len=32,
                         vocab=16)


def _flags(job, *extra):
    return [job, "--distribution_strategy", "Local", "--model_def", MODEL,
            "--model_params", PARAMS, "--minibatch_size", str(BATCH),
            "--records_per_task", "512", "--device", "cpu", *extra]


def test_local_bert_job_learns_the_planted_pairs_and_evaluates_exactly(
        pairs_data, tmp_path):
    train_dir, val_dir = pairs_data
    ckpt = str(tmp_path / "ckpt")
    job = api.run_local(cli.parse_args(_flags(
        "train", "--training_data", train_dir, "--validation_data",
        val_dir, "--num_epochs", str(EPOCHS), "--checkpoint_dir", ckpt,
        "--checkpoint_steps", str(STEPS))), "train")
    counters = job.master.task_manager.counters.as_dict()
    assert job.exit_code == 0 and counters["failed"] == 0
    assert job.owner.step == STEPS
    assert counters["by_type"][0] == EPOCHS * N_TRAIN // 512
    metrics = job.metrics
    assert sorted(metrics) == ["accuracy", "auc"]
    # chance is 0.5; the compare of the first and last tokens must be
    # learned through attention over the whole sequence
    assert metrics["accuracy"] > 0.9, metrics
    assert metrics["auc"] > 0.9, metrics
    losses = [float(x) for x in job.workers[0].losses]
    assert np.isfinite(losses).all()

    saver = job.owner.checkpoint_saver
    assert saver.all_steps() == [STEPS] and saver.verify_step(STEPS)
    blob = torch.load(os.path.join(ckpt, str(STEPS), "state.pt"),
                      weights_only=False)
    moments = blob["optimizer"]["state"]
    n_params = len(list(job.owner.state.model.parameters()))
    assert len(moments) == n_params
    assert all({"exp_avg", "exp_avg_sq"} <= set(m) for m in
               moments.values())
    assert blob["optimizer"]["param_groups"][0]["weight_decay"] == 0.01

    ev = api.run_local(cli.parse_args(_flags(
        "evaluate", "--validation_data", val_dir,
        "--checkpoint_dir_for_init", ckpt)), "evaluate")
    assert ev.exit_code == 0 and ev.owner.step == STEPS
    assert ev.metrics == metrics
