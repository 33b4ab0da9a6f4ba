"""A step that passes its manifest check but fails to load (ROADMAP.md
queue 3): the newest step has no manifest and a `state.pt` that does not
load.

- The JAX package trusts its task journal up to the newest step
  directory while its restore falls back to the step before: a relaunch
  would skip the shards trained after the step it restores (the gap,
  shown on the JAX side).
- The port decides the cutoff by the restore's own rule
  (`save_utils.restorable_step`: the newest step that passes its check
  and loads), so the restore and the cutoff agree: in the Local runner
  and in a relaunched cluster rank, the shards after the restored step
  train again.
- A cluster group restores one step on every rank: a step that fails to
  load on one rank only makes the whole group fall back.
"""

import os
import socket

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_dp_rank
from elasticdl_tpu.common.save_utils import CheckpointSaver as JaxSaver
from elasticdl_tpu.master import main as jax_main
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.client.api import run_local
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.save_utils import (
    committed_steps,
    intact_steps,
    restorable_step,
)
from elasticdl_tpu_torch.data.reader import TFRecordDataReader
from elasticdl_tpu_torch.master.main import Master, latest_model_checkpoint_step
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.proto.service import InProcessMasterClient
from elasticdl_tpu_torch.worker.spmd import SPMDWorker

torch.set_num_threads(2)

MNIST = "mnist.mnist_functional_api.custom_model"
# 256 records, tasks of 64, batches of 32: 4 tasks, 8 steps, a
# checkpoint every 2 steps, the newest 3 kept (4, 6, 8)
RECORDS, TASK, BATCH, CKPT_STEPS = 256, 64, 32, 2


def _damage(ckpt: str, step: int) -> None:
    """No manifest, and a state.pt that does not load."""
    os.remove(os.path.join(ckpt, ".manifests", f"{step}.json"))
    with open(os.path.join(ckpt, str(step), "state.pt"), "wb") as f:
        f.write(b"not a checkpoint")


def test_the_reference_trusts_its_journal_past_the_step_it_restores(
        tmp_path):
    import model_zoo.mnist.mnist_functional_api as zoo

    trainer = JaxTrainer(model=zoo.custom_model(),
                         optimizer=optax.adam(1e-3), loss_fn=zoo.loss)
    rng = np.random.RandomState(0)
    batch = {"features": rng.rand(32, 784).astype(np.float32),
             "labels": rng.randint(0, 10, 32).astype(np.int32)}
    state = trainer.init_state(jax.random.PRNGKey(0), batch["features"])
    ckpt = str(tmp_path / "ckpt")
    saver = JaxSaver(ckpt, async_save=False)
    for _ in range(2):
        for _ in range(2):
            state, _ = trainer.train_on_batch(state, batch)
        assert saver.save(state, force=True)
    saver.wait_until_finished()
    saver.close()
    # the newest step: no manifest, its files unreadable
    os.remove(os.path.join(ckpt, ".manifests", "4.json"))
    for root, _, files in os.walk(os.path.join(ckpt, "4")):
        for name in files:
            with open(os.path.join(root, name), "wb") as f:
                f.write(b"\0")
    cutoff = jax_main._latest_model_checkpoint_step(ckpt)
    template = trainer.init_state(jax.random.PRNGKey(1), batch["features"])
    restored = JaxSaver(ckpt, async_save=False).maybe_restore(template)
    # the journal is trusted up to step 4; the model restores step 2
    assert cutoff == 4
    assert int(restored.step) == 2


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    train_dir, _ = write_dataset(str(tmp_path_factory.mktemp("cutoff")),
                                 n_train=RECORDS, n_val=0)
    return train_dir


def _local_argv(train_dir, ckpt):
    return ["train", "--distribution_strategy", "Local", "--model_def",
            MNIST, "--training_data", train_dir, "--records_per_task",
            str(TASK), "--minibatch_size", str(BATCH), "--num_epochs", "1",
            "--checkpoint_dir", ckpt, "--checkpoint_steps", str(CKPT_STEPS),
            "--device", "cpu", "--use_bf16", "false"]


def test_the_local_runner_retrains_after_the_step_it_restores(mnist,
                                                              tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = run_local(cli.parse_args(_local_argv(mnist, ckpt)))
    assert first.exit_code == 0 and first.owner.step == 8
    first.owner.checkpoint_saver.wait_until_finished()
    _damage(ckpt, 8)
    # the manifest check alone still trusts step 8; the restore cannot
    assert intact_steps(ckpt)[-1] == 8
    assert restorable_step(ckpt) == latest_model_checkpoint_step(ckpt) == 6
    again = run_local(cli.parse_args(_local_argv(mnist, ckpt)))
    assert again.exit_code == 0
    # the journal was trusted up to step 6, the step the model restored:
    # the last task (steps 7-8) trained again, and only it
    assert sum(w._steps_total for w in again.workers) == TASK // BATCH
    assert again.owner.step == 8


def test_a_relaunched_cluster_rank_retrains_after_the_step_it_restores(
        mnist, tmp_path, monkeypatch):
    from elasticdl_tpu_torch.worker.trainer import Trainer

    steps = []
    train_global = Trainer.train_on_global_batch

    def counted(self, state, shard, mesh):
        steps.append(state.step)
        return train_global(self, state, shard, mesh)

    monkeypatch.setattr(Trainer, "train_on_global_batch", counted)
    ckpt = str(tmp_path / "ckpt")
    argv = ["--training_data", mnist, "--records_per_task", str(TASK),
            "--num_epochs", "1", "--model_def", MNIST, "--device", "cpu",
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(CKPT_STEPS)]

    def rank(master):
        from elasticdl_tpu_torch.common.save_utils import CheckpointSaver

        return SPMDWorker(
            worker_id=0, master_client=InProcessMasterClient(
                master.servicer),
            data_reader=TFRecordDataReader(mnist),
            spec=get_model_spec(ZOO_DIR, MNIST), minibatch_size=BATCH,
            device="cpu", checkpoint_steps=CKPT_STEPS,
            checkpoint_saver_factory=lambda: CheckpointSaver(ckpt))

    master = Master(port_args.parse_master_args(argv))
    worker = rank(master)
    assert worker.run() and int(worker.state.step) == 8
    _damage(ckpt, 8)
    del steps[:]
    # the relaunch: a new master over the journal, a new rank
    master = Master(port_args.parse_master_args(argv))
    worker = rank(master)
    assert worker.run()
    # restored step 6 and trained the last task's 2 steps: with the
    # journal trusted to step 8 no task would run and no state would
    # exist
    assert steps == [6, 7]
    assert int(worker.state.step) == 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_step_that_fails_on_one_rank_makes_the_group_fall_back(
        mnist, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    job = run_local(cli.parse_args(_local_argv(mnist, ckpt)))
    job.owner.checkpoint_saver.wait_until_finished()
    assert intact_steps(ckpt) == [4, 6, 8]
    sample = str(tmp_path / "sample.npz")
    np.savez(sample, features=np.zeros((2, 784), np.float32))
    ctx = torch.multiprocessing.get_context("spawn")
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"restored{r}.pt") for r in range(2)]
    procs = [ctx.Process(target=_torch_dp_rank.restore_rank, args=(
        r, coordinator, ckpt, MNIST, sample, 8, outs[r]))
        for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0, 0]
    got = [torch.load(o) for o in outs]
    # step 8 loaded on rank 0 only: both ranks fall back to step 6
    assert [g["step"] for g in got] == [6, 6]
    assert got[0]["digest"] == got[1]["digest"]


def test_a_relaunched_rank_checks_only_the_steps_it_needs(
        mnist, tmp_path, monkeypatch):
    """The group's restore checks the committed steps newest first and
    stops at the first that restores: the older steps' files are never
    hashed, so a damaged older step goes unnoticed, and a damaged newest
    step costs one more check.  The newest step's check, started on a
    thread before the init, is the one the restore reads."""
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.parallel.mesh import DataMesh
    from elasticdl_tpu_torch.worker import spmd
    from elasticdl_tpu_torch.worker.trainer import Trainer

    ckpt = str(tmp_path / "ckpt")
    job = run_local(cli.parse_args(_local_argv(mnist, ckpt)))
    job.owner.checkpoint_saver.wait_until_finished()
    assert committed_steps(ckpt) == [4, 6, 8]
    _damage(ckpt, 4)
    checked = []
    verify = spmd.verify_step
    monkeypatch.setattr(spmd, "verify_step", lambda d, s: (
        checked.append(s), verify(d, s))[1])
    spec = get_model_spec(ZOO_DIR, MNIST)

    def restored_step():
        rank = SPMDWorker.__new__(SPMDWorker)
        rank.process_id = 0
        rank.mesh = DataMesh(1, 0, torch.device("cpu"), "", None)
        rank._saver = CheckpointSaver(ckpt)
        rank.state = Trainer(spec.model, spec.optimizer, spec.loss,
                             device="cpu").init_state(
            0, np.zeros((1, 784), np.float32))
        rank._restore(rank._check_newest_step())
        return int(rank.state.step)

    assert restored_step() == 8 and checked == [8]
    del checked[:]
    _damage(ckpt, 8)
    assert restored_step() == 6 and checked == [8, 6]
