"""Local jobs that survive a crash and injected faults, on the CPU at a
narrow DeepFM (vocab 2^12, embed dim 8, 512 TFRecord records, batch 16,
tasks of 64 records: 8 tasks, 32 steps, checkpoints every 8 steps):

- (a) a job stopped after a committed checkpoint and relaunched with the
  same flags: the relaunch restores that step from `--checkpoint_dir`,
  reads the task journal beside it and trains only the shards after the
  cutoff.  The JAX package's Local runner runs the same steps in the same
  test; both resumed jobs train the same shard list and count every
  record once.  The JAX resumed job equals its uninterrupted twin bit
  for bit, and so must the port's.  The stop is emulated in process:
  when the 4th training report (model version 16) has been journaled,
  the worker thread waits in that report until step 16's checkpoint is
  committed and the checkpoint directory (journal included) is copied;
  the copy is what a kill at that moment leaves on disk.  The job then
  runs on to its end: it is the uninterrupted twin.
- (b) a Local-runner counterpart of tests/test_chaos_soak.py: seeded
  faults at every point a train job fires (`rpc.get_task`, `rpc.report`,
  `checkpoint.write`), with errors, drops and delays; the job finishes
  with full coverage, every scheduled fault fired, non-zero retry and
  fault counters, and two same-seed runs give byte-identical traces.
- (c) `--profile_dir` writes one trace, for worker 0's first task.
"""

import glob
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import jax
from elasticdl_tpu.client.main import main as jax_cli_main
from elasticdl_tpu.master import task_manager as jax_tm
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.worker import sync as jax_sync
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import faults, resilience
from elasticdl_tpu_torch.common.faults import FaultRegistry, FaultSpec
from elasticdl_tpu_torch.master import task_manager as port_tm
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset
from elasticdl_tpu_torch.proto import messages as pb

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
TRAIN = 512
PER_TASK = 64
BATCH = 16
STEPS = TRAIN // BATCH                      # 32
CKPT_STEPS = 8
CRASH_VERSION = 16                          # the 4th task's report


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("criteo_resilient")
    return write_dataset(str(root), n_train=TRAIN, n_val=64)


def _flags(train_dir, ckpt, *extra):
    return ["--distribution_strategy", "Local", "--model_def", MODEL,
            "--model_params", PARAMS, "--minibatch_size", str(BATCH),
            "--records_per_task", str(PER_TASK), "--use_bf16", "false",
            "--training_data", train_dir, "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(CKPT_STEPS), *extra]


def _committed(ckpt: str, step: int, port: bool) -> bool:
    step_dir = os.path.join(ckpt, str(step))
    return (os.path.isfile(os.path.join(step_dir, "state.pt")) if port
            else os.path.isdir(step_dir))


class ReportTap:
    """Wraps a TaskManager class's `report`: records the shard of every
    successful training report and, at the report of model version
    `crash_version`, waits for that step's checkpoint and copies the
    checkpoint directory to `crash_dir` before the worker goes on."""

    def __init__(self, monkeypatch, cls, training, port: bool,
                 ckpt=None, crash_dir=None):
        self.shards = []
        self.ckpt, self.crash_dir, self.port = ckpt, crash_dir, port
        original = cls.report
        tap = self

        def report(tm, task_id, success, worker_id=-1, records=0,
                   transient=False, model_version=-1):
            with tm._lock:
                entry = tm._doing.get(task_id)
            ok = original(tm, task_id, success, worker_id=worker_id,
                          records=records, transient=transient,
                          model_version=model_version)
            if ok and success and entry is not None and \
                    entry.task.type == training:
                shard = entry.task.shard
                tap.shards.append((shard.name, shard.start, shard.end))
                if tap.crash_dir and model_version == CRASH_VERSION:
                    tap.snapshot()
            return ok

        monkeypatch.setattr(cls, "report", report)

    def snapshot(self):
        deadline = time.time() + 60
        while not _committed(self.ckpt, CRASH_VERSION, self.port):
            assert time.time() < deadline, "step 16 never committed"
            time.sleep(0.01)
        assert not os.path.exists(os.path.join(self.ckpt, "24"))
        shutil.copytree(self.ckpt, self.crash_dir,
                        ignore=shutil.ignore_patterns("*.tmp"))


def _jax_owners(monkeypatch):
    owners = []
    init = jax_sync.ModelOwner.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        owners.append(self)

    monkeypatch.setattr(jax_sync.ModelOwner, "__init__", recording)
    return owners


def _jax_leaves(owner):
    return [np.asarray(x) for x in
            jax.tree_util.tree_leaves((owner.state.params,
                                       owner.state.opt_state))]


def _port_tensors(job):
    model = {k: v.detach().cpu().clone()
             for k, v in job.owner.state.model.state_dict().items()}
    return model, job.owner.state.optimizer.state_dict()


def _same_optimizer(a, b) -> bool:
    for sa, sb in zip(a["state"].values(), b["state"].values()):
        for key in sa:
            if not torch.equal(torch.as_tensor(sa[key]),
                               torch.as_tensor(sb[key])):
                return False
    return True


def test_a_relaunched_job_trains_only_the_shards_after_the_cutoff(
        data, tmp_path, monkeypatch):
    train_dir, _ = data
    # ---- the JAX package: the uninterrupted job, copied at the stop ----
    jckpt, jcrash = str(tmp_path / "jax_ckpt"), str(tmp_path / "jax_crash")
    owners = _jax_owners(monkeypatch)
    with monkeypatch.context() as m:
        first = ReportTap(m, jax_tm.TaskManager, jpb.TRAINING, port=False,
                          ckpt=jckpt, crash_dir=jcrash)
        assert jax_cli_main(["train", "--model_zoo", "model_zoo",
                             *_flags(train_dir, jckpt)]) == 0
    jax_whole = _jax_leaves(owners[-1])
    assert len(first.shards) == TRAIN // PER_TASK
    with monkeypatch.context() as m:
        resumed = ReportTap(m, jax_tm.TaskManager, jpb.TRAINING, port=False)
        assert jax_cli_main(["train", "--model_zoo", "model_zoo",
                             *_flags(train_dir, jcrash)]) == 0
    jax_owner = owners[-1]
    jax_resumed_shards = resumed.shards
    with open(os.path.join(jcrash, "task_state.json")) as f:
        jax_journal = json.load(f)
    # the JAX resumed job equals its uninterrupted twin bit for bit
    jax_bitwise = all(np.array_equal(a, b) for a, b in
                      zip(jax_whole, _jax_leaves(jax_owner)))
    assert int(jax_owner.step) == STEPS
    assert jax_bitwise

    # ---- the port, the same steps ----
    pckpt, pcrash = str(tmp_path / "ckpt"), str(tmp_path / "crash")
    with monkeypatch.context() as m:
        first = ReportTap(m, port_tm.TaskManager, pb.TRAINING, port=True,
                          ckpt=pckpt, crash_dir=pcrash)
        whole = api.run_local(cli.parse_args(
            ["train", *_flags(train_dir, pckpt), "--device", "cpu"]),
            "train")
    assert whole.exit_code == 0
    assert len(first.shards) == TRAIN // PER_TASK
    whole_model, whole_opt = _port_tensors(whole)
    with open(os.path.join(pcrash, "task_state.json")) as f:
        crash_journal = json.load(f)
    assert sorted(e[3] for e in crash_journal["done_training_shards"]) \
        == [4, 8, 12, 16]
    with monkeypatch.context() as m:
        resumed = ReportTap(m, port_tm.TaskManager, pb.TRAINING, port=True)
        job = api.run_local(cli.parse_args(
            ["train", *_flags(train_dir, pcrash), "--device", "cpu"]),
            "train")
    assert job.exit_code == 0
    tm = job.master.task_manager
    # restored step 16, trained the 4 shards after the cutoff, no more
    assert len(resumed.shards) == 4
    assert resumed.shards == [tuple(s) for s in jax_resumed_shards]
    assert first.shards[4:] == resumed.shards
    assert job.owner.step == STEPS
    assert tm._training_records_done == TRAIN
    assert tm.counters.records_done == TRAIN
    # the port holds the JAX package's relation: bit for bit
    model, opt = _port_tensors(job)
    assert all(torch.equal(model[k], whole_model[k]) for k in model)
    assert _same_optimizer(opt, whole_opt)
    # both journals, as JSON: the same shards at the same versions
    with open(os.path.join(pcrash, "task_state.json")) as f:
        port_final = json.load(f)
    with open(os.path.join(jcrash, "task_state.json")) as f:
        jax_final = json.load(f)
    assert port_final == jax_final == jax_journal


def test_a_relaunch_over_a_damaged_newest_step_retrains_after_the_older(
        data, tmp_path, monkeypatch):
    """The newest step fails its manifest check: the relaunch restores
    the step before it, and the journal is trusted only that far, so the
    shards after the older step train again and no record is lost."""
    train_dir, _ = data
    ckpt, crash = str(tmp_path / "ckpt"), str(tmp_path / "crash")
    with monkeypatch.context() as m:
        first = ReportTap(m, port_tm.TaskManager, pb.TRAINING, port=True,
                          ckpt=ckpt, crash_dir=crash)
        whole = api.run_local(cli.parse_args(
            ["train", *_flags(train_dir, ckpt), "--device", "cpu"]),
            "train")
    assert whole.exit_code == 0
    whole_model, _ = _port_tensors(whole)
    manifest = os.path.join(crash, ".manifests", f"{CRASH_VERSION}.json")
    with open(manifest) as f:
        meta = json.load(f)
    meta["files"]["state.pt"]["sha256"] = "0" * 64
    with open(manifest, "w") as f:
        json.dump(meta, f)
    with monkeypatch.context() as m:
        resumed = ReportTap(m, port_tm.TaskManager, pb.TRAINING, port=True)
        job = api.run_local(cli.parse_args(
            ["train", *_flags(train_dir, crash), "--device", "cpu"]),
            "train")
    assert job.exit_code == 0
    # restored step 8: tasks 3-8 train again, tasks 1-2 do not
    older = CRASH_VERSION - CKPT_STEPS
    assert resumed.shards == first.shards[older * BATCH // PER_TASK:]
    assert job.owner.step == STEPS
    assert job.master.task_manager.counters.records_done == TRAIN
    model, _ = _port_tensors(job)
    assert all(torch.equal(model[k], whole_model[k]) for k in model)


def test_a_relaunch_after_the_last_shard_finishes_at_once(data, tmp_path):
    """A journal that is already terminal (every shard done, the last
    checkpoint covering them): the relaunch trains nothing and exits
    0."""
    train_dir, _ = data
    ckpt = str(tmp_path / "ckpt")
    flags = ["train", *_flags(train_dir, ckpt), "--device", "cpu"]
    assert api.run_local(cli.parse_args(flags), "train").exit_code == 0
    again = api.run_local(cli.parse_args(flags), "train")
    tm = again.master.task_manager
    assert again.exit_code == 0 and tm.finished
    assert tm.counters.by_type.get(0, 0) == 0
    assert tm.counters.records_done == TRAIN


def _chaos_schedule(seed: int):
    """Seed-derived, explicit faults at every point a Local train job
    fires, at hit indices the job is sure to reach: rpc.get_task is hit
    about 9 times, rpc.report about 16 (a report and a version report
    per task), checkpoint.write 4 times."""
    rng = np.random.default_rng(seed)
    specs = []
    for point, hits, n in ((faults.POINT_RPC_GET_TASK, 8, 3),
                           (faults.POINT_RPC_REPORT, 14, 4),
                           (faults.POINT_CHECKPOINT_WRITE, 3, 1)):
        for at in sorted(rng.choice(hits, size=n, replace=False)):
            action = ("raise", "drop", "delay")[int(rng.integers(3))]
            if point == faults.POINT_CHECKPOINT_WRITE:
                action = "raise"
            specs.append(FaultSpec(point, int(at), action,
                                   0.01 if action == "delay" else 0.0))
    return FaultRegistry(specs, seed=seed)


@pytest.fixture
def fast_retries(monkeypatch):
    monkeypatch.setenv(resilience.ENV_INITIAL_BACKOFF_S, "0.001")
    monkeypatch.setenv(resilience.ENV_MAX_BACKOFF_S, "0.002")
    yield
    faults.uninstall()


def test_a_job_under_seeded_faults_covers_its_data_and_replays(
        data, tmp_path, fast_retries):
    train_dir, _ = data
    traces = []
    for run in range(2):
        resilience.reset_stats()
        registry = faults.install(_chaos_schedule(20241017))
        ckpt = str(tmp_path / f"ckpt{run}")
        job = api.run_local(cli.parse_args(
            ["train", *_flags(train_dir, ckpt), "--device", "cpu"]),
            "train")
        snap = job.master.snapshot()
        faults.uninstall()
        tm = job.master.task_manager
        assert job.exit_code == 0 and tm.finished
        assert registry.unfired() == []
        assert tm.counters.records_done == TRAIN
        assert tm.counters.by_type[0] == TRAIN // PER_TASK
        assert job.owner.step == STEPS
        assert snap["resilience"]["retries"] > 0
        assert snap["faults"]["injected"] == snap["faults"]["planned"] == 8
        # the skipped save is the one injected fault a save path swallows
        assert job.owner.checkpoint_saver.latest_step() == STEPS
        traces.append(registry.trace_text())
    assert traces[0] == traces[1]
    assert "fired checkpoint.write#" in traces[0]


def test_profile_dir_traces_worker_zeros_first_task(data, tmp_path):
    train_dir, _ = data
    profile = tmp_path / "profile"
    job = api.run_local(cli.parse_args(
        ["train", *_flags(train_dir, str(tmp_path / "ckpt")),
         "--device", "cpu", "--num_workers", "2",
         "--profile_dir", str(profile)]), "train")
    assert job.exit_code == 0
    traces = glob.glob(str(profile / "*.json"))
    assert traces == [job.workers[0].profile_trace]
    assert job.workers[1].profile_trace is None
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the task-<id> annotation around the traced task's steps
    assert os.path.basename(traces[0])[:-len(".json")] in names
    assert any(n and n.startswith("aten::") for n in names)


def test_two_workers_under_a_journal_count_every_shard_once(data,
                                                            tmp_path):
    """Two worker threads under the journal: every shard once, and the
    ids of a journaled generation start from a random base of at least
    2^20, so a report from an earlier generation cannot ack a shard."""
    train_dir, _ = data
    job = api.run_local(cli.parse_args(
        ["train", *_flags(train_dir, str(tmp_path / "ckpt")),
         "--device", "cpu", "--num_workers", "2"]), "train")
    tm = job.master.task_manager
    assert job.exit_code == 0
    assert tm.counters.records_done == TRAIN
    assert tm.counters.by_type[0] == TRAIN // PER_TASK
    assert tm._next_task_id >= (1 << 20)
    with open(str(tmp_path / "ckpt" / "task_state.json")) as f:
        assert json.load(f)["records_done"] == TRAIN
