"""The port's Local runner (elasticdl_tpu_torch/client/api.py and the
master, worker and data modules under it) on DeepFM at a small size
(vocab 2^12, embed dim 8, a few hundred TFRecord records) on the CPU:

- against the JAX package's Local path from the same carried init: the
  task sequence, the per-step losses (within 1e-5, the bound
  tests/test_torch_trainer.py states: the JAX step splits each batch
  over the 8-device CPU mesh, so its sums run in another order), the
  evaluation rounds, and the final exact AUC (within 1e-4: the same
  predictions to ~1e-6, ranked; a near-tie may swap);
- steps_per_execution 4 bit for bit against 1;
- two workers with a failed task and a dead worker;
- the command line: train, evaluate, predict from the checkpoint with
  --device cpu; unknown flags, cluster strategies and waiting features
  rejected; no GPU and no --device cpu raises;
- complete event chains for every task.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_k8s_stub
from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.data.reader import TFRecordDataReader as JaxReader
from elasticdl_tpu.master.main import Master as JaxMaster
from elasticdl_tpu.proto.service import (
    InProcessMasterClient as JaxClient,
)
from elasticdl_tpu.worker.sync import ModelOwner as JaxOwner
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker.worker import Worker as JaxWorker
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common.k8s_config import K8sConfigError
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.data.reader import TFRecordDataReader
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.common.metrics import auc
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.service import InProcessMasterClient
from elasticdl_tpu_torch.worker.sync import ModelOwner
from elasticdl_tpu_torch.worker.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
LOSS_TOL = 1e-5
AUC_TOL = 1e-4
CHAIN = ["task_dispatched", "task_claimed", "task_trained", "task_reported"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("criteo")
    return write_dataset(str(root), n_train=512, n_val=128)


def _flags(train_dir, val_dir, *extra):
    return ["--distribution_strategy", "Local", "--model_def", MODEL,
            "--model_params", PARAMS, "--minibatch_size", "64",
            "--records_per_task", "128", "--use_bf16", "false",
            "--training_data", train_dir, "--validation_data", val_dir,
            "--evaluation_steps", "4", *extra]


def _final_auc(service):
    return service.latest_metrics()["auc"]


def test_local_job_matches_the_jax_local_path(data):
    """One worker each, shuffling on with the master's seed, the same
    TFRecord files, the JAX init carried across."""
    train_dir, val_dir = data
    jargs = jax_args.parse_master_args(
        _flags(train_dir, val_dir) + ["--model_zoo", "model_zoo"])
    jmaster = JaxMaster(jargs)
    js = jax_spec("model_zoo", MODEL, model_params=PARAMS)
    jowner = JaxOwner(JaxTrainer(js.model, js.optimizer, js.loss))
    pargs = cli.parse_args(["train", *_flags(train_dir, val_dir),
                            "--device", "cpu"])
    pargs.job_type = "train"
    pmaster = Master(pargs)
    ps = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    powner = ModelOwner(Trainer(ps.model, ps.optimizer, ps.loss,
                                device="cpu"))

    sample = {"dense": np.zeros((64, 13), np.float32),
              "sparse": np.zeros((64, 26), np.int32)}
    jowner.state = jowner.trainer.init_state(jax.random.PRNGKey(0), sample)
    powner.state = powner.trainer.init_state(0, sample)
    flat = flatten_params(jax.tree.map(np.asarray,
                                       jowner.state.params["params"]))
    powner.state.model.load_state_dict(
        params_from_jax(powner.state.model, flat), strict=True)

    sequences = []
    for master, client_cls, reader_cls, worker_cls, owner, spec in (
            (jmaster, JaxClient, JaxReader, JaxWorker, jowner, js),
            (pmaster, InProcessMasterClient, TFRecordDataReader, Worker,
             powner, ps)):
        seq = []
        master.task_manager.add_completion_callback(
            lambda task, ok, seq=seq: seq.append(
                (task.task_id, int(task.type), task.shard.name,
                 task.shard.start, task.shard.end, task.model_version, ok)))
        worker = worker_cls(0, client_cls(master.servicer),
                            reader_cls(train_dir), spec, model_owner=owner,
                            minibatch_size=64)
        assert worker.run() and master.task_manager.finished
        sequences.append((seq, [float(x) for x in worker.losses]))
    (jseq, jlosses), (pseq, plosses) = sequences
    assert pseq == jseq
    assert len(plosses) == 8 == powner.step == int(jowner.state.step)
    np.testing.assert_allclose(plosses, jlosses, rtol=0, atol=LOSS_TOL)
    jc = jmaster.task_manager.counters.as_dict()
    pc = pmaster.task_manager.counters.as_dict()
    assert pc["by_type"] == jc["by_type"] == {0: 4, 1: 3}
    assert pc["failed"] == jc["failed"] == 0
    assert pc["records_done"] == jc["records_done"]
    jhist = jmaster.evaluation_service.history
    phist = pmaster.evaluation_service.history
    assert sorted(phist) == sorted(jhist) == [4, 8]
    assert abs(_final_auc(pmaster.evaluation_service)
               - _final_auc(jmaster.evaluation_service)) <= AUC_TOL
    assert _final_auc(pmaster.evaluation_service) > 0.5


def _train(train_dir, val_dir, tmp_path, *extra):
    args = cli.parse_args(["train", *_flags(train_dir, val_dir),
                           "--device", "cpu", *extra])
    return api.run_local(args, "train")


def test_steps_per_execution_4_is_bitwise_equal_to_1(tmp_path):
    # 640 records per shard in tasks of 320: five batches of 64 per
    # task, so each task runs one stack of 4 and one single step
    train_dir, val_dir = write_dataset(str(tmp_path), n_train=1280,
                                       n_val=64)
    jobs = [_train(train_dir, val_dir, tmp_path, "--records_per_task",
                   "320", "--evaluation_steps", "0",
                   "--steps_per_execution", k) for k in ("1", "4")]
    flat, stacked = jobs
    assert flat.ok and stacked.ok
    assert flat.owner.step == stacked.owner.step == 20
    assert torch.equal(torch.stack(list(flat.workers[0].losses)),
                       torch.stack(list(stacked.workers[0].losses)))
    for (name, a), b in zip(flat.owner.state.model.state_dict().items(),
                            stacked.owner.state.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert flat.metrics == stacked.metrics


def test_two_workers_with_a_failed_task_and_a_dead_worker(data):
    """Worker 0 fails its first task (reported, re-queued), trains one,
    then dies; the master recovers its lease and worker 1 finishes the
    job: every shard trained, one model."""
    train_dir, val_dir = data
    args = cli.parse_args(["train", *_flags(train_dir, val_dir),
                           "--device", "cpu"])
    args.job_type = "train"
    master = Master(args)
    client = InProcessMasterClient(master.servicer)
    spec = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    owner = ModelOwner(Trainer(spec.model, spec.optimizer, spec.loss,
                               device="cpu"))
    trained = []
    master.task_manager.add_completion_callback(
        lambda task, ok: ok and task.type == pb.TRAINING and trained.append(
            (task.shard.name, task.shard.start)))
    worker0 = Worker(0, client, TFRecordDataReader(train_dir), spec,
                     minibatch_size=64, model_owner=owner)
    calls = []
    real_process = worker0._process_task

    def flaky(task):
        calls.append(task.task_id)
        if len(calls) == 1:
            raise RuntimeError("injected task failure")
        if len(calls) == 3:
            raise KeyboardInterrupt("worker 0 dies")
        return real_process(task)

    worker0._process_task = flaky
    with pytest.raises(KeyboardInterrupt):
        worker0.run()
    assert master.task_manager.recover_tasks(0) == 1
    worker1 = Worker(1, client, TFRecordDataReader(train_dir), spec,
                     minibatch_size=64, model_owner=owner)
    assert worker1.run()
    tm = master.task_manager
    assert tm.finished
    counters = tm.counters.as_dict()
    assert counters["failed"] == 1 and counters["recovered"] == 1
    shards = {(s.name, s.start) for s in
              master.task_manager._training_shards}
    assert set(trained) == shards and len(trained) == 4
    # one model: both workers' steps landed in the shared owner
    assert owner.step == len(worker0.losses) + len(worker1.losses) == 8


def test_cli_train_evaluate_predict_and_event_chains(data, tmp_path):
    train_dir, val_dir = data
    ckpt = str(tmp_path / "ckpt")
    log = str(tmp_path / "events.jsonl")
    job = _train(train_dir, val_dir, tmp_path, "--checkpoint_dir", ckpt,
                 "--checkpoint_steps", "2", "--keep_checkpoint_max", "2",
                 "--event_log", log, "--num_workers", "2")
    assert job.exit_code == 0
    snap = job.master.task_manager.snapshot()
    assert snap["counters"]["failed"] == 0
    assert snap["counters"]["by_type"][0] == 4
    assert job.owner.step == 8
    steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    assert steps == [6, 8]
    saver = job.owner.checkpoint_saver
    assert all(saver.verify_step(s) for s in steps)
    evs = events.read_events(log)
    events.configure(None)
    reported = {e["task_id"] for e in evs if e["event"] == "task_reported"}
    assert len(reported) == sum(snap["counters"]["by_type"].values())
    for task_id in reported:
        assert events.task_chain(evs, task_id) == CHAIN, task_id
    assert {e["step"] for e in evs if e["event"] == "checkpoint_saved"} \
        == {2, 4, 6, 8}
    # the final model's predictions and AUC on the validation rows
    spec = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    val = spec.feed_bulk(*TFRecordDataReader(val_dir).read_records_bulk(
        pb.Task(shard=pb.Shard(
            name=os.path.join(val_dir, "criteo-val.tfrecord"),
            start=0, end=128))))
    want = job.owner.trainer.predict_on_batch(job.owner.state,
                                              val["features"])
    # evaluate from the checkpoint scores the final step (the train
    # job's own final round may score an earlier checkpointed version:
    # with two workers it is injected at the version reported when the
    # queue drained, as in the JAX master)
    common = ["--distribution_strategy", "Local", "--model_def", MODEL,
              "--model_params", PARAMS, "--minibatch_size", "64",
              "--records_per_task", "128", "--use_bf16", "false",
              "--device", "cpu", "--checkpoint_dir_for_init", ckpt]
    ev = api.run_local(cli.parse_args(
        ["evaluate", *common, "--validation_data", val_dir]), "evaluate")
    assert ev.ok and ev.owner.step == 8
    assert abs(ev.metrics["auc"] - auc(val["labels"], want)) <= 1e-6
    out = str(tmp_path / "pred")
    assert cli.main(["predict", *common, "--prediction_data", val_dir,
                     "--output", out]) == 0
    preds = np.load(os.path.join(out, "predictions.npy"))
    # the rows come back in task order, from the restored final step
    np.testing.assert_array_equal(preds, want)


def test_cli_module_runs_as_a_program(data, tmp_path):
    train_dir, val_dir = data
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
         *_flags(train_dir, val_dir), "--device", "cpu",
         "--evaluation_steps", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Job succeeded" in proc.stderr


def test_cli_rejects_and_raises(data, monkeypatch, tmp_path):
    train_dir, val_dir = data
    # --tensorboard_log_dir is accepted; without the tensorboard package
    # the writers are inert and the job runs as it would without it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = tmp_path / "tb"
    job = api.run_local(cli.parse_args(
        ["train", *_flags(train_dir, val_dir), "--device", "cpu",
         "--tensorboard_log_dir", str(tb)]), "train")
    assert job.exit_code == 0
    assert not job.master.eval_summary.active
    assert "tensorboard unavailable" in job.master.eval_summary.reason
    assert not any(w._summary.active for w in job.workers)
    assert not tb.exists()
    for bad in (["--device", "tpu"], ["--wire_format", "bogus"],
                ["--arena_dtype", "int4"]):
        with pytest.raises(SystemExit):
            cli.parse_args(["train", *bad])
    flags = _flags(train_dir, val_dir)
    # a cluster strategy submits the master's pod through the default
    # client, the real Kubernetes one: with no cluster configured it
    # raises naming KUBECONFIG; a kubeconfig for the stub API server
    # takes the master pod and its Service
    cluster = ["train", *flags, "--device", "cpu",
               "--distribution_strategy", "AllReduce"]
    _torch_k8s_stub.no_cluster(monkeypatch, tmp_path)
    with pytest.raises(K8sConfigError, match="KUBECONFIG"):
        api.train(cli.parse_args(cluster))
    assert cli.main(cluster) == 1
    with _torch_k8s_stub.stub_cluster(monkeypatch, tmp_path,
                                      kubelet=False) as stub:
        assert cli.main(cluster) == 0
    assert [kind for kind, _ in stub.bodies] == ["pod", "service"]
    # evaluate needs a checkpoint
    assert cli.main(["evaluate", *flags, "--device", "cpu"]) == 1
    # the card by default: without CUDA and without --device cpu, raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", *flags])


@pytest.mark.parametrize("n,multiple", [(64, 64), (10, 64), (100, 64),
                                        (1, 8), (7, 3)])
def test_pad_to_multiple_matches_the_jax_function(n, multiple):
    from elasticdl_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from elasticdl_tpu_torch.worker.task_data_service import pad_to_multiple

    rng = np.random.RandomState(n)
    batch = {"features": {"dense": rng.rand(n, 3).astype(np.float32),
                          "sparse": rng.randint(0, 9, (n, 2))},
             "labels": rng.randint(0, 2, n)}
    got, real = pad_to_multiple(batch, multiple)
    want, want_real = jax_pad(batch, multiple)
    assert real == want_real == n
    for key in ("dense", "sparse"):
        np.testing.assert_array_equal(got["features"][key],
                                      np.asarray(want["features"][key]))
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))


@pytest.mark.parametrize("bulk", [True, False])
def test_batches_for_task_match_the_jax_data_service(data, bulk):
    """Bulk and streaming paths, with a wrap-padded tail: the same rows
    and real counts as the JAX TaskDataService."""
    from elasticdl_tpu.proto import elasticdl_pb2 as jpb
    from elasticdl_tpu.worker.task_data_service import (
        TaskDataService as JaxService,
    )
    from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

    train_dir, _ = data
    name = os.path.join(train_dir, "criteo-00001.tfrecord")
    spec = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    jsvc = JaxService(None, JaxReader(train_dir), 0)
    psvc = TaskDataService(None, TFRecordDataReader(train_dir), 0)
    jsvc.BULK_CHUNK_BATCHES = psvc.BULK_CHUNK_BATCHES = 2
    feed_bulk = spec.feed_bulk if bulk else None
    got = list(psvc.batches_for_task(
        pb.Task(shard=pb.Shard(name=name, start=3, end=203)), 64,
        spec.feed, feed_bulk=feed_bulk))
    want = list(jsvc.batches_for_task(
        jpb.Task(shard=jpb.Shard(name=name, start=3, end=203)), 64,
        spec.feed, feed_bulk=feed_bulk))
    assert [r for _, r in got] == [r for _, r in want] == [64, 64, 64, 8]
    for (gb, _), (wb, _) in zip(got, want):
        for key in ("dense", "sparse"):
            np.testing.assert_array_equal(gb["features"][key],
                                          wb["features"][key])
        np.testing.assert_array_equal(gb["labels"], wb["labels"])


def test_prefetch_delivers_staged_batches_then_the_error():
    from elasticdl_tpu_torch.common.profiler import PhaseTimer
    from elasticdl_tpu_torch.worker.task_data_service import (
        prefetch_batches,
    )

    def source():
        yield from range(3)
        raise IOError("reader died")

    timer = PhaseTimer()
    got = []
    with pytest.raises(IOError, match="reader died"):
        for item in prefetch_batches(source(), device_stage=lambda x: x * 10,
                                     phase_timer=timer):
            got.append(item)
    assert got == [0, 10, 20]
    assert timer.snapshot()["data_wait"]["total_s"] >= 0.0
    # the tiered store's phase is in the vocabulary; others still raise
    timer.add("cold_gather", 1.0)
    assert timer.snapshot()["cold_gather"]["total_s"] == 1.0
    with pytest.raises(ValueError, match="unknown step phase"):
        timer.add("not_a_phase", 1.0)


def _job_parts(train_dir, val_dir, saver=None, checkpoint_steps=0):
    args = cli.parse_args(["train", *_flags(train_dir, val_dir),
                           "--device", "cpu", "--evaluation_steps", "0"])
    args.job_type = "train"
    master = Master(args)
    spec = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    owner = ModelOwner(Trainer(spec.model, spec.optimizer, spec.loss,
                               device="cpu"),
                       checkpoint_saver=saver,
                       checkpoint_steps=checkpoint_steps)
    worker = Worker(0, InProcessMasterClient(master.servicer),
                    TFRecordDataReader(train_dir), spec, minibatch_size=64,
                    model_owner=owner)
    return master, owner, worker


def test_drain_saves_a_checkpoint_and_stops(data, tmp_path):
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver

    train_dir, val_dir = data
    saver = CheckpointSaver(str(tmp_path))
    master, owner, worker = _job_parts(train_dir, val_dir, saver)
    real_process = worker._process_task

    def process_then_drain(task):
        records = real_process(task)
        worker.drain_and_stop()
        return records

    worker._process_task = process_then_drain
    assert worker.run() is False
    assert owner.step == 2 and saver.all_steps() == [2]
    assert not master.task_manager.finished


def test_save_model_tasks_save_or_fail_loudly(data, tmp_path):
    """A SAVE_MODEL task checkpoints; one whose rider names an output
    directory also exports the model there; one whose export cannot be
    written fails and is reported, retried and dropped, and the job
    still ends."""
    import json

    from elasticdl_tpu_torch.common.export import load_exported
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver

    train_dir, val_dir = data
    saver = CheckpointSaver(str(tmp_path / "ckpt"))
    master, owner, worker = _job_parts(train_dir, val_dir, saver)
    export_dir = str(tmp_path / "export")
    (tmp_path / "a_file").write_text("")
    unwritable = str(tmp_path / "a_file" / "export")
    injected = []

    def save_model_tasks():
        if injected:
            return []
        injected.append(1)
        return [(pb.Shard(), pb.SAVE_MODEL, -1),
                (pb.Shard(), pb.SAVE_MODEL, -1,
                 json.dumps({"output": export_dir})),
                (pb.Shard(), pb.SAVE_MODEL, -1,
                 json.dumps({"output": unwritable}))]

    master.task_manager.add_pre_finish_provider(save_model_tasks)
    assert worker.run() and master.task_manager.finished
    counters = master.task_manager.counters.as_dict()
    assert counters["by_type"] == {0: 4, 1: 1, 4: 2}
    assert counters["failed"] == 4          # the first try and 3 retries
    saver.wait_until_finished()
    assert saver.all_steps() == [8]
    exported = load_exported(export_dir, template=owner.state.model)
    for name, tensor in owner.state.model.state_dict().items():
        assert torch.equal(exported[name], tensor), name


def test_threads_share_the_queue_and_the_owner_without_lost_updates():
    """16 threads lease and report from one TaskManager and 8 train
    through one ModelOwner, with a tiny switch interval: every task is
    reported once and every step lands."""
    import threading

    from elasticdl_tpu_torch.master.task_manager import (
        TaskManager,
        create_shards_from_ranges,
    )

    tm = TaskManager(training_shards=create_shards_from_ranges(
        [("a", 0, 4000)], 10), num_epochs=2, shuffle_shards=True,
        shuffle_seed=1)
    reported, lock = [], threading.Lock()

    def lease_and_report(wid):
        while not tm.finished:
            task = tm.get(wid)
            if task is None:
                continue
            assert tm.report(task.task_id, success=True, worker_id=wid,
                             records=10)
            with lock:
                reported.append(task.task_id)

    spec = get_model_spec(ZOO_DIR, MODEL, "vocab_capacity=256;embed_dim=4")
    owner = ModelOwner(Trainer(spec.model, spec.optimizer, spec.loss,
                               device="cpu"))
    batch = {"features": {"dense": np.ones((8, 13), np.float32),
                          "sparse": np.arange(208).reshape(8, 26) % 50},
             "labels": np.arange(8) % 2}

    def train(_):
        for _ in range(5):
            owner.train_batch(batch)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=lease_and_report, args=(w,))
                    for w in range(16)]
                   + [threading.Thread(target=train, args=(w,))
                      for w in range(8)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(reported) == list(range(800))
    assert tm.counters.as_dict()["finished"] == 800
    assert tm.counters.records_done == 8000
    assert owner.step == 40


def test_a_dead_worker_thread_fails_the_job_loudly(data, monkeypatch):
    """A worker thread that dies outside the task loop's reporting path:
    its lease is recovered, the other thread drains the queue, and
    run_local re-raises the error instead of reporting success."""
    train_dir, val_dir = data
    real_run = Worker.run

    def run(self):
        if self.worker_id == 1:
            self._data_service.get_task()      # holds a lease, then dies
            raise RuntimeError("worker 1 lost")
        return real_run(self)

    monkeypatch.setattr(Worker, "run", run)
    args = cli.parse_args(["train", *_flags(train_dir, val_dir),
                           "--device", "cpu", "--num_workers", "2"])
    with pytest.raises(RuntimeError, match="worker 1 lost"):
        api.run_local(args, "train")
