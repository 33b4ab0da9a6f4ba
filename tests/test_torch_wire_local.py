"""The port's Local runner on DeepFM's compact and dedup wire formats and
its int8 arena, on the CPU at a small size (vocab 2^12, embed dim 8,
512 + 128 TFRecord records, batch 32, tasks of 128 records):

- a dedup job with steps_per_execution 4 and a compact job give
  bitwise-equal losses (their model inputs are the same rows and bf16
  dense values); both match the JAX Local job on the same flags from the
  carried init (losses within 1e-5, the final exact AUC within 1e-4:
  the bounds of tests/test_torch_local_runner.py);
- sticky dedup caps that grow inside a steps_per_execution group drain
  the held batches step by step, bit for bit as an undivided run;
- an int8 job trains from the command line, checkpoints, and evaluates
  from its checkpoint to the same AUC.
"""

import numpy as np
import pytest
import torch

import jax
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
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.data import wire as port_wire
from elasticdl_tpu_torch.data.reader import TFRecordDataReader
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.deepfm import (
    deepfm_functional_api as port_fm,
)
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset
from elasticdl_tpu_torch.proto.service import InProcessMasterClient
from elasticdl_tpu_torch.worker.sync import ModelOwner
from elasticdl_tpu_torch.worker.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker
from model_zoo.deepfm import deepfm_functional_api as jax_fm

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
BATCH = 32
LOSS_TOL = 1e-5
AUC_TOL = 1e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("criteo_wire")
    return write_dataset(str(root), n_train=512, n_val=128)


@pytest.fixture
def fresh_packers(monkeypatch):
    """Fresh sticky caps in both zoos for each test."""
    monkeypatch.setattr(port_fm, "_DEDUP_PACKER", port_wire.DedupPacker())
    monkeypatch.setattr(jax_fm, "_DEDUP_PACKER", None)


def _flags(train_dir, val_dir, *extra):
    return ["--distribution_strategy", "Local", "--model_def", MODEL,
            "--model_params", PARAMS, "--minibatch_size", str(BATCH),
            "--records_per_task", "128", "--use_bf16", "false",
            "--training_data", train_dir, "--validation_data", val_dir,
            "--evaluation_steps", "8", *extra]


def _port_job(train_dir, val_dir, wire_format, k, jax_params=None):
    args = cli.parse_args(["train", *_flags(train_dir, val_dir),
                           "--device", "cpu"])
    args.job_type = "train"
    master = Master(args)
    spec = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    owner = ModelOwner(Trainer(spec.model, spec.optimizer, spec.loss,
                               device="cpu"))
    sample = {"dense": np.zeros((BATCH, 13), np.float32),
              "sparse": np.zeros((BATCH, 26), np.int32)}
    owner.state = owner.trainer.init_state(0, sample)
    if jax_params is not None:
        owner.state.model.load_state_dict(
            params_from_jax(owner.state.model, jax_params), strict=True)
    worker = Worker(0, InProcessMasterClient(master.servicer),
                    TFRecordDataReader(train_dir), spec, model_owner=owner,
                    minibatch_size=BATCH, steps_per_execution=k,
                    wire_format=wire_format)
    assert worker.run() and master.task_manager.finished
    return master, owner, worker


def _jax_job(train_dir, val_dir, wire_format, k):
    jargs = jax_args.parse_master_args(
        _flags(train_dir, val_dir) + ["--model_zoo", "model_zoo"])
    master = JaxMaster(jargs)
    spec = jax_spec("model_zoo", MODEL, model_params=PARAMS)
    owner = JaxOwner(JaxTrainer(spec.model, spec.optimizer, spec.loss))
    sample = {"dense": np.zeros((BATCH, 13), np.float32),
              "sparse": np.zeros((BATCH, 26), np.int32)}
    owner.state = owner.trainer.init_state(jax.random.PRNGKey(0), sample)
    params = flatten_params(jax.tree.map(np.asarray,
                                         owner.state.params["params"]))
    worker = JaxWorker(0, JaxClient(master.servicer), JaxReader(train_dir),
                       spec, model_owner=owner, minibatch_size=BATCH,
                       steps_per_execution=k, wire_format=wire_format)
    assert worker.run() and master.task_manager.finished
    return master, worker, params


def test_dedup_and_compact_jobs_match_each_other_and_the_jax_jobs(
        data, fresh_packers):
    train_dir, val_dir = data
    runs = {}
    for wire_format, k in (("dedup", 4), ("compact", 1)):
        jmaster, jworker, params = _jax_job(train_dir, val_dir, wire_format,
                                            k)
        pmaster, powner, pworker = _port_job(train_dir, val_dir,
                                             wire_format, k, params)
        jlosses = [float(x) for x in jworker.losses]
        plosses = torch.stack(list(pworker.losses))
        assert len(jlosses) == plosses.numel() == powner.step == 16
        np.testing.assert_allclose(plosses.numpy(), jlosses, rtol=0,
                                   atol=LOSS_TOL)
        jauc = jmaster.evaluation_service.latest_metrics()["auc"]
        pauc = pmaster.evaluation_service.latest_metrics()["auc"]
        assert abs(pauc - jauc) <= AUC_TOL and pauc > 0.5
        assert sorted(pmaster.evaluation_service.history) == sorted(
            jmaster.evaluation_service.history) == [8, 16]
        pc = pmaster.task_manager.counters.as_dict()
        jc = jmaster.task_manager.counters.as_dict()
        assert pc["failed"] == jc["failed"] == 0
        assert pc["by_type"] == jc["by_type"]
        runs[wire_format] = (plosses, powner, pauc)
    # the same rows and dense values on both wires: bit for bit
    (dl, downer, dauc), (cl, cowner, cauc) = runs["dedup"], runs["compact"]
    assert torch.equal(dl, cl) and dauc == cauc
    for (name, a), b in zip(downer.state.model.state_dict().items(),
                            cowner.state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_growing_dedup_caps_drain_the_held_group(data, monkeypatch):
    """A packer whose caps grow on most batches: a group of 4 sees
    batches of changing shapes, so held batches step one by one; the run
    equals the steps_per_execution 1 run bit for bit."""
    train_dir, val_dir = data
    stacks, singles = [], []
    real_stack = ModelOwner.train_batch_stack
    real_single = ModelOwner.train_batch

    def stack(self, batches):
        stacks.append(len(batches))
        return real_stack(self, batches)

    def single(self, batch):
        singles.append(1)
        return real_single(self, batch)

    monkeypatch.setattr(ModelOwner, "train_batch_stack", stack)
    monkeypatch.setattr(ModelOwner, "train_batch", single)
    results = []
    for k in (4, 1):
        monkeypatch.setattr(port_fm, "_DEDUP_PACKER",
                            port_wire.DedupPacker(quantum=1, headroom=1.0))
        stacks.clear()
        singles.clear()
        _, owner, worker = _port_job(train_dir, val_dir, "dedup", k)
        results.append((torch.stack(list(worker.losses)), owner,
                        list(stacks), len(singles)))
    (grown, owner4, stacks4, singles4), (flat, owner1, _, _) = results
    # caps grew inside groups: fewer than 4 full stacks, the rest drained
    assert len(stacks4) < 4 and singles4 > 0
    assert 4 * len(stacks4) + singles4 == 16
    assert torch.equal(grown, flat)
    for (name, a), b in zip(owner4.state.model.state_dict().items(),
                            owner1.state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_int8_job_trains_checkpoints_and_evaluates(data, tmp_path):
    train_dir, val_dir = data
    ckpt = str(tmp_path / "ckpt")
    job = api.run_local(cli.parse_args(
        ["train", *_flags(train_dir, val_dir), "--device", "cpu",
         "--arena_dtype", "int8", "--checkpoint_dir", ckpt,
         "--checkpoint_steps", "8"]), "train")
    assert job.ok and job.owner.step == 16
    assert job.master.task_manager.counters.as_dict()["failed"] == 0
    model = job.owner.state.model
    assert model.fm_embedding.q8.dtype == torch.int8
    assert not model.fm_embedding.embedding.detach().any()
    common = ["--distribution_strategy", "Local", "--model_def", MODEL,
              "--model_params", PARAMS, "--minibatch_size", str(BATCH),
              "--records_per_task", "128", "--use_bf16", "false",
              "--device", "cpu", "--checkpoint_dir_for_init", ckpt,
              "--validation_data", val_dir]
    ev = api.run_local(cli.parse_args(
        ["evaluate", *common, "--arena_dtype", "int8"]), "evaluate")
    assert ev.ok and ev.owner.step == 16
    assert ev.metrics["auc"] == job.metrics["auc"]
    # the fp32 configuration refuses the int8 checkpoint: its eval task
    # fails (ArenaDtypeMismatch) on every try and scores nothing, never
    # the random init
    fp32 = api.run_local(cli.parse_args(["evaluate", *common]), "evaluate")
    assert fp32.master.task_manager.counters.as_dict()["failed"] > 0
    assert not fp32.metrics


@pytest.mark.parametrize("extra", [["--wire_format", "compact"],
                                   ["--compact_wire", "true"],
                                   ["--wire_format", "dedup",
                                    "--steps_per_execution", "4"]])
def test_wire_formats_run_from_the_command_line(data, extra, fresh_packers):
    train_dir, val_dir = data
    job = api.run_local(cli.parse_args(
        ["train", *_flags(train_dir, val_dir), "--device", "cpu",
         *extra]), "train")
    assert job.ok and job.owner.step == 16
    want = "dedup" if "dedup" in extra else "compact"
    assert job.workers[0].wire_format == want
    assert job.metrics["auc"] > 0.5
