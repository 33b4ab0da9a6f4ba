"""The tiered DeepFM through the port's Local runner
(`elasticdl train --model_def deepfm.deepfm_tiered.custom_model`) on the
CPU, beside the JAX package's Local path on the same records (the twins
of tests/test_tiered_store.py's Local tests):

- one worker: the store's threads tick, the plans' hits, misses and
  growth equal the JAX job's, the threads stop at the end, and every
  kept step has its sidecar;
- two workers plan deferred (overlap share exactly 0);
- `--steps_per_execution 4` plans union blocks, and on an all-hot cache
  trains bit for bit as one step at a time;
- `--store_cache_dtype int8` runs on int8 cache planes;
- a resumed job restores the store from the sidecar;
- `--validation_data`, evaluate jobs and wrap-padded tails are refused.

Small configuration: 512 TFRecord records, batch 64, tasks of 128
records, embed dim 4, caches of 2048 or 4096 rows.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from elasticdl_tpu.client.main import main as jax_cli_main
from elasticdl_tpu.common import metrics as jax_metrics
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_tiered as port_zoo
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset
from elasticdl_tpu_torch.store import checkpoint as port_ckpt
from elasticdl_tpu_torch.store.tiered import TieredStore
from elasticdl_tpu_torch.worker.task_data_service import pad_to_multiple

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_tiered.custom_model"
PARAMS = "cache_rows=2048;embed_dim=4"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("criteo")
    return write_dataset(str(root), n_train=512, n_val=64)


def _flags(train_dir, *extra, params=PARAMS):
    return ["--distribution_strategy", "Local", "--model_def", MODEL,
            "--model_params", params, "--training_data", train_dir,
            "--num_epochs", "1", "--minibatch_size", "64",
            "--records_per_task", "128", *extra]


def _port_job(train_dir, *extra, params=PARAMS):
    args = cli.parse_args(["train", *_flags(train_dir, *extra,
                                            params=params),
                           "--device", "cpu"])
    job = api.run_local(args, "train")
    assert job.exit_code == 0 and job.master.task_manager.finished
    assert job.master.task_manager.counters.as_dict()["failed"] == 0
    return job, port_zoo._LAST_STORE


def test_one_worker_job_matches_the_jax_job(data, tmp_path):
    train_dir, _ = data
    ckpt = str(tmp_path / "ckpt")
    job, store = _port_job(train_dir, "--checkpoint_dir", ckpt,
                           "--checkpoint_steps", "2",
                           "--keep_checkpoint_max", "3")
    assert job.owner.step == 8
    stats = store.stats()
    assert store.prefetch_ticks > 0, "the prefetch thread never ticked"
    assert stats["growth_rows"] > 0
    assert stats["vocab_rows"] == stats["growth_rows"]
    assert stats["cold_gather_overlap_share"] > 0.0
    assert not store._started and store.threads_alive == 0
    assert not store.deferred_prepare
    # one sidecar per kept step, none for the pruned ones
    steps = job.owner.checkpoint_saver.all_steps()
    assert steps == [4, 6, 8]
    assert sorted(int(n) for n in os.listdir(
        os.path.join(ckpt, port_ckpt.SIDECAR_ROOT))) == steps
    with open(os.path.join(ckpt, ".manifests", "8.json")) as f:
        assert json.load(f)["tiered"]["vocab_rows"] == stats["vocab_rows"]
    # cold_gather reaches the job's phase split
    assert job.phase_timer.snapshot()["cold_gather"]["total_s"] > 0

    # the JAX store's stats() reads process-wide counters (its job's
    # registry is the default one), so its counts are this job's deltas
    counters = {"hits": "store_cache_hits_total",
                "misses": "store_cache_misses_total",
                "growth_rows": "store_growth_rows_total"}
    registry = jax_metrics.default_registry()
    before = {key: registry.counter(name).value()
              for key, name in counters.items()}
    rc = jax_cli_main(["train", "--model_zoo", "model_zoo",
                       *_flags(train_dir)])
    assert rc == 0
    jstats = sys.modules["deepfm.deepfm_tiered"]._LAST_STORE.stats()
    for key in counters:
        jstats[key] -= before[key]
    for key in ("hits", "misses", "growth_rows", "vocab_rows",
                "cache_occupancy_rows", "host_bytes", "device_cache_bytes"):
        assert stats[key] == jstats[key], key


def test_two_workers_plan_deferred(data):
    train_dir, _ = data
    job, store = _port_job(train_dir, "--num_workers", "2")
    stats = store.stats()
    assert store.deferred_prepare and job.owner.step == 8
    assert stats["growth_rows"] > 0 and stats["hit_rate"] > 0.5
    assert stats["cold_gather_overlap_share"] == 0.0
    assert stats["cold_gather_sync_s"] > 0.0
    assert not store._started


def test_union_blocks_train_as_single_steps_on_an_all_hot_cache(data):
    train_dir, _ = data
    params = "cache_rows=4096;embed_dim=4"
    one, store_one = _port_job(train_dir, "--records_per_task", "256",
                               params=params)
    four, store_four = _port_job(train_dir, "--records_per_task", "256",
                                 "--steps_per_execution", "4",
                                 params=params)
    assert store_four.deferred_prepare
    assert store_four.stats()["block_plans"] == 2
    assert store_one.stats()["block_plans"] == 0
    assert store_four.stats()["growth_rows"] == \
        store_one.stats()["growth_rows"] < 4096
    losses_one = [float(x) for w in one.workers for x in w.losses]
    losses_four = [float(x) for w in four.workers for x in w.losses]
    assert losses_one == losses_four and len(losses_one) == 8


def test_store_cache_dtype_int8_runs(data, tmp_path):
    train_dir, _ = data
    ckpt = str(tmp_path / "ckpt8")
    job, store = _port_job(train_dir, "--store_cache_dtype", "int8",
                           "--checkpoint_dir", ckpt,
                           "--checkpoint_steps", "4")
    assert store.cache_dtype == "int8" and job.owner.step == 8
    arena = job.owner.state.model.fm_embedding
    assert arena.q8.dtype == torch.int8
    assert not arena.embedding.detach().any()      # the carrier is folded
    assert store.stats()["device_cache_bytes"] == 2048 * ((4 + 4) + (1 + 4))
    sidecar = port_ckpt.load_sidecar(ckpt, 8)
    assert sidecar.cache_dtype == "int8"
    assert set(sidecar.cache_planes) == {"fm_embedding", "fm_linear"}


def test_a_resumed_job_restores_the_store(data, tmp_path):
    train_dir, _ = data
    ckpt = str(tmp_path / "ckpt")
    first, store = _port_job(train_dir, "--checkpoint_dir", ckpt,
                             "--checkpoint_steps", "8")
    vocab = store.host.state_dict()
    # the task journal beside the checkpoints marks the first epoch done,
    # so the relaunch that trains is a second epoch on the same ids
    again, resumed = _port_job(train_dir, "--checkpoint_dir", ckpt,
                               "--checkpoint_steps", "8",
                               "--num_epochs", "2")
    # restored before its first plan (deferred), so the same ids grow
    # nothing
    assert resumed.deferred_prepare and again.owner.step == 16
    assert resumed.stats()["growth_rows"] == 0
    for key in ("vocab_fields", "vocab_ids", "vocab_rows"):
        np.testing.assert_array_equal(
            resumed.host.state_dict()[key], vocab[key])


def test_validation_data_is_refused_as_in_jax(data, capsys):
    train_dir, val_dir = data
    flags = _flags(train_dir, "--validation_data", val_dir)
    with pytest.raises(ValueError, match="mid-train evaluation"):
        api.run_local(cli.parse_args(["train", *flags, "--device", "cpu"]),
                      "train")
    # the JAX command line reports the same ValueError and exits non-zero
    assert jax_cli_main(["train", "--model_zoo", "model_zoo", *flags]) != 0
    assert "mid-train evaluation" in capsys.readouterr().err


def test_evaluate_job_is_refused(data, tmp_path):
    _, val_dir = data
    args = cli.parse_args([
        "evaluate", "--distribution_strategy", "Local", "--model_def",
        MODEL, "--model_params", PARAMS, "--validation_data", val_dir,
        "--checkpoint_dir_for_init", str(tmp_path), "--device", "cpu"])
    with pytest.raises(ValueError, match="TieredServingEngine"):
        api.run_local(args, "evaluate")


def test_a_planned_tail_is_not_wrap_padded():
    store = TieredStore({"fm_embedding": 4, "fm_linear": 1}, 26, 256)
    batch = store.attach({
        "features": {"dense": np.zeros((3, 13), np.float32),
                     "sparse": np.arange(78).reshape(3, 26)},
        "labels": np.zeros(3, np.int32)})
    with pytest.raises(ValueError, match="tiered-store batch"):
        pad_to_multiple(batch, 4)
    # a whole batch passes untouched
    same, n = pad_to_multiple(batch, 3)
    assert same is batch and n == 3
