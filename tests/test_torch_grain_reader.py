"""The port's `grain://` reader (elasticdl_tpu_torch/data/reader/
grain_reader.py) against the JAX package's over grain, on the CPU: the
twins of tests/test_grain_reader.py's cases.  The port reads the same
shards and the same records, byte for byte, from its zoo's plain
random-access sequence as the JAX reader reads from a grain
`MapDataset`; a grain dataset itself reads through the port as well (the
port never imports grain: the factory does); and a Local MNIST job
trains over a `grain://` origin."""

import os
import sys

import pytest

from elasticdl_tpu.data.reader import create_data_reader as jax_reader
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.data.reader import GrainDataReader
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.proto import messages as pb

pytest.importorskip("grain")

# the JAX reader resolves factory modules like zoo model_defs, with its
# model_zoo on sys.path; the port's resolve in its own zoo first
_ZOO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "model_zoo"
)
if _ZOO not in sys.path:
    sys.path.insert(0, _ZOO)

ORIGIN = "grain://mnist.data:grain_dataset?n=256&seed=1"


def test_shards_and_reads():
    reader = create_data_reader(ORIGIN, records_per_shard=100)
    assert isinstance(reader, GrainDataReader)
    assert isinstance(reader.dataset, list)      # no grain in the port
    jreader = jax_reader(ORIGIN, records_per_shard=100)
    shards = reader.create_shards()
    assert shards == jreader.create_shards()
    assert [(s, e) for _, s, e in shards] == [(0, 100), (100, 200),
                                              (200, 256)]
    for name, start, end in shards:
        task = pb.Task(shard=pb.Shard(name=name, start=start, end=end))
        jtask = jpb.Task(shard=jpb.Shard(name=name, start=start, end=end))
        records = list(reader.read_records(task))
        assert records == [bytes(r) for r in jreader.read_records(jtask)]
        assert all(len(r) == 785 for r in records)
    # deterministic: same factory args -> same records
    task = pb.Task(shard=pb.Shard(name=shards[1][0], start=100, end=103))
    assert list(create_data_reader(ORIGIN).read_records(task)) == \
        list(reader.read_records(task))


def test_transformed_dataset_records():
    """A factory outside the port's zoo resolves on sys.path, and a
    grain dataset (here with a transform upstream) reads through the
    port's reader as through the JAX one."""
    origin = "grain://tests.grain_fixtures:dict_dataset?n=8"
    reader = create_data_reader(origin)
    (name, start, end), = reader.create_shards()
    assert (name, start, end) == jax_reader(origin).create_shards()[0]
    task = pb.Task(shard=pb.Shard(name=name, start=0, end=8))
    records = list(reader.read_records(task))
    assert records[3] == {"image": [3] * 4, "label": 1}
    jtask = jpb.Task(shard=jpb.Shard(name=name, start=0, end=8))
    assert records == list(jax_reader(origin).read_records(jtask))


def test_bad_origin_rejected():
    with pytest.raises(ValueError, match="factory"):
        create_data_reader("grain://no_colon_here").create_shards()


def test_local_training_job_over_grain_origin():
    """Full Local job: the master cuts shards over the dataset, the worker
    pulls tasks and trains through the zoo's feed."""
    job = api.run_local(cli.parse_args([
        "train", "--model_def", "mnist.mnist_functional_api.custom_model",
        "--distribution_strategy", "Local",
        "--training_data", "grain://mnist.data:grain_dataset?n=512",
        "--num_workers", "1", "--minibatch_size", "64",
        "--num_epochs", "1", "--records_per_task", "128",
        "--device", "cpu"]), "train")
    assert job.ok and job.exit_code == 0
    assert job.owner.step == 8
    counters = job.master.task_manager.counters.as_dict()
    assert counters["failed"] == 0 and counters["by_type"][0] == 4
