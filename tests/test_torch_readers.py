"""The port's CSV, memory and sqlite readers and its reader registry
(elasticdl_tpu_torch/data/reader/) against the JAX package's on the same
files: shards and rows must be equal (both are integer and string
paths, so equal means equal), with quoted fields, no header, ROWID gaps
and concurrent reads; the registry's dispatch and errors; and a scheme
registered by a zoo module driving a Local job of the port."""

import csv
import os
import sqlite3
import threading

import numpy as np
import pytest
import torch

from elasticdl_tpu.data import reader as jax_reader
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu_torch.client import main as port_cli
from elasticdl_tpu_torch.data import reader as port_reader
from elasticdl_tpu_torch.data.reader.base import AbstractDataReader
from elasticdl_tpu_torch.model_zoo.census import data as census_data
from elasticdl_tpu_torch.proto import messages as pb

torch.set_num_threads(2)


def _task(name, start, end):
    return pb.Task(shard=pb.Shard(name=name, start=start, end=end))


def _jtask(name, start, end):
    return jpb.Task(shard=jpb.Shard(name=name, start=start, end=end))


def _rows(reader, task_fn, shards, step=7):
    """Every shard read in windows of `step` records."""
    out = []
    for name, start, end in shards:
        for lo in range(start, end, step):
            out.append(list(reader.read_records(task_fn(name, lo,
                                                        lo + step))))
    return out


def _same_reads(port, ref, check_metadata=True):
    shards = port.create_shards()
    assert shards == ref.create_shards()
    assert _rows(port, _task, shards) == _rows(ref, _jtask, shards)
    # past the end, and an empty window
    for name, _, end in shards:
        assert list(port.read_records(_task(name, end - 3, end + 50))) == \
            list(ref.read_records(_jtask(name, end - 3, end + 50)))
        assert list(port.read_records(_task(name, end, end))) == []
    if check_metadata:
        assert port.metadata == ref.metadata
    return shards


# ---- CSV ----------------------------------------------------------------


def _write(path, rows, header=None, sep=","):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter=sep)
        if header:
            writer.writerow(header)
        writer.writerows(rows)
    return path


def test_csv_directory_rows_shards_and_columns(tmp_path):
    rows = census_data.synthetic_census(230, seed=3)
    header = census_data.COLUMNS
    _write(str(tmp_path / "a.csv"), rows[:100], header)
    _write(str(tmp_path / "b.csv"), rows[100:], header)
    port = port_reader.CSVDataReader(data_dir=str(tmp_path))
    ref = jax_reader.CSVDataReader(data_dir=str(tmp_path))
    shards = _same_reads(port, ref)
    assert [s[2] for s in shards] == [100, 130]
    assert port.metadata == {"columns": header}


@pytest.mark.parametrize("sep", [",", ";", "\t"])
def test_csv_quoted_fields_and_no_header(tmp_path, sep):
    rows = [["a,b", "1", 'say "hi"'], ['c"d', "2", ""], ["e;f\tg", "3", "x"],
            ["  padded ", "4", "é ü"]] * 5
    path = _write(str(tmp_path / "q.csv"), rows, sep=sep)
    port = port_reader.CSVDataReader(data_dir=path, sep=sep,
                                     has_header=False)
    ref = jax_reader.CSVDataReader(data_dir=path, sep=sep, has_header=False)
    _same_reads(port, ref)
    assert port.metadata == {"columns": None}
    assert list(port.read_records(_task(path, 0, 4))) == rows[:4]
    # the caller's column names win over a header
    named = port_reader.CSVDataReader(data_dir=path, sep=sep,
                                      has_header=False, columns=["x", "y",
                                                                 "z"])
    named.create_shards()
    assert named.metadata == {"columns": ["x", "y", "z"]}


def test_csv_concurrent_reads_of_one_reader(tmp_path):
    rows = census_data.synthetic_census(400, seed=4)
    path = _write(str(tmp_path / "c.csv"), rows, census_data.COLUMNS)
    port = port_reader.CSVDataReader(data_dir=path)
    errors, done = [], []

    def work(tid):
        try:
            # the first reads race to build the index
            for rep in range(15):
                lo = (tid * 37 + rep * 11) % 390
                got = list(port.read_records(_task(path, lo, lo + 10)))
                assert got == rows[lo:lo + 10]
            done.append(tid)
        except Exception as exc:  # pragma: no cover - reported below
            errors.append((tid, repr(exc)))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and sorted(done) == list(range(8))
    assert port.create_shards() == [(path, 0, 400)]


# ---- memory -------------------------------------------------------------


def test_memory_reader_rows_and_batch():
    rng = np.random.RandomState(0)
    arrays = {"user": rng.randint(0, 100, 50), "item": rng.randint(0, 9, 50),
              "clicked": rng.randint(0, 2, 50)}
    port = port_reader.MemoryDataReader(arrays, name="clicks")
    ref = jax_reader.MemoryDataReader(arrays, name="clicks")
    _same_reads(port, ref)
    records = list(port.read_records(_task("clicks", 5, 12)))
    for key, value in port.batch(records).items():
        np.testing.assert_array_equal(value, ref.batch(records)[key])
    with pytest.raises(ValueError, match="same length"):
        port_reader.MemoryDataReader({"a": np.zeros(2), "b": np.zeros(3)})


# ---- sqlite -------------------------------------------------------------


def _table(path, table, rows, delete=()):
    with sqlite3.connect(path) as conn:
        conn.execute(f'CREATE TABLE "{table}" (a TEXT, b INTEGER, c REAL)')
        conn.executemany(f'INSERT INTO "{table}" VALUES (?, ?, ?)', rows)
        for rowid in delete:
            conn.execute(f'DELETE FROM "{table}" WHERE ROWID = ?', (rowid,))
    conn.close()


@pytest.mark.parametrize("gaps", [(), (1, 2, 17, 40, 41, 42, 99)])
def test_sqlite_rows_and_shards_with_and_without_rowid_gaps(tmp_path, gaps):
    path = str(tmp_path / "t.db")
    rows = [(f"r{i}", i, i * 0.25) for i in range(100)]
    _table(path, "events", rows, delete=gaps)
    origin = f"sqlite://{path}?table=events"
    port = port_reader.create_data_reader(origin)
    ref = jax_reader.create_data_reader(origin)
    assert isinstance(port, port_reader.TableDataReader)
    shards = _same_reads(port, ref)
    assert shards == [(f"{path}?table=events", 0, 100 - len(gaps))]
    kept = [r for i, r in enumerate(rows) if i + 1 not in gaps]
    got = list(port.read_records(_task(shards[0][0], 0, len(kept))))
    assert got == kept
    assert port.metadata == {"columns": ["a", "b", "c"], "table": "events"}


def test_sqlite_table_kwarg_concurrent_reads_and_refusals(tmp_path):
    path = str(tmp_path / "t.db")
    rows = [(f"r{i}", i, float(i)) for i in range(300)]
    _table(path, "t", rows)
    port = port_reader.TableDataReader(data_dir=path, table="t")
    name = port.create_shards()[0][0]
    errors = []

    def work(tid):
        try:
            for rep in range(10):
                lo = (tid * 29 + rep * 13) % 290
                assert list(port.read_records(_task(name, lo, lo + 10))) == \
                    rows[lo:lo + 10]
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    with pytest.raises(ValueError, match="not found"):
        port_reader.create_data_reader(f"sqlite://{path}?table=nope")
    with pytest.raises(ValueError, match="needs a table name"):
        port_reader.create_data_reader(f"sqlite://{path}")
    empty = str(tmp_path / "e.db")
    _table(empty, "t", [])
    assert port_reader.TableDataReader(data_dir=empty,
                                       table="t").create_shards() == []


def test_census_rows_read_alike_from_csv_and_sqlite(tmp_path):
    rows = census_data.synthetic_census(64, seed=5)
    path = census_data.write_csv(str(tmp_path / "c.csv"), rows)
    origin = census_data.write_table(str(tmp_path / "c.db"), "census", rows)
    from_csv = port_reader.create_data_reader(path)
    from_db = port_reader.create_data_reader(origin)
    csv_rows = list(from_csv.read_records(
        _task(from_csv.create_shards()[0][0], 0, 64)))
    db_rows = list(from_db.read_records(
        _task(from_db.create_shards()[0][0], 0, 64)))
    assert csv_rows == rows
    assert [list(r) for r in db_rows] == rows
    assert from_csv.metadata["columns"] == from_db.metadata["columns"]


# ---- registry -----------------------------------------------------------


def test_registry_dispatch_matches_jax(tmp_path):
    csv_dir = tmp_path / "csvs"
    csv_dir.mkdir()
    _write(str(csv_dir / "x.csv"), [["1"]], ["a"])
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    _write(str(mixed / "x.csv"), [["1"]], ["a"])
    (mixed / "y.tfrecord").write_bytes(b"")
    cases = [str(csv_dir), str(csv_dir / "x.csv"), str(mixed),
             "csv://" + str(csv_dir), "tfrecord://" + str(mixed)]
    for origin in cases:
        port = port_reader.create_data_reader(origin)
        ref = jax_reader.create_data_reader(origin)
        assert type(port).__name__ == type(ref).__name__, origin
    port = port_reader.create_data_reader(str(csv_dir / "x.csv"),
                                          reader_type="tfrecord")
    assert isinstance(port, port_reader.TFRecordDataReader)


def test_registry_errors():
    with pytest.raises(ValueError, match="no data reader registered"):
        port_reader.create_data_reader("nosuch://x")
    with pytest.raises(ValueError, match="no data reader registered"):
        port_reader.create_data_reader("/tmp/x", reader_type="nosuch")
    with pytest.raises(TypeError):
        port_reader.register_data_reader("bad", object)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_reader.create_data_reader("grain://mnist.data:grain_dataset")
    # the stream reader is ported, and as in the JAX package no scheme
    # is registered for it: a caller builds it
    for module in (jax_reader, port_reader):
        with pytest.raises(ValueError, match="no data reader registered "
                                             "for scheme 'stream'"):
            module.create_data_reader("stream://clicks")
        assert module.StreamReader.__name__ == "StreamReader"
        assert module.ClickStreamSource.__name__ == "ClickStreamSource"


def test_registered_scheme_as_call_and_decorator():
    @port_reader.register_data_reader("sq_port_test")
    class SquareReader(AbstractDataReader):
        def __init__(self, data_dir="", **kw):
            super().__init__(**kw)
            self.n = int(data_dir)

        def read_records(self, task):
            for i in range(task.shard.start, min(task.shard.end, self.n)):
                yield i * i

        def create_shards(self):
            return [("sq", 0, self.n)]

    reader = port_reader.create_data_reader("sq_port_test://5")
    assert isinstance(reader, SquareReader)
    assert list(reader.read_records(_task("sq", 1, 4))) == [1, 4, 9]
    assert port_reader.register_data_reader("sq_port_test2",
                                            SquareReader) is SquareReader
    assert isinstance(port_reader.create_data_reader(
        "9", reader_type="sq_port_test2"), SquareReader)


ZOO_MODULE = '''
import functools

import numpy as np
import torch

from elasticdl_tpu_torch.data.reader import register_data_reader
from elasticdl_tpu_torch.data.reader.base import AbstractDataReader
from elasticdl_tpu_torch.layers.linen import Dense


@register_data_reader("synth_port")
class SynthReader(AbstractDataReader):
    """y = 2x + 1, generated on the fly: no files at all."""

    def __init__(self, data_dir="", **kw):
        super().__init__(**kw)
        self.n = int(data_dir)

    def read_records(self, task):
        xs = np.random.RandomState(0).rand(self.n).astype("float32")
        for i in range(task.shard.start, min(task.shard.end, self.n)):
            yield (xs[i], 2.0 * xs[i] + 1.0)

    def create_shards(self):
        return [("synth", 0, self.n)]


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(1, 1)

    def forward(self, x):
        return self.Dense_0(x)


def custom_model():
    return Linear()


def loss(labels, predictions):
    return torch.mean((predictions[..., 0] - labels) ** 2)


def optimizer(lr=0.1):
    return functools.partial(torch.optim.SGD, lr=lr)


def feed(records, metadata):
    xs = np.array([r[0] for r in records], "float32")[:, None]
    ys = np.array([r[1] for r in records], "float32")
    return {"features": xs, "labels": ys}


def eval_metrics_fn():
    return {"mse": lambda labels, preds: float(
        np.mean((np.asarray(preds).reshape(-1) - labels) ** 2))}
'''


def test_zoo_registered_scheme_drives_a_local_job(tmp_path):
    """A reader registered by a zoo module, imported the way a job
    imports zoo code, serves a whole Local job: the master's shards, the
    workers' records and the final eval round."""
    from elasticdl_tpu_torch.client import api

    zoo = tmp_path / "zoo"
    zoo.mkdir()
    (zoo / "synth_port_zoo.py").write_text(ZOO_MODULE)
    args = port_cli.parse_args([
        "train", "--model_zoo", str(zoo),
        "--model_def", "synth_port_zoo.custom_model",
        "--training_data", "synth_port://256",
        "--validation_data", "synth_port://64",
        "--distribution_strategy", "Local", "--num_epochs", "4",
        "--minibatch_size", "32", "--records_per_task", "64",
        "--num_workers", "2", "--device", "cpu"])
    job = api.run_local(args, "train")
    assert job.exit_code == 0
    counters = job.master.task_manager.counters.as_dict()
    assert counters["failed"] == 0
    assert counters["by_type"][0] == 16           # 4 epochs x 4 tasks
    assert job.owner.step == 32
    assert job.metrics["mse"] < 0.05, job.metrics
    assert port_cli.main([
        "train", "--model_zoo", str(zoo),
        "--model_def", "synth_port_zoo.custom_model",
        "--training_data", "synth_port://64",
        "--distribution_strategy", "Local", "--minibatch_size", "32",
        "--records_per_task", "32", "--device", "cpu"]) == 0
    assert os.path.isdir(zoo)


def test_a_table_reader_reads_its_own_table_whatever_the_shard(tmp_path):
    """Why a train job's eval tasks go through the validation origin's
    reader: the table reader (the JAX one and its copy) reads ROWID
    windows of its own table whatever table the shard names, so the
    JAX Local runner, which reads eval tasks with the training reader,
    scores training rows of a `sqlite://` job."""
    path = str(tmp_path / "t.db")
    _table(path, "train", [(f"t{i}", i, 0.0) for i in range(10)])
    _table(path, "val", [(f"v{i}", i, 1.0) for i in range(10)])
    val_shard = f"{path}?table=val"
    for module, task in ((jax_reader, _jtask), (port_reader, _task)):
        train_reader = module.create_data_reader(
            f"sqlite://{path}?table=train")
        rows = list(train_reader.read_records(task(val_shard, 0, 3)))
        assert [r[0] for r in rows] == ["t0", "t1", "t2"]
    val_reader = port_reader.create_data_reader(f"sqlite://{val_shard}")
    assert [r[0] for r in val_reader.read_records(_task(val_shard, 0, 3))] \
        == ["v0", "v1", "v2"]
