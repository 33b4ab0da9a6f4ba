"""The port's TFRecord IO (elasticdl_tpu_torch/data/record_io.py), its
reader (data/reader) and the DeepFM zoo's write_dataset against the JAX
package's: the CRCs, the files and the indexes are byte for byte the
same, each package reads the other's files, and the shards agree."""

import filecmp
import os

import numpy as np
import pytest
import torch

from elasticdl_tpu.data import record_io as jax_io
from elasticdl_tpu.data.reader import TFRecordDataReader as JaxReader
from elasticdl_tpu_torch.data import record_io as port_io
from elasticdl_tpu_torch.data.reader import (
    CSVDataReader,
    TFRecordDataReader,
    create_data_reader,
)
from elasticdl_tpu_torch.model_zoo.deepfm import data as port_data
from elasticdl_tpu_torch.proto import messages as pb

torch.set_num_threads(2)


def _payloads(seed, n=64, fixed=None):
    rng = np.random.RandomState(seed)
    sizes = (np.full(n, fixed) if fixed is not None
             else rng.randint(0, 300, n))
    return [rng.randint(0, 256, int(s)).astype(np.uint8).tobytes()
            for s in sizes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32c_equals_the_jax_function(seed):
    for payload in _payloads(seed, n=16):
        assert port_io.crc32c(payload) == jax_io.crc32c(payload)
        assert port_io._masked_crc(payload) == jax_io._masked_crc(payload)


@pytest.mark.parametrize("width", [1, 8, 157])
def test_vectorised_crc_equals_the_per_byte_function(width):
    rows = np.random.RandomState(width).randint(
        0, 256, (200, width)).astype(np.uint8)
    got = port_io.crc32c_rows(rows)
    masked = port_io._masked_crc_rows(rows)
    for row, crc, m in zip(rows, got, masked):
        assert int(crc) == jax_io.crc32c(row.tobytes())
        assert int(m) == jax_io._masked_crc(row.tobytes())


@pytest.mark.parametrize("fixed", [None, 157])
def test_writers_produce_byte_identical_files(tmp_path, fixed):
    payloads = _payloads(3, fixed=fixed)
    jax_io.write_tfrecords(str(tmp_path / "jax.tfrecord"), payloads)
    port_io.write_tfrecords(str(tmp_path / "port.tfrecord"), payloads)
    sizes = np.asarray([len(p) for p in payloads], np.int64)
    buffer = np.frombuffer(b"".join(payloads), np.uint8)
    port_io.write_tfrecords_bulk(str(tmp_path / "bulk.tfrecord"), buffer,
                                 sizes)
    for name in ("port.tfrecord", "bulk.tfrecord"):
        assert filecmp.cmp(tmp_path / "jax.tfrecord", tmp_path / name,
                           shallow=False), name


def test_each_package_reads_the_others_files_with_equal_indexes(tmp_path):
    payloads = _payloads(4)
    jax_path = str(tmp_path / "jax.tfrecord")
    port_path = str(tmp_path / "port.tfrecord")
    jax_io.write_tfrecords(jax_path, payloads)
    port_io.write_tfrecords(port_path, payloads)
    # each package builds the index of the other's file
    np.testing.assert_array_equal(port_io.load_or_build_index(jax_path),
                                  jax_io.load_or_build_index(jax_path))
    jax_io.load_or_build_index(port_path)        # writes port_path.idx
    with open(port_path + ".idx", "rb") as f:
        jax_idx = f.read()
    os.remove(port_path + ".idx")
    port_io.load_or_build_index(port_path)
    with open(port_path + ".idx", "rb") as f:
        assert f.read() == jax_idx
    # and reads it, with CRCs checked
    with port_io.TFRecordReader(jax_path, check_crc=True) as reader:
        assert list(reader.read(0)) == payloads
    with jax_io.TFRecordReader(port_path, check_crc=True) as reader:
        assert list(reader.read(0)) == payloads


@pytest.mark.parametrize("fixed", [None, 157])
def test_read_bulk_equals_read(tmp_path, fixed):
    payloads = _payloads(5, fixed=fixed)
    path = str(tmp_path / "a.tfrecord")
    port_io.write_tfrecords(path, payloads)
    with port_io.TFRecordReader(path) as reader:
        for start, end in ((0, 64), (3, 17), (60, 100), (10, 10)):
            buffer, sizes = reader.read_bulk(start, end)
            want = list(reader.read(start, end))
            assert list(sizes) == [len(p) for p in want]
            assert buffer.tobytes() == b"".join(want)
    with port_io.TFRecordReader(path, check_crc=True) as reader:
        buffer, _ = reader.read_bulk(5, 9)
        assert buffer.tobytes() == b"".join(payloads[5:9])


def test_a_corrupt_payload_fails_the_crc_check(tmp_path):
    path = str(tmp_path / "a.tfrecord")
    port_io.write_tfrecords(path, _payloads(6, n=4, fixed=20))
    with open(path, "r+b") as f:
        f.seek(12 + 5)
        f.write(b"\xff")
    with port_io.TFRecordReader(path, check_crc=True) as reader:
        with pytest.raises(IOError, match="payload CRC"):
            list(reader.read(0))


def test_write_dataset_is_byte_identical_to_the_jax_zoo(tmp_path):
    from model_zoo.deepfm.data import write_dataset as jax_write

    jdirs = jax_write(str(tmp_path / "jax"), n_train=300, n_val=70, seed=3)
    pdirs = port_data.write_dataset(str(tmp_path / "port"), n_train=300,
                                    n_val=70, seed=3)
    for jdir, pdir in zip(jdirs, pdirs):
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(pdir)) and names
        for name in names:
            assert filecmp.cmp(os.path.join(jdir, name),
                               os.path.join(pdir, name), shallow=False)


def test_reader_shards_and_records_equal_the_jax_reader(tmp_path):
    train_dir, _ = port_data.write_dataset(str(tmp_path), n_train=200,
                                           n_val=10, shards=3)
    port, jax_reader = TFRecordDataReader(train_dir), JaxReader(train_dir)
    shards = port.create_shards()
    assert shards == jax_reader.create_shards()
    assert [s[2] for s in shards] == [66, 66, 66]
    name = shards[1][0]
    task = pb.Task(shard=pb.Shard(name=name, start=5, end=40))
    records = list(port.read_records(task))
    buffer, sizes = port.read_records_bulk(task)
    assert buffer.tobytes() == b"".join(records)
    with jax_io.TFRecordReader(name) as reader:
        assert records == list(reader.read(5, 40))


def test_create_data_reader_takes_paths_and_raises_for_waiting_readers(
        tmp_path):
    train_dir, _ = port_data.write_dataset(str(tmp_path), n_train=20,
                                           n_val=4)
    assert isinstance(create_data_reader(train_dir), TFRecordDataReader)
    assert isinstance(create_data_reader("tfrecord://" + train_dir),
                      TFRecordDataReader)
    # the CSV and sqlite readers are ported (tests/test_torch_readers.py);
    # grain waits and says where; stream is ported but, as in the JAX
    # package, registered under no scheme
    assert isinstance(create_data_reader("data.csv"), CSVDataReader)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_data_reader("grain://x")
    with pytest.raises(ValueError, match="no data reader registered"):
        create_data_reader("stream://clicks")
    with pytest.raises(ValueError, match="no data reader"):
        create_data_reader("odps://table")
