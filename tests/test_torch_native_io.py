"""The port's native TFRecord scanner (data/native_io.py over
hostsrc/recordio.cc, built with g++ at first use) against the port's
Python path and the JAX package's reader: counterparts of
tests/test_native_io.py's 5 tests, the index from the native library
against the Python scanner's bit for bit as int64, the native scan's
bytes against the reader's (Python) reads, the bulk writer's bytes, and
the counts of which path served each call."""

import os
import struct

import numpy as np
import pytest

from elasticdl_tpu.data import record_io as jax_rio
from elasticdl_tpu_torch.data import native_io
from elasticdl_tpu_torch.data import record_io as rio
from elasticdl_tpu_torch.data.record_io import (
    TFRecordReader,
    build_index,
    write_tfrecords,
)
from elasticdl_tpu_torch.ops import _build


@pytest.fixture
def tf_file(tmp_path):
    path = str(tmp_path / "data.tfrecord")
    payloads = [bytes([i % 256]) * (50 + i % 37) for i in range(500)]
    write_tfrecords(path, payloads)
    return path, payloads


def _python_only(monkeypatch):
    monkeypatch.setattr(rio, "_try_native", lambda: None)


def test_the_library_builds_here_from_the_ports_own_source():
    """g++ is on this machine: the library builds, from hostsrc/, named
    by the source's hash beside the CUDA builds."""
    assert native_io.available(), native_io.unavailable_reason
    path = _build.host_library_path(native_io.SOURCE)
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("recordio-")
    assert _build.HOSTSRC_DIR.parent.name == "elasticdl_tpu_torch"
    # the CUDA builds' hash covers csrc/ only
    assert not list(_build.CSRC_DIR.glob("*.cc"))


def test_index_matches_python(tf_file, monkeypatch):
    path, _ = tf_file
    native_idx = native_io.build_index(path)
    _python_only(monkeypatch)
    python_idx = build_index(path)
    assert native_idx.dtype == python_idx.dtype == np.int64
    assert np.array_equal(native_idx, python_idx)


def test_read_matches_python_and_source(tf_file):
    path, payloads = tf_file
    with TFRecordReader(path, check_crc=True) as reader:
        assert list(reader.read(123, 456)) == payloads[123:456]


def test_corruption_detected(tf_file):
    path, _ = tf_file
    offsets = native_io.build_index(path)
    with open(path, "r+b") as f:  # flip a payload byte of record 10
        f.seek(offsets[10] + 12)
        byte = f.read(1)
        f.seek(offsets[10] + 12)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(IOError, match="payload CRC"):
        native_io.read_records(path, offsets, 0, 20, check_crc=True)
    # without CRC checking the corrupted byte passes through
    records = native_io.read_records(path, offsets, 0, 20, check_crc=False)
    assert len(records) == 20


def test_corrupt_length_is_clean_error(tf_file):
    """A huge bogus on-disk length returns the clean truncation error,
    not bad_alloc across the ctypes boundary."""
    path, _ = tf_file
    offsets = native_io.build_index(path)
    reader = TFRecordReader(path)   # indexed while the file is whole
    for bogus in (1 << 60, 0xFFFFFFFFFFFFFFFF):
        with open(path, "r+b") as f:  # overwrite record 5's length
            f.seek(offsets[5])
            f.write(struct.pack("<Q", bogus))
        with pytest.raises(IOError, match="truncated"):
            native_io.read_records(path, offsets, 0, 20, check_crc=False)
        # the reader (Python) refuses the length before any read
        with pytest.raises(IOError, match="truncated record @record 5"):
            list(reader.read(0, 20))
    reader.close()


def test_truncated_file_rejected(tmp_path):
    path = str(tmp_path / "trunc.tfrecord")
    write_tfrecords(path, [b"x" * 100])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 10)
    with pytest.raises(IOError):
        native_io.build_index(path)


@pytest.mark.parametrize("n,widths,seed", [
    (1, (7,), 0), (1000, (64,), 1), (777, (1, 200), 2), (4096, (100,), 3),
    (0, (5,), 4)])
def test_native_and_python_indexes_are_equal_bit_for_bit(tmp_path, n,
                                                         widths, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(widths[0], widths[-1] + 1, size=n).astype(np.int64)
    buffer = rng.integers(0, 256, size=int(sizes.sum()), dtype=np.uint8)
    path = str(tmp_path / "r.tfrecord")
    rio.write_tfrecords_bulk(path, buffer, sizes)
    native_idx = native_io.build_index(path)
    old = rio._try_native
    rio._try_native = lambda: None
    try:
        python_idx = rio.build_index(path)
        py_buf, py_sizes = TFRecordReader(path).read_bulk(0, n)
    finally:
        rio._try_native = old
    assert native_idx.tobytes() == python_idx.tobytes()
    # the JAX package's Python scanner agrees
    jax_old = jax_rio._try_native
    jax_rio._try_native = lambda: None
    try:
        assert np.array_equal(jax_rio.build_index(path), native_idx)
    finally:
        jax_rio._try_native = jax_old
    buf, got_sizes = native_io.read_records_np(path, native_idx, 0, n)
    assert np.array_equal(got_sizes, sizes)
    assert buf.tobytes() == py_buf.tobytes() == buffer.tobytes()
    assert np.array_equal(py_sizes, sizes)


def test_the_native_and_python_writers_write_the_same_bytes(tmp_path,
                                                            monkeypatch):
    rng = np.random.default_rng(7)
    for sizes in (np.full(300, 40, np.int64),
                  rng.integers(1, 90, size=300).astype(np.int64)):
        buffer = rng.integers(0, 256, size=int(sizes.sum()),
                              dtype=np.uint8)
        native = str(tmp_path / "n.tfrecord")
        rio.write_tfrecords_bulk(native, buffer, sizes)
        with monkeypatch.context() as m:
            m.setattr(rio, "_try_native", lambda: None)
            python = str(tmp_path / "p.tfrecord")
            rio.write_tfrecords_bulk(python, buffer, sizes)
        with open(native, "rb") as a, open(python, "rb") as b:
            assert a.read() == b.read()


def test_each_call_counts_the_path_that_served_it(tf_file, monkeypatch):
    """Index builds and bulk writes are counted by path; reads have the
    one (Python) path and are not counted."""
    path, payloads = tf_file
    rio.reset_served()
    with TFRecordReader(path) as reader:
        list(reader.read(0, 10))
        reader.read_bulk(0, 10)
    rio.write_tfrecords_bulk(path + ".2", np.zeros(8, np.uint8),
                             np.full(2, 4, np.int64))
    assert rio.served() == {"index": {"native": 1, "python": 0},
                            "write": {"native": 1, "python": 0}}
    _python_only(monkeypatch)
    rio.build_index(path)
    assert rio.served()["index"] == {"native": 1, "python": 1}
    rio.reset_served()
    assert rio.served() == {}


def test_a_failed_build_leaves_the_python_path_serving(tf_file,
                                                       monkeypatch):
    """The JAX package's choice, kept: no library, Python serves, and the
    count says so."""
    path, payloads = tf_file
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_build_attempted", False)
    monkeypatch.setattr(native_io, "unavailable_reason", None)

    def no_compiler(source):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(_build, "build_host", no_compiler)
    rio.reset_served()
    assert not native_io.available()
    assert "g++ not found" in native_io.unavailable_reason
    with TFRecordReader(path) as reader:
        assert list(reader.read(0, 5)) == payloads[:5]
    assert rio.served()["index"] == {"native": 0, "python": 1}
    with pytest.raises(RuntimeError, match="unavailable"):
        native_io.build_index(path)
