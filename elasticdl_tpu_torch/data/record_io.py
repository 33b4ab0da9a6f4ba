"""Pure-Python TFRecord container IO with a random-access offset index
(the port's copy of the JAX package's data/record_io.py; the files are
byte for byte the same).

    each record:  uint64 length (LE) | uint32 masked-crc32c(length)
                  | payload bytes    | uint32 masked-crc32c(payload)

TFRecord has no random access of its own, so a task ("file + record
range") is served through a sidecar offset index built on first use and
cached next to the file (`<file>.idx`: a header of magic, data-file size
and record count, then one uint64 offset per record).

The index build and the bulk writer go through the native scanner
(data/native_io.py, C++ built with g++ at first use) when it is
available, and through Python otherwise, as in the JAX package; both
give the same bytes.  `served()` counts which path served each call, by
operation.  Reads have one path, Python's: a task's `read_bulk` is one
`pread` and a strided numpy copy, faster on the H100 host than the
native scanner's record-by-record read of the same ranges (PERF.md).
Beside the per-byte crc32c there is a vectorised one (`crc32c_rows`)
that runs the same table over many equal-length records at once; the
Python bulk writer uses it for fixed-width records.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

import numpy as np

from elasticdl_tpu_torch.common import metrics

# which path served each call: operation -> {"native": n, "python": n}
_served = metrics.default_registry().counter(
    "data_recordio_calls_total",
    "TFRecord index builds and bulk writes, by operation and by the "
    "path that served them (native or python)",
    labelnames=("op", "path"),
)


def _count(op: str, native) -> None:
    _served.labels(op=op, path="python" if native is None
                   else "native").inc()


def served() -> dict:
    """{operation: {"native": calls, "python": calls}} since the last
    `reset_served()`."""
    out: dict = {}
    for (op, path), value in sorted(_served.child_values().items()):
        out.setdefault(op, {"native": 0, "python": 0})[path] = int(value)
    return out


def reset_served() -> None:
    _served.reset()


def _try_native():
    """The native scanner's module when its library is in use, else
    None (the Python path serves)."""
    from elasticdl_tpu_torch.data import native_io

    return native_io if native_io.available() else None

# ---- crc32c (Castagnoli), table-driven ---------------------------------


def _build_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _build_table()
_CRC_TABLE_NP = np.asarray(_CRC_TABLE, np.uint32)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """crc32c of every row of a (n, L) uint8 array, as (n,) uint32: the
    per-byte table walk, one numpy pass per byte column."""
    rows = np.asarray(rows, np.uint8)
    crc = np.full(rows.shape[0], 0xFFFFFFFF, np.uint32)
    for j in range(rows.shape[1]):
        crc = _CRC_TABLE_NP[(crc ^ rows[:, j]) & 0xFF] ^ (crc >> 8)
    return crc ^ np.uint32(0xFFFFFFFF)


def _masked_crc_rows(rows: np.ndarray) -> np.ndarray:
    crc = crc32c_rows(rows).astype(np.uint64)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8).astype(np.uint32)


# ---- writer ------------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_tfrecords(path: str, payloads) -> int:
    with TFRecordWriter(path) as writer:
        n = 0
        for payload in payloads:
            writer.write(payload)
            n += 1
    return n


def write_tfrecords_bulk(path: str, buffer, sizes) -> int:
    """Write records given as (contiguous uint8 payload buffer, int64
    sizes), the symmetric form of TFRecordReader.read_bulk: through the
    native writer when it is available; otherwise fixed-width records
    are framed in one numpy pass (`crc32c_rows`) and mixed widths go
    through the streaming writer."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    buffer = np.ascontiguousarray(buffer, np.uint8).reshape(-1)
    n = len(sizes)
    native = _try_native()
    _count("write", native)
    if native is not None:
        native.write_records(path, buffer, sizes)
        return n
    if n and (sizes == sizes[0]).all():
        width = int(sizes[0])
        payload = buffer.reshape(n, width)
        header = struct.pack("<Q", width)
        framed = np.empty((n, 16 + width), np.uint8)
        framed[:, :8] = np.frombuffer(header, np.uint8)
        framed[:, 8:12] = np.frombuffer(
            struct.pack("<I", _masked_crc(header)), np.uint8)
        framed[:, 12:12 + width] = payload
        framed[:, 12 + width:] = (
            _masked_crc_rows(payload).astype("<u4")
            .view(np.uint8).reshape(n, 4))
        with open(path, "wb") as f:
            f.write(framed.tobytes())
        return n
    bounds = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return write_tfrecords(
        path,
        (buffer[bounds[i]: bounds[i + 1]].tobytes() for i in range(n)),
    )


# ---- reader + index ----------------------------------------------------


def build_index(path: str) -> np.ndarray:
    """Scan the file once; the byte offset of every record as int64."""
    native = _try_native()
    _count("index", native)
    if native is not None:
        return native.build_index(path)
    return python_index(path)


def python_index(path: str) -> np.ndarray:
    """`build_index`'s Python scanner, whichever path is in use."""
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            offsets.append(pos)
            header = f.read(8)
            if len(header) < 8:
                raise IOError(f"{path}: truncated record header at {pos}")
            (length,) = struct.unpack("<Q", header)
            pos += 8 + 4 + length + 4
            f.seek(pos)
    return np.asarray(offsets, np.int64)


def _index_path(path: str) -> str:
    return path + ".idx"


_IDX_MAGIC = 0x454C4458  # "ELDX"


def load_or_build_index(path: str) -> np.ndarray:
    """The sidecar index's header (magic, data-file size, record count)
    is checked against the data file, so a regenerated file never serves
    stale offsets.  Returns an int64 array."""
    idx = _index_path(path)
    data_size = os.path.getsize(path)
    if (
        os.path.exists(idx)
        and os.path.getmtime(idx) >= os.path.getmtime(path)
    ):
        try:
            with open(idx, "rb") as f:
                blob = f.read()
            magic, size, count = struct.unpack("<IQQ", blob[:20])
            if magic == _IDX_MAGIC and size == data_size:
                offsets = np.frombuffer(
                    blob, "<u8", count=count, offset=20
                ).astype(np.int64)
                if len(offsets) == 0 or offsets[-1] < data_size:
                    return offsets
        except (struct.error, ValueError):
            pass  # corrupt index: rebuild below
    offsets = build_index(path)
    try:
        with open(idx, "wb") as f:
            f.write(struct.pack("<IQQ", _IDX_MAGIC, data_size,
                                len(offsets)))
            f.write(np.asarray(offsets, "<u8").tobytes())
    except OSError:
        pass  # read-only data dir: the index stays in memory
    return offsets


class TFRecordReader:
    """Random-access reader over an indexed TFRecord file.

    Thread-safe: the offset index is immutable after __init__ and every
    read is an `os.pread` at an absolute offset, so one reader serves
    concurrent worker threads."""

    def __init__(self, path: str, check_crc: bool = False):
        self._path = path
        self._check_crc = check_crc
        self._offsets = load_or_build_index(path)
        self._fd = os.open(path, os.O_RDONLY)
        self._file_size = os.fstat(self._fd).st_size

    def __len__(self) -> int:
        return len(self._offsets)

    def read(self, start: int, end: Optional[int] = None) -> Iterator[bytes]:
        """Yield payloads for records in [start, end)."""
        end = len(self._offsets) if end is None else min(
            end, len(self._offsets))
        for i in range(start, end):
            offset = int(self._offsets[i])
            header = os.pread(self._fd, 12, offset)
            if len(header) < 12:
                raise IOError(f"{self._path}: truncated header @record {i}")
            (length,) = struct.unpack("<Q", header[:8])
            if length > self._file_size - offset - 16:
                # a corrupt length: never a read that size
                raise IOError(f"{self._path}: truncated record @record {i}")
            body = os.pread(self._fd, length + 4, offset + 12)
            if len(body) < length + 4:
                raise IOError(f"{self._path}: truncated record @record {i}")
            payload = body[:length]
            if self._check_crc:
                stored_hdr_crc = struct.unpack("<I", header[8:12])[0]
                stored_crc = struct.unpack("<I", body[length:])[0]
                if stored_hdr_crc != _masked_crc(header[:8]):
                    raise IOError(
                        f"{self._path}: header CRC mismatch @record {i}")
                if stored_crc != _masked_crc(payload):
                    raise IOError(
                        f"{self._path}: payload CRC mismatch @record {i}")
            yield payload

    def read_bulk(self, start: int, end: Optional[int] = None):
        """Records [start, end) as (uint8 payload buffer, int64 sizes):
        one pread spanning the range, the 16-byte framing stripped with
        numpy, no per-record bytes objects."""
        end = len(self._offsets) if end is None else min(
            end, len(self._offsets))
        if start >= end:
            return np.empty(0, np.uint8), np.empty(0, np.int64)
        first = int(self._offsets[start])
        last = (
            int(self._offsets[end]) if end < len(self._offsets)
            else self._file_size
        )
        raw = os.pread(self._fd, last - first, first)
        if len(raw) < last - first:
            raise IOError(f"{self._path}: truncated read @record {start}")
        span = np.frombuffer(raw, np.uint8)
        offs = np.concatenate(
            [self._offsets[start:end], [last]]
        ).astype(np.int64) - first
        sizes = offs[1:] - offs[:-1] - 16  # strip length + 2 CRCs
        if self._check_crc:
            # CRC validation parses each record: the checked streaming
            # path (which serves it in Python too)
            payloads = list(self.read(start, end))
            return (
                np.frombuffer(b"".join(payloads), np.uint8),
                np.asarray([len(p) for p in payloads], np.int64),
            )
        if (sizes == sizes[0]).all():
            # fixed-width records (the zoo's formats): one strided strip
            rec = int(sizes[0]) + 16
            payload = span.reshape(end - start, rec)[
                :, 12: 12 + int(sizes[0])]
            return np.ascontiguousarray(payload).reshape(-1), sizes
        out = np.empty(int(sizes.sum()), np.uint8)
        pos = 0
        for off, size in zip(offs[:-1], sizes):
            out[pos: pos + size] = span[off + 12: off + 12 + size]
            pos += size
        return out, sizes

    def close(self):
        if getattr(self, "_fd", -1) >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
