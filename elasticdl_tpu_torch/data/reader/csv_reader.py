"""Shard-addressable CSV reader (the port's copy of the JAX package's
data/reader/csv_reader.py): a record is one data row, a list of strings,
and `metadata` is {"columns": header}.

Streaming: instead of caching whole files, each file gets a
line-start byte index (one int per row) built on first touch, and
`read_records` preads exactly the task's byte range.  Reads are
thread-safe (pread, no shared file position), so one reader instance can
serve every local worker thread.

Limitation carried by the row=line model: quoted fields containing
embedded newlines are not supported (the index is line-granular).  The
reference's table readers had the same row-granular addressing contract.
"""

from __future__ import annotations

import csv
import io
import os
import threading
from typing import Iterator, List, Optional, Tuple

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader


class _IndexedCSVFile:
    """Line-start offsets + header for one CSV file; O(rows) ints of
    memory, never the row data itself."""

    def __init__(self, path: str, has_header: bool, sep: str = ","):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        size = os.path.getsize(path)
        offsets: List[int] = []
        pos = 0
        with open(path, "rb") as f:
            for line in f:
                offsets.append(pos)
                pos += len(line)
        self.header: Optional[List[str]] = None
        if has_header and offsets:
            first = os.pread(
                self._fd, (offsets[1] if len(offsets) > 1 else size), 0
            )
            self.header = next(
                csv.reader([first.decode("utf-8")], delimiter=sep)
            )
            offsets = offsets[1:]
        self.offsets = offsets
        self.size = size

    def __len__(self) -> int:
        return len(self.offsets)

    def read_rows(self, start: int, end: int, sep: str) -> Iterator[list]:
        end = min(end, len(self.offsets))
        if start >= end:
            return
        begin = self.offsets[start]
        stop = self.offsets[end] if end < len(self.offsets) else self.size
        blob = os.pread(self._fd, stop - begin, begin)
        yield from csv.reader(
            io.StringIO(blob.decode("utf-8")), delimiter=sep
        )

    def close(self):
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class CSVDataReader(AbstractDataReader):
    def __init__(self, data_dir: str, columns: List[str] = None,
                 sep: str = ",", has_header: bool = True, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._sep = sep
        self._has_header = has_header
        self._columns = columns
        self._indexed = {}
        self._lock = threading.Lock()

    def _files(self) -> List[str]:
        if os.path.isfile(self._data_dir):
            return [self._data_dir]
        return sorted(
            os.path.join(self._data_dir, f)
            for f in os.listdir(self._data_dir)
            if f.endswith(".csv")
        )

    def _file(self, name: str) -> _IndexedCSVFile:
        with self._lock:
            if name not in self._indexed:
                indexed = _IndexedCSVFile(name, self._has_header, self._sep)
                if self._columns is None and indexed.header:
                    self._columns = indexed.header
                self._indexed[name] = indexed
            return self._indexed[name]

    def read_records(self, task) -> Iterator[list]:
        yield from self._file(task.shard.name).read_rows(
            task.shard.start, task.shard.end, self._sep
        )

    def create_shards(self) -> List[Tuple[str, int, int]]:
        return [(f, 0, len(self._file(f))) for f in self._files()]

    @property
    def metadata(self):
        # _columns is filled under the lock by the first _file() index;
        # read it under the same lock (GL-LOCK).
        with self._lock:
            return {"columns": self._columns}
