"""Shard-addressable TFRecord directory reader (the port's copy of the
JAX package's data/reader/tfrecord_reader.py)."""

from __future__ import annotations

import os
import threading
from typing import Iterator, List, Tuple

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader
from elasticdl_tpu_torch.data.record_io import TFRecordReader


class TFRecordDataReader(AbstractDataReader):
    """Reads a directory of (or a single) .tfrecord file(s); the shard
    name is the file path, records are addressed through the sidecar
    offset index.

    Safe to share across worker threads: the per-file reader cache is
    lock-guarded and TFRecordReader reads with pread."""

    def __init__(self, data_dir: str, **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir
        self._readers = {}
        self._lock = threading.Lock()

    def _files(self) -> List[str]:
        if os.path.isfile(self._data_dir):
            return [self._data_dir]
        return sorted(
            os.path.join(self._data_dir, f)
            for f in os.listdir(self._data_dir)
            if not f.endswith(".idx")
        )

    def _reader(self, name: str) -> TFRecordReader:
        with self._lock:
            if name not in self._readers:
                self._readers[name] = TFRecordReader(name)
            return self._readers[name]

    def read_records(self, task) -> Iterator[bytes]:
        reader = self._reader(task.shard.name)
        yield from reader.read(task.shard.start, task.shard.end)

    def read_records_bulk(self, task):
        reader = self._reader(task.shard.name)
        return reader.read_bulk(task.shard.start, task.shard.end)

    def create_shards(self) -> List[Tuple[str, int, int]]:
        return [(f, 0, len(self._reader(f))) for f in self._files()]
