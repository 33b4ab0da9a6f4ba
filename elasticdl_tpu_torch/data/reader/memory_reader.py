"""In-memory array reader (the port's copy of the JAX package's
data/reader/memory_reader.py): the data backend for tests, synthetic
runs and records that are dicts rather than bytes."""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader


class MemoryDataReader(AbstractDataReader):
    """Serves records out of a dict of equal-length numpy arrays; a record
    is the tuple of per-field rows at one index."""

    def __init__(self, arrays: dict, name: str = "memory", **kwargs):
        super().__init__(**kwargs)
        lengths = {len(v) for v in arrays.values()}
        if len(lengths) != 1:
            raise ValueError("all arrays must have the same length")
        self._arrays = arrays
        self._n = lengths.pop()
        self._name = name

    def read_records(self, task) -> Iterator[dict]:
        end = min(task.shard.end, self._n)
        for i in range(task.shard.start, end):
            yield {k: v[i] for k, v in self._arrays.items()}

    def create_shards(self) -> List[Tuple[str, int, int]]:
        return [(self._name, 0, self._n)]

    def batch(self, records: List[dict]) -> dict:
        return {
            k: np.stack([r[k] for r in records]) for k in self._arrays
        }
