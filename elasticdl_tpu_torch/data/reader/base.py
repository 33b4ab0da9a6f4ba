"""Data reader contract (the port's copy of the JAX package's
data/reader/base.py).

A reader makes a data source shard-addressable: `create_shards()`
enumerates (name, start, end) ranges the master cuts into tasks, and
`read_records(task)` yields the raw records of one leased task on a
worker.
"""

from __future__ import annotations

import abc
from typing import Iterator, List, Tuple

Metadata = dict


class AbstractDataReader(abc.ABC):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @abc.abstractmethod
    def read_records(self, task) -> Iterator:
        """Yield records for task.shard ([start, end) of shard.name)."""

    def read_records_bulk(self, task):
        """Optional bulk path: (uint8 payload buffer, int64 sizes) for the
        task's records, or None when the reader has no bulk form (callers
        then use `read_records`).  Pairs with the zoo's `feed_bulk`."""
        return None

    @abc.abstractmethod
    def create_shards(self) -> List[Tuple[str, int, int]]:
        """Enumerate (source_name, start, end) ranges covering the data."""

    @property
    def metadata(self) -> Metadata:
        return {}
