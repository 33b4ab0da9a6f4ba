"""Shard-addressable TABLE reader for SQL databases (the port's copy of
the JAX package's data/reader/table_reader.py).

Row-range shard addressing over a database table instead of record
files.  The backend is SQLite (stdlib), which exercises the
contract: `create_shards()` cuts the table into row ranges, workers read
only their leased range, and records are column tuples plus a `columns`
metadata entry, exactly like the CSV reader.  A warehouse backend drops
in by registering another scheme (see data/reader/__init__.py registry).

Origin syntax:  sqlite:///path/to/file.db?table=NAME
(also accepted via create_data_reader kwargs: table="NAME").

Row addressing uses ROWID windows, not OFFSET: OFFSET is O(offset) per
read (the database walks and discards), which would make a job's total
scan cost quadratic in table size — the exact failure mode task sharding
exists to avoid.  ROWID range scans are index seeks.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator, List, Optional, Tuple

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader


class TableDataReader(AbstractDataReader):
    def __init__(
        self,
        data_dir: str = "",
        table: str = "",
        columns: Optional[List[str]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        path = data_dir
        if "?" in path:
            path, _, query = path.partition("?")
            for part in query.split("&"):
                key, _, value = part.partition("=")
                if key == "table":
                    table = value
        if not table:
            raise ValueError(
                "TableDataReader needs a table name: "
                "sqlite:///file.db?table=NAME"
            )
        # after the scheme split, "sqlite:///tmp/x.db" arrives as
        # "/tmp/x.db" — already a filesystem path
        self._path = path
        self._table = table
        self._columns = columns
        # sqlite3 connections are not shareable across threads; one
        # connection per worker thread, lazily.
        self._local = threading.local()
        self._index_lock = threading.Lock()
        self._rowids: Optional[List[int]] = None
        self._rowids_known = False
        self._rowid_base = 0
        self._validate()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path)
            self._local.conn = conn
        return conn

    def _validate(self):
        cur = self._conn().execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=?",
            (self._table,),
        )
        if cur.fetchone() is None:
            raise ValueError(
                f"table {self._table!r} not found in {self._path!r}"
            )
        if self._columns is None:
            info = self._conn().execute(
                f'PRAGMA table_info("{self._table}")'
            ).fetchall()
            self._columns = [row[1] for row in info]

    def _rowid_window(self) -> Tuple[int, int, int]:
        """(min_rowid, max_rowid, count) for the table right now."""
        row = self._conn().execute(
            f'SELECT MIN(ROWID), MAX(ROWID), COUNT(*) FROM '
            f'"{self._table}"'
        ).fetchone()
        if row is None or row[0] is None:
            return 0, -1, 0
        return row[0], row[1], row[2]

    def _record_rowids(self) -> Optional[List[int]]:
        """Record-index -> ROWID mapping.  None when ROWIDs are contiguous
        (the common append-only case: record i IS min_rowid + i, no index
        needed).  Tables with deletion gaps get an explicit sorted ROWID
        index (O(rows) ints, like the CSV line index) — without it the
        MAX-MIN+1 count over-reports size and windows land in gaps,
        yielding phantom/empty tasks."""
        with self._index_lock:
            if self._rowids_known:
                return self._rowids
            lo, hi, count = self._rowid_window()
            if count and hi - lo + 1 != count:
                self._rowids = [
                    r[0]
                    for r in self._conn().execute(
                        f'SELECT ROWID FROM "{self._table}" ORDER BY ROWID'
                    )
                ]
            self._rowid_base = lo
            self._rowids_known = True
            return self._rowids

    def create_shards(self) -> List[Tuple[str, int, int]]:
        """One shard covering every row; the task manager cuts it into
        --records_per_task windows.  Shard name carries origin so a
        worker-side reader for the same origin resolves it."""
        rowids = self._record_rowids()
        count = (
            len(rowids) if rowids is not None else self._rowid_window()[2]
        )
        if not count:
            return []
        return [(f"{self._path}?table={self._table}", 0, count)]

    def read_records(self, task) -> Iterator[tuple]:
        rowids = self._record_rowids()
        cols = ", ".join(f'"{c}"' for c in self._columns)
        if rowids is None:
            # _rowid_base is set under _index_lock by _record_rowids();
            # read it under the same lock (GL-LOCK).
            with self._index_lock:
                base = self._rowid_base
            lo, hi = base + task.shard.start, base + task.shard.end
        else:
            if task.shard.start >= len(rowids):
                return
            lo = rowids[task.shard.start]
            end = min(task.shard.end, len(rowids))
            hi = rowids[end - 1] + 1
        cur = self._conn().execute(
            f'SELECT {cols} FROM "{self._table}" '
            "WHERE ROWID >= ? AND ROWID < ? ORDER BY ROWID",
            (lo, hi),
        )
        yield from cur

    @property
    def metadata(self):
        return {"columns": self._columns, "table": self._table}
