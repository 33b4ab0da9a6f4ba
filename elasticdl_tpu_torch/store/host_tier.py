"""Host-RAM bulk tier: full-vocabulary embedding planes and lazy growth
(the port's copy of the JAX package's store/host_tier.py; numpy only).

- `LazyVocabulary`: per-field id -> row maps that grow on first lookup
  instead of hashing into a fixed capacity.  Fields are scanned left to
  right and new ids within a field take rows in first-occurrence order,
  so one batch sequence always gives one map (restores and eviction
  write-backs depend on it).
- `HostTier`: the storage planes, one per arena of the model (DeepFM:
  `fm_embedding` at dim 16 and `fm_linear` at dim 1), sharing one row
  numbering.  Rows are fp32, or int8 codes with per-row scales
  (`host_dtype="int8"`, the arena's host quantization, bit for bit the
  JAX package's).

One lock guards every operation: growth reallocates the planes, so a
gather racing a grow would read a dropped array, and the lock also keeps
`set_rows` (the fold thread) and `assign` (the producer) apart.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.layers.arena import (
    dequantize_rows_host,
    quantize_rows_host,
)

HOST_DTYPES = ("fp32", "int8")

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer, uint64 in and out; the
    wraparound is the algorithm."""
    with np.errstate(over="ignore"):
        z = (x + _GOLDEN).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def row_init_values(seed: int, plane_index: int, rows: np.ndarray,
                    dim: int, scale: float = 0.05) -> np.ndarray:
    """Deterministic per-row init: uniform on [-scale*sqrt(3),
    +scale*sqrt(3)) (the std of the arena's normal(0.05) init), keyed by
    (seed, plane, row, column), so a row's init depends only on which
    row it is, never on when it grew."""
    rows = np.asarray(rows, np.uint64).reshape(-1)
    with np.errstate(over="ignore"):
        salt = _splitmix64(
            np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
            + np.uint64(plane_index + 1) * _GOLDEN
        )
        idx = (rows[:, None] * np.uint64(dim)
               + np.arange(dim, dtype=np.uint64))
    z = _splitmix64(idx ^ salt)
    u = (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    amp = scale * np.sqrt(3.0)
    return ((2.0 * u - 1.0) * amp).astype(np.float32)


class LazyVocabulary:
    """Per-field id -> row maps with deterministic first-occurrence
    growth.  Not thread-safe by itself: HostTier's lock drives it."""

    def __init__(self, num_fields: int):
        self.num_fields = int(num_fields)
        self._maps = [dict() for _ in range(self.num_fields)]
        self._next_row = 0

    @property
    def size(self) -> int:
        return self._next_row

    def assign(self, sparse: np.ndarray):
        """Map a (B, F) id batch to store rows, growing on first lookup.

        Returns (rows (B, F) int64, new_fields (N,), new_ids (N,),
        new_rows (N,)), all int64: the N new entries in assignment
        order, for the caller to initialise."""
        sparse = np.asarray(sparse, np.int64)
        if sparse.ndim != 2 or sparse.shape[1] != self.num_fields:
            raise ValueError(
                f"expected (B, {self.num_fields}) ids, got {sparse.shape}")
        rows = np.empty_like(sparse)
        new_fields, new_ids, new_rows = [], [], []
        for f in range(self.num_fields):
            col = sparse[:, f]
            uniq, first = np.unique(col, return_index=True)
            m = self._maps[f]
            uniq_rows = np.empty(uniq.size, np.int64)
            # new ids take rows in first-occurrence order within the
            # field: the determinism contract
            for i in np.argsort(first, kind="stable"):
                v = int(uniq[i])
                r = m.get(v)
                if r is None:
                    r = self._next_row
                    self._next_row += 1
                    m[v] = r
                    new_fields.append(f)
                    new_ids.append(v)
                    new_rows.append(r)
                uniq_rows[i] = r
            rows[:, f] = uniq_rows[np.searchsorted(uniq, col)]
        return (
            rows,
            np.asarray(new_fields, np.int64),
            np.asarray(new_ids, np.int64),
            np.asarray(new_rows, np.int64),
        )

    def lookup(self, sparse: np.ndarray) -> np.ndarray:
        """Lookup without growth (the serving path): unknown ids map to
        -1."""
        sparse = np.asarray(sparse, np.int64)
        rows = np.empty_like(sparse)
        for f in range(min(self.num_fields, sparse.shape[1])):
            m = self._maps[f]
            col = sparse[:, f]
            uniq, inverse = np.unique(col, return_inverse=True)
            uniq_rows = np.fromiter(
                (m.get(int(v), -1) for v in uniq), np.int64, uniq.size)
            rows[:, f] = uniq_rows[inverse.reshape(-1)]
        return rows

    def state_arrays(self):
        """(fields, ids, rows) int64 arrays in row order: the
        serializable form."""
        n = self._next_row
        fields = np.empty(n, np.int64)
        ids = np.empty(n, np.int64)
        rows = np.empty(n, np.int64)
        i = 0
        for f, m in enumerate(self._maps):
            for v, r in m.items():
                fields[i], ids[i], rows[i] = f, v, r
                i += 1
        order = np.argsort(rows[:i], kind="stable")
        return fields[:i][order], ids[:i][order], rows[:i][order]

    @classmethod
    def from_arrays(cls, num_fields: int, fields, ids, rows):
        vocab = cls(num_fields)
        fields = np.asarray(fields, np.int64)
        ids = np.asarray(ids, np.int64)
        rows = np.asarray(rows, np.int64)
        for f in range(vocab.num_fields):
            mine = fields == f
            vocab._maps[f] = dict(zip(ids[mine].tolist(),
                                      rows[mine].tolist()))
        vocab._next_row = int(rows.max()) + 1 if rows.size else 0
        return vocab


class HostTier:
    """Every plane's full vocabulary in host RAM.

    `set_backfill(fn)` installs a source consulted for newly grown rows
    before the deterministic init: `fn(plane_name, fields, ids) -> (N,
    dim) fp32 or None`.  The flat -> tiered migration uses it to pull
    rows lazily out of restored flat tables."""

    def __init__(self, planes: Dict[str, int], num_fields: int,
                 host_dtype: str = "fp32", seed: int = 0x5EED,
                 init_scale: float = 0.05, initial_rows: int = 1024):
        if host_dtype not in HOST_DTYPES:
            raise ValueError(
                f"host_dtype must be one of {HOST_DTYPES}, got "
                f"{host_dtype!r}")
        self.planes = dict(planes)
        self.host_dtype = host_dtype
        self.seed = int(seed)
        self.init_scale = float(init_scale)
        self.vocab = LazyVocabulary(num_fields)
        self._lock = threading.Lock()
        self._cap = 0
        self._initial_rows = max(1, int(initial_rows))
        self._fp32: Dict[str, np.ndarray] = {}
        self._codes: Dict[str, np.ndarray] = {}
        self._scales: Dict[str, np.ndarray] = {}
        self._backfill: Optional[Callable] = None
        self._plane_index = {
            name: i for i, name in enumerate(sorted(self.planes))}

    # ---- capacity ------------------------------------------------------

    def _ensure_capacity(self, rows_needed: int) -> None:
        if rows_needed <= self._cap:
            return
        new_cap = max(self._initial_rows, self._cap)
        while new_cap < rows_needed:
            new_cap = new_cap + max(new_cap // 2, self._initial_rows)
        for name, dim in self.planes.items():
            if self.host_dtype == "fp32":
                arr = np.zeros((new_cap, dim), np.float32)
                if self._cap:
                    arr[: self._cap] = self._fp32[name]
                self._fp32[name] = arr
            else:
                codes = np.zeros((new_cap, dim), np.int8)
                scales = np.ones((new_cap, 1), np.float32)
                if self._cap:
                    codes[: self._cap] = self._codes[name]
                    scales[: self._cap] = self._scales[name]
                self._codes[name] = codes
                self._scales[name] = scales
        self._cap = new_cap

    # ---- growth and lookup ---------------------------------------------

    def set_backfill(self, fn: Optional[Callable]) -> None:
        with self._lock:
            self._backfill = fn

    def assign(self, sparse: np.ndarray):
        """Map ids to rows, growing and initialising new rows.  Returns
        (rows (B, F) int64, the number of new rows)."""
        with self._lock:
            rows, new_fields, new_ids, new_rows = self.vocab.assign(sparse)
            if new_rows.size:
                self._ensure_capacity(self.vocab.size)
                for name, dim in self.planes.items():
                    values = None
                    if self._backfill is not None:
                        values = self._backfill(name, new_fields, new_ids)
                    if values is None:
                        values = row_init_values(
                            self.seed, self._plane_index[name], new_rows,
                            dim, self.init_scale)
                    self._write_rows(name, new_rows, values)
            return rows, int(new_rows.size)

    def lookup(self, sparse: np.ndarray) -> np.ndarray:
        with self._lock:
            return self.vocab.lookup(sparse)

    @property
    def size(self) -> int:
        with self._lock:
            return self.vocab.size

    @property
    def nbytes(self) -> int:
        """Bytes of the assigned rows (planes are allocated at the first
        growth, so an empty tier holds none)."""
        with self._lock:
            total = 0
            for name in self.planes:
                if self.host_dtype == "fp32":
                    if name in self._fp32:
                        total += self._fp32[name][: self.vocab.size].nbytes
                elif name in self._codes:
                    total += self._codes[name][: self.vocab.size].nbytes
                    total += self._scales[name][: self.vocab.size].nbytes
            return total

    # ---- row values ----------------------------------------------------

    def _write_rows(self, name: str, rows: np.ndarray,
                    values: np.ndarray) -> None:
        values = np.asarray(values, np.float32).reshape(
            -1, self.planes[name])
        if self.host_dtype == "fp32":
            self._fp32[name][rows] = values
        else:
            codes, scales = quantize_rows_host(values)
            self._codes[name][rows] = codes
            self._scales[name][rows] = scales

    def gather(self, rows: np.ndarray, planes=None) -> Dict[str, np.ndarray]:
        """fp32 copies of `rows`, per plane; the rows must be assigned."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        with self._lock:
            if rows.size and int(rows.max()) >= self.vocab.size:
                raise IndexError("gather of unassigned store row")
            out = {}
            for name in planes if planes is not None else self.planes:
                if self.host_dtype == "fp32":
                    out[name] = self._fp32[name][rows].copy()
                else:
                    out[name] = dequantize_rows_host(
                        self._codes[name][rows], self._scales[name][rows])
            return out

    def set_rows(self, rows: np.ndarray,
                 values: Dict[str, np.ndarray]) -> None:
        """Absolute write-back (the eviction fold)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        with self._lock:
            if rows.size and int(rows.max()) >= self.vocab.size:
                raise IndexError("set_rows of unassigned store row")
            for name, vals in values.items():
                self._write_rows(name, rows, vals)

    def reinit_rows(self, rows: np.ndarray) -> None:
        """Rewrite `rows` with their deterministic init: the sharded
        store's recovery of rows grown after the last sidecar.
        `row_init_values` keys on (seed, plane, row) alone, so the value
        is the one the row first grew with."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size == 0:
            return
        with self._lock:
            if int(rows.max()) >= self.vocab.size:
                raise IndexError("reinit_rows of unassigned store row")
            for name, dim in self.planes.items():
                values = row_init_values(
                    self.seed, self._plane_index[name], rows, dim,
                    self.init_scale)
                self._write_rows(name, rows, values)

    # ---- serialization -------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Owning copies of the vocabulary and the planes, under the
        JAX package's keys (each package reads the other's sidecar)."""
        with self._lock:
            n = self.vocab.size
            fields, ids, rows = self.vocab.state_arrays()
            out = {
                "vocab_fields": fields,
                "vocab_ids": ids,
                "vocab_rows": rows,
            }
            # a tier that never grew has no planes yet: empty ones
            self._ensure_capacity(1)
            for name in self.planes:
                if self.host_dtype == "fp32":
                    out[f"plane_{name}_fp32"] = self._fp32[name][:n].copy()
                else:
                    out[f"plane_{name}_codes"] = self._codes[name][:n].copy()
                    out[f"plane_{name}_scales"] = \
                        self._scales[name][:n].copy()
            return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        with self._lock:
            self.vocab = LazyVocabulary.from_arrays(
                self.vocab.num_fields, state["vocab_fields"],
                state["vocab_ids"], state["vocab_rows"])
            n = self.vocab.size
            self._cap = 0
            self._fp32, self._codes, self._scales = {}, {}, {}
            self._ensure_capacity(max(n, 1))
            for name in self.planes:
                if self.host_dtype == "fp32":
                    self._fp32[name][:n] = state[f"plane_{name}_fp32"]
                else:
                    self._codes[name][:n] = state[f"plane_{name}_codes"]
                    self._scales[name][:n] = state[f"plane_{name}_scales"]
