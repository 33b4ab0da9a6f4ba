"""The device hot-row cache's bookkeeping and per-batch admission plans
(the port's copy of the JAX package's store/cache.py; numpy only).

The cache's values live in the model's `TieredArena` on the device;
this module only decides which store row holds which cache slot.
Admission is mandatory: every row a training batch touches is resident
before its step runs (gradients reach only the device table).  Per
batch the cache

  1. ranks the batch's unique rows by frequency (`wire.frequency_rank`,
     the dedup wire format's signal);
  2. counts hits (resident before this batch's admissions) and misses;
  3. fills empty slots first, then evicts the lowest-score resident rows
     outside the current batch (score: decayed lookup frequency; ties
     go to the lowest slot, so planning is deterministic);
  4. returns a `CachePlan` that `TieredStore.apply_plan` executes.

A batch with more unique rows than the cache holds raises: it cannot
keep every touched row resident.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from elasticdl_tpu_torch.data.wire import frequency_rank

# device cache storage modes (layers/arena.py ARENA_DTYPES)
CACHE_DTYPES = ("float32", "int8")


def cache_value_bytes_per_row(dim: int, cache_dtype: str) -> int:
    """Bytes one cache row of one plane puts on the gather path: fp32
    reads 4 * dim; int8 reads dim code bytes and one fp32 scale.  The
    fp32 carrier and the Adam moments exist in both modes, so they are
    left out of the comparison."""
    if cache_dtype == "int8":
        return int(dim) + 4
    return int(dim) * 4


def device_cache_bytes(planes: Dict[str, int], cache_rows: int,
                       cache_dtype: str) -> int:
    """Bytes of the cache's value storage over all planes."""
    return sum(int(cache_rows) * cache_value_bytes_per_row(dim, cache_dtype)
               for dim in planes.values())


def device_cache_bytes_per_step(planes: Dict[str, int], lookups: int,
                                cache_dtype: str) -> int:
    """Bytes one train step's gathers read from the cache: `lookups`
    row reads per plane."""
    return sum(int(lookups) * cache_value_bytes_per_row(dim, cache_dtype)
               for dim in planes.values())


def partition_plan(plan: "CachePlan", num_shards: int,
                   cache_rows: int) -> list:
    """Split one plan into per-device sub-plans over a row-sharded slot
    arena of `num_shards` contiguous blocks of cache_rows / num_shards
    slots (the device of a slot is slot // block).  Each sub-plan keeps
    the parent's admission order, and their union is the parent plan.
    The rank at `model` coordinate d applies sub-plan d
    (`TieredStore.apply_plan`)."""
    num_shards = int(num_shards)
    if num_shards < 1 or cache_rows % num_shards:
        raise ValueError(
            f"cache_rows={cache_rows} must divide evenly over "
            f"{num_shards} mesh shards (row-sharded table blocks)")
    block = cache_rows // num_shards
    subs = []
    admit_dev = np.asarray(plan.admit_slots, np.int64) // block
    evict_dev = np.asarray(plan.evict_slots, np.int64) // block
    for d in range(num_shards):
        am = admit_dev == d
        em = evict_dev == d
        subs.append({
            "device": d,
            "slot_lo": d * block,
            "slot_hi": (d + 1) * block,
            "admit_slots": plan.admit_slots[am].copy(),
            "admit_rows": plan.admit_rows[am].copy(),
            "evict_slots": plan.evict_slots[em].copy(),
            "evict_rows": plan.evict_rows[em].copy(),
        })
    return subs


@dataclass
class CachePlan:
    """One batch's admission and eviction schedule.

    `slots` is what the model takes; the admit and evict arrays are what
    `TieredStore.apply_plan` executes on the device and the host tier.
    `deferred` marks admits whose host value is still on the fold queue
    (evicted recently, write-back pending): apply_plan gathers those
    after flushing the queue."""

    slots: np.ndarray                 # (B, F) int32 cache slots
    admit_slots: np.ndarray           # (K,) int32
    admit_rows: np.ndarray            # (K,) int64 store rows
    evict_slots: np.ndarray           # (E,) int32
    evict_rows: np.ndarray            # (E,) int64 store rows
    hits: int
    misses: int
    growth: int = 0                   # vocabulary rows this batch grew
    deferred: Optional[np.ndarray] = None        # (K,) bool
    prefetch_rows: Optional[np.ndarray] = None   # admit_rows[~deferred]
    admit_values: Dict[str, np.ndarray] = field(default_factory=dict)
    ready: threading.Event = field(default_factory=threading.Event)
    # batches this plan's admissions cover (K for a steps_per_execution
    # block)
    block_batches: int = 1
    # per-block sub-plans of a slot arena row-sharded over `model`
    # (`partition_plan`; None on one block)
    sub_plans: Optional[list] = None

    def digest(self) -> str:
        """sha256 of the slots and the admit and evict arrays: two ranks
        that plan alike give the same digest."""
        h = hashlib.sha256()
        for arr in (self.slots, self.admit_slots, self.admit_rows,
                    self.evict_slots, self.evict_rows):
            arr = np.ascontiguousarray(arr)
            h.update(f"{arr.dtype}{arr.shape}".encode())
            h.update(arr.tobytes())
        return h.hexdigest()


class HotRowCache:
    """Slot bookkeeping for the device hot-row cache.  Not thread-safe
    by itself: TieredStore's lock drives it (plans are sequential
    anyway, since slot assignment is stateful)."""

    def __init__(self, capacity: int, decay: float = 0.999,
                 dtype: str = "float32"):
        if capacity < 1:
            raise ValueError("cache needs at least one row")
        if dtype not in CACHE_DTYPES:
            raise ValueError(
                f"cache dtype must be one of {CACHE_DTYPES}, got {dtype!r}")
        self.capacity = int(capacity)
        # the storage dtype of the device values this map fronts; it
        # travels with the sidecar, so an int8 cache's values never
        # restore as fp32 unnoticed
        self.dtype = dtype
        self._decay = float(decay)
        self._slot_of: Dict[int, int] = {}      # store row -> slot
        self.row_of = np.full(self.capacity, -1, np.int64)
        self._score = np.zeros(self.capacity, np.float64)

    @property
    def occupancy(self) -> int:
        return len(self._slot_of)

    def slot_of(self, row: int) -> int:
        """The resident slot of a store row, or -1."""
        return self._slot_of.get(int(row), -1)

    def plan(self, rows: np.ndarray, ranked=None) -> CachePlan:
        """The admission plan of a batch of store rows.  `ranked` is an
        optional precomputed `(uniq, counts)` ranking of exactly these
        rows; its order and tie-breaks must be those of
        `frequency_rank(rows.reshape(-1))`, since admission order decides
        victims.  A ranking that covers another count of lookups
        raises."""
        rows = np.asarray(rows, np.int64)
        flat = rows.reshape(-1)
        if ranked is None:
            uniq, counts = frequency_rank(flat)
        else:
            uniq = np.asarray(ranked[0], np.int64)
            counts = np.asarray(ranked[1], np.int64)
            if int(counts.sum()) != flat.size:
                raise ValueError(
                    f"precomputed ranking covers {int(counts.sum())} "
                    f"lookups but the batch has {flat.size}")
        if uniq.size > self.capacity:
            raise ValueError(
                f"batch touches {uniq.size} unique rows but the cache "
                f"holds {self.capacity}; shrink the batch or grow the "
                "cache: thrashing within one step is not supported "
                "(with steps_per_execution > 1 the admission block spans "
                "the union of all K batches' rows)")
        resident = np.fromiter(
            (int(r) in self._slot_of for r in uniq), bool, uniq.size)
        hits = int(counts[resident].sum())
        misses = int(counts[~resident].sum())
        admit_rows = uniq[~resident]          # descending frequency

        # victims: empty slots first, then the lowest-score residents
        # outside this batch (enough exist: free + non-batch residents
        # >= capacity - batch uniques >= admits)
        free = np.nonzero(self.row_of < 0)[0]
        n_free = min(free.size, admit_rows.size)
        admit_slots = free[:n_free].astype(np.int64)
        need = admit_rows.size - n_free
        if need > 0:
            cand = np.nonzero(
                (self.row_of >= 0) & ~np.isin(self.row_of, uniq))[0]
            order = cand[np.lexsort((cand, self._score[cand]))]
            evict_slots = order[:need]
        else:
            evict_slots = np.empty(0, np.int64)
        evict_rows = self.row_of[evict_slots].copy()

        # commit now: plans run ahead of execution, and the next plan
        # must see this one's assignments
        for r in evict_rows:
            del self._slot_of[int(r)]
        admit_slots = np.concatenate([admit_slots, evict_slots])
        for s, r in zip(admit_slots, admit_rows):
            self._slot_of[int(r)] = int(s)
            self.row_of[s] = r
            self._score[s] = 0.0

        # frequency scores: decay all, bump this batch's rows
        self._score *= self._decay
        uniq_slots = np.fromiter(
            (self._slot_of[int(r)] for r in uniq), np.int64, uniq.size)
        self._score[uniq_slots] += counts

        # row -> slot for the whole batch
        order = np.argsort(uniq, kind="stable")
        uniq_sorted, slot_sorted = uniq[order], uniq_slots[order]
        slots = slot_sorted[np.searchsorted(uniq_sorted, flat)]
        return CachePlan(
            slots=slots.reshape(rows.shape).astype(np.int32),
            admit_slots=admit_slots.astype(np.int32),
            admit_rows=admit_rows.copy(),
            evict_slots=evict_slots.astype(np.int32),
            evict_rows=evict_rows,
            hits=hits,
            misses=misses,
        )

    def reset(self) -> None:
        """Drop every residency and score: a handed-off shard's successor
        starts cold, and admission traffic rebuilds it."""
        self._slot_of.clear()
        self.row_of.fill(-1)
        self._score.fill(0.0)

    # ---- serialization -------------------------------------------------

    def state_arrays(self):
        """(row_of, score, dtype): copies of the residency map and the
        scores, and the dtype of the device values the map fronts."""
        return self.row_of.copy(), self._score.copy(), self.dtype

    def load_state_arrays(self, row_of: np.ndarray,
                          score: Optional[np.ndarray] = None,
                          dtype: Optional[str] = None,
                          convert: bool = False) -> None:
        """Adopt a saved residency map.  `dtype` is the saved cache's
        value dtype; one that differs from this cache's raises unless
        `convert=True`, the caller's word that the device values were
        converted too (CheckpointSaver's arena_convert restore)."""
        if dtype is not None and dtype != self.dtype and not convert:
            raise ValueError(
                f"cache plane dtype mismatch: sidecar holds {dtype!r} "
                f"values but this cache stores {self.dtype!r}; restore "
                "through CheckpointSaver (arena_convert migrates the "
                "device values) or pass convert=True after converting "
                "them yourself")
        row_of = np.asarray(row_of, np.int64)
        if row_of.shape != (self.capacity,):
            raise ValueError(
                f"cache map shape {row_of.shape} != ({self.capacity},)")
        self.row_of = row_of.copy()
        slots = np.nonzero(row_of >= 0)[0]
        self._slot_of = dict(zip(row_of[slots].tolist(), slots.tolist()))
        self._score = (
            np.asarray(score, np.float64).copy()
            if score is not None else np.zeros(self.capacity, np.float64))
