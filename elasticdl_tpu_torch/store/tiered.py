"""TieredStore: the orchestrator of the host tier, the hot-row cache and
the device seam (the port of the JAX package's store/tiered.py).

Per training batch, one producer and one consumer:

  producer (the feed's prefetch thread; `wrap_feed` / `attach`):
      prepare(sparse) -> (slots, CachePlan): grow the vocabulary, plan
      the admissions, queue the host gather of the admitted rows
  store-prefetch thread:
      gathers the admitted rows' values from the host tier (numpy only)
      and sets `plan.ready`
  consumer (Trainer.train_on_batch, just before the step, inside the
  device-serialized region):
      apply_plan(state, plan): read the evicted rows off the device (an
      owning host copy) and queue their fold, wait for the prefetched
      values (rows whose fold is still in flight: flush the fold queue,
      then gather them here), write the admissions into the cache
  store-fold thread:
      writes the evicted rows' trained values back into the host tier

Every device call runs on the consumer; the threads touch numpy only.
Plans run in batch order on the one producer and apply in batch order on
the consumer, so plan k+1 sees plan k's admissions and a write-back
always carries the latest trained value.  With more than one producer
(several Local workers) or K-step blocks, `enable_deferred_prepare`
moves planning into the trainer: the feed ships the raw sparse batch and
prepare and apply run back to back under the ModelOwner's lock, in step
order, at the cost of the cold-gather overlap.  A row evicted by plan k
and re-admitted by a later plan while its fold is queued is marked
`deferred`, and apply_plan flushes the fold queue before gathering it.

Metrics: `store_cache_hits_total`, `store_cache_misses_total`,
`store_growth_rows_total`, `store_block_plans_total`,
`store_cold_gather_seconds` (histogram), and the gauges
`store_cache_occupancy_rows`, `store_cache_hit_ratio`,
`store_device_cache_bytes`, `store_mesh_shards_count`.  `stats()` reads
this store's own tallies, so two stores in one process (two jobs) do not
add up there; cold-gather time also lands in the worker's PhaseTimer as
`cold_gather`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import MetricsRegistry
from elasticdl_tpu_torch.data.wire import field_disjoint_ids
from elasticdl_tpu_torch.store import device as store_device
from elasticdl_tpu_torch.store.cache import (
    CACHE_DTYPES,
    CachePlan,
    HotRowCache,
    device_cache_bytes,
    partition_plan,
)
from elasticdl_tpu_torch.store.host_tier import HostTier
from elasticdl_tpu_torch.worker.trainer import (
    RANKING_KEY,
    STORE_PLAN_KEY,
    STORE_SPARSE_KEY,
)

logger = get_logger(__name__)


class TieredStore:
    """One store serves every embedding plane of one model (DeepFM:
    fm_embedding and fm_linear), with one vocabulary and one slot
    numbering across planes.  Each plane's `TieredArena` carries the
    plane's name in the model."""

    def __init__(self, planes: Dict[str, int], num_fields: int,
                 cache_rows: int, host_dtype: str = "fp32",
                 seed: int = 0x5EED,
                 registry: Optional[MetricsRegistry] = None,
                 phase_timer=None, cache_dtype: str = "float32"):
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype must be one of {CACHE_DTYPES}, got "
                f"{cache_dtype!r}")
        self.planes = dict(planes)
        self.num_fields = int(num_fields)
        self.cache_rows = int(cache_rows)
        self.cache_dtype = cache_dtype
        # blocks of the slot arena over `model` (set_mesh_shards)
        self.mesh_shards = 1
        self.host = HostTier(planes, num_fields, host_dtype, seed)
        self.cache = HotRowCache(cache_rows, dtype=cache_dtype)
        self.param_paths = {name: name for name in planes}
        self.phase_timer = phase_timer
        self.registry = registry if registry is not None \
            else MetricsRegistry()

        self._lock = threading.Lock()
        self.deferred_prepare = False
        self._pending_writeback = set()     # store rows with a fold queued
        self._gather_q: "queue.Queue" = queue.Queue()
        self._fold_q: "queue.Queue" = queue.Queue()
        self._threads = []
        self._started = False
        # a failure on a store thread, re-raised on the consumer
        self._thread_error: Optional[BaseException] = None
        # liveness, read by the Local runner's checks
        self.prefetch_ticks = 0
        self.fold_ticks = 0
        # cold-gather seconds by where they ran: the prefetch thread
        # (overlapped with compute) or the consumer at apply time
        self.gather_async_s = 0.0
        self.gather_sync_s = 0.0
        # this store's own tallies (the registry's families may be
        # shared by several stores in one process)
        self._tally = {"hits": 0, "misses": 0, "growth": 0,
                       "block_plans": 0}
        # the cache map as the device holds it: plans commit their map
        # when prepared, ahead of the step, and this copy follows
        # apply_plan, so a checkpoint pairs the map with the values
        self._applied_row_of = self.cache.row_of.copy()
        self._unapplied = 0

        reg = self.registry
        self._hits = reg.counter(
            "store_cache_hits_total",
            "Embedding lookups served by the device hot-row cache")
        self._misses = reg.counter(
            "store_cache_misses_total",
            "Embedding lookups that needed a host-tier admission")
        self._growth = reg.counter(
            "store_growth_rows_total",
            "Vocabulary rows lazily grown on first lookup")
        self._block_plans = reg.counter(
            "store_block_plans_total",
            "Admission plans spanning a steps_per_execution block")
        self._gather_hist = reg.histogram(
            "store_cold_gather_seconds",
            "Host-tier gather latency for cold-row admissions")
        reg.gauge_fn("store_cache_occupancy_rows",
                     lambda: float(self.cache.occupancy),
                     "Resident rows in the device hot-row cache")
        reg.gauge_fn("store_cache_hit_ratio", self._hit_ratio,
                     "Lifetime cache hit fraction of embedding lookups")
        reg.gauge_fn("store_device_cache_bytes",
                     lambda: float(self.device_cache_bytes()),
                     "Byte footprint of the device hot-row cache values")
        reg.gauge_fn("store_mesh_shards_count",
                     lambda: float(self.mesh_shards),
                     "Shards the cache slot arena is partitioned over")

    def device_cache_bytes(self) -> int:
        """Value bytes of the device cache at capacity: q8 codes and
        per-row scales for int8, 4 bytes an element for fp32 (the
        carrier and the moments exist in both modes and are left
        out)."""
        return device_cache_bytes(self.planes, self.cache_rows,
                                  self.cache_dtype)

    def set_mesh_shards(self, n: int) -> None:
        """Declare the `model` size the cache tables are row-sharded over:
        every rank holds an equal contiguous block of cache_rows / n
        slots (the blocks of `shard_tensor`), and plans carry each
        block's sub-plan."""
        n = int(n)
        if n < 1 or self.cache_rows % n:
            raise ValueError(
                f"cache_rows={self.cache_rows} must divide evenly over "
                f"{n} mesh shards")
        self.mesh_shards = n

    def _hit_ratio(self) -> float:
        with self._lock:
            total = self._tally["hits"] + self._tally["misses"]
            return self._tally["hits"] / total if total else 0.0

    # ---- background threads -------------------------------------------

    def start(self) -> None:
        """Start the prefetch and fold threads.  The Local runner starts
        them (client/api.py)."""
        if self._started:
            return
        self._started = True
        for name, fn in (("store-prefetch", self._gather_loop),
                         ("store-fold", self._fold_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Drain the pending write-backs, then stop both threads."""
        if not self._started:
            return
        self._fold_q.join()
        self._gather_q.put(None)
        self._fold_q.put(None)
        for t in self._threads:
            t.join(timeout=30.0)
        self._threads = []
        self._started = False
        self._raise_thread_error()

    @property
    def threads_alive(self) -> int:
        return sum(t.is_alive() for t in self._threads)

    def _raise_thread_error(self) -> None:
        if self._thread_error is not None:
            raise RuntimeError(
                "a tiered-store thread failed") from self._thread_error

    def _record_gather(self, seconds: float, sync: bool) -> None:
        self._gather_hist.record(seconds)
        if self.phase_timer is not None:
            self.phase_timer.add("cold_gather", seconds)
        if sync:
            self.gather_sync_s += seconds
        else:
            self.gather_async_s += seconds

    def _gather_loop(self) -> None:
        while True:
            plan = self._gather_q.get()
            if plan is None:
                return
            try:
                t0 = time.perf_counter()
                plan.admit_values = self.host.gather(plan.prefetch_rows)
                self._record_gather(time.perf_counter() - t0, sync=False)
                self.prefetch_ticks += 1
            except BaseException as exc:   # re-raised by apply_plan
                self._thread_error = exc
                logger.exception("cold-row prefetch failed")
            finally:
                plan.ready.set()

    def _fold(self, rows, values) -> None:
        self.host.set_rows(rows, values)
        with self._lock:
            for r in rows:
                self._pending_writeback.discard(int(r))
        self.fold_ticks += 1

    def _fold_loop(self) -> None:
        while True:
            item = self._fold_q.get()
            try:
                if item is None:
                    return
                self._fold(*item)
            except BaseException as exc:   # re-raised by the consumer
                self._thread_error = exc
                logger.exception("host fold failed")
            finally:
                self._fold_q.task_done()

    def flush_folds(self) -> None:
        """Wait until every queued write-back is in the host tier (the
        sidecar capture calls this before it copies the host tier)."""
        if self._started:
            self._fold_q.join()
        else:
            self._drain_fold_queue_inline()
        self._raise_thread_error()

    # ---- producer side -------------------------------------------------

    def prepare(self, sparse: np.ndarray, ranked=None):
        """Grow the vocabulary, plan the admissions and queue the host
        gather; returns (slots, plan).  Called in batch order from one
        thread.

        `ranked` is an optional `(uniq, counts)` frequency ranking of
        this batch's field-encoded ids (`wire.field_disjoint_ids(sparse)`,
        as the zoo's feed ranks them: the vocabulary keys (field, id), so
        equal raw ids of two fields must not merge).  Encoded id, (field,
        id) and store row are in bijection on the batch, so the counts
        carry over and only the unique values are translated."""
        with self._lock:
            rows, n_new = self.host.assign(sparse)
            if ranked is not None:
                ranked = self._rows_ranking(sparse, rows, ranked)
            plan = self.cache.plan(rows, ranked=ranked)
            self._finish_plan_locked(plan, n_new)
        self._publish_plan(plan, n_new)
        return plan.slots, plan

    @staticmethod
    def _rows_ranking(sparse, rows, ranked):
        uniq_ids = np.asarray(ranked[0], np.int64)
        flat_ids = field_disjoint_ids(sparse).reshape(-1)
        flat_rows = np.asarray(rows, np.int64).reshape(-1)
        sort_idx = np.argsort(flat_ids, kind="stable")
        sorted_ids = flat_ids[sort_idx]
        pos = np.searchsorted(sorted_ids, uniq_ids)
        if pos.size and (
            int(pos.max(initial=0)) >= sorted_ids.size
            or np.any(sorted_ids[np.minimum(pos, sorted_ids.size - 1)]
                      != uniq_ids)
        ):
            raise ValueError(
                "ranking does not match this batch's encoded ids: rank "
                "wire.field_disjoint_ids(sparse), not the raw per-field "
                "ids")
        rows_u = flat_rows[sort_idx[pos]]
        counts_u = np.asarray(ranked[1], np.int64)
        # ties break in row space: admission order must be that of
        # frequency_rank(rows) (ties to the smaller row), and rows are
        # claimed in first-occurrence order, not in encoded-id order
        order = np.lexsort((rows_u, -counts_u))
        return rows_u[order], counts_u[order]

    def prepare_block(self, sparse_list):
        """One admission plan over the union of K batches' rows, for a
        steps_per_execution block: the K steps share one apply point, so
        every row of every batch stays resident for the whole block and
        the victims are rows outside the union.  The ranking is
        recomputed over the union.  Returns (K slot arrays, plan)."""
        if not sparse_list:
            raise ValueError("prepare_block needs at least one batch")
        with self._lock:
            rows_list = []
            n_new = 0
            for sparse in sparse_list:
                rows, grown = self.host.assign(sparse)
                rows_list.append(np.asarray(rows))
                n_new += grown
            union = np.concatenate([r.reshape(-1) for r in rows_list])
            plan = self.cache.plan(union)
            plan.block_batches = len(rows_list)
            self._finish_plan_locked(plan, n_new)
            self._tally["block_plans"] += 1
        self._publish_plan(plan, n_new)
        self._block_plans.inc()
        flat_slots = np.asarray(plan.slots).reshape(-1)
        slots_list = []
        offset = 0
        for rows in rows_list:
            slots_list.append(
                flat_slots[offset:offset + rows.size].reshape(rows.shape))
            offset += rows.size
        return slots_list, plan

    def _finish_plan_locked(self, plan: CachePlan, n_new: int) -> None:
        plan.growth = n_new
        for r in plan.evict_rows:
            self._pending_writeback.add(int(r))
        plan.deferred = np.fromiter(
            (int(r) in self._pending_writeback for r in plan.admit_rows),
            bool, plan.admit_rows.size)
        plan.prefetch_rows = plan.admit_rows[~plan.deferred]
        if self.mesh_shards > 1:
            plan.sub_plans = partition_plan(plan, self.mesh_shards,
                                            self.cache_rows)
        self._unapplied += 1
        self._tally["hits"] += plan.hits
        self._tally["misses"] += plan.misses
        self._tally["growth"] += n_new

    def _publish_plan(self, plan: CachePlan, n_new: int) -> None:
        self._hits.inc(plan.hits)
        self._misses.inc(plan.misses)
        if n_new:
            self._growth.inc(n_new)
            events.emit(events.STORE_GROWN, rows=n_new,
                        vocab_rows=self.host.size)
        if (plan.prefetch_rows.size and self._started
                and not self.deferred_prepare):
            self._gather_q.put(plan)
        else:
            # nothing to prefetch, no threads, or deferred mode (apply
            # follows prepare at once, so the gather is synchronous and
            # counted so): apply_plan gathers
            plan.ready.set()

    # ---- consumer side -------------------------------------------------

    def apply_plan(self, state, plan: CachePlan):
        """Execute `plan` on the device and the host tier, before the
        step that reads `plan.slots`.  Returns `state` (updated in
        place)."""
        self._raise_thread_error()
        if plan.evict_rows.size:
            # read the evicted rows before the admissions overwrite them
            evicted = store_device.read_rows(
                state, self.param_paths, plan.evict_slots,
                cache_dtype=self.cache_dtype)
            self._fold_q.put((plan.evict_rows.copy(), evicted))
            if not self._started:
                self._drain_fold_queue_inline()
        if plan.admit_rows.size:
            plan.ready.wait()
            self._raise_thread_error()
            values = plan.admit_values
            missing = plan.deferred if values \
                else np.ones(plan.admit_rows.size, bool)
            if missing.any():
                # their latest value may be on the fold queue: flush it,
                # then gather here (on the critical path)
                t0 = time.perf_counter()
                self.flush_folds()
                cold = self.host.gather(plan.admit_rows[missing])
                self._record_gather(time.perf_counter() - t0, sync=True)
                full = {}
                for name, dim in self.planes.items():
                    arr = np.empty((plan.admit_rows.size, dim), np.float32)
                    if values:
                        arr[~missing] = values[name]
                    arr[missing] = cold[name]
                    full[name] = arr
                values = full
            slots = plan.admit_slots
            block = store_device.cache_block(state, self.param_paths)
            if block is not None:
                # this rank's block of the slot arena: its sub-plan
                sub = self._sub_plan(plan, block)
                mine = np.isin(slots, sub["admit_slots"])
                slots = slots[mine]
                values = {name: v[mine] for name, v in values.items()}
            state = store_device.apply_admissions(
                state, self.param_paths, slots, values,
                cache_dtype=self.cache_dtype)
        with self._lock:
            self._applied_row_of[plan.evict_slots] = -1
            self._applied_row_of[plan.admit_slots] = plan.admit_rows
            self._unapplied -= 1
        return state

    def _sub_plan(self, plan: CachePlan, block) -> dict:
        """The sub-plan of the block (index, count) a rank's cache tables
        hold; the plan must have been made for that many blocks."""
        index, count = block
        if plan.sub_plans is None or len(plan.sub_plans) != count:
            raise ValueError(
                f"the cache tables are {count} blocks over 'model' but "
                f"the plan was made for {self.mesh_shards}: call "
                f"set_mesh_shards({count}) before planning")
        return plan.sub_plans[index]

    def _drain_fold_queue_inline(self) -> None:
        """The fold, synchronously, when the threads do not run."""
        while True:
            try:
                item = self._fold_q.get_nowait()
            except queue.Empty:
                return
            try:
                if item is not None:
                    self._fold(*item)
            finally:
                self._fold_q.task_done()

    # ---- feed integration ---------------------------------------------

    def enable_deferred_prepare(self) -> None:
        """Plan in the trainer's step-serialized region instead of on
        the feed's producer (more than one producer, or K-step
        blocks)."""
        self.deferred_prepare = True

    def attach(self, batch: dict) -> dict:
        """Rewrite one feed batch: the raw `sparse` ids become cache
        `slots` and the plan rides under `__store_plan__`.  A ranking the
        feed left under `__dedup_ranking__` is consumed here.  In
        deferred mode the raw batch and ranking ride under
        `__store_sparse__` instead, with placeholder zero `slots` that
        keep the feature structure whole (ModelOwner builds the model
        from the first batch); the trainer plans at train time."""
        features = dict(batch["features"])
        sparse = features.pop("sparse")
        out = dict(batch)
        ranked = out.pop(RANKING_KEY, None)
        if self.deferred_prepare:
            sparse = np.asarray(sparse)
            features["slots"] = np.zeros(sparse.shape, np.int32)
            out["features"] = features
            out[STORE_SPARSE_KEY] = (sparse, ranked)
            return out
        slots, plan = self.prepare(sparse, ranked=ranked)
        features["slots"] = slots
        out["features"] = features
        out[STORE_PLAN_KEY] = plan
        return out

    def wrap_feed(self, feed):
        """`feed` (or a feed_bulk) with every batch it makes attached; it
        runs on the prefetch producer, the one prepare() site."""
        if feed is None:
            return None

        def wrapped(*args, **kwargs):
            return self.attach(feed(*args, **kwargs))

        return wrapped

    # ---- checkpoint integration ---------------------------------------

    def checkpoint_state(self):
        """(host state, cache map, scores, cache dtype) for a sidecar, as
        owning copies.  Call it where no plan is applied (the saver runs
        under the owner's lock).  The fold queue is joined first: a row
        evicted just before has its trained value there and nowhere
        else.  The map is the applied one: the producer may have planned
        batches ahead of the step (eager mode), and their admissions are
        not in the device values yet."""
        self.flush_folds()
        with self._lock:
            host_state = self.host.state_dict()
            row_of = self._applied_row_of.copy()
            _, score, dtype = self.cache.state_arrays()
        return host_state, row_of, score, dtype

    def load_sidecar_state(self, host_state: Dict[str, np.ndarray],
                           row_of: np.ndarray,
                           score: Optional[np.ndarray] = None,
                           cache_dtype: Optional[str] = None,
                           convert: bool = False) -> None:
        """Adopt a restored sidecar: host planes, vocabulary and cache
        map (the cache values come back with the TrainState).  A sidecar
        whose `cache_dtype` differs from this store's raises unless
        `convert` says the values were migrated."""
        with self._lock:
            if self._unapplied:
                raise RuntimeError(
                    f"{self._unapplied} admission plan(s) prepared but not "
                    "applied: restoring the store would strand their "
                    "slots (restore before planning, or plan deferred)")
            self.host.load_state_dict(host_state)
            self.cache.load_state_arrays(row_of, score, dtype=cache_dtype,
                                         convert=convert)
            self._applied_row_of = self.cache.row_of.copy()
            self._pending_writeback.clear()

    # ---- introspection -------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            tally = dict(self._tally)
        total = tally["hits"] + tally["misses"]
        gathered = self.gather_async_s + self.gather_sync_s
        return {
            "hit_rate": tally["hits"] / total if total else 0.0,
            "hits": tally["hits"],
            "misses": tally["misses"],
            "growth_rows": tally["growth"],
            "vocab_rows": self.host.size,
            "cache_occupancy_rows": self.cache.occupancy,
            "cache_rows": self.cache_rows,
            "cache_dtype": self.cache_dtype,
            "device_cache_bytes": self.device_cache_bytes(),
            "mesh_shards": self.mesh_shards,
            "block_plans": tally["block_plans"],
            "host_bytes": self.host.nbytes,
            "prefetch_ticks": self.prefetch_ticks,
            "fold_ticks": self.fold_ticks,
            "cold_gather_async_s": self.gather_async_s,
            "cold_gather_sync_s": self.gather_sync_s,
            "cold_gather_overlap_share":
                self.gather_async_s / max(gathered, 1e-12),
        }
