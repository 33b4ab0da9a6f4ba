"""The sharded tiered store: row-space shards and shard handoff (the
port of the JAX package's store/sharding.py).

`TieredStore` (tiered.py) binds one producer to one consumer.  The
online loop's trainers join and die while the state they own survives,
which this module provides:

* `ShardMap`: the store's row space splits into `num_shards` shards
  (`shard = row % num_shards`, so a row's shard never changes as the
  vocabulary grows), assigned to workers round-robin and rebalanced
  deterministically on a death or a join, with no clock and no RNG.
* `ShardedTieredStore`: ONE host tier that the master keeps (it
  survives any worker) and a `HotRowCache` slice per shard.  Planning
  splits the batch's global frequency ranking per shard, keeping its
  order inside each shard; a global slot is `shard * per_shard_rows +
  local_slot`.
* Handoff: a dead or evicted worker's shards move to the least-loaded
  live worker.  Each move fires `store.shard_handoff` first; an injected
  fault defers that move to the next handoff call and never loses it.
  The successor's cache slice starts cold; its host rows can be rebuilt
  from the sharded sidecar plus the deterministic init
  (`rebuild_shard`).

All of it is host bookkeeping (numpy under the store lock), as in the
JAX package: the online loop's model has no embedding, and its "ctr"
plane holds per-row statistics.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import MetricsRegistry
from elasticdl_tpu_torch.data.wire import frequency_rank
from elasticdl_tpu_torch.store.cache import HotRowCache
from elasticdl_tpu_torch.store.host_tier import HostTier

logger = get_logger(__name__)


class ShardMap:
    """shard -> worker assignment with deterministic rebalancing.

    All decisions are pure functions of the current assignment and the
    sorted worker ids — no clocks, no randomness — so a chaos run's
    handoff sequence is byte-stable across same-seed replays.
    """

    def __init__(self, num_shards: int, workers):
        if num_shards < 1:
            raise ValueError("need at least one shard")
        self.num_shards = int(num_shards)
        # Liveness is an EXPLICIT register, not derived from the owner
        # map: a shard whose evacuation was deferred by an injected
        # fault still names its dead owner, and that corpse must never
        # be picked as a handoff target.
        self._workers: List[int] = sorted({int(w) for w in workers})
        if not self._workers:
            raise ValueError("need at least one worker")
        self._owner: Dict[int, int] = {
            s: self._workers[s % len(self._workers)]
            for s in range(self.num_shards)
        }

    # ---- queries --------------------------------------------------------

    def owner(self, shard: int) -> int:
        return self._owner[int(shard)]

    def workers(self) -> List[int]:
        return list(self._workers)

    def worker_shards(self, worker_id: int) -> List[int]:
        return sorted(
            s for s, w in self._owner.items() if w == int(worker_id)
        )

    def shard_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.asarray(rows, np.int64) % self.num_shards

    def as_dict(self) -> Dict[int, int]:
        return dict(self._owner)

    # ---- rebalancing ----------------------------------------------------

    def least_loaded(self) -> int:
        """Least-loaded REGISTERED worker (ties toward the smallest id)
        — the handoff target, chosen at apply time so a move deferred by
        a fault re-targets against the liveness at retry, not at plan."""
        loads = {w: 0 for w in self._workers}
        for w in self._owner.values():
            if w in loads:
                loads[w] += 1
        return min(self._workers, key=lambda w: (loads[w], w))

    def remove_worker(self, worker_id: int) -> List[int]:
        """Deregister a dead/evicted worker; returns the shards needing
        evacuation (owner unchanged until each move applies)."""
        worker_id = int(worker_id)
        if worker_id not in self._workers:
            return []
        if len(self._workers) == 1:
            raise ValueError("cannot remove the last worker")
        self._workers.remove(worker_id)
        return self.worker_shards(worker_id)

    def add_worker(self, worker_id: int) -> List[int]:
        """Register a joiner; returns its fair share of shards to
        migrate, taken from the most-loaded donors (ties toward the
        largest worker id, so low-id workers keep their shards)."""
        worker_id = int(worker_id)
        if worker_id in self._workers:
            return []
        self._workers.append(worker_id)
        self._workers.sort()
        target = self.num_shards // len(self._workers)
        shards: List[int] = []
        donors = [w for w in self._workers if w != worker_id]
        loads = {w: len(self.worker_shards(w)) for w in donors}
        for _ in range(target):
            donor = max(donors, key=lambda w: (loads[w], w))
            if loads[donor] <= 1:
                break
            candidates = [
                s for s in self.worker_shards(donor) if s not in shards
            ]
            if not candidates:
                break
            loads[donor] -= 1
            shards.append(max(candidates))
        return shards

    def apply_move(self, shard: int, new_owner: int) -> None:
        self._owner[int(shard)] = int(new_owner)


@dataclass
class ShardedPlan:
    """One batch's merged per-shard admission schedule."""

    slots: np.ndarray                  # (B, F) int32 GLOBAL cache slots
    rows: np.ndarray                   # (B, F) int64 store rows
    admit_rows: np.ndarray             # (K,) int64
    evict_rows: np.ndarray             # (E,) int64
    hits: int
    misses: int
    growth: int = 0
    by_shard: Dict[int, int] = field(default_factory=dict)  # lookups/shard


class ShardedTieredStore:
    """Multi-worker tiered store: one shared host tier, per-shard cache
    slices, deterministic shard handoff.

    Unlike `TieredStore` this class is safe to drive from multiple
    logical workers: every operation takes the store lock, and plans
    stay per-shard so no cross-worker ordering is required beyond the
    lock's serialization.
    """

    def __init__(
        self,
        planes: Dict[str, int],
        num_fields: int,
        cache_rows: int,
        num_shards: int,
        workers,
        host_dtype: str = "fp32",
        seed: int = 0x5EED,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.planes = dict(planes)
        self.num_fields = int(num_fields)
        self.num_shards = int(num_shards)
        self.per_shard_rows = max(1, int(cache_rows) // self.num_shards)
        self.cache_rows = self.per_shard_rows * self.num_shards
        self.host = HostTier(planes, num_fields, host_dtype, seed)
        self.map = ShardMap(num_shards, workers)
        self._caches: Dict[int, HotRowCache] = {
            s: HotRowCache(self.per_shard_rows)
            for s in range(self.num_shards)
        }
        self._lock = threading.Lock()
        self._pending_moves: List[Tuple[int, int]] = []   # (shard, old)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._hits = self.registry.counter(
            "store_cache_hits_total",
            "Embedding lookups served by the device hot-row cache",
        )
        self._misses = self.registry.counter(
            "store_cache_misses_total",
            "Embedding lookups that needed a host-tier admission",
        )
        self._growth = self.registry.counter(
            "store_growth_rows_total",
            "Vocabulary rows lazily grown on first lookup",
        )
        self._handoffs = self.registry.counter(
            "store_shard_handoffs_total",
            "shard row-ranges reassigned to a successor worker",
        )
        self._handoff_faults = self.registry.counter(
            "store_shard_handoff_faults_total",
            "handoff moves deferred by an injected store.shard_handoff "
            "fault",
        )
        self.registry.gauge_fn(
            "store_shard_pending_handoffs_count",
            lambda: float(len(self._pending_moves)),
            "deferred shard moves awaiting retry",
        )

    # ---- admission planning --------------------------------------------

    def prepare(self, sparse: np.ndarray) -> ShardedPlan:
        """Plan one batch: grow vocab, then partition the batch-global
        frequency ranking per shard and plan each shard's cache slice.
        The global frequency order is preserved inside every shard (a
        boolean mask keeps relative order), so shard-local admission
        matches what the single global cache would have admitted for
        those rows."""
        sparse = np.asarray(sparse, np.int64)
        with self._lock:
            rows, n_new = self.host.assign(sparse)
            flat = np.asarray(rows, np.int64).reshape(-1)
            uniq, counts = frequency_rank(flat)
            shard_of_flat = self.map.shard_of_rows(flat)
            shard_of_uniq = self.map.shard_of_rows(uniq)
            global_slots = np.empty(flat.size, np.int64)
            admit_rows: List[np.ndarray] = []
            evict_rows: List[np.ndarray] = []
            hits = misses = 0
            by_shard: Dict[int, int] = {}
            for shard in np.unique(shard_of_uniq):
                shard = int(shard)
                lookup_mask = shard_of_flat == shard
                rank_mask = shard_of_uniq == shard
                plan = self._caches[shard].plan(
                    flat[lookup_mask],
                    ranked=(uniq[rank_mask], counts[rank_mask]),
                )
                offset = shard * self.per_shard_rows
                global_slots[lookup_mask] = (
                    plan.slots.reshape(-1).astype(np.int64) + offset
                )
                admit_rows.append(plan.admit_rows)
                evict_rows.append(plan.evict_rows)
                hits += plan.hits
                misses += plan.misses
                by_shard[shard] = int(lookup_mask.sum())
        self._hits.inc(hits)
        self._misses.inc(misses)
        if n_new:
            self._growth.inc(n_new)
            events.emit(events.STORE_GROWN, rows=n_new,
                        vocab_rows=self.host.size)
        return ShardedPlan(
            slots=global_slots.reshape(rows.shape).astype(np.int32),
            rows=rows,
            admit_rows=(
                np.concatenate(admit_rows) if admit_rows
                else np.empty(0, np.int64)
            ),
            evict_rows=(
                np.concatenate(evict_rows) if evict_rows
                else np.empty(0, np.int64)
            ),
            hits=hits,
            misses=misses,
            growth=n_new,
            by_shard=by_shard,
        )

    # ---- statistics plane (the online pipeline's consumer) --------------

    def fold_stats(self, rows: np.ndarray, clicked: np.ndarray,
                   plane: str = "ctr") -> None:
        """Accumulate [impressions, clicks] per store row into a host
        plane — the write-back that makes the host tier live state a
        handoff must not lose (the chaos test pins its byte stability)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        clicked = np.asarray(clicked, np.float32).reshape(-1)
        if rows.size == 0:
            return
        uniq, inverse = np.unique(rows, return_inverse=True)
        imps = np.bincount(inverse, minlength=uniq.size).astype(np.float32)
        clk = np.bincount(
            inverse, weights=clicked, minlength=uniq.size
        ).astype(np.float32)
        with self._lock:
            cur = self.host.gather(uniq, planes=(plane,))[plane]
            cur[:, 0] += imps
            if cur.shape[1] > 1:
                cur[:, 1] += clk
            self.host.set_rows(uniq, {plane: cur})

    # ---- shard handoff --------------------------------------------------

    def handoff(self, dead_worker: Optional[int] = None,
                sidecar=None) -> List[Tuple[int, int, int]]:
        """Reassign `dead_worker`'s shards (plus any moves a previous
        injected fault deferred).  Every move fires `store.shard_handoff`
        first: a raised fault defers THAT move — retried on the next
        call — and the rest proceed, so chaos never wedges the whole
        evacuation.  Returns the completed (shard, old, new) moves.

        The successor's cache slice starts empty (admission traffic
        rebuilds residency); when `sidecar` is given the shard's host
        rows are also rebuilt from it (`rebuild_shard`) — the lost-host
        recovery path."""
        with self._lock:
            moves = list(self._pending_moves)
            self._pending_moves = []
            if dead_worker is not None:
                moves.extend(
                    (s, int(dead_worker))
                    for s in self.map.remove_worker(dead_worker)
                )
            completed = self._apply_moves_locked(moves, sidecar)
        self._emit_moves(completed)
        return completed

    def join(self, new_worker: int,
             sidecar=None) -> List[Tuple[int, int, int]]:
        """Rebalance toward a joining worker (plus any deferred moves):
        same per-move fault/deferral semantics as `handoff`."""
        with self._lock:
            moves = list(self._pending_moves)
            self._pending_moves = []
            moves.extend(
                (s, self.map.owner(s))
                for s in self.map.add_worker(new_worker)
            )
            completed = self._apply_moves_locked(moves, sidecar)
        self._emit_moves(completed)
        return completed

    def _apply_moves_locked(self, moves, sidecar):
        """`moves` is (shard, old_owner) — the TARGET is chosen at apply
        time (`ShardMap.least_loaded`), so a deferred move retried after
        further deaths/joins lands on a worker that is actually alive."""
        completed: List[Tuple[int, int, int]] = []
        for shard, old in moves:
            try:
                faults.fire(faults.POINT_STORE_SHARD_HANDOFF)
            except faults.InjectedFault as exc:
                self._handoff_faults.inc()
                self._pending_moves.append((shard, old))
                logger.warning(
                    "shard %d handoff from %d deferred (%s)",
                    shard, old, exc,
                )
                continue
            new = self.map.least_loaded()
            # the moved shard's residency belonged to the old
            # worker's device table — the successor starts cold
            self._caches[shard].reset()
            if sidecar is not None:
                self._rebuild_shard_locked(shard, sidecar)
            self.map.apply_move(shard, new)
            completed.append((shard, old, new))
        return completed

    def _emit_moves(self, completed) -> None:
        for shard, old, new in completed:
            self._handoffs.inc()
            events.emit(
                events.STORE_SHARD_HANDOFF,
                shard=shard, from_worker=old, to_worker=new,
            )

    def pending_handoffs(self) -> int:
        with self._lock:
            return len(self._pending_moves)

    def shard_rows(self, shard: int) -> np.ndarray:
        """Assigned store rows belonging to `shard`."""
        n = self.host.size
        all_rows = np.arange(n, dtype=np.int64)
        return all_rows[all_rows % self.num_shards == int(shard)]

    def rebuild_shard(self, shard: int, sidecar) -> int:
        """Rebuild one shard's host-tier slice: sidecar values for rows
        the checkpoint covers, the deterministic backfill seed for rows
        grown since (host_tier.row_init_values keys on the row index, so
        the re-init equals the original init).  Returns rows rebuilt."""
        with self._lock:
            return self._rebuild_shard_locked(shard, sidecar)

    def _rebuild_shard_locked(self, shard: int, sidecar) -> int:
        rows = self.shard_rows(shard)
        if rows.size == 0:
            return 0
        covered_n = int(sidecar.meta.get("vocab_rows", 0))
        covered = rows[rows < covered_n]
        fresh = rows[rows >= covered_n]
        if covered.size:
            values = {
                name: sidecar.latest_row_values(name)[covered]
                for name in self.planes
            }
            self.host.set_rows(covered, values)
        if fresh.size:
            self.host.reinit_rows(fresh)
        return int(rows.size)

    # ---- checkpoint integration -----------------------------------------

    def cache_state(self) -> Dict[str, np.ndarray]:
        """Per-shard residency arrays for the sharded sidecar."""
        out: Dict[str, np.ndarray] = {}
        with self._lock:
            for shard, cache in self._caches.items():
                row_of, score, _ = cache.state_arrays()
                out[f"shard{shard}__row_of"] = row_of
                out[f"shard{shard}__score"] = score
        return out

    def load_cache_state(self, arrays: Dict[str, np.ndarray]) -> None:
        with self._lock:
            for shard, cache in self._caches.items():
                row_of = arrays.get(f"shard{shard}__row_of")
                if row_of is None:
                    continue
                cache.load_state_arrays(
                    row_of, arrays.get(f"shard{shard}__score")
                )

    # ---- introspection --------------------------------------------------

    def stats(self) -> dict:
        hits = self._hits.value()
        misses = self._misses.value()
        total = hits + misses
        with self._lock:
            occupancy = sum(c.occupancy for c in self._caches.values())
            owners = self.map.as_dict()
            pending = len(self._pending_moves)
        return {
            "hit_rate": (hits / total) if total else 0.0,
            "hits": int(hits),
            "misses": int(misses),
            "growth_rows": int(self._growth.value()),
            "vocab_rows": self.host.size,
            "cache_occupancy_rows": occupancy,
            "cache_rows": self.cache_rows,
            "num_shards": self.num_shards,
            "per_shard_rows": self.per_shard_rows,
            "shard_owners": {str(s): w for s, w in sorted(owners.items())},
            "handoffs": int(self._handoffs.value()),
            "handoff_faults": int(self._handoff_faults.value()),
            "pending_handoffs": pending,
            "host_bytes": self.host.nbytes,
        }
