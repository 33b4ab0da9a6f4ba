"""Dynamic data sharding: the task queue (the port's copy of the queue
core of the JAX package's master/task_manager.py).

- Training data is cut into tasks (shard descriptors: source name plus a
  half-open record range); a central todo queue is leased to workers on
  demand (`get`), leased tasks are tracked in `doing` by task id with the
  owning worker id.
- A worker that dies never reports; `recover_tasks(worker_id)` re-queues
  its in-flight tasks (at-least-once delivery).
- Leases also expire (`reap_expired_tasks`, on an injectable clock) so a
  hung worker cannot strand data.
- Evaluation, prediction and save-model tasks ride the same queue;
  evaluation tasks go to the front.
- Epochs: the training todo list is re-created (shuffled with
  `random.Random(seed + epoch)`) until `num_epochs` are done.
- Completion callbacks and pre-finish providers let the evaluation
  service and the master hook task completion without polling.

- The journal (`persist_path`, master fault tolerance): each finished
  training shard of the current epoch is written, with the model version
  it finished at, to a JSON file (through a `.tmp` and `os.replace`),
  so a relaunched job resumes the epoch without it.  A restore trusts
  the journal only up to `restore_cutoff_step` (the newest model
  checkpoint's step): a shard finished at a later or unknown version
  re-runs, and so does an epoch bump the checkpoint does not cover.  It
  parses the whole file before it changes any state; a corrupt, non-dict
  or malformed journal falls back to a fresh epoch.  The layout is the
  JAX master's, so either package reads the other's `task_state.json`.
- Straggler detection: a rolling window of training-task durations per
  worker (lease to report); a worker whose mean exceeds
  `straggler_multiple` times the lower median of the workers with at
  least `straggler_min_tasks` tasks is flagged (`straggler_snapshot`,
  the `master_straggler_workers_count` gauge, a `straggler_detected`
  event).

- Perpetual mode (`perpetual=True`, the online side): the queue never
  finishes.  Each sealed stream window (data/reader/stream_reader.py)
  becomes TRAINING tasks through `arm_window`, idempotent per window id,
  with a `task.rearm` fault point that skips an arm atomically (the
  caller re-offers the window).  A window ledger records each armed
  window's stream offsets, watermark and done task offsets; a report of
  an offset already done counts as a duplicate.  `release_window` acks
  a trained window and `forfeit_window` gives one up as lost.  With a
  journal the ledger is journaled too, and a restarted manager re-arms
  exactly the undone shards of the unreleased windows; released windows
  stay released.  The `master_stream_*` counters and the armed
  watermark's lag gauge go to the manager's registry.  The online loop
  (`online/pipeline.py`) drives it.

For the same shards and seed the task sequence (ids, types, shards) is
the JAX master's, bit for bit (a journaled manager draws its id base
from `random.Random()`, as the JAX one does).  Pure Python under one
lock; never touches tensors.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)


@dataclass
class _DoingEntry:
    worker_id: int
    task: pb.Task
    lease_start: float


class _ByTypeView:
    """Dict-shaped view (int task type -> count) over the labeled
    by-type counter, so `counters.by_type[t] = ... .get(t, 0) + 1`
    keeps working against registry storage."""

    def __init__(self, family):
        self._family = family

    def get(self, task_type: int, default: int = 0) -> int:
        value = self._family.value(type=str(task_type))
        return int(value) if value else default

    def __getitem__(self, task_type: int) -> int:
        return self.get(task_type)

    def __setitem__(self, task_type: int, value: int) -> None:
        self._family.labels(type=str(task_type)).set(float(value))

    def as_dict(self) -> Dict[int, int]:
        return {
            int(key[0]): int(value)
            for key, value in sorted(self._family.child_values().items())
            if value
        }


def _counter_property(attr: str):
    return property(
        lambda self: int(getattr(self, attr).value()),
        lambda self, v: getattr(self, attr).set(float(v)),
    )


class TaskCounters:
    """Registry-backed task counters, as in the JAX package: the
    attribute surface (`counters.finished += 1`, `counters.by_type[t]`)
    stays, the storage is the manager's metrics registry.  A replacement
    manager that adopts its predecessor's registry counts on from its
    values (the families are get-or-create)."""

    def __init__(self,
                 registry: Optional[metrics_lib.MetricsRegistry] = None):
        self.registry = registry or metrics_lib.MetricsRegistry()
        self._finished = self.registry.counter(
            "master_tasks_finished_total", "tasks reported done")
        self._failed = self.registry.counter(
            "master_tasks_failed_total", "task reports carrying an error")
        self._recovered = self.registry.counter(
            "master_tasks_recovered_total",
            "leases re-queued after a worker loss")
        self._expired = self.registry.counter(
            "master_tasks_expired_total", "leases reaped by timeout")
        self._records = self.registry.counter(
            "master_task_records_rows", "training records completed")
        self._by_type = self.registry.counter(
            "master_tasks_finished_by_type_total",
            "tasks reported done, by task type enum value",
            labelnames=("type",))
        self.by_type = _ByTypeView(self._by_type)

    finished = _counter_property("_finished")
    failed = _counter_property("_failed")
    recovered = _counter_property("_recovered")
    expired = _counter_property("_expired")
    records_done = _counter_property("_records")

    def as_dict(self) -> dict:
        return {
            "finished": self.finished,
            "failed": self.failed,
            "recovered": self.recovered,
            "expired": self.expired,
            "records_done": self.records_done,
            "by_type": self.by_type.as_dict(),
        }


def create_shards_from_ranges(
    sources: List[Tuple[str, int, int]],
    records_per_task: int,
    shuffle: bool = False,
    seed: Optional[int] = None,
) -> List[pb.Shard]:
    """Cut (name, start, end) sources into fixed-size shard descriptors."""
    shards = []
    for name, start, end in sources:
        for lo in range(start, end, records_per_task):
            shards.append(
                pb.Shard(name=name, start=lo,
                         end=min(lo + records_per_task, end)))
    if shuffle:
        random.Random(seed).shuffle(shards)
    return shards


class TaskManager:
    """Central task queue with lease / report / recover semantics."""

    # A transiently failing task (the worker cannot serve it yet)
    # re-queues without charging a retry, but past this many bounces it
    # degrades to a charged failure, so a job no worker can serve ends.
    MAX_TRANSIENT_REQUEUES = 100
    # Hold window before a transiently re-queued task is leasable again.
    TRANSIENT_HOLD_S = 1.0
    # Rolling window of recent training-task durations per worker: long
    # enough to smooth task-size variance, short enough that a worker
    # that recovers un-flags within a few tasks.
    STRAGGLER_WINDOW = 20

    def __init__(
        self,
        training_shards: Optional[List[pb.Shard]] = None,
        evaluation_shards: Optional[List[pb.Shard]] = None,
        prediction_shards: Optional[List[pb.Shard]] = None,
        num_epochs: int = 1,
        lease_timeout_s: float = 900.0,
        max_task_retries: int = 3,
        shuffle_shards: bool = False,
        shuffle_seed: Optional[int] = None,
        persist_path: Optional[str] = None,
        restore_cutoff_step: Optional[int] = None,
        straggler_multiple: float = 3.0,
        straggler_min_tasks: int = 3,
        clock: Callable[[], float] = time.time,
        perpetual: bool = False,
        metrics_registry: Optional[metrics_lib.MetricsRegistry] = None,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        self._training_shards = list(training_shards or [])
        self._evaluation_shards = list(evaluation_shards or [])
        self._prediction_shards = list(prediction_shards or [])
        self._num_epochs = num_epochs
        self._lease_timeout_s = lease_timeout_s
        self._max_task_retries = max_task_retries
        self._shuffle = shuffle_shards
        self._seed = shuffle_seed

        self._todo: deque = deque()
        self._doing: Dict[int, _DoingEntry] = {}
        self._dead_workers: set = set()
        # Stale-report guard for relaunches (journaled jobs only): a
        # per-generation random id base, so a report of the previous
        # generation's task N misses instead of acking another shard
        self._next_task_id = (
            random.Random().randrange(1 << 20, 1 << 30)
            if persist_path is not None else 0
        )
        # Jobs without training data (evaluate/predict) start with the
        # epoch requirement met, so they finish once their tasks drain.
        self._epoch = 0 if training_shards else num_epochs
        self._task_retry_count: Dict[int, int] = {}
        self._transient_count: Dict[int, int] = {}
        # task_id -> earliest leasable time of a transiently re-queued
        # task, so the same worker cannot re-lease it in a tight loop
        self._transient_hold: Dict[int, float] = {}
        # A restarted manager may adopt its predecessor's registry: the
        # stream counters are get-or-create (their values go on) and a
        # gauge re-registered reads the new manager.
        self.counters = TaskCounters(metrics_registry)
        # Straggler detection from the lease -> report durations the
        # master already sees: one rolling window per worker, a median
        # at report time, no new RPC.
        self._straggler_multiple = float(straggler_multiple)
        self._straggler_min_tasks = int(straggler_min_tasks)
        self._worker_task_s: Dict[int, deque] = {}
        self._stragglers: set = set()
        # worker_id -> clock() when its current flag was raised (the
        # dwell an eviction policy reads); cleared with the flag
        self._straggler_since: Dict[int, float] = {}
        self.counters.registry.gauge_fn(
            "master_straggler_workers_count",
            lambda: float(len(self._stragglers)),
            "workers currently flagged as stragglers (mean task "
            "duration > --straggler_multiple x fleet median)")
        # Perpetual (online) mode: sealed stream windows re-arm the queue
        # through `arm_window`, and the job never finishes by itself.
        self._perpetual = bool(perpetual)
        self._armed_windows = 0
        self._armed_tasks = 0
        self._last_window_id = -1
        self._last_window_name = ""
        self._armed_watermark_unix_s: Optional[float] = None
        # The window ledger: window_id -> name, stream start index,
        # records, task size, watermark, the set of done task offsets and
        # the released ack.  Journaled on every change, so a restarted
        # manager re-arms exactly the unfinished windows.
        self._window_ledger: Dict[int, dict] = {}
        self._window_by_name: Dict[str, int] = {}
        # ids below this floor were released and pruned: arming one
        # again is a no-op (exactly once across restarts)
        self._armed_floor = 0
        if self._perpetual:
            registry = self.counters.registry
            self._windows_armed_counter = registry.counter(
                "master_stream_windows_armed_total",
                "sealed stream windows turned into queue tasks")
            self._tasks_rearmed_counter = registry.counter(
                "master_stream_tasks_rearmed_total",
                "training tasks created by window re-arms")
            self._rearm_faults_counter = registry.counter(
                "master_stream_rearm_faults_total",
                "window re-arms skipped by an injected task.rearm fault")
            self._windows_released_counter = registry.counter(
                "master_stream_windows_released_total",
                "armed windows fully trained and acked in the ledger")
            self._windows_lost_counter = registry.counter(
                "master_stream_windows_lost_total",
                "armed windows forfeited unreplayable; must stay 0")
            self._duplicate_reports_counter = registry.counter(
                "master_stream_duplicate_reports_total",
                "task reports for window offsets the ledger already "
                "recorded done")
            registry.gauge_fn(
                "master_stream_watermark_lag_seconds",
                self._armed_watermark_lag,
                "now minus the watermark of the last armed window")
        self._completion_callbacks: List[Callable[[pb.Task, bool],
                                                  None]] = []
        self._all_done_callbacks: List[Callable[[], None]] = []
        # Pre-finish providers inject final work (the final evaluation
        # round) atomically before the job is declared finished.
        self._pre_finish_providers: List[Callable[[], list]] = []
        self._finished = False
        # The journal is armed only after construction: creating the
        # first epoch must not overwrite a journal before it is read.
        self._persist_path = None
        self._done_training_shards: Dict[tuple, int] = {}  # key -> version
        self._restore_cutoff_step = restore_cutoff_step
        self._training_records_done = 0
        # [(completed epoch, model version at completion)]: an epoch bump
        # is trusted on restore only when the checkpoint covers it
        self._epoch_history: List[Tuple[int, int]] = []

        if self._training_shards:
            self._create_training_tasks_locked()
        for shard in self._prediction_shards:
            self._todo.append(self._new_task(shard, pb.PREDICTION))
        if persist_path is not None:
            self._persist_path = persist_path
            self._maybe_restore_locked(persist_path)
            self._persist_locked()

    # ---- task creation -------------------------------------------------

    def _new_task(self, shard: pb.Shard, task_type, model_version: int = -1,
                  extended_config: str = "") -> pb.Task:
        task = pb.Task(
            task_id=self._next_task_id,
            shard=shard,
            type=pb.TaskType(task_type),
            model_version=model_version,
            extended_config=extended_config,
        )
        self._next_task_id += 1
        return task

    def _create_training_tasks_locked(self):
        shards = list(self._training_shards)
        if self._shuffle:
            seed = None if self._seed is None else self._seed + self._epoch
            random.Random(seed).shuffle(shards)
        for shard in shards:
            self._todo.append(self._new_task(shard, pb.TRAINING))
        if self._done_training_shards:
            # the epoch just completed: the model version that covers
            # all of it (-1 when any shard's version is unknown, which a
            # checkpoint cutoff never trusts)
            versions = list(self._done_training_shards.values())
            floor = -1 if min(versions) < 0 else max(versions)
            self._epoch_history.append((self._epoch, floor))
        self._epoch += 1
        self._done_training_shards.clear()
        self._persist_locked()
        logger.info("Created %d training tasks for epoch %d",
                    len(shards), self._epoch)

    # ---- the journal (master fault tolerance) --------------------------

    @staticmethod
    def _shard_key(shard: pb.Shard) -> list:
        return [shard.name, shard.start, shard.end]

    def _persist_locked(self) -> None:
        """Unthrottled: reports arrive per task, the state is a few KB,
        and a dropped trailing write would lose the newest completions
        on a crash right after them."""
        if self._persist_path is None:
            return
        state = {
            "epoch": self._epoch,
            "done_training_shards": sorted(
                [*key, v] for key, v in self._done_training_shards.items()
            ),
            "epoch_history": [list(e) for e in self._epoch_history],
            # training records only: eval and predict records count
            # again when their rounds re-run
            "records_done": self._training_records_done,
        }
        if self._perpetual:
            state["windows"] = [
                [wid, e["name"], e["start"], e["records"], e["per_task"],
                 e["watermark"], sorted(e["done"]), bool(e["released"])]
                for wid, e in sorted(self._window_ledger.items())
            ]
            state["armed_floor"] = self._armed_floor
            state["windows_armed"] = self._armed_windows
            state["tasks_armed"] = self._armed_tasks
            state["last_window_id"] = self._last_window_id
            state["last_window_name"] = self._last_window_name
            state["armed_watermark"] = self._armed_watermark_unix_s
        tmp = self._persist_path + ".tmp"
        try:
            os.makedirs(os.path.dirname(self._persist_path) or ".",
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self._persist_path)  # atomic
        except OSError as exc:
            logger.warning("task-state persist failed: %s", exc)

    def _maybe_restore_locked(self, path: str) -> None:
        if not os.path.exists(path):
            return
        # Parse everything before changing any state: a malformed
        # journal falls back to a fresh epoch, and nothing overwrites it
        # until parsing has succeeded.
        try:
            with open(path) as f:
                state = json.load(f)
            if not isinstance(state, dict):
                raise ValueError(f"journal top level is {type(state)}")
            saved_epoch = int(state.get("epoch", 1))
            saved_records = int(state.get("records_done", 0))
            entries = [
                ((str(e[0]), int(e[1]), int(e[2])), int(e[3]))
                for e in state.get("done_training_shards", [])
            ]
            history = [(int(e[0]), int(e[1]))
                       for e in state.get("epoch_history", [])]
            windows = [
                {"window_id": int(e[0]), "name": str(e[1]),
                 "start": int(e[2]), "records": int(e[3]),
                 "per_task": int(e[4]), "watermark": float(e[5]),
                 "done": {int(d) for d in e[6]}, "released": bool(e[7])}
                for e in state.get("windows", [])
            ]
            perpetual_saved = {
                "armed_floor": int(state.get("armed_floor", 0)),
                "windows_armed": int(state.get("windows_armed", 0)),
                "tasks_armed": int(state.get("tasks_armed", 0)),
                "last_window_id": int(state.get("last_window_id", -1)),
                "last_window_name": str(state.get("last_window_name", "")),
                "armed_watermark": state.get("armed_watermark"),
            }
        except (OSError, ValueError, TypeError, IndexError, KeyError,
                AttributeError) as exc:
            logger.warning("task-state restore failed (%s); starting the "
                           "epoch fresh", exc)
            return
        if self._perpetual:
            self._restore_perpetual_locked(windows, perpetual_saved,
                                           saved_records)
            return
        if not self._training_shards:
            return
        if self._restore_cutoff_step is not None:
            # trust only the epoch bumps the model checkpoint covers
            trusted = [e for e, v in history
                       if 0 <= v <= self._restore_cutoff_step]
            durable_epoch = (max(trusted) if trusted else 0) + 1
            if durable_epoch < saved_epoch:
                logger.info(
                    "Journal epoch %d post-dates the model checkpoint "
                    "(durable through epoch %d); resuming at epoch %d "
                    "and re-running its shards",
                    saved_epoch, durable_epoch - 1, durable_epoch)
                saved_epoch = durable_epoch
                entries = []  # they belong to the untrusted later epoch
            self._epoch_history = [(e, v) for e, v in history
                                   if e < saved_epoch]
        else:
            self._epoch_history = list(history)
        done: Dict[tuple, int] = {}
        dropped = dropped_records = 0
        for key, version in entries:
            if self._restore_cutoff_step is not None and (
                    version < 0 or version > self._restore_cutoff_step):
                # finished past the checkpointed step (or at an unknown
                # one): its gradients are not in the restored model
                dropped += 1
                dropped_records += key[2] - key[1]
                continue
            done[key] = version
        if dropped:
            logger.info("%d journaled shards post-date the model "
                        "checkpoint (step cutoff %s); they will re-run",
                        dropped, self._restore_cutoff_step)
        # rebuild the current epoch (its per-epoch shuffle seed) minus
        # the trusted done shards
        self._todo = deque(t for t in self._todo if t.type != pb.TRAINING)
        self._epoch = max(0, saved_epoch - 1)
        self._create_training_tasks_locked()   # sets the epoch, persists
        if done:
            self._todo = deque(
                t for t in self._todo
                if not (t.type == pb.TRAINING
                        and tuple(self._shard_key(t.shard)) in done))
            self._done_training_shards = dict(done)
        # shards that re-run are counted again when they finish
        self._training_records_done = max(0, saved_records - dropped_records)
        self.counters.records_done = self._training_records_done
        logger.info("Restored task state: epoch %d, %d/%d shards already "
                    "done, training records_done=%d", self._epoch,
                    len(done), len(self._training_shards),
                    self._training_records_done)
        self._persist_locked()

    def _restore_perpetual_locked(self, windows: List[dict], saved: dict,
                                  saved_records: int) -> None:
        """Rebuild the window ledger from the journal and re-arm exactly
        the unfinished work: TRAINING tasks for the offsets of every
        unreleased window that its done set does not cover.  Released
        windows stay released and done offsets stay done."""
        self._armed_floor = saved["armed_floor"]
        self._armed_windows = saved["windows_armed"]
        self._armed_tasks = saved["tasks_armed"]
        self._last_window_id = saved["last_window_id"]
        self._last_window_name = saved["last_window_name"]
        if saved["armed_watermark"] is not None:
            self._armed_watermark_unix_s = float(saved["armed_watermark"])
        self._training_records_done = max(0, saved_records)
        self.counters.records_done = self._training_records_done
        rearmed_windows = rearmed_tasks = 0
        rearmed_stamps: List[tuple] = []
        for entry in windows:
            wid = entry.pop("window_id")
            self._window_ledger[wid] = entry
            self._window_by_name[entry["name"]] = wid
            if entry["released"]:
                continue
            rearmed = 0
            for lo in range(0, entry["records"], entry["per_task"]):
                if lo in entry["done"]:
                    continue
                shard = pb.Shard(
                    name=entry["name"], start=lo,
                    end=min(lo + entry["per_task"], entry["records"]))
                self._todo.append(self._new_task(shard, pb.TRAINING))
                rearmed += 1
            if rearmed:
                rearmed_windows += 1
                rearmed_tasks += rearmed
                rearmed_stamps.append((int(wid), rearmed))
        self._prune_released_locked()
        for wid, n in rearmed_stamps:
            # the lineage join keeps the original armed time when it saw
            # the first arm: a restart only flags the window `rearmed`
            events.emit(
                events.WINDOW_SPAN, window_id=wid, phase="arm_wait",
                reason="rearmed", at_unix_s=round(float(self._clock()), 6),
                tasks=n)
        logger.info("Restored window ledger: %d windows journaled, %d "
                    "unfinished re-armed (%d tasks), armed_floor=%d",
                    len(windows), rearmed_windows, rearmed_tasks,
                    self._armed_floor)
        self._persist_locked()

    # ---- perpetual (online) mode ---------------------------------------

    def arm_window(
        self,
        window_name: str,
        num_records: int,
        records_per_task: int,
        watermark_unix_s: Optional[float] = None,
        window_id: Optional[int] = None,
        start_index: int = 0,
    ) -> Optional[int]:
        """Turn one sealed stream window into TRAINING tasks and open its
        ledger entry.  Returns the number of tasks armed, or None when an
        injected `task.rearm` fault skipped the arm atomically (nothing
        queued; the caller keeps the window and re-offers it).  Idempotent
        per window id: a window the ledger tracks, or has released,
        returns 0."""
        if not self._perpetual:
            raise RuntimeError(
                "arm_window requires TaskManager(perpetual=True)")
        try:
            faults.fire(faults.POINT_TASK_REARM)
        except faults.InjectedFault as exc:
            self._rearm_faults_counter.inc()
            logger.warning("window %s re-arm skipped (%s); caller retries",
                           window_name, exc)
            return None
        per_task = max(1, int(records_per_task))
        with self._lock:
            if window_id is not None and (
                    int(window_id) < self._armed_floor
                    or int(window_id) in self._window_ledger):
                return 0
            n = 0
            for lo in range(0, int(num_records), per_task):
                shard = pb.Shard(name=window_name, start=lo,
                                 end=min(lo + per_task, int(num_records)))
                self._todo.append(self._new_task(shard, pb.TRAINING))
                n += 1
            self._armed_windows += 1
            self._armed_tasks += n
            self._last_window_name = window_name
            if window_id is not None:
                self._last_window_id = int(window_id)
                self._window_ledger[int(window_id)] = {
                    "name": window_name,
                    "start": int(start_index),
                    "records": int(num_records),
                    "per_task": per_task,
                    "watermark": float(watermark_unix_s or 0.0),
                    "done": set(),
                    "released": False,
                }
                self._window_by_name[window_name] = int(window_id)
            if watermark_unix_s is not None:
                self._armed_watermark_unix_s = float(watermark_unix_s)
            # a re-arm revives a queue that momentarily drained
            self._finished = False
            self._persist_locked()
        self._windows_armed_counter.inc()
        self._tasks_rearmed_counter.inc(n)
        events.emit(
            events.STREAM_WINDOW_ARMED,
            window=int(window_id) if window_id is not None else window_name,
            tasks=n)
        if window_id is not None:
            # closes arm_wait; a window that bounced off a `task.rearm`
            # fault stamps only when its re-offer lands, so the fault's
            # delay is charged to arm_wait
            events.emit(
                events.WINDOW_SPAN, window_id=int(window_id),
                phase="arm_wait", reason="armed",
                at_unix_s=round(float(self._clock()), 6), tasks=n)
        return n

    def _prune_released_locked(self) -> None:
        """Drop the contiguous released prefix of the ledger and move the
        armed floor past it: the journal stays bounded, and `arm_window`
        still refuses every pruned id."""
        while self._window_ledger:
            wid = min(self._window_ledger)
            if not self._window_ledger[wid]["released"]:
                break
            entry = self._window_ledger.pop(wid)
            self._window_by_name.pop(entry["name"], None)
            self._armed_floor = max(self._armed_floor, wid + 1)

    def release_window(self, window_id: int) -> bool:
        """Ack one fully trained window in the ledger; True when this
        call released it.  Its journaled shard completions go with it."""
        window_id = int(window_id)
        with self._lock:
            entry = self._window_ledger.get(window_id)
            if entry is None or entry["released"]:
                return False
            entry["released"] = True
            name = entry["name"]
            for key in [k for k in self._done_training_shards
                        if k[0] == name]:
                del self._done_training_shards[key]
            self._prune_released_locked()
            self._persist_locked()
        self._windows_released_counter.inc()
        events.emit(events.STREAM_WINDOW_RELEASED, window=window_id)
        return True

    def forfeit_window(self, window_id: int) -> bool:
        """Give up on a window that can neither train nor replay: counted
        as lost (`master_stream_windows_lost_total`), its queued tasks
        dropped and its ledger entry closed."""
        window_id = int(window_id)
        with self._lock:
            entry = self._window_ledger.get(window_id)
            if entry is None or entry["released"]:
                return False
            entry["released"] = True
            name = entry["name"]
            self._todo = deque(t for t in self._todo
                               if t.shard.name != name)
            for key in [k for k in self._done_training_shards
                        if k[0] == name]:
                del self._done_training_shards[key]
            self._prune_released_locked()
            self._persist_locked()
        self._windows_lost_counter.inc()
        logger.error("stream window %d forfeited (unreplayable)", window_id)
        return True

    def open_windows(self) -> List[dict]:
        """Unreleased ledger entries, ascending window id: what a
        restarted caller rebuilds its per-window bookkeeping from."""
        with self._lock:
            return [
                {"window_id": wid, "name": e["name"], "start": e["start"],
                 "records": e["records"], "per_task": e["per_task"],
                 "watermark": e["watermark"], "done": sorted(e["done"])}
                for wid, e in sorted(self._window_ledger.items())
                if not e["released"]
            ]

    def _armed_watermark_lag(self) -> float:
        watermark = self._armed_watermark_unix_s
        if watermark is None:
            return 0.0
        return max(0.0, float(self._clock()) - watermark)

    def online_snapshot(self) -> Optional[dict]:
        """Perpetual-mode progress (snapshot()["online"]); None outside
        perpetual mode."""
        if not self._perpetual:
            return None
        with self._lock:
            return {
                "window": self._last_window_id,
                "window_name": self._last_window_name,
                "windows_armed": self._armed_windows,
                "tasks_rearmed": self._armed_tasks,
                "rearm_faults": int(self._rearm_faults_counter.value()),
                "watermark_lag_s": round(self._armed_watermark_lag(), 6),
                "windows_released": int(
                    self._windows_released_counter.value()),
                "windows_lost": int(self._windows_lost_counter.value()),
                "duplicate_reports": int(
                    self._duplicate_reports_counter.value()),
                "open_windows": sum(
                    1 for e in self._window_ledger.values()
                    if not e["released"]),
            }

    @property
    def perpetual(self) -> bool:
        return self._perpetual

    def create_evaluation_tasks(self, model_version: int) -> int:
        """Inject evaluation tasks at the front of the queue, so metrics
        reflect the intended model version promptly."""
        with self._lock:
            for shard in self._evaluation_shards:
                self._todo.appendleft(
                    self._new_task(shard, pb.EVALUATION, model_version))
            return len(self._evaluation_shards)

    # ---- lease / report / recover -------------------------------------

    def get(self, worker_id: int, task_type=None) -> Optional[pb.Task]:
        """Lease the next task to `worker_id`; None when no task is
        available now (the worker backs off; epochs and eval injections
        may still produce more)."""
        with self._lock:
            if worker_id in self._dead_workers:
                return None
            task = None
            now = self._clock()
            for i, cand in enumerate(self._todo):
                if (task_type is None or cand.type == task_type) and (
                        self._transient_hold.get(cand.task_id, 0) <= now):
                    del self._todo[i]
                    task = cand
                    break
            if task is not None:
                self._transient_hold.pop(task.task_id, None)
            if (
                task is None
                and not self._doing
                and not self._todo
                and self._epoch < self._num_epochs
                and self._training_shards
            ):
                self._create_training_tasks_locked()
                # epoch refills are TRAINING tasks: honour a type filter
                if task_type is None or task_type == pb.TRAINING:
                    task = self._todo.popleft() if self._todo else None
            if task is not None:
                self._doing[task.task_id] = _DoingEntry(
                    worker_id=worker_id, task=task,
                    lease_start=self._clock())
            return task

    def report(self, task_id: int, success: bool, worker_id: int = -1,
               records: int = 0, transient: bool = False,
               model_version: int = -1) -> bool:
        """A worker reports a leased task done or failed.  False for an
        unknown lease (already reaped or recovered): stale reports are
        ignored.  `model_version` (the reporter's step at completion) is
        journaled with a finished training shard."""
        newly_flagged = []
        with self._lock:
            entry = self._doing.pop(task_id, None)
            if entry is None:
                logger.warning("Report for unknown task %d ignored", task_id)
                return False
            task = entry.task
            if success and task.type == pb.TRAINING and \
                    entry.worker_id >= 0:
                newly_flagged = self._observe_task_duration_locked(
                    entry.worker_id, self._clock() - entry.lease_start)
            if success:
                self.counters.finished += 1
                self.counters.records_done += records
                self.counters.by_type[task.type] = (
                    self.counters.by_type.get(task.type, 0) + 1)
                if task.type == pb.TRAINING:
                    self._training_records_done += records
                    self._done_training_shards[
                        tuple(self._shard_key(task.shard))] = model_version
                    # the window ledger: mark the offset done; a report
                    # of a done offset (at-least-once redelivery) is
                    # counted, not recorded twice
                    wid = self._window_by_name.get(task.shard.name)
                    if wid is not None:
                        done = self._window_ledger[wid]["done"]
                        if task.shard.start in done:
                            self._duplicate_reports_counter.inc()
                        else:
                            done.add(int(task.shard.start))
                    self._persist_locked()
            elif transient and (
                self._transient_count.get(task_id, 0)
                < self.MAX_TRANSIENT_REQUEUES
            ):
                self._transient_count[task_id] = (
                    self._transient_count.get(task_id, 0) + 1)
                self._transient_hold[task_id] = (
                    self._clock() + self.TRANSIENT_HOLD_S)
                self._todo.append(task)
                logger.info("Task %d transiently unserviceable; re-queued "
                            "(no retry charged)", task_id)
            else:
                self.counters.failed += 1
                retries = self._task_retry_count.get(task_id, 0) + 1
                self._task_retry_count[task_id] = retries
                if retries <= self._max_task_retries:
                    self._todo.append(task)
                    logger.info("Task %d failed (retry %d/%d); re-queued",
                                task_id, retries, self._max_task_retries)
                else:
                    logger.error("Task %d exhausted retries; dropped",
                                 task_id)
            callbacks = list(self._completion_callbacks)
            fire_done = self._check_all_done_locked()
        for wid, mean_s, median_s in newly_flagged:
            logger.warning("Straggler: worker %d averages %.3fs/task vs "
                           "fleet median %.3fs", wid, mean_s, median_s)
            events.emit(
                events.STRAGGLER_DETECTED, worker_id=wid,
                mean_task_s=round(mean_s, 6),
                median_task_s=round(median_s, 6),
                ratio=round(mean_s / median_s, 3) if median_s else 0.0)
        for cb in callbacks:
            cb(task, success)
        if fire_done:
            self._fire_all_done()
        return True

    # ---- straggler detection -------------------------------------------

    def _observe_task_duration_locked(
        self, worker_id: int, duration_s: float
    ) -> List[Tuple[int, float, float]]:
        """Record one finished training task and re-evaluate the flags;
        returns the newly flagged (worker_id, mean_s, median_s), whose
        events the caller emits outside the lock."""
        window = self._worker_task_s.setdefault(
            worker_id, deque(maxlen=self.STRAGGLER_WINDOW))
        window.append(max(0.0, float(duration_s)))
        if self._straggler_multiple <= 0:
            return []
        means = {wid: sum(w) / len(w)
                 for wid, w in self._worker_task_s.items()
                 if len(w) >= self._straggler_min_tasks}
        # a one-worker fleet has no peer to be slower than
        if len(means) < 2:
            self._stragglers.clear()
            self._straggler_since.clear()
            return []
        # the lower median: in a small even fleet the interpolated one is
        # dragged up by the straggler's own mean (with 2 workers nothing
        # would ever flag)
        ordered = sorted(means.values())
        median = ordered[(len(ordered) - 1) // 2]
        if median <= 0:
            self._stragglers.clear()
            self._straggler_since.clear()
            return []
        flagged = {wid for wid, mean in means.items()
                   if mean > self._straggler_multiple * median}
        newly = flagged - self._stragglers
        self._stragglers = flagged
        # the dwell clock restarts when a flag bounces
        now = self._clock()
        for wid in newly:
            self._straggler_since[wid] = now
        for wid in list(self._straggler_since):
            if wid not in flagged:
                del self._straggler_since[wid]
        return [(wid, means[wid], median) for wid in sorted(newly)]

    def straggler_snapshot(self) -> Dict[int, dict]:
        """worker_id -> rolling task-duration stats and the straggler
        flag (merged into Master.snapshot()["workers"])."""
        with self._lock:
            now = self._clock()
            return {
                wid: {
                    "task_count": len(window),
                    "mean_task_s": round(sum(window) / len(window), 6),
                    "straggler": wid in self._stragglers,
                    # seconds the current flag has persisted
                    "flagged_for_s": (
                        round(now - self._straggler_since[wid], 6)
                        if wid in self._straggler_since else 0.0),
                }
                for wid, window in self._worker_task_s.items()
                if window
            }

    def recover_tasks(self, worker_id: int) -> int:
        """Re-queue, at the front, every in-flight task leased by a
        (presumed dead) worker; never lease to it again."""
        with self._lock:
            self._dead_workers.add(worker_id)
            # a dead worker's window must not skew the fleet median nor
            # linger as a phantom flag
            self._worker_task_s.pop(worker_id, None)
            self._stragglers.discard(worker_id)
            self._straggler_since.pop(worker_id, None)
            dead = [tid for tid, e in self._doing.items()
                    if e.worker_id == worker_id]
            for tid in dead:
                self._todo.appendleft(self._doing.pop(tid).task)
                self.counters.recovered += 1
            if dead:
                logger.info("Recovered %d tasks from worker %d",
                            len(dead), worker_id)
            return len(dead)

    def reap_expired_tasks(self, now: Optional[float] = None) -> int:
        """Re-queue, at the front, tasks whose lease exceeded the
        timeout."""
        now = self._clock() if now is None else now
        with self._lock:
            expired = [tid for tid, e in self._doing.items()
                       if now - e.lease_start > self._lease_timeout_s]
            for tid in expired:
                entry = self._doing.pop(tid)
                self._todo.appendleft(entry.task)
                self.counters.expired += 1
                logger.warning("Task %d lease expired (worker %d); "
                               "re-queued", tid, entry.worker_id)
            return len(expired)

    # ---- completion ----------------------------------------------------

    def add_completion_callback(self, cb: Callable[[pb.Task, bool], None]):
        self._completion_callbacks.append(cb)

    def add_all_done_callback(self, cb: Callable[[], None]):
        self._all_done_callbacks.append(cb)

    def add_pre_finish_provider(self, provider: Callable[[], list]):
        """provider() -> list of (shard, task_type, model_version) or
        (shard, task_type, model_version, extended_config) tuples to
        inject when the queue first drains; called under the lock, so it
        must not call back into this TaskManager."""
        self._pre_finish_providers.append(provider)

    def start_lease_reaper(self, interval_s: float = 30.0
                           ) -> threading.Thread:
        """A daemon thread that reaps expired leases every `interval_s`
        until the job finishes (a cluster master's; the Local runner's
        leases end with its workers)."""
        def loop():
            while not self.finished:
                time.sleep(interval_s)
                self.reap_expired_tasks()

        thread = threading.Thread(target=loop, daemon=True,
                                  name="lease-reaper")
        thread.start()
        return thread

    def maybe_finish_if_drained(self) -> None:
        """Run the finish check outside any report (a job whose queue is
        already drained at start would otherwise never finish)."""
        with self._lock:
            fire = self._check_all_done_locked()
        if fire:
            self._fire_all_done()

    def _check_all_done_locked(self) -> bool:
        if self._perpetual:
            # an online job never finishes by itself: a drained queue
            # means the next window is not armed yet
            return False
        if self._finished:
            return False
        if (self._todo or self._doing
                or self._epoch < self._num_epochs):
            return False
        for provider in self._pre_finish_providers:
            injected = False
            for entry in provider():
                shard, task_type, model_version = entry[:3]
                extended = entry[3] if len(entry) > 3 else ""
                self._todo.appendleft(self._new_task(
                    shard, task_type, model_version,
                    extended_config=extended))
                injected = True
            if injected:
                return False  # final work injected; not done yet
        self._finished = True
        return True

    def _fire_all_done(self):
        logger.info("All tasks finished")
        for cb in self._all_done_callbacks:
            cb()

    # ---- introspection -------------------------------------------------

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._finished

    def snapshot(self) -> dict:
        online = self.online_snapshot()
        with self._lock:
            out = {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "epoch": self._epoch,
                "num_epochs": self._num_epochs,
                "finished": self._finished,
                "counters": self.counters.as_dict(),
                # training records of the job, a relaunch's restored
                # ones included (eval and predict records are not)
                "training_records_done": self._training_records_done,
                "task_retries": sum(self._task_retry_count.values()),
                "transient_requeues": sum(self._transient_count.values()),
                "stragglers": sorted(self._stragglers),
            }
        if online is not None:
            out["online"] = online
        return out
