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

For the same shards and seed the task sequence (ids, types, shards) is
the JAX master's, bit for bit.  Pure Python under one lock; never
touches tensors.  The journal (`persist_path`, master fault tolerance),
perpetual windows (the online loop) and straggler detection wait for
their slices of the port.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)


@dataclass
class _DoingEntry:
    worker_id: int
    task: pb.Task
    lease_start: float


class TaskCounters:
    """Plain task counters, mutated under the task manager's lock."""

    def __init__(self):
        self.finished = 0
        self.failed = 0
        self.recovered = 0
        self.expired = 0
        self.records_done = 0
        self.by_type: Dict[int, int] = {}

    def as_dict(self) -> dict:
        return {
            "finished": self.finished,
            "failed": self.failed,
            "recovered": self.recovered,
            "expired": self.expired,
            "records_done": self.records_done,
            "by_type": {int(k): v for k, v in sorted(self.by_type.items())},
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
        clock: Callable[[], float] = time.time,
        persist_path: Optional[str] = None,
        perpetual: bool = False,
    ):
        if persist_path is not None:
            raise NotImplementedError(
                "the task journal (persist_path) waits for its slice of "
                "the port (ROADMAP.md queue 1, item 3)")
        if perpetual:
            raise NotImplementedError(
                "perpetual (online) task windows wait for the online-loop "
                "slice of the port (ROADMAP.md queue 1, item 10)")
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
        self._next_task_id = 0
        # Jobs without training data (evaluate/predict) start with the
        # epoch requirement met, so they finish once their tasks drain.
        self._epoch = 0 if training_shards else num_epochs
        self._task_retry_count: Dict[int, int] = {}
        self._transient_count: Dict[int, int] = {}
        # task_id -> earliest leasable time of a transiently re-queued
        # task, so the same worker cannot re-lease it in a tight loop
        self._transient_hold: Dict[int, float] = {}
        self.counters = TaskCounters()
        self._completion_callbacks: List[Callable[[pb.Task, bool],
                                                  None]] = []
        self._all_done_callbacks: List[Callable[[], None]] = []
        # Pre-finish providers inject final work (the final evaluation
        # round) atomically before the job is declared finished.
        self._pre_finish_providers: List[Callable[[], list]] = []
        self._finished = False

        if self._training_shards:
            self._create_training_tasks_locked()
        for shard in self._prediction_shards:
            self._todo.append(self._new_task(shard, pb.PREDICTION))

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
        self._epoch += 1
        logger.info("Created %d training tasks for epoch %d",
                    len(shards), self._epoch)

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
        ignored.  `model_version` (the reporter's step) is kept for the
        journal's slice."""
        with self._lock:
            entry = self._doing.pop(task_id, None)
            if entry is None:
                logger.warning("Report for unknown task %d ignored", task_id)
                return False
            task = entry.task
            if success:
                self.counters.finished += 1
                self.counters.records_done += records
                self.counters.by_type[task.type] = (
                    self.counters.by_type.get(task.type, 0) + 1)
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
        for cb in callbacks:
            cb(task, success)
        if fire_done:
            self._fire_all_done()
        return True

    def recover_tasks(self, worker_id: int) -> int:
        """Re-queue, at the front, every in-flight task leased by a
        (presumed dead) worker; never lease to it again."""
        with self._lock:
            self._dead_workers.add(worker_id)
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

    def maybe_finish_if_drained(self) -> None:
        """Run the finish check outside any report (a job whose queue is
        already drained at start would otherwise never finish)."""
        with self._lock:
            fire = self._check_all_done_locked()
        if fire:
            self._fire_all_done()

    def _check_all_done_locked(self) -> bool:
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
        with self._lock:
            return {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "epoch": self._epoch,
                "num_epochs": self._num_epochs,
                "finished": self._finished,
                "counters": self.counters.as_dict(),
                "task_retries": sum(self._task_retry_count.values()),
                "transient_requeues": sum(self._transient_count.values()),
            }
