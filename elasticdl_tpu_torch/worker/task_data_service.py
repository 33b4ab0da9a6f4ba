"""Turns the stream of leased tasks into a stream of fixed-shape batches
(the port's copy of the JAX package's worker/task_data_service.py).

The invariant: task completion means data consumed.  A task is reported
only after every batch cut from its records went through the train
loop.  Batches never span tasks; a task's last partial batch is padded
by wrapping its records (`pad_to_multiple`), with the true record count
carried alongside for metrics.

`get_task` and `report_task` retry under the data service's policy
(`rpc_policy`, default `resilience.default_policy()`), as in the JAX
package: a transport failure or an injected fault (which behaves like
one) retries with backoff (`resilience.is_retryable_error`); any other
exception propagates at once.  A master unreachable past the get budget
(`MASTER_GRACE_S`) ends the worker; a report that exhausts its budget is logged as lost, and the
task's lease is what brings it back (at-least-once).  A cluster rank
reads only its rows of each global batch (`local_batches_for_task`).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import resilience
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.trainer import STORE_KEYS

logger = get_logger(__name__)

# How long get_task retries an unreachable master before the worker
# stops (the JAX package's `master_grace_s` default).
MASTER_GRACE_S = 30.0


def pad_to_multiple(batch, multiple: int):
    """Pad a nested dict of arrays along the leading dim up to a multiple
    of `multiple`, wrapping the existing rows; returns (padded_batch,
    real_count).  (A copy of the JAX package's parallel/mesh.py
    `pad_to_multiple`, which asserts where this raises.)  A leaf keeps
    its array class (the bf16 bits of the compact format stay marked).

    Every leaf must share one leading size.  A dedup batch does not (its
    unique, starts, inverse8 and exc_val planes have four), so a dedup
    tail raises here, as it fails in the JAX package."""
    leaves = []
    # a tiered store's bookkeeping is not row data
    carried = sorted(k for k in batch if k in STORE_KEYS)

    def collect(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k not in carried:
                    collect(v)
        else:
            leaves.append(tree)

    collect(batch)
    sizes = {np.shape(x)[0] for x in leaves}
    if len(sizes) != 1:
        raise ValueError(
            f"ragged batch: leading sizes {sorted(sizes)} differ, so its "
            f"rows cannot be wrap-padded to a multiple of {multiple} (a "
            "dedup wire-format batch has four plane sizes; give its tasks "
            "a record count that is a multiple of the minibatch size)")
    n = sizes.pop()
    if n % multiple == 0:
        return batch, n
    if carried:
        raise ValueError(
            f"batch carries {carried}: a tiered-store batch is planned "
            "when the feed makes it and cannot be wrap-padded to a "
            f"multiple of {multiple} after; give its tasks a record count "
            "that is a multiple of the minibatch size")
    target = ((n + multiple - 1) // multiple) * multiple
    reps = (target + n - 1) // n

    def pad(tree):
        if isinstance(tree, dict):
            return {k: pad(v) for k, v in tree.items()}
        out = np.concatenate([tree] * reps, axis=0)[:target]
        return out.view(type(tree)) if isinstance(tree, np.ndarray) \
            else out

    return pad(batch), n


def prefetch_batches(iterator, depth: int = 2, device_stage=None,
                     device_depth: int = 1, phase_timer=None):
    """Run a host batch iterator (reader IO and feed parsing) in a
    background thread, keeping up to `depth` batches ready while the
    caller's thread drives the device.  The producer never touches the
    device.

    `device_stage`, when given, adds a second level for the host->device
    copy: up to `device_depth` upcoming batches pass through
    `device_stage(item)` on the consumer thread before the current one is
    yielded.

    Exceptions from the iterator or from device_stage re-raise at the
    consumer, after the batches staged before them.  Abandoning the
    generator stops the producer.  `phase_timer`, when given, books the
    consumer's blocked time on the queue as `data_wait`."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    error = []

    def produce():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:  # re-raised at the consumer
            error.append(exc)
        finally:
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.5)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=produce, daemon=True,
                              name="batch-prefetch")
    thread.start()

    def consume():
        while True:
            wait_start = time.perf_counter()
            item = q.get()
            if phase_timer is not None:
                phase_timer.add("data_wait",
                                time.perf_counter() - wait_start)
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item

    try:
        if device_stage is None:
            yield from consume()
            return
        staged: "deque" = deque()
        source = consume()
        while True:
            try:
                item = next(source)
                staged.append(device_stage(item))
            except StopIteration:
                break
            except BaseException:
                # batches staged before the failure are good: deliver
                # them first
                while staged:
                    yield staged.popleft()
                raise
            if len(staged) > device_depth:
                yield staged.popleft()
        while staged:
            yield staged.popleft()
    finally:
        stop.set()


class TaskDataService:
    # Step-phase attribution hook (common/profiler.PhaseTimer): feed /
    # feed_bulk parse time is the `pack` phase; the worker sets it.
    phase_timer = None

    # The most of a task's payload the bulk path holds in host memory at
    # once, in batches.
    BULK_CHUNK_BATCHES = 16

    def __init__(self, master_client, data_reader, worker_id: int,
                 wait_sleep_s: float = 0.5,
                 rpc_policy: Optional[resilience.RetryPolicy] = None):
        self._client = master_client
        self._reader = data_reader
        self._worker_id = worker_id
        self._wait_sleep_s = wait_sleep_s
        base = (rpc_policy if rpc_policy is not None
                else resilience.default_policy())
        # get_task gets the master-grace budget (exhaustion: the job is
        # over or the master is lost); reports get a short budget,
        # because the lease brings back whatever a lost report covered
        self._get_policy = base.with_overrides(
            max_elapsed_s=MASTER_GRACE_S,
            initial_backoff_s=min(wait_sleep_s, 0.5),
            retryable=resilience.is_retryable_error)
        self._report_policy = base.with_overrides(
            max_elapsed_s=10.0, retryable=resilience.is_retryable_error)

    def get_task(self, should_stop=None
                 ) -> Tuple[Optional[pb.Task], bool]:
        """Poll the master for a task: (task | None, job_finished),
        sleeping through WAIT answers.  `should_stop` is checked between
        polls; when it turns true, returns (None, False).  A master
        unreachable past `MASTER_GRACE_S` means the job is over or lost:
        (None, True)."""
        while True:
            req = pb.GetTaskRequest(worker_id=self._worker_id)
            try:
                resp = self._get_policy.call(
                    lambda: self._client.get_task(req),
                    description="get_task")
            except resilience.RetryBudgetExhausted:
                logger.error("Master unreachable for %.0fs; worker %d "
                             "stopping", MASTER_GRACE_S,
                             self._worker_id)
                return None, True
            if resp.job_finished:
                return None, True
            task = resp.task
            if task.task_id < 0 or task.type == pb.WAIT:
                if should_stop is not None and should_stop():
                    return None, False
                time.sleep(self._wait_sleep_s)
                continue
            return task, False

    def report_task(self, task: pb.Task, err: str = "", records: int = 0,
                    transient: bool = False, model_version: int = -1,
                    telemetry: Optional[dict] = None):
        req = pb.ReportTaskResultRequest(
            task_id=task.task_id, err_message=err,
            worker_id=self._worker_id, transient=transient)
        req.exec_counters["records"] = records
        if model_version >= 0:
            # the model step at completion: the master's journal pairs a
            # done shard with it and trusts it up to the checkpoint's step
            req.exec_counters["model_version"] = model_version
        # worker telemetry rides the same map under a `__` namespace; the
        # master's servicer peels it into its snapshot
        for key, value in (telemetry or {}).items():
            req.exec_counters[f"__{key}"] = int(value)
        try:
            self._report_policy.call(
                lambda: self._client.report_task_result(req),
                description="report_task_result")
        except Exception as exc:
            if not (resilience.is_retryable_error(exc) or isinstance(
                    exc, resilience.RetryBudgetExhausted)):
                raise
            # a lost report: the task's lease brings it back
            # (at-least-once)
            logger.warning("report_task_result for task %d failed: %s",
                           task.task_id, exc)

    def _timed_pack(self, fn: Optional[Callable]) -> Optional[Callable]:
        """`fn` with its parse time booked as `pack`."""
        timer = self.phase_timer
        if timer is None or fn is None:
            return fn

        def timed(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timer.add("pack", time.perf_counter() - start)

        return timed

    @staticmethod
    def _bulk_batches(bulk, batch_size: int, feed_bulk: Callable):
        """Cut one (buffer, sizes) bulk read into per-batch views; the
        tail, if any, is wrap-padded to the batch size."""
        buffer, sizes = bulk
        n = len(sizes)
        bounds = np.zeros(n + 1, np.int64)
        np.cumsum(sizes, out=bounds[1:])
        for i in range(0, n, batch_size):
            j = min(i + batch_size, n)
            batch = feed_bulk(buffer[bounds[i]: bounds[j]], sizes[i:j])
            if j - i == batch_size:
                yield batch, batch_size
            else:
                yield pad_to_multiple(batch, batch_size)

    def batches_for_task(
        self,
        task: pb.Task,
        batch_size: int,
        feed: Callable,
        feed_bulk: Optional[Callable] = None,
    ) -> Iterator[Tuple[dict, int]]:
        """Yield (batch, real_count) for one task.  With a bulk reader
        (`read_records_bulk`) and the zoo's `feed_bulk`, the records move
        as contiguous uint8 buffers, read in batch-aligned chunks of at
        most BULK_CHUNK_BATCHES batches; otherwise `feed(records)` parses
        lists of records."""
        feed = self._timed_pack(feed)
        feed_bulk = self._timed_pack(feed_bulk)
        if feed_bulk is not None:
            reader_bulk = getattr(self._reader, "read_records_bulk", None)
            if reader_bulk is not None:
                shard = task.shard
                total = shard.end - shard.start
                chunk = self.BULK_CHUNK_BATCHES * batch_size
                used_bulk = False
                for off in range(0, total, chunk):
                    sub = pb.Task(
                        task_id=task.task_id, type=task.type,
                        shard=pb.Shard(
                            name=shard.name, start=shard.start + off,
                            end=min(shard.start + off + chunk, shard.end)))
                    bulk = reader_bulk(sub)
                    if bulk is None:
                        if used_bulk:
                            # a reader that served earlier chunks must not
                            # truncate the task mid-stream
                            raise IOError(
                                f"bulk read failed mid-task at record "
                                f"{off} of {task.task_id}")
                        break   # no bulk form: the streaming path
                    used_bulk = True
                    yield from self._bulk_batches(bulk, batch_size,
                                                  feed_bulk)
                if used_bulk or total == 0:
                    return
        buf = []
        for record in self._reader.read_records(task):
            buf.append(record)
            if len(buf) == batch_size:
                yield feed(buf), batch_size
                buf = []
        if buf:
            yield pad_to_multiple(feed(buf), batch_size)

    def local_batches_for_task(
        self,
        task: pb.Task,
        batch_size: int,
        feed: Callable,
        feed_bulk: Optional[Callable],
        local_start: int,
        local_stop: int,
    ) -> Iterator[Tuple[dict, int, bool]]:
        """A cluster rank's batches: (batch, global_real, is_local).

        For each full global batch of `batch_size` records this rank
        reads only rows [local_start, local_stop) of it (its slice of
        the data axis), so the ranks together read each record once;
        those batches come with `is_local=True`.  The task's last partial
        batch, if any, is read in full and wrap-padded identically on
        every rank (`is_local=False`), so padding agrees without any
        exchange between ranks."""
        shard = task.shard
        total = shard.end - shard.start
        full = total // batch_size
        for i in range(full):
            base = shard.start + i * batch_size
            sub = pb.Task(task_id=task.task_id, type=task.type,
                          shard=pb.Shard(name=shard.name,
                                         start=base + local_start,
                                         end=base + local_stop))
            for batch, _ in self.batches_for_task(
                    sub, local_stop - local_start, feed,
                    feed_bulk=feed_bulk):
                yield batch, batch_size, True
        if total - full * batch_size:
            tail = pb.Task(task_id=task.task_id, type=task.type,
                           shard=pb.Shard(
                               name=shard.name,
                               start=shard.start + full * batch_size,
                               end=shard.end))
            for batch, real in self.batches_for_task(
                    tail, batch_size, feed, feed_bulk=feed_bulk):
                yield batch, real, False
