"""Worker runtime: pull tasks, train / evaluate / predict, report (the
port's copy of the JAX package's worker/worker.py).

The only calls to the master are per shard: get_task and report.  Model
state lives in a `ModelOwner` (worker/sync.py); workers sharing one owner
train one model.

A task's exception is reported to the master as the task's failure
(`err_message`); the master re-queues it up to its retry budget.  That
is the one place an exception is caught and the loop goes on.

Batches parse into the wire format `--wire_format` asks for (plain,
compact or dedup; `resolve_wire_format` falls back where the zoo lacks
a feed), for training, evaluation and prediction tasks alike.  A
SAVE_MODEL task checkpoints and, when its rider names an output
directory, exports a snapshot of the model (`export_for_task`).  The
remesh path, TensorBoard scalars, `--profile_dir` traces and the program
registry binding wait for their slices of the port.
"""

from __future__ import annotations

import json
import traceback
from collections import deque
from typing import Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common.export import export_model
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_handler import (
    ModelSpec,
    resolve_wire_format,
)
from elasticdl_tpu_torch.common.profiler import PhaseTimer, StepTimer
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.sync import ModelOwner
from elasticdl_tpu_torch.worker.trainer import STORE_KEYS
from elasticdl_tpu_torch.worker.task_data_service import (
    TaskDataService,
    prefetch_batches,
)

logger = get_logger(__name__)


def invoke_callbacks(callbacks, hook: str, *args) -> None:
    """Fire one zoo-callback hook (on_task_start(task), on_task_end(task,
    records), on_job_end()) on every callback that implements it.  A
    raising callback fails the task like any other task error."""
    for cb in callbacks or ():
        fn = getattr(cb, hook, None)
        if fn is not None:
            fn(*args)


# rows of (label, prediction) samples per evaluation report
EVAL_SAMPLE_CHUNK_FLOATS = 1 << 18


def report_evaluation_with_samples(
    client, worker_id: int, model_version: int,
    metrics: Dict[str, float], num_examples: int, labels, preds,
    task_id: int = -1,
) -> None:
    """Report shard metrics plus the raw (label, prediction) samples so
    the master recomputes rank metrics (AUC) exactly over the merged
    validation set.  Samples go in chunks; continuation chunks set
    samples_only so the scalars and num_examples count once."""
    labels = np.asarray(labels, np.float32)
    preds2 = np.asarray(preds, np.float32).reshape(len(labels), -1)
    width = preds2.shape[1]
    rows_per_chunk = max(1, EVAL_SAMPLE_CHUNK_FLOATS // (1 + width))
    first = True
    for i in range(0, len(labels), rows_per_chunk):
        j = min(i + rows_per_chunk, len(labels))
        req = pb.ReportEvaluationMetricsRequest(
            worker_id=worker_id,
            model_version=model_version,
            pred_width=width,
            samples_only=not first,
            eval_task_key=task_id + 1 if task_id >= 0 else 0,
            final_chunk=j >= len(labels),
            eval_labels=labels[i:j].copy(),
            eval_preds=preds2[i:j].reshape(-1).copy(),
        )
        if first:
            req.num_examples = num_examples
            req.metrics = {name: float(v) for name, v in metrics.items()}
            first = False
        client.report_evaluation_metrics(req)


def _leaf_shapes(tree):
    """The leaf shapes and dtypes of a host batch; a tiered store's
    bookkeeping (its plan or raw sparse batch) is not batch data."""
    if isinstance(tree, dict):
        return tuple((k, _leaf_shapes(v)) for k, v in sorted(tree.items())
                     if k not in STORE_KEYS)
    return (tuple(np.shape(tree)), str(getattr(tree, "dtype", None)))


def _same_batch_shapes(a, b) -> bool:
    """True when two host batches have identical leaf shapes and dtypes,
    which one steps_per_execution group needs.  Only the dedup wire
    format gives consecutive batches of different shapes (its sticky pad
    caps grow, data/wire.py DedupPacker)."""
    return _leaf_shapes(a) == _leaf_shapes(b)


class TransientTaskError(RuntimeError):
    """The task is fine but this worker cannot serve it yet (e.g. an eval
    task leased before the worker has trained state).  Reported with
    transient=True: the master re-queues it without charging a retry."""


class Worker:
    def __init__(
        self,
        worker_id: int,
        master_client,
        data_reader,
        spec: ModelSpec,
        model_owner: ModelOwner,
        minibatch_size: int = 64,
        steps_per_execution: int = 1,
        compact_wire: bool = False,
        wire_format: str = "",
        phase_timer: Optional[PhaseTimer] = None,
        validation_reader=None,
    ):
        self.worker_id = worker_id
        self.spec = spec
        self.minibatch_size = minibatch_size
        # --wire_format / --compact_wire: the format batches parse into
        self.wire_format = resolve_wire_format(spec, wire_format,
                                               compact_wire, logger)
        # >1: that many steps per Trainer.train_on_batch_stack call
        self.steps_per_execution = max(1, int(steps_per_execution))
        self._client = master_client
        self._data_service = TaskDataService(master_client, data_reader,
                                             worker_id)
        self._owner = model_owner
        # phase attribution: the trainer books h2d_stage and compute, the
        # data service pack, prefetch_batches data_wait, run() report
        self.phase_timer = phase_timer or PhaseTimer()
        self._owner.trainer.phase_timer = self.phase_timer
        self._data_service.phase_timer = self.phase_timer
        self._reader = data_reader
        # evaluation tasks of a train job read their shards through the
        # validation origin's reader: a table reader addresses rows of
        # its own table whatever the shard's name, so the training
        # reader would score training rows
        self._eval_reader = data_reader
        self._eval_data_service = self._data_service
        if validation_reader is not None:
            self._eval_reader = validation_reader
            self._eval_data_service = TaskDataService(
                master_client, validation_reader, worker_id)
            self._eval_data_service.phase_timer = self.phase_timer
        # bounded: device tensors, converted lazily
        self.losses = deque(maxlen=1024)
        self.step_timer = StepTimer()
        self.predictions: Dict[int, np.ndarray] = {}
        self._stop_requested = False

    # ---- loops ---------------------------------------------------------

    def drain_and_stop(self) -> None:
        """Request a stop at the next task boundary (thread-safe); run()
        then saves a checkpoint and returns False."""
        self._stop_requested = True

    def run(self) -> bool:
        """Process tasks until the master declares the job finished.
        True on completion, False after a drain."""
        while True:
            if self._stop_requested:
                logger.info("Worker %d draining at task boundary; "
                            "flushing checkpoint", self.worker_id)
                self._owner.save_and_flush()
                return False
            task, finished = self._data_service.get_task(
                should_stop=lambda: self._stop_requested)
            if finished:
                logger.info("Job finished; worker %d exiting",
                            self.worker_id)
                if self.step_timer.steps_per_sec:
                    self.step_timer.log(f"worker {self.worker_id}: ")
                invoke_callbacks(self.spec.callbacks, "on_job_end")
                return True
            if task is None:
                continue   # woken out of the WAIT loop by a drain
            events.emit(events.TASK_CLAIMED, task_id=task.task_id,
                        worker_id=self.worker_id, task_type=int(task.type))
            try:
                invoke_callbacks(self.spec.callbacks, "on_task_start", task)
                records = self._process_task(task)
                events.emit(events.TASK_TRAINED, task_id=task.task_id,
                            worker_id=self.worker_id, records=records)
                with self.phase_timer.phase("report"):
                    self._data_service.report_task(
                        task, records=records,
                        model_version=(self._owner.step
                                       if task.type == pb.TRAINING else -1))
                invoke_callbacks(self.spec.callbacks, "on_task_end", task,
                                 records)
                if task.type == pb.TRAINING:
                    self._client.report_version(pb.ReportVersionRequest(
                        worker_id=self.worker_id,
                        model_version=self._owner.step))
            except TransientTaskError as exc:
                logger.info("Task %d transiently unserviceable on worker "
                            "%d: %s", task.task_id, self.worker_id, exc)
                self._data_service.report_task(task, err=str(exc),
                                               transient=True)
            except Exception as exc:  # reported; the master re-queues
                logger.error("Task %d failed on worker %d: %s",
                             task.task_id, self.worker_id, exc)
                traceback.print_exc()
                # an empty str() must still read as a failure on the wire
                self._data_service.report_task(
                    task, err=str(exc) or type(exc).__name__)

    def _process_task(self, task: pb.Task) -> int:
        if task.type == pb.TRAINING:
            return self._train_task(task)
        if task.type == pb.EVALUATION:
            return self._evaluate_task(task)
        if task.type == pb.PREDICTION:
            return self._predict_task(task)
        if task.type == pb.SAVE_MODEL:
            self._save_model(task)
            return 0
        raise ValueError(f"unknown task type {task.type!r}")

    def _save_model(self, task: pb.Task):
        """Checkpoint, and export if the task's config rider asks for it
        (cluster mode: the master injects the output dir at job end)."""
        self._owner.save()
        # a snapshot: another worker thread may still be training (and
        # rewriting the live parameters in place) while the export reads
        export_for_task(
            self._owner.snapshot(), self.spec, task,
            sample_features=self._owner.sample_features,
        )

    def _train_step(self, batch):
        loss = self._owner.train_batch(batch)
        self._step_done()
        self.losses.append(loss)

    def _step_done(self):
        self.step_timer.tick()
        self.phase_timer.step_done()

    def _train_task(self, task: pb.Task) -> int:
        records = 0
        pending = []
        # single-step dispatch stages batch k+1 on the device while batch
        # k runs; the stacked path keeps host batches
        device_stage = None
        if self.steps_per_execution == 1:
            def device_stage(item):
                staged_batch, staged_real = item
                return self._owner.stage_batch(staged_batch), staged_real
        feed, feed_bulk = self._feeds(self._reader)
        for batch, real in prefetch_batches(
            self._data_service.batches_for_task(
                task, self.minibatch_size, feed, feed_bulk=feed_bulk),
            device_stage=device_stage,
            phase_timer=self.phase_timer,
        ):
            records += real
            if self.steps_per_execution == 1:
                self._train_step(batch)
                continue
            # full groups go through train_batch_stack; the task's tail
            # (fewer than steps_per_execution batches) steps one by one.
            # Dedup's sticky caps can grow between batches: a group holds
            # one shape, so the held batches step one by one first.
            if pending and not _same_batch_shapes(pending[-1], batch):
                for held in pending:
                    self._train_step(held)
                pending.clear()
            pending.append(batch)
            if len(pending) == self.steps_per_execution:
                self.losses.extend(self._owner.train_batch_stack(pending))
                for _ in pending:
                    self._step_done()
                pending.clear()
        for batch in pending:
            self._train_step(batch)
        # the task boundary must not strand accumulated phase time
        self.phase_timer.flush()
        return records

    def _evaluate_task(self, task: pb.Task) -> int:
        """Forward-only over the shard; metrics over the un-padded rows,
        reported with the samples."""
        if not self._owner.has_trained_state():
            raise TransientTaskError(
                "worker has no trained state for evaluation; re-queueing")
        records = 0
        all_labels, all_preds = [], []
        eval_state, actual_version = None, None
        feed, feed_bulk = self._feeds(self._eval_reader)
        for batch, real in self._eval_data_service.batches_for_task(
            task, self.minibatch_size, feed, feed_bulk=feed_bulk,
        ):
            if actual_version is None:
                # score the state at the task's version when it can be
                # had; otherwise label the metrics with the true step
                self._owner.ensure_state(batch)
                eval_state, actual_version = self._owner.state_for_eval(
                    task.model_version)
            preds = self._owner.predict_batch(batch, state=eval_state)
            all_labels.append(np.asarray(batch["labels"])[:real])
            all_preds.append(preds[:real])
            records += real
        if records:
            labels = np.concatenate(all_labels)
            preds = np.concatenate(all_preds)
            version = (actual_version if actual_version >= 0
                       else self._owner.step)
            metrics = {name: float(fn(labels, preds))
                       for name, fn in self.spec.eval_metrics.items()}
            report_evaluation_with_samples(
                self._client, self.worker_id, version, metrics, records,
                labels, preds, task_id=task.task_id)
        return records

    def _predict_task(self, task: pb.Task) -> int:
        """Predictions of the shard's real rows, kept by task id and only
        on completion (a re-run task replaces its rows)."""
        records = 0
        processor = self.spec.prediction_outputs_processor
        rows = []
        feed, feed_bulk = self._feeds(self._reader)
        for batch, real in self._data_service.batches_for_task(
            task, self.minibatch_size, feed, feed_bulk=feed_bulk,
        ):
            rows.append(self._owner.predict_batch(batch)[:real])
            records += real
        if rows:
            self.predictions[task.task_id] = np.concatenate(rows)
            if processor is not None:
                for chunk in rows:
                    processor.process(chunk, self.worker_id)
        return records

    def _feeds(self, reader):
        """(feed, feed_bulk) over `reader`'s metadata: the zoo's feed and
        its vectorised parse in the resolved wire format, or None for
        the latter (the streaming feed runs then)."""
        fn = {"plain": self.spec.feed_bulk,
              "compact": self.spec.feed_bulk_compact,
              "dedup": self.spec.feed_bulk_dedup}[self.wire_format]

        def feed(records):
            return self.spec.feed(records, reader.metadata)

        if fn is None:
            return feed, None
        return feed, lambda buf, sizes: fn(buf, sizes, reader.metadata)


def _task_export_config(task: pb.Task) -> dict:
    """Parse a SAVE_MODEL task's JSON config rider ({output, saved_model})."""
    if not task.extended_config:
        return {}
    try:
        return json.loads(task.extended_config)
    except ValueError:
        logger.warning(
            "Bad extended_config on task %d: %r",
            task.task_id, task.extended_config,
        )
        return {}


def export_for_task(state, spec, task: pb.Task,
                    sample_features=None) -> bool:
    """Export the model if the SAVE_MODEL task's rider names an output dir.

    Raises when an export was requested but there is no trained state —
    a silent skip would let the job report success with the output never
    written; raising re-queues the task for a worker that has state.
    """
    config = _task_export_config(task)
    output = config.get("output", "")
    if not output:
        return False
    if state is None:
        raise RuntimeError(
            "SAVE_MODEL requested an export but this worker has no "
            "trained state; re-queueing"
        )
    export_model(
        state, spec, output,
        saved_model=bool(config.get("saved_model", False)),
        sample_features=sample_features,
    )
    logger.info("Exported model to %s", output)
    return True
