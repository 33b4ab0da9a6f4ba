"""The master of a Local job (the port's copy of the Local subset of the
JAX package's master/main.py): shards from the readers -> task manager
-> evaluation service -> servicer -> wait for completion, with the final
evaluation round injected when the queue first drains.

A train job with `--checkpoint_dir` journals its finished training
shards at `<checkpoint_dir>/task_state.json`, trusted up to the newest
committed model checkpoint's step, so a relaunched job with the same
flags restores the model and trains only the shards it has not seen.  A
journal with no model checkpoint beside it is orphaned and discarded
(resuming the queue without the model would drop that data).  The
evaluation rounds' job-level metrics go to TensorBoard under
`<tensorboard_log_dir>/master` when that flag is set; `snapshot()` adds
the fault, retry and straggler stats to the task counters.

Pods, rendezvous, the policy engine, the serving fleet, metric history
and SLOs, the telemetry server and the gRPC server wait for the cluster
slice of the port.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from elasticdl_tpu_torch.common import faults, resilience
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_handler import load_module
from elasticdl_tpu_torch.common.save_utils import intact_steps
from elasticdl_tpu_torch.common.summary import SummaryWriter
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_manager import (
    TaskManager,
    create_shards_from_ranges,
)
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)


class Master:
    """Owns the control plane of one job."""

    def __init__(self, args):
        self.args = args
        self.job_type = args.job_type
        training_shards = (
            create_shards_from_ranges(
                create_data_reader(args.training_data).create_shards(),
                args.records_per_task)
            if args.training_data and self.job_type == "train" else []
        )
        evaluation_shards = (
            create_shards_from_ranges(
                create_data_reader(args.validation_data).create_shards(),
                args.records_per_task)
            if args.validation_data else []
        )
        prediction_shards = []
        if args.prediction_data and self.job_type == "predict":
            prediction_shards = create_shards_from_ranges(
                create_data_reader(args.prediction_data).create_shards(),
                args.records_per_task)
        if not (training_shards or evaluation_shards or prediction_shards):
            raise ValueError(
                f"job type {self.job_type!r} has no input data "
                "(--training_data / --validation_data / --prediction_data)")
        persist_path = restore_cutoff = None
        if args.checkpoint_dir and self.job_type == "train":
            persist_path = os.path.join(args.checkpoint_dir,
                                        "task_state.json")
            restore_cutoff = latest_model_checkpoint_step(
                args.checkpoint_dir)
            if restore_cutoff is None and os.path.exists(persist_path):
                logger.warning("Discarding orphaned task journal %s (no "
                               "model checkpoint to pair it with)",
                               persist_path)
                try:
                    os.remove(persist_path)
                except OSError:
                    pass
        self.task_manager = TaskManager(
            training_shards=training_shards,
            evaluation_shards=evaluation_shards,
            prediction_shards=prediction_shards,
            num_epochs=args.num_epochs,
            lease_timeout_s=args.task_lease_timeout_s,
            shuffle_shards=True,
            shuffle_seed=0,
            persist_path=persist_path,
            restore_cutoff_step=restore_cutoff,
            straggler_multiple=args.straggler_multiple,
            straggler_min_tasks=args.straggler_min_tasks,
        )
        # evaluate-only jobs: the eval round is the job
        if self.job_type == "evaluate" and evaluation_shards:
            self.task_manager.create_evaluation_tasks(model_version=0)
        self.eval_summary = SummaryWriter(
            os.path.join(args.tensorboard_log_dir, "master")
            if args.tensorboard_log_dir else None)
        self.evaluation_service = EvaluationService(
            self.task_manager,
            evaluation_steps=args.evaluation_steps,
            start_delay_secs=args.evaluation_start_delay_secs,
            throttle_secs=args.evaluation_throttle_secs,
            summary_writer=self.eval_summary,
            eval_metrics=self._load_eval_metrics(args),
        )
        self.servicer = MasterServicer(
            self.task_manager, evaluation_service=self.evaluation_service)
        self._done = threading.Event()
        self.task_manager.add_all_done_callback(self._done.set)
        # The final evaluation over the validation set, injected by the
        # task manager the moment the queue first drains.
        self._final_eval_done = False
        self._evaluation_shards = evaluation_shards
        if evaluation_shards and self.job_type == "train":
            self.task_manager.add_pre_finish_provider(self._final_eval_tasks)

    @staticmethod
    def _load_eval_metrics(args):
        """The zoo module's eval_metrics_fn, so job-level rank metrics
        (AUC) are recomputed exactly over the merged worker samples."""
        if not args.model_def:
            return None
        module, _ = load_module(args.model_zoo, args.model_def)
        factory = getattr(module, args.eval_metrics_fn, None)
        return factory() if factory else None

    def _final_eval_tasks(self):
        """Pre-finish provider (runs under the task-manager lock): the
        final evaluation round, exactly once."""
        if self._final_eval_done:
            return []
        self._final_eval_done = True
        version = self.servicer.max_model_version
        logger.info("Final evaluation: %d tasks at version %d",
                    len(self._evaluation_shards), version)
        return [(shard, pb.EVALUATION, version)
                for shard in self._evaluation_shards]

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job finished (True) or `timeout` passed
        (False)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return False
            wait_s = 0.2 if remaining is None else min(0.2, remaining)
            if self._done.wait(timeout=wait_s) and self.task_manager.finished:
                return True

    def snapshot(self) -> dict:
        """Task progress, the per-worker straggler stats, and the
        process-wide retry and fault counters (common/resilience.py,
        common/faults.py)."""
        return {
            "tasks": self.task_manager.snapshot(),
            "workers": self.task_manager.straggler_snapshot(),
            "resilience": resilience.stats(),
            "faults": faults.stats(),
        }

    def stop(self) -> None:
        self.eval_summary.close()


def latest_model_checkpoint_step(checkpoint_dir: str) -> Optional[int]:
    """The step a relaunch restores: the newest committed model
    checkpoint (its `state.pt` in place) that passes its manifest check,
    by the rule `CheckpointSaver.maybe_restore` applies; None when there
    is none.  Step-based, never a clock comparison."""
    steps = intact_steps(checkpoint_dir)
    return steps[-1] if steps else None
