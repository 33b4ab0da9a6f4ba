"""Master servicer: the job brain's call surface (the port's copy of the
task, evaluation and version handlers of the JAX package's
master/servicer.py).

Handlers only touch the task queue and the metric dicts, never tensors.
A task report's `__`-prefixed exec_counters are worker telemetry, kept
per worker for `Master.snapshot()` (`worker_telemetry`).  The SPMD,
cluster-spec and keep-alive handlers wait for the cluster slice of the
port.
"""

from __future__ import annotations

import threading
import time

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.proto import messages as pb

# exec_counters keys carrying worker telemetry on task reports
# (worker/task_data_service.py): a double underscore can never collide
# with a real execution counter
TELEMETRY_KEY_PREFIX = "__"


class MasterServicer:
    def __init__(self, task_manager: TaskManager, evaluation_service=None):
        self._tm = task_manager
        self._eval = evaluation_service
        self._max_model_version = 0
        # worker_id -> latest telemetry peeled from report exec_counters
        self._telemetry_lock = threading.Lock()
        self._worker_telemetry = {}

    # ---- task dispatch -------------------------------------------------

    def get_task(self, req: pb.GetTaskRequest, ctx) -> pb.GetTaskResponse:
        task_type = req.task_type if req.filter_by_type else None
        task = self._tm.get(req.worker_id, task_type=task_type)
        if task is not None:
            events.emit(events.TASK_DISPATCHED, task_id=task.task_id,
                        worker_id=req.worker_id, task_type=int(task.type))
            return pb.GetTaskResponse(task=task)
        # the WAIT sentinel: task_id -1
        return pb.GetTaskResponse(task=pb.Task(task_id=-1, type=pb.WAIT),
                                  job_finished=self._tm.finished)

    def report_task_result(self, req: pb.ReportTaskResultRequest, ctx):
        success = req.err_message == ""
        self._absorb_telemetry(req)
        self._tm.report(
            req.task_id,
            success=success,
            worker_id=req.worker_id,
            records=req.exec_counters.get("records", 0),
            transient=req.transient,
            model_version=req.exec_counters.get("model_version", -1),
        )
        events.emit(events.TASK_REPORTED, task_id=req.task_id,
                    worker_id=req.worker_id, success=success)
        return pb.Empty()

    def _absorb_telemetry(self, req: pb.ReportTaskResultRequest) -> None:
        """Peel the `__`-prefixed keys from exec_counters into the
        worker's telemetry entry, stamped with the report's wall time."""
        fields = {
            key[len(TELEMETRY_KEY_PREFIX):]: int(value)
            for key, value in req.exec_counters.items()
            if key.startswith(TELEMETRY_KEY_PREFIX)
        }
        if not fields:
            return
        with self._telemetry_lock:
            entry = self._worker_telemetry.setdefault(req.worker_id, {})
            entry.update(fields)
            entry["last_report_unix_s"] = int(time.time())

    def worker_telemetry(self) -> dict:
        """worker_id -> latest reported telemetry (plain dict copy)."""
        with self._telemetry_lock:
            return {wid: dict(entry)
                    for wid, entry in self._worker_telemetry.items()}

    # ---- evaluation ----------------------------------------------------

    def report_evaluation_metrics(
            self, req: pb.ReportEvaluationMetricsRequest, ctx):
        if self._eval is not None:
            self._eval.report_metrics(req)
        return pb.Empty()

    def report_version(self, req: pb.ReportVersionRequest, ctx):
        self._max_model_version = max(self._max_model_version,
                                      req.model_version)
        if self._eval is not None:
            self._eval.on_version_report(req.model_version)
        return pb.Empty()

    # ---- introspection -------------------------------------------------

    @property
    def max_model_version(self) -> int:
        return self._max_model_version
