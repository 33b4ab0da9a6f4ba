"""Master servicer: the job brain's call surface (the port's copy of the
JAX package's master/servicer.py).

Handlers only touch the task queue and the metric dicts, never tensors.
A task report's `__`-prefixed exec_counters are worker telemetry, kept
per worker for `Master.snapshot()` (`worker_telemetry`).  A cluster job
adds the group-synchronized leasing (`get_spmd_task`,
master/spmd_assigner.py), the rendezvous (`get_cluster_spec`) and the
workers' liveness (`keep_alive`); a recovery clock, when given, closes
an outage at the first successful report or version report.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.master.spmd_assigner import SpmdAssigner
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.proto import messages as pb

# exec_counters keys carrying worker telemetry on task reports
# (worker/task_data_service.py): a double underscore can never collide
# with a real execution counter
TELEMETRY_KEY_PREFIX = "__"


class MasterServicer:
    def __init__(self, task_manager: TaskManager, evaluation_service=None,
                 rendezvous_server=None, recovery_clock=None):
        self._tm = task_manager
        self._eval = evaluation_service
        self._rendezvous = rendezvous_server
        self._spmd = SpmdAssigner(task_manager, rendezvous_server)
        self._worker_liveness = {}
        self._recovery_clock = recovery_clock
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

    def get_spmd_task(self, req: pb.GetSpmdTaskRequest,
                      ctx) -> pb.SpmdTaskResponse:
        """Group-synchronized leasing: every rank asking for the same
        (epoch, seq) receives the identical task."""
        return self._spmd.get(req)

    def report_task_result(self, req: pb.ReportTaskResultRequest, ctx):
        success = req.err_message == ""
        if self._recovery_clock is not None and success:
            self._recovery_clock.mark_progress()
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
        if self._recovery_clock is not None:
            self._recovery_clock.mark_progress()
        self._max_model_version = max(self._max_model_version,
                                      req.model_version)
        if self._eval is not None:
            self._eval.on_version_report(req.model_version)
        return pb.Empty()

    # ---- membership ----------------------------------------------------

    def get_cluster_spec(self, req: pb.GetClusterSpecRequest, ctx):
        if self._rendezvous is None:
            return pb.ClusterSpec(rendezvous_id=0, world_size=1)
        return self._rendezvous.cluster_spec(req)

    def keep_alive(self, req: pb.KeepAliveRequest, ctx):
        self._worker_liveness[req.worker_id] = time.time()
        if req.address and self._rendezvous is not None:
            # the worker's self-reported address corrects one the pod
            # watch delivered before the pod's IP was known
            self._rendezvous.update_address(req.worker_id, req.address)
        return pb.Empty()

    # ---- introspection -------------------------------------------------

    @property
    def max_model_version(self) -> int:
        return self._max_model_version

    def worker_last_seen(self, worker_id: int) -> Optional[float]:
        return self._worker_liveness.get(worker_id)

    def stale_workers(self, threshold_s: float) -> dict:
        """worker_id -> seconds silent, for workers whose last keep_alive
        is older than `threshold_s` (the lease reaper stays the hang
        detector; this is what the master logs)."""
        now = time.time()
        # a copy first: keep_alive adds keys from the server's threads
        return {wid: now - seen
                for wid, seen in list(self._worker_liveness.items())
                if now - seen > threshold_s}
