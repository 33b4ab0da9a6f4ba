"""Group-synchronized task assignment for SPMD training (the port of the
JAX package's master/spmd_assigner.py).

Every rank of a cluster job runs the same data-parallel step, so every
rank must consume the same task sequence.  The first rank to ask for
(epoch, seq) leases a task from the TaskManager on behalf of the group;
every other rank gets the cached answer.  The group holds the lease
under an owner id of its own per epoch, so an epoch bump (a membership
change) recovers the old group's leases and starts a new sequence.
"""

from __future__ import annotations

import threading
from typing import Dict

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)

# group lease owner ids live far above real worker ids, one per epoch
SPMD_GROUP_BASE = 1 << 20


class SpmdAssigner:
    def __init__(self, task_manager, rendezvous_server=None):
        self._tm = task_manager
        self._rendezvous = rendezvous_server
        self._lock = threading.Lock()
        self._epoch = 0
        # seq -> SpmdTaskResponse, valid for the current epoch only
        self._assignments: Dict[int, pb.SpmdTaskResponse] = {}

    def _current_epoch(self) -> int:
        if self._rendezvous is None:
            return 0
        return self._rendezvous.rendezvous_id

    def _group_id(self, epoch: int) -> int:
        return SPMD_GROUP_BASE + epoch

    def get(self, req: pb.GetSpmdTaskRequest) -> pb.SpmdTaskResponse:
        epoch = self._current_epoch()
        with self._lock:
            if epoch != self._epoch:
                # membership changed: re-queue what the old group holds
                # and start a new sequence
                recovered = self._tm.recover_tasks(
                    self._group_id(self._epoch))
                if recovered:
                    logger.info("SPMD epoch %d -> %d: recovered %d group "
                                "leases", self._epoch, epoch, recovered)
                self._assignments.clear()
                self._epoch = epoch
            if req.rendezvous_id != epoch:
                return pb.SpmdTaskResponse(epoch_stale=True)
            cached = self._assignments.get(req.seq)
            if cached is not None:
                return cached
            task = self._tm.get(self._group_id(epoch))
            if task is not None:
                resp = pb.SpmdTaskResponse(task=task)
                self._assignments[req.seq] = resp
                return resp
            if self._tm.finished:
                resp = pb.SpmdTaskResponse(
                    task=pb.Task(task_id=-1, type=pb.WAIT),
                    job_finished=True)
                self._assignments[req.seq] = resp
                return resp
            # nothing leasable yet but the job is not over: NOT cached,
            # so the first rank to ask after a task appears creates the
            # shared assignment
            return pb.SpmdTaskResponse(
                task=pb.Task(task_id=-1, type=pb.WAIT))
