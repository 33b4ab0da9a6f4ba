"""Elastic rendezvous: membership epochs (the port of the JAX package's
master/rendezvous_server.py).

The pod manager adds and removes workers; every change bumps the epoch.
A worker forms its torch.distributed group only for an epoch that is
settled (its world size equals the pod manager's target,
`set_expected`) and confirmed by every member's main thread (the
confirmation barrier): a rank wedged in a collective with a dead peer
cannot confirm, so nobody dials a group that contains it.  Ranks follow
the sorted worker ids; rank 0's host and the coordinator port are where
the group's TCPStore listens for the epoch.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)


class RendezvousServer:
    def __init__(self, coordinator_port: int = 51001):
        self._lock = threading.Lock()
        self._workers: Dict[int, str] = {}  # worker_id -> address
        self._rendezvous_id = 0
        self._coordinator_port = coordinator_port
        # the pod manager's membership target for the epoch (0: unknown)
        self._expected = 0
        # worker_id -> the last epoch its main thread confirmed
        self._confirmed: Dict[int, int] = {}

    # ---- membership (driven by the pod manager) ------------------------

    def add_worker(self, worker_id: int, address: str = "") -> int:
        with self._lock:
            if worker_id in self._workers and (
                    self._workers[worker_id] == address or not address):
                # idempotent; an empty re-report never clobbers a known
                # address
                return self._rendezvous_id
            self._workers[worker_id] = address
            self._rendezvous_id += 1
            logger.info("Rendezvous %d: +worker %d (%d total)",
                        self._rendezvous_id, worker_id, len(self._workers))
            return self._rendezvous_id

    def update_address(self, worker_id: int, address: str) -> int:
        """A member's self-reported address (keep_alive).  Only members
        update: a stale keep-alive from a removed worker must not bring
        it back.  A change bumps the epoch (the coordinator may move)."""
        with self._lock:
            if not address or worker_id not in self._workers:
                return self._rendezvous_id
            if self._workers[worker_id] == address:
                return self._rendezvous_id
            self._workers[worker_id] = address
            self._rendezvous_id += 1
            logger.info("Rendezvous %d: worker %d address -> %s",
                        self._rendezvous_id, worker_id, address)
            return self._rendezvous_id

    def set_expected(self, n: int) -> None:
        """The pod manager's membership target for this epoch."""
        with self._lock:
            self._expected = n

    def remove_worker(self, worker_id: int) -> int:
        with self._lock:
            if worker_id not in self._workers:
                return self._rendezvous_id
            del self._workers[worker_id]
            self._confirmed.pop(worker_id, None)
            self._rendezvous_id += 1
            logger.info("Rendezvous %d: -worker %d (%d left)",
                        self._rendezvous_id, worker_id, len(self._workers))
            return self._rendezvous_id

    # ---- worker-facing -------------------------------------------------

    def cluster_spec(
            self, req: Optional[pb.GetClusterSpecRequest] = None
    ) -> pb.ClusterSpec:
        with self._lock:
            if (req is not None and req.confirm_epoch
                    and req.worker_id in self._workers):
                self._confirmed[req.worker_id] = req.confirm_epoch
            all_confirmed = bool(self._workers) and all(
                self._confirmed.get(wid) == self._rendezvous_id
                for wid in self._workers)
            spec = pb.ClusterSpec(
                rendezvous_id=self._rendezvous_id,
                world_size=len(self._workers),
                expected_world_size=self._expected,
                all_confirmed=all_confirmed,
            )
            ordered = sorted(self._workers)
            for rank, worker_id in enumerate(ordered):
                spec.workers.append(pb.WorkerSpec(
                    worker_id=worker_id, address=self._workers[worker_id],
                    rank=rank))
            if ordered:
                host = (self._workers[ordered[0]]
                        or "localhost").split(":")[0]
                spec.coordinator_address = (
                    f"{host}:{self._coordinator_port}")
            return spec

    @property
    def rendezvous_id(self) -> int:
        with self._lock:
            return self._rendezvous_id
