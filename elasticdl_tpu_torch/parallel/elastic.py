"""Worker-side elastic group lifecycle (the port of the JAX package's
parallel/elastic.py).

The cycle: poll the master's rendezvous epoch between tasks (a cheap
RPC); on a bump, join the new (world size, rank, coordinator) and build
the data axis again; the task queue has re-leased whatever the lost
workers held, so no step-exact replay is needed.

`ElasticMeshManager` re-forms the group in process.  The cluster worker
(worker/spmd.py) restarts its process for every new topology instead,
as the JAX worker does; this manager serves in-process drivers and
tests.  `devices_for_world(world_size)` lets such a test give each world
size its own device without joining a process group.
"""

from __future__ import annotations

from typing import Callable, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)


class ElasticMeshManager:
    """Tracks the membership epoch and builds the data axis again on a
    change."""

    def __init__(self, master_client, worker_id: int,
                 devices_for_world: Optional[Callable] = None,
                 use_distributed: bool = False, device: str = "cuda",
                 init_timeout_s: float = 60.0,
                 collective_timeout_s: float = 20.0):
        self._client = master_client
        self._worker_id = worker_id
        self._devices_for_world = devices_for_world
        self._use_distributed = use_distributed
        self._device = device
        self._init_timeout_s = init_timeout_s
        self._collective_timeout_s = collective_timeout_s
        self._known_id = -1
        self._mesh: Optional[mesh_lib.DataMesh] = None
        self.world_size = 0
        self.rank = -1
        self.remesh_count = 0

    def fetch_spec(self) -> pb.ClusterSpec:
        return self._client.get_cluster_spec(pb.GetClusterSpecRequest(
            worker_id=self._worker_id,
            known_rendezvous_id=self._known_id))

    def is_new_epoch(self, spec: pb.ClusterSpec) -> bool:
        return spec.rendezvous_id != self._known_id

    def needs_remesh(self) -> bool:
        return self.is_new_epoch(self.fetch_spec())

    def build_mesh(self, spec: Optional[pb.ClusterSpec] = None
                   ) -> Optional[mesh_lib.DataMesh]:
        """Join the epoch's group and return its data axis (None if this
        worker is no longer a member)."""
        spec = spec or self.fetch_spec()
        self._known_id = spec.rendezvous_id
        self.world_size = spec.world_size
        self.rank = next((w.rank for w in spec.workers
                          if w.worker_id == self._worker_id), -1)
        if self.rank < 0 or self.world_size == 0:
            logger.warning("Worker %d not in rendezvous %d",
                           self._worker_id, spec.rendezvous_id)
            return None
        if self._use_distributed:
            mesh_lib.destroy_mesh(self._mesh)
            mesh = mesh_lib.create_mesh(
                self.world_size, self.rank, self._device,
                spec.coordinator_address,
                init_timeout_s=self._init_timeout_s,
                collective_timeout_s=self._collective_timeout_s)
        elif self._devices_for_world is not None:
            mesh = mesh_lib.DataMesh(
                self.world_size, self.rank,
                self._devices_for_world(self.world_size), "", None)
        else:
            mesh = mesh_lib.DataMesh(
                self.world_size, self.rank,
                mesh_lib.device_for_rank(self.rank, self._device), "",
                None)
        self._mesh = mesh
        self.remesh_count += 1
        logger.info("Worker %d re-meshed: epoch=%d world=%d rank=%d "
                    "device=%s", self._worker_id, self._known_id,
                    self.world_size, self.rank, mesh.device)
        return mesh
