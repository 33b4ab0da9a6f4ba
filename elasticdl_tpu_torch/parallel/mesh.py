"""The data axis of a cluster job as a torch.distributed group (the
port of the JAX package's parallel/mesh.py, its `data` axis and batch
helpers).

The JAX package lays every device of every process out as one
`jax.sharding.Mesh` and lets XLA emit the gradient reduction from the
shardings.  Here a cluster job's ranks are processes, one device each,
and `DataMesh` is the data axis: the world size, this rank, its device
and the process group its collectives run over (parallel/collectives.py,
the trainer's data-parallel step).

Stated rules, never chosen by catching an error:

- a rank's device is `cuda:(rank % torch.cuda.device_count())`, or the
  CPU when the job runs there (`device_for_rank`);
- the backend is `nccl` when every rank owns a distinct CUDA device
  (world size <= device count), and `gloo` when ranks share one device
  or run on the CPU (`backend_for`): NCCL refuses two ranks on one
  device.  Gloo takes CUDA tensors for all_reduce and broadcast; the
  gathers stage through host copies.

`create_mesh` forms the group from the rendezvous alone: rank 0's
address at the coordinator port hosts the TCPStore.  The join is bounded
by `init_timeout_s` and every collective by `collective_timeout_s` (the
worker's `--wedge_grace_s`), not torch.distributed's 30-minute default.

The `model`, `seq`, `expert` and `pipe` axes (sharded tables, ring
attention, MoE, GPipe) are not ported: a size other than 1 raises
(ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.worker.task_data_service import (  # noqa: F401
    pad_to_multiple,
)

logger = get_logger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


def device_for_rank(rank: int, device: str = "cuda") -> torch.device:
    """The device of `rank`: cuda:(rank % device_count), or the CPU when
    the job asked for it.  A CUDA job without CUDA raises."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a cluster rank was asked to run on CUDA but no CUDA device "
            "is available; pass --device cpu to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world_size: int, device: torch.device) -> str:
    """nccl when every rank owns a distinct CUDA device, else gloo."""
    if device.type != "cuda":
        return "gloo"
    if world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclass
class DataMesh:
    """The data axis: `world_size` ranks, this one `rank`, on `device`,
    their collectives over `group` (None for a world of one, whose
    collectives are the identity)."""

    world_size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str = ""
    group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None and self.world_size > 1

    def collective_device(self) -> torch.device:
        """Where a gather's buffers live: the rank's device under NCCL,
        host memory under gloo."""
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")


def create_mesh(world_size: int = 1, rank: int = 0, device: str = "cuda",
                coordinator_address: str = "",
                init_timeout_s: float = 60.0,
                collective_timeout_s: float = 20.0,
                data: int = -1, model: int = 1, seq: int = 1,
                expert: int = 1, pipe: int = 1) -> DataMesh:
    """The data axis for this rank.  `data` is -1 or the world size; the
    other axes must be 1.  A world above one joins torch.distributed's
    default group at `coordinator_address` (rank 0 hosts its TCPStore)."""
    others = {MODEL_AXIS: model, SEQ_AXIS: seq, EXPERT_AXIS: expert,
              PIPE_AXIS: pipe}
    bad = {axis: size for axis, size in others.items() if size != 1}
    if bad:
        raise NotImplementedError(
            f"mesh axes {bad}: only the data axis is ported; the model, "
            "seq, expert and pipe axes (sharded tables, ring attention, "
            "MoE, GPipe) wait for ROADMAP.md queue 1, item 12")
    if data not in (-1, world_size):
        raise ValueError(f"data axis {data} != world size {world_size}")
    dev = device_for_rank(rank, device)
    if world_size <= 1:
        return DataMesh(1, 0, dev, "", None)
    backend = backend_for(world_size, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator address {coordinator_address!r} is not host:port")
    logger.info("rank %d/%d joining %s group at %s on %s (%s: %s)",
                rank, world_size, backend, coordinator_address, dev,
                "every rank owns a distinct device" if backend == "nccl"
                else "ranks share a device or run on the CPU",
                backend)
    store = dist.TCPStore(host, int(port), world_size, rank == 0,
                          timeout=datetime.timedelta(
                              seconds=init_timeout_s),
                          wait_for_workers=True)
    dist.init_process_group(
        backend, store=store, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=collective_timeout_s))
    return DataMesh(world_size, rank, dev, backend, dist.group.WORLD)


def destroy_mesh(mesh: Optional[DataMesh]) -> None:
    """Leave the group (a no-op for a world of one)."""
    if mesh is not None and mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()


def local_batch_range(mesh: DataMesh,
                      global_batch_size: int) -> Tuple[int, int]:
    """Rows [start, stop) of a global batch that this rank holds: an
    even split, the first `global_batch_size % world` ranks one row
    more (the JAX mesh needs an even split; this one takes any)."""
    base, extra = divmod(global_batch_size, mesh.world_size)
    start = mesh.rank * base + min(mesh.rank, extra)
    return start, start + base + (1 if mesh.rank < extra else 0)


@dataclass
class LocalShard:
    """This rank's rows of one global batch, staged to its device:
    `batch` (features and labels as tensors), its `rows` and the global
    batch's `global_rows`."""

    batch: dict
    rows: int
    global_rows: int


def _rows_of(tree, start: int, stop: int):
    if isinstance(tree, dict):
        return {k: _rows_of(v, start, stop) for k, v in tree.items()}
    out = tree[start:stop]
    return out.view(type(tree)) if isinstance(tree, np.ndarray) else out


def make_global_batch_from_local(batch: dict, mesh: DataMesh,
                                 global_batch_size: int, local_start: int,
                                 stage) -> LocalShard:
    """This rank's rows (`batch`, which holds only them, starting at
    global row `local_start`) staged to its device by `stage` (the
    trainer's `stage_batch`)."""
    start, stop = local_batch_range(mesh, global_batch_size)
    rows = {np.shape(x)[0] for x in _leaves(batch)}
    if start != local_start or rows != {stop - start}:
        raise IndexError(
            f"rank {mesh.rank} holds rows {sorted(rows)} from "
            f"{local_start}, but its slice of a batch of "
            f"{global_batch_size} is [{start}, {stop}) "
            "(local_batch_range mismatch)")
    return LocalShard(stage(batch), stop - start, global_batch_size)


def make_global_batch(batch: dict, mesh: DataMesh, stage) -> LocalShard:
    """From a full global batch every rank holds (a task's padded tail,
    an evaluation batch): this rank's rows, staged."""
    n = {np.shape(x)[0] for x in _leaves(batch)}
    if len(n) != 1:
        raise ValueError(f"ragged batch: leading sizes {sorted(n)}")
    total = n.pop()
    start, stop = local_batch_range(mesh, total)
    return LocalShard(stage(_rows_of(batch, start, stop)), stop - start,
                      total)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
