"""The device mesh of a cluster job as torch.distributed groups (the
port of the JAX package's parallel/mesh.py).

The JAX package lays every device of every process out as one
`jax.sharding.Mesh` with five axes, `(pipe, data, model, seq, expert)`
in that order, and lets XLA emit collectives from the shardings.  Here
a job's ranks are processes, one device each, and `ProcessMesh` is the
same layout: rank r sits at `np.unravel_index(r, shape)`, so rank r
holds the mesh position of the JAX device r.  Each axis of size > 1 has
one `dist.new_group` per line of ranks along it, and so has every
complement of one axis (the trainer's gradient sums run over those);
every rank creates every group, in the same order, in `create_mesh`.

- data:   ranks hold different rows of the global batch
          (`local_batch_range`); ranks that differ only in the other
          axes hold the same rows, as the JAX `P("data")` places them;
- model:  row-sharded embedding tables (layers/embedding.py);
- seq:    ring attention over sequence chunks (ops/ring_attention.py);
- expert: the expert stacks of the Switch MoE (layers/moe.py);
- pipe:   GPipe stages (ops/pipeline.py).

`DataMesh` is the mesh whose other axes are 1.

Stated rules, never chosen by catching an error:

- a rank's device is `cuda:(rank % torch.cuda.device_count())`, or the
  CPU when the job runs there (`device_for_rank`);
- the backend is `nccl` when every rank owns a distinct CUDA device
  (world size <= device count), and `gloo` when ranks share one device
  or run on the CPU (`backend_for`): NCCL refuses two ranks on one
  device.  Gloo takes CUDA tensors for all_reduce and broadcast; send,
  recv, all_gather and all_to_all stage through pinned host buffers
  (parallel/collectives.py).  Under NCCL the same code keeps every
  buffer on the device.

`create_mesh` forms the default group from the rendezvous alone (rank
0's address at the coordinator port hosts the TCPStore), or lays a new
mesh over a default group this process has joined already (one world,
several layouts in turn).  The join is bounded by `init_timeout_s` and
every collective by `collective_timeout_s` (the worker's
`--wedge_grace_s`), not torch.distributed's 30-minute default.

`set_current_mesh` / `get_current_mesh` hand the mesh to model code (the
zoo's `custom_model()` factories are mesh-free), and inside
`export_mode` the mesh-aware layers run their one-device forms, as in
the JAX package.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
# the JAX mesh's layout order: pipe outermost
AXES = (PIPE_AXIS, DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS)


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


def _axes(axes) -> Tuple[str, ...]:
    """`axes` (a name or names) in layout order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(names) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes "
                         f"are {AXES}")
    return tuple(a for a in AXES if a in names)


@dataclass(eq=False)
class ProcessMesh:
    """`world_size` ranks laid out as `shape` ({axis: size} in the order
    `AXES`), this one `rank` at `coords`, on `device`, joined by the
    default `group` (None for a world of one, whose collectives are the
    identity).  `axis_sizes` None is the data-only mesh."""

    world_size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str = ""
    group: Optional[object] = None
    axis_sizes: Optional[Dict[str, int]] = None

    def __post_init__(self):
        sizes = dict(self.axis_sizes or {DATA_AXIS: self.world_size})
        self.shape: Dict[str, int] = {a: int(sizes.get(a, 1)) for a in AXES}
        if int(np.prod(list(self.shape.values()))) != self.world_size:
            raise ValueError(
                f"mesh {self.shape} does not hold {self.world_size} ranks")
        self.coords: Dict[str, int] = dict(zip(AXES, (
            int(c) for c in np.unravel_index(
                self.rank, tuple(self.shape.values())))))
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}

    @property
    def distributed(self) -> bool:
        return self.group is not None and self.world_size > 1

    def collective_device(self) -> torch.device:
        """Where a staged collective's buffers live: the rank's device
        under NCCL, host memory under gloo."""
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")

    def size(self, axes) -> int:
        """The number of ranks along `axes` (a name or names)."""
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def rank_at(self, coords: Dict[str, int]) -> int:
        """The global rank at `coords` (missing axes: this rank's)."""
        full = {**self.coords, **coords}
        return int(np.ravel_multi_index(
            tuple(full[a] for a in AXES), tuple(self.shape.values())))

    def axis_group(self, axes):
        """(group, ranks) of this rank's line along `axes`, its ranks
        ordered by their coordinates there (row-major in layout order);
        None when the line is this rank alone or the mesh is not
        distributed.  A new set of axes creates its lines on first use,
        so every rank must ask for the same sets in the same order;
        `create_groups` asks for every set the port's layers use."""
        names = tuple(a for a in _axes(axes) if self.shape[a] > 1)
        if not self.distributed or not names:
            return None
        if names not in self._groups:
            if self.size(names) == self.world_size:
                self._groups[names] = (self.group,
                                       list(range(self.world_size)))
            else:
                self._groups[names] = self._new_lines(names)
        return self._groups[names]

    def _new_lines(self, names):
        rest = [a for a in AXES if a not in names]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            base = dict(zip(rest, fixed))
            ranks = [self.rank_at({**base, **dict(zip(names, c))})
                     for c in itertools.product(
                         *(range(self.shape[a]) for a in names))]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (group, ranks)
        return mine

    def create_groups(self) -> None:
        """Every line `axis_group` hands out on the trainer's and the
        layers' paths: each axis, and each complement of one."""
        live = [a for a in AXES if self.shape[a] > 1]
        for axis in live:
            self.axis_group(axis)
        for axis in live:
            self.axis_group([a for a in live if a != axis])


DataMesh = ProcessMesh


def create_mesh(world_size: int = 1, rank: int = 0, device: str = "cuda",
                coordinator_address: str = "",
                init_timeout_s: float = 60.0,
                collective_timeout_s: float = 20.0,
                data: int = -1, model: int = 1, seq: int = 1,
                expert: int = 1, pipe: int = 1) -> ProcessMesh:
    """The mesh for this rank.  `data=-1` absorbs the ranks left after
    the explicit axes.  A world above one joins torch.distributed's
    default group at `coordinator_address` (rank 0 hosts its TCPStore),
    or, when this process has joined it already, lays the mesh over it."""
    fixed = model * seq * expert * pipe
    if data == -1:
        if world_size % fixed:
            raise ValueError(
                f"{world_size} devices not divisible by "
                f"model*seq*expert*pipe={fixed}")
        data = world_size // fixed
    if data * fixed != world_size:
        raise ValueError(
            f"mesh {data}x{model}x{seq}x{expert}x{pipe} != {world_size} "
            "devices")
    sizes = {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq,
             EXPERT_AXIS: expert, PIPE_AXIS: pipe}
    dev = device_for_rank(rank, device)
    if world_size <= 1:
        return ProcessMesh(1, 0, dev, "", None, sizes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise ValueError(
                f"the default group has rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {rank} of {world_size}")
        mesh = ProcessMesh(world_size, rank, dev, dist.get_backend(),
                           dist.group.WORLD, sizes)
        mesh.create_groups()
        return mesh
    backend = backend_for(world_size, dev)
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
    mesh = ProcessMesh(world_size, rank, dev, backend, dist.group.WORLD,
                       sizes)
    mesh.create_groups()
    return mesh


def destroy_mesh(mesh: Optional[ProcessMesh]) -> None:
    """Leave the group (a no-op for a world of one), and clear the
    current mesh: no later call in this process runs on a mesh whose
    groups are gone.  The mesh lets go of its groups too, so they are
    freed here and not among the last objects of the interpreter's exit,
    where freeing a gloo group now and then aborted the process
    ("terminate called without an active exception") after its work had
    finished."""
    set_current_mesh(None)
    if mesh is None:
        return
    if mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()
    mesh.group = None
    mesh._groups.clear()


# ---- the mesh model code reads (the JAX set_current_mesh, export_mode) ---

_MESH_TLS = threading.local()
_DEFAULT_MESH: Optional[ProcessMesh] = None
_EXPORT_MODE = threading.local()


def set_current_mesh(mesh: Optional[ProcessMesh]) -> None:
    """The mesh model code on this thread reads, and the default of
    threads that never set one."""
    global _DEFAULT_MESH
    _MESH_TLS.mesh = mesh
    _DEFAULT_MESH = mesh


def get_current_mesh() -> ProcessMesh:
    """The current mesh: a mesh of one rank when none was set, and in
    export mode."""
    if in_export_mode():
        return ProcessMesh()
    mesh = getattr(_MESH_TLS, "mesh", None) or _DEFAULT_MESH
    return mesh if mesh is not None else ProcessMesh()


@contextlib.contextmanager
def using_mesh(mesh: Optional[ProcessMesh]):
    """`mesh` as this thread's current mesh inside the block (a
    `ProcessMesh()` runs the layers on one device)."""
    prev = getattr(_MESH_TLS, "mesh", None)
    _MESH_TLS.mesh = mesh
    try:
        yield
    finally:
        _MESH_TLS.mesh = prev


@contextlib.contextmanager
def export_mode():
    """Inside, the mesh-aware layers run their one-device forms (a ring
    of one, the sequential pipeline, every expert local) on the gathered
    parameters, as a serving export needs."""
    prev = getattr(_EXPORT_MODE, "on", False)
    _EXPORT_MODE.on = True
    try:
        yield
    finally:
        _EXPORT_MODE.on = prev


def in_export_mode() -> bool:
    return getattr(_EXPORT_MODE, "on", False)


def local_batch_range(mesh: ProcessMesh,
                      global_batch_size: int) -> Tuple[int, int]:
    """Rows [start, stop) of a global batch that this rank holds: an
    even split over the data axis by this rank's data coordinate, the
    first `global_batch_size % data` coordinates one row more (the JAX
    mesh needs an even split; this one takes any).  Ranks that differ
    only in the other axes hold the same rows."""
    size, index = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    base, extra = divmod(global_batch_size, size)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


def pad_to_multiple(batch, multiple: int):
    """worker/task_data_service.py's `pad_to_multiple` (imported on call:
    the layers import this module, and that one imports the trainer)."""
    from elasticdl_tpu_torch.worker.task_data_service import (
        pad_to_multiple as pad,
    )

    return pad(batch, multiple)


@dataclass
class LocalShard:
    """This rank's rows of one global batch, staged to its device:
    `batch` (features and labels as tensors), its `rows` and the global
    batch's `global_rows`."""

    batch: dict
    rows: int
    global_rows: int


def _host_key(key) -> bool:
    """A batch's host bookkeeping ("__name__": a tiered store's plan or
    raw ids, worker/trainer.py STORE_KEYS) rides whole beside its rows:
    every rank plans on the global batch."""
    return isinstance(key, str) and key.startswith("__") \
        and key.endswith("__")


def _rows_of(tree, start: int, stop: int):
    if isinstance(tree, dict):
        return {k: v if _host_key(k) else _rows_of(v, start, stop)
                for k, v in tree.items()}
    out = tree[start:stop]
    return out.view(type(tree)) if isinstance(tree, np.ndarray) else out


def make_global_batch_from_local(batch: dict, mesh: ProcessMesh,
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


def make_global_batch(batch: dict, mesh: ProcessMesh, stage) -> LocalShard:
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
        for k, v in tree.items():
            if not _host_key(k):
                yield from _leaves(v)
    else:
        yield tree
