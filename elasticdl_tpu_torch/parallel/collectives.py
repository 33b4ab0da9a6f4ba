"""Collectives a cluster job's host code needs (the port of the JAX
package's parallel/collectives.py), plus the data-parallel gradient
all-reduce that XLA emits from the shardings in the JAX step.

Every function takes the `DataMesh` (parallel/mesh.py) and is the
identity for a world of one.  Tensors to all_reduce and broadcast stay
on the rank's device (NCCL, and gloo, take CUDA tensors for those);
gathers stage through host copies under gloo (`collective_device`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

if TYPE_CHECKING:   # the mesh module imports the trainer, which imports this
    from elasticdl_tpu_torch.parallel.mesh import DataMesh


def host_snapshot(tree):
    """A deep, owning host copy of a nested dict of tensors or arrays:
    a copy taken while training goes on must not alias the parameters a
    later step rewrites in place."""
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if hasattr(tree, "shape"):
        return np.array(tree, copy=True)
    return tree


def host_allgather(x, mesh: "DataMesh") -> np.ndarray:
    """Every rank's rows of `x` (a tensor or array, this rank's rows of
    a global batch), concatenated in rank order on every rank as numpy.
    Ranks may hold different row counts."""
    x = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    if not mesh.distributed:
        return x.cpu().numpy()
    dev = mesh.collective_device()
    local = x.to(dev).contiguous()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(mesh.world_size)]
    dist.all_gather(counts, torch.tensor([local.shape[0]], device=dev),
                    group=mesh.group)
    counts = [int(c.item()) for c in counts]
    width = max(counts)
    padded = torch.zeros((width,) + tuple(local.shape[1:]),
                         dtype=local.dtype, device=dev)
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(mesh.world_size)]
    dist.all_gather(parts, padded, group=mesh.group)
    return torch.cat([p[:n] for p, n in zip(parts, counts)]).cpu().numpy()


def all_reduce_sum_(tensors: Sequence[torch.Tensor],
                    mesh: "DataMesh") -> None:
    """Sum `tensors` over the data axis, in place: one flat buffer per
    dtype and one all_reduce each, so every rank ends with the same
    bits (each reduced element is computed once and sent to all)."""
    if not mesh.distributed or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def broadcast_(tensors: Sequence[torch.Tensor], mesh: "DataMesh",
               src: int = 0) -> None:
    """Rank `src`'s values of `tensors` on every rank, in place."""
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=mesh.group)


def broadcast_ints(values: Sequence[int], mesh: "DataMesh",
                   src: int = 0) -> List[int]:
    """Rank `src`'s list of ints on every rank (lists may differ in
    length before the call)."""
    if not mesh.distributed:
        return list(values)
    dev = mesh.collective_device()
    n = torch.tensor([len(values)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=src, group=mesh.group)
    buf = torch.zeros(int(n.item()), dtype=torch.int64, device=dev)
    if mesh.rank == src:
        buf.copy_(torch.tensor(list(values), dtype=torch.int64))
    dist.broadcast(buf, src=src, group=mesh.group)
    return [int(v) for v in buf.cpu().tolist()]


def all_true(flag: bool, mesh: "DataMesh") -> bool:
    """True when `flag` holds on every rank."""
    if not mesh.distributed:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int64,
                     device=mesh.collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(t.item())
