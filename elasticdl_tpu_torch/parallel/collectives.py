"""Collectives of a cluster job (the port of the JAX package's
parallel/collectives.py), the gradient sums that XLA emits from the
shardings in the JAX step, and the collectives over one mesh axis that
the JAX layers call inside `shard_map` (`lax.ppermute`, `psum`,
`all_gather`, `all_to_all`, and the max of BERT's pool).

The host-side helpers take the `ProcessMesh` (parallel/mesh.py) and are
the identity for a world of one.  Tensors to all_reduce and broadcast
stay on the rank's device (NCCL, and gloo, take CUDA tensors for
those); gathers stage through host copies under gloo
(`collective_device`).

The axis collectives (`axis_ring_shift`, `axis_sum`, `axis_all_gather`,
`axis_all_to_all`, `axis_max`) are `torch.autograd.Function`s whose
backward is the exact transpose of the forward as a linear map of every
rank's values: the reverse shift, a sum of the cotangents, a sum then
this rank's slice, the inverse exchange.  So a value computed the same
way on n ranks carries 1/n of its cotangent on each when the objective
is weighted so (the trainer's `objective_weight`), and a parameter's
gradient is the sum over the ranks that hold it.  Under gloo with
CUDA tensors, send, recv, all_gather and all_to_all go through pinned
host buffers; `STAGING` counts the wall time and bytes of every
collective on a CUDA tensor under gloo (`reset_staging` zeroes it).
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

if TYPE_CHECKING:   # the mesh module imports the trainer, which imports this
    from elasticdl_tpu_torch.parallel.mesh import ProcessMesh as DataMesh

DATA_AXIS = "data"


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
    """Every data coordinate's rows of `x` (a tensor or array, this
    rank's rows of a global batch), concatenated in data order on every
    rank as numpy.  Ranks may hold different row counts; ranks that
    differ only in the other axes hold the same rows and are not
    gathered twice."""
    x = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    line = mesh.axis_group(DATA_AXIS)
    if line is None:
        return x.cpu().numpy()
    group, ranks = line
    dev = mesh.collective_device()
    local = x.to(dev).contiguous()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in ranks]
    dist.all_gather(counts, torch.tensor([local.shape[0]], device=dev),
                    group=group)
    counts = [int(c.item()) for c in counts]
    width = max(counts)
    padded = torch.zeros((width,) + tuple(local.shape[1:]),
                         dtype=local.dtype, device=dev)
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in ranks]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, counts)]).cpu().numpy()


def all_reduce_sum_(tensors: Sequence[torch.Tensor],
                    mesh: "DataMesh", axes=None) -> None:
    """Sum `tensors` over `axes` (default: every rank), in place: one
    flat buffer per dtype and one all_reduce each, so every rank ends
    with the same bits (each reduced element is computed once and sent
    to all)."""
    if not tensors:
        return
    if axes is None:
        if not mesh.distributed:
            return
        group = mesh.group
    else:
        line = mesh.axis_group(axes)
        if line is None:
            return
        group = line[0]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors_of in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors_of])
        with _accounted(mesh, flat):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for t in tensors_of:
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


# ---- host staging --------------------------------------------------------

# {op: {"ms", "bytes", "calls"}} of collectives on CUDA tensors under
# gloo, each of which crosses host memory (gloo stages all_reduce and
# broadcast itself; the rest stage here)
STAGING: Dict[str, Dict[str, float]] = {}


def reset_staging() -> None:
    STAGING.clear()


def staging_totals() -> Dict[str, float]:
    """{"ms", "bytes", "calls"} summed over every op in `STAGING`."""
    return {key: sum(v[key] for v in STAGING.values())
            for key in ("ms", "bytes", "calls")}


def _stages(mesh: "DataMesh", x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


class _accounted:
    """Adds the wall time of the block and the bytes of `x` to
    `STAGING[op]` when `x` crosses host memory."""

    def __init__(self, mesh, x, op: str = "all_reduce"):
        self.on = _stages(mesh, x)
        self.op, self.nbytes = op, x.numel() * x.element_size()

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.on and exc[0] is None:
            entry = STAGING.setdefault(self.op, {"ms": 0.0, "bytes": 0,
                                                 "calls": 0})
            entry["ms"] += (time.perf_counter() - self.t0) * 1e3
            entry["bytes"] += self.nbytes
            entry["calls"] += 1


_HALF = (torch.bfloat16, torch.float16)

def _to_wire(mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` where the backend can move it: a pinned host copy under gloo
    for a CUDA tensor, else `x` itself (contiguous); 16-bit floats as
    their bytes (exchanges move bytes, and gloo's gathers take no
    16-bit type)."""
    x = x.contiguous()
    if x.dtype in _HALF:
        x = x.view(torch.uint8)
    if not _stages(mesh, x):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _line(mesh, axis):
    line = mesh.axis_group(axis)
    if line is None:
        return None, [mesh.rank]
    return line


# ---- raw exchanges over one axis (no autograd) ---------------------------


def ring_shift(x: torch.Tensor, mesh: "DataMesh", axis: str,
               shift: int = 1) -> torch.Tensor:
    """Position i's `x` at position (i + shift) mod n of `axis`'s line
    (the JAX `ppermute` with that rotation)."""
    group, ranks = _line(mesh, axis)
    if group is None:
        return x
    me = ranks.index(mesh.rank)
    n = len(ranks)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    with _accounted(mesh, x, "ring_shift"):
        send = _to_wire(mesh, x)
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)])
        for req in reqs:
            req.wait()
        out = recv.to(x.device).view(x.dtype)
    return out


def send_to(x: torch.Tensor, mesh: "DataMesh", dst: int) -> None:
    """Blocking send of `x` to global rank `dst`."""
    with _accounted(mesh, x, "send"):
        dist.send(_to_wire(mesh, x), dst)


def recv_from(like: torch.Tensor, mesh: "DataMesh", src: int
              ) -> torch.Tensor:
    """Blocking receive from global rank `src` of a tensor shaped and
    typed like `like`, on `like`'s device."""
    with _accounted(mesh, like, "recv"):
        buf = _to_wire(mesh, torch.empty_like(like))
        dist.recv(buf, src)
        out = buf.to(like.device).view(like.dtype)
    return out


def axis_reduce(x: torch.Tensor, mesh: "DataMesh", axis,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: `x` reduced by `op` over `axis`'s line."""
    group, _ = _line(mesh, axis)
    if group is None:
        return x.clone()
    # 16-bit floats reduce in f32 (gloo's reductions take no bfloat16)
    out = x.float() if x.dtype in _HALF else x.clone()
    with _accounted(mesh, out):
        dist.all_reduce(out, op=op, group=group)
    return out.to(x.dtype)


def all_gather(x: torch.Tensor, mesh: "DataMesh", axis, dim: int = 0
               ) -> torch.Tensor:
    """Every position's `x` along `axis`, concatenated on `dim` in the
    line's order."""
    group, ranks = _line(mesh, axis)
    if group is None:
        return x
    with _accounted(mesh, x, "all_gather"):
        send = _to_wire(mesh, x)
        parts = [torch.empty_like(send) for _ in ranks]
        dist.all_gather(parts, send, group=group)
        out = torch.cat(parts, dim=dim).to(x.device).view(x.dtype)
    return out


def all_to_all(x: torch.Tensor, mesh: "DataMesh", axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Chunk j of `x` along `split_dim` goes to position j of `axis`'s
    line; the chunks received are concatenated on `concat_dim` in the
    line's order."""
    group, ranks = _line(mesh, axis)
    if group is None:
        return x
    n = len(ranks)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    with _accounted(mesh, x, "all_to_all"):
        # chunks along a new leading dim, as all_to_all_single splits
        chunked = torch.stack(torch.chunk(x, n, dim=split_dim))
        send = _to_wire(mesh, chunked)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        out = torch.cat(list(recv.to(x.device).view(x.dtype).unbind(0)),
                        dim=concat_dim)
    return out


# ---- the axis collectives, differentiable ---------------------------------


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return ring_shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return ring_shift(g.contiguous(), mesh, axis, -shift), None, None, \
            None


def axis_ring_shift(x: torch.Tensor, mesh: "DataMesh", axis: str,
                    shift: int = 1) -> torch.Tensor:
    """The JAX `ppermute` by `shift` along `axis`; its backward is the
    reverse shift."""
    return _RingShift.apply(x, mesh, axis, shift)


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return axis_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return axis_reduce(g.contiguous(), mesh, axis), None, None


def axis_sum(x: torch.Tensor, mesh: "DataMesh", axis) -> torch.Tensor:
    """The sum of `x` over `axis` on every position (the JAX `psum`);
    its backward sums the cotangents."""
    return _AxisSum.apply(x, mesh, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, width = ctx.args
        group, ranks = _line(mesh, axis)
        total = axis_reduce(g.contiguous(), mesh, axis)
        index = ranks.index(mesh.rank)
        return total.narrow(dim, index * width, width), None, None, None


def axis_all_gather(x: torch.Tensor, mesh: "DataMesh", axis,
                    dim: int = 0) -> torch.Tensor:
    """Every position's `x` along `axis`, concatenated on `dim`; the
    backward sums the cotangents and keeps this position's slice."""
    return _AllGather.apply(x, mesh, axis, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (all_to_all(g.contiguous(), mesh, axis, concat_dim,
                           split_dim), None, None, None, None)


def axis_all_to_all(x: torch.Tensor, mesh: "DataMesh", axis,
                    split_dim: int, concat_dim: int) -> torch.Tensor:
    """The JAX `all_to_all`; its backward is the inverse exchange."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


class _AxisMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        top = axis_reduce(x.amax(dim=dim), mesh, axis, dist.ReduceOp.MAX)
        hit = x == top.unsqueeze(dim)
        count = axis_reduce(hit.sum(dim=dim, dtype=torch.float32), mesh,
                            axis)
        ctx.save_for_backward(hit, count)
        ctx.args = (mesh, axis, dim)
        return top

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        mesh, axis, dim = ctx.args
        total = axis_reduce(g.float().contiguous(), mesh, axis)
        share = (total / count).unsqueeze(dim)
        return (hit * share).to(g.dtype), None, None, None


def axis_max(x: torch.Tensor, mesh: "DataMesh", axis,
             dim: int) -> torch.Tensor:
    """The max of `x` over `dim` and over `axis` (the positions hold
    chunks of that dim), on every position.  The gradient goes to the
    elements that held the max, split evenly among ties across every
    position, as `jnp.max`'s VJP splits it."""
    return _AxisMax.apply(x, mesh, axis, dim)


def axis_broadcast(x: torch.Tensor, mesh: "DataMesh", axis,
                   index: int) -> torch.Tensor:
    """Position `index`'s `x` on every position of `axis`'s line (a new
    tensor; `x` on the other positions gives only its shape and
    dtype)."""
    group, ranks = _line(mesh, axis)
    out = x.clone()
    if group is not None:
        wire = out.float() if out.dtype in _HALF else out
        with _accounted(mesh, wire, "broadcast"):
            dist.broadcast(wire, src=ranks[index], group=group)
        out = wire.to(x.dtype)
    return out
