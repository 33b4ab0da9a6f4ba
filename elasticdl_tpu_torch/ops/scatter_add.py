"""Deterministic embedding scatter-add: the Hopper kernel and its plain
version.

The kernel (`csrc/scatter_add.cu`) replaces the Pallas TPU kernel
`_pallas_kernel` of scripts/probe_pallas_scatter.py.  It computes the
same function, `scatter_add(table, ids, grads) -> table'`:

    table'[r] = table[r] + grads[i1] + grads[i2] + ...

summed left to right over the positions i1 < i2 < ... where ids == r.
The wrapper sorts the int32 ids with a stable sort (`torch.sort`: it
orders integers and computes none of the float function), so each row's
grads form one segment in original-index order, and computes the segment
plan (`segment_plan`, two `torch.searchsorted` calls on the sorted ids,
no host sync); the kernel copies the grads rows into that order, sums
each segment from table[r] in order and writes each touched row once.
Segments longer than `LONG_SEGMENT` ids (`long_segments`) get a block
each, which stages their rows in shared memory; the rest a group of
lanes.
No float atomics, so the result is the same bit for bit from run to run
and equal to the serial in-order sum.  The source says what bounds it.

`scatter_add_forward` is the wrapper: on a CUDA tensor it launches the
kernel (or raises) and counts the launch in `scatter_add.launches`; on a
CPU tensor it takes `scatter_add_reference`, the plain version
(`index_add_` on the CPU, which adds the rows serially in id order).
Nothing falls back from the card to the plain version.

The in-place sum is the `torch.library` custom op
`elasticdl_torch::scatter_add_` (CPU: `index_add_`; CUDA: the kernel;
a fake implementation for tracing).  Its cost, `scatter_cost`, is what
the program registry (common/programs.py) charges for it and what
`chip_smoke.py` divides by the card's peaks for its bound.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import launches as launches_lib

SOURCE = "scatter_add.cu"
_MAX_IDS = 2 ** 31 - 1
# segments longer than this many ids take the kernel's staged block path
LONG_SEGMENT = 64
MAX_DIM = 4096  # one staged chunk holds at least one row

_LIB_LOCK = threading.Lock()
_LIB = None


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load_library(SOURCE)
            fn = lib.scatter_add_segments
            fn.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def scatter_add_reference(table: torch.Tensor, ids: torch.Tensor,
                          grads: torch.Tensor) -> torch.Tensor:
    """The plain version: a copy of `table` with each grads row added at
    its id.  On the CPU `index_add_` adds the rows one after another in
    id order, which is the kernel's order; it raises on an id out of
    range."""
    return table.clone().index_add_(0, ids.long(), grads)


def segment_plan(sorted_ids: torch.Tensor):
    """The kernel's segment plan for ids sorted ascending: at every
    anchor position j*LONG_SEGMENT, the first and one-past-last position
    of the segment (run of equal ids) that holds it, as two int32
    tensors of ceil(N / LONG_SEGMENT) entries.  Integer work only, on the
    ids' device, with no host sync."""
    anchors = sorted_ids[::LONG_SEGMENT].contiguous()
    heads = torch.searchsorted(sorted_ids, anchors, out_int32=True)
    ends = torch.searchsorted(sorted_ids, anchors, right=True,
                              out_int32=True)
    return heads, ends


def long_segments(heads: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The (head, end) pairs of the segments longer than LONG_SEGMENT,
    by the rule the kernel's long-segment blocks apply to the plan: the
    block of anchor j takes its segment when it is long and holds no
    earlier anchor.  (K, 2) int64, in sorted order."""
    heads, ends = heads.long(), ends.long()
    anchors = torch.arange(heads.numel(), device=heads.device) * LONG_SEGMENT
    first = torch.ones_like(heads, dtype=torch.bool)
    first[1:] = heads[1:] > anchors[1:] - LONG_SEGMENT
    take = first & (ends - heads > LONG_SEGMENT)
    return torch.stack([heads[take], ends[take]], dim=1)


def _check_inputs(table, ids, grads) -> None:
    if table.dim() != 2 or ids.dim() != 1 or grads.dim() != 2:
        raise ValueError(
            f"scatter_add needs a (R, D) table, (N,) ids and (N, D) grads; "
            f"got {tuple(table.shape)}, {tuple(ids.shape)}, "
            f"{tuple(grads.shape)}")
    if grads.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(
            f"scatter_add grads must be (N, D) = ({ids.shape[0]}, "
            f"{table.shape[1]}); got {tuple(grads.shape)}")
    if table.dtype != torch.float32 or grads.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise ValueError(
            f"scatter_add takes a float32 table and grads and int32 ids; "
            f"got {table.dtype}, {grads.dtype}, {ids.dtype}")
    if not (table.device == ids.device == grads.device):
        raise ValueError(
            f"scatter_add needs its tensors on one device; got "
            f"{table.device}, {ids.device}, {grads.device}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and grads.is_contiguous()):
        raise ValueError("scatter_add needs contiguous tensors")
    if ids.shape[0] > _MAX_IDS:
        raise ValueError(f"scatter_add takes at most {_MAX_IDS} ids")
    if table.shape[1] > MAX_DIM:
        raise ValueError(f"scatter_add takes rows of at most {MAX_DIM} "
                         f"floats; got {table.shape[1]}")


def _kernel_scatter_add_(table, ids, grads) -> torch.Tensor:
    n = ids.shape[0]
    if n == 0:
        return table
    sorted_ids, order = torch.sort(ids, stable=True)
    heads, ends = segment_plan(sorted_ids)
    # 4 floats of slack: the staged copies move whole 16-byte units
    sorted_grads = torch.empty(grads.numel() + 4, dtype=grads.dtype,
                               device=grads.device)
    fn = _library().scatter_add_segments
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
                 grads.data_ptr(), sorted_grads.data_ptr(),
                 heads.data_ptr(), ends.data_ptr(), n, table.shape[1],
                 LONG_SEGMENT, stream)
    if err != 0:
        raise RuntimeError(
            f"scatter_add_segments kernel launch failed with CUDA error "
            f"{err} for {n} ids into a {tuple(table.shape)} table")
    launches_lib.count("scatter_add")
    return table


def scatter_cost(n: int, dim: int, touched: int):
    """(flops, bytes) of the scatter-add: the ids (N*4) and grads (N*D*4)
    read once, the U touched rows read and written once (2*U*D*4); one
    add per grads element."""
    return float(n * dim), float(n * 4 + n * dim * 4 + 2 * touched * dim * 4)


OP_SCATTER_ADD = "elasticdl_torch::scatter_add_"

torch.library.define(
    OP_SCATTER_ADD, "(Tensor(a!) table, Tensor ids, Tensor grads) -> ()")


@torch.library.impl(OP_SCATTER_ADD, "cpu")
def _scatter_add_cpu(table, ids, grads):
    table.index_add_(0, ids.long(), grads)


@torch.library.impl(OP_SCATTER_ADD, "cuda")
def _scatter_add_cuda(table, ids, grads):
    _kernel_scatter_add_(table, ids, grads)


@torch.library.register_fake(OP_SCATTER_ADD)
def _scatter_add_fake(table, ids, grads):
    return None


def _op_cost(table, ids, grads):
    """U, the rows the ids touch, is what this call's data needs; an
    abstract call has no data and counts U's bound, min(N, R)."""
    if programs.is_abstract(ids):
        touched = min(ids.numel(), table.shape[0])
    else:
        touched = int(torch.unique(ids).numel())
    return scatter_cost(ids.numel(), table.shape[1], touched)


programs.register_kernel_cost(OP_SCATTER_ADD, _op_cost)
programs.register_kernel_libraries(
    OP_SCATTER_ADD,
    lambda table, ids, grads: (SOURCE,) if table.device.type == "cuda"
    else ())


def scatter_add_forward(table: torch.Tensor, ids: torch.Tensor,
                        grads: torch.Tensor,
                        inplace: bool = False) -> torch.Tensor:
    """table + grads rows added at ids, in id order: the Hopper kernel
    for CUDA tensors, the plain version for CPU tensors.  With
    `inplace=True` the sums land in `table` itself and it is returned (the
    embedding backward does this on its fresh zero table)."""
    _check_inputs(table, ids, grads)
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter_add runs on cuda or cpu, not "
                         f"{table.device}")
    out = table if inplace else table.clone()
    torch.ops.elasticdl_torch.scatter_add_(out, ids, grads)
    return out


def scatter_add(table: torch.Tensor, ids: torch.Tensor,
                grads: torch.Tensor) -> torch.Tensor:
    """`pallas_scatter_add`'s function: a new (R, D) f32 table equal to
    `table` plus each (N, D) grads row added at its int32 id, serially in
    id order.  Ids must lie in [0, R); any N.  On a CUDA tensor it is the
    Hopper kernel; `scatter_add.launches` counts its launches."""
    return scatter_add_forward(table, ids, grads)


scatter_add.launches = 0
launches_lib.register("scatter_add", scatter_add, "launches")
