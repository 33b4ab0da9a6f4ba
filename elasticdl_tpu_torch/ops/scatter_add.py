"""Deterministic embedding scatter-add: the Hopper kernel and its plain
version.

The kernel (`csrc/scatter_add.cu`) replaces the Pallas TPU kernel
`_pallas_kernel` of scripts/probe_pallas_scatter.py.  It computes the
same function, `scatter_add(table, ids, grads) -> table'`:

    table'[r] = table[r] + grads[i1] + grads[i2] + ...

summed left to right over the positions i1 < i2 < ... where ids == r.
The wrapper sorts the int32 ids with a stable sort (`torch.sort`: it
orders integers and computes none of the float function), so each row's
grads form one segment in original-index order; the kernel copies the
grads rows into that order, sums each segment from table[r] and writes
each touched row once.
No float atomics, so the result is the same bit for bit from run to run
and equal to the serial in-order sum.  The source says what bounds it.

`scatter_add_forward` is the wrapper: on a CUDA tensor it launches the
kernel (or raises) and counts the launch in `scatter_add.launches`; on a
CPU tensor it takes `scatter_add_reference`, the plain version
(`index_add_` on the CPU, which adds the rows serially in id order).
Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from elasticdl_tpu_torch.ops import _build

SOURCE = "scatter_add.cu"
_MAX_IDS = 2 ** 31 - 1

_LIB_LOCK = threading.Lock()
_LIB = None


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _build.load_library(SOURCE)
            fn = lib.scatter_add_segments
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
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


def _kernel_scatter_add_(table, ids, grads) -> torch.Tensor:
    n = ids.shape[0]
    if n == 0:
        return table
    sorted_ids, order = torch.sort(ids, stable=True)
    sorted_grads = torch.empty_like(grads)
    fn = _library().scatter_add_segments
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
                 grads.data_ptr(), sorted_grads.data_ptr(), n,
                 table.shape[1], stream)
    if err != 0:
        raise RuntimeError(
            f"scatter_add_segments kernel launch failed with CUDA error "
            f"{err} for {n} ids into a {tuple(table.shape)} table")
    scatter_add.launches += 1
    return table


def scatter_add_forward(table: torch.Tensor, ids: torch.Tensor,
                        grads: torch.Tensor,
                        inplace: bool = False) -> torch.Tensor:
    """table + grads rows added at ids, in id order: the Hopper kernel
    for CUDA tensors, the plain version for CPU tensors.  With
    `inplace=True` the sums land in `table` itself and it is returned (the
    embedding backward does this on its fresh zero table)."""
    _check_inputs(table, ids, grads)
    if table.device.type == "cpu":
        if inplace:
            return table.index_add_(0, ids.long(), grads)
        return scatter_add_reference(table, ids, grads)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_add runs on cuda or cpu, not "
                         f"{table.device}")
    return _kernel_scatter_add_(table if inplace else table.clone(), ids,
                                grads)


def scatter_add(table: torch.Tensor, ids: torch.Tensor,
                grads: torch.Tensor) -> torch.Tensor:
    """`pallas_scatter_add`'s function: a new (R, D) f32 table equal to
    `table` plus each (N, D) grads row added at its int32 id, serially in
    id order.  Ids must lie in [0, R); any N.  On a CUDA tensor it is the
    Hopper kernel; `scatter_add.launches` counts its launches."""
    return scatter_add_forward(table, ids, grads)


scatter_add.launches = 0
