"""The tiered store's one device seam (the port of the JAX package's
store/device.py): every device operation of the store goes through
here, and the rest of `store/` stays numpy on the host.

- `apply_admissions` writes host-gathered row values into the cache
  parameter in place (`index_copy_` under `torch.no_grad()`; the
  Parameter object stays, so the optimizer keeps its reference), and
  zeroes those rows in every optimizer-state tensor shaped like the
  parameter: an admitted row then behaves like a never-touched flat row,
  whose Adam moments are zero.  Adam's `step` is a scalar and is left
  alone (optax's count is global too), and a parameter the optimizer has
  not stepped yet has no state to zero.  In int8 mode the values are
  quantized by round-to-nearest into `q8`/`scale` and the carrier rows
  are zeroed, so a re-admitted slot carries no stale delta.
- `read_rows`, `read_full_tables`, `read_full_planes` return owning host
  copies (a blocking copy: a non-blocking one could hand the fold thread
  memory the stream has not written yet).  int8 reads dequantize and add
  the carrier, exact even mid-step.

Index vectors are padded to a power-of-four bucket (`_pad_bucket`) by
repeating their first entry with its own value, so duplicate writes
carry identical values and `index_copy_`'s unspecified order among
duplicates cannot change the result.  The JAX package pads for XLA's
compile cache; here it keeps the CUDA graphs few.  On CUDA, for whole
cache tables, the gather of `read_rows` and the admission run as
captured graphs (worker/graphs.py), one per bucket and cache dtype,
kept on the state (`TrainState.graphs`) and dispatched on `graph_ok`:
the padded host indices and values are copied into the graph's static
inputs before the replay; the admit's replay does the `index_copy_` per
plane, the zeroing of the moment rows and, for int8, the quantize; the
gather's replay writes its static rows, and the blocking copy to the
host runs after it, under the pool's lock.  An admit graph bakes in the
optimizer's moments: a parameter without them yet has another graph,
told apart by the state's fingerprint.  A cache row-sharded over
`model`, and `read_full_tables` / `read_full_planes` (which the JAX
package does not register either), stay eager.  The admit and gather
are plain PyTorch (`index_select`, `index_copy_`): ROADMAP.md queue 2's
later hand kernel 7.

Model layout: `param_paths` maps each store plane to the dotted name of
its `TieredArena` in the model (DeepFM: `fm_embedding`, `fm_linear`);
the arena holds `embedding`, and in int8 mode `q8` and `scale`.

Cache tables row-sharded over `model` (`state.mesh`; `cache_block`):
a rank holds one contiguous block of the slots.  `apply_admissions`
writes only the slots of its block, at their offsets in the block; the
reads return whole rows on every rank whatever block holds them (the
block's rows, zeros elsewhere, summed over `model`; the whole tables
gathered), so every rank's host tier takes the same values.  These are
collectives: every rank reads the same slots at the same point.

The gather of `read_rows` and the admission are registered programs
(common/programs.py), `store_gather` and `store_admit`, one per layout
and cache dtype as in the JAX package; their signatures are the padded
index buckets.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.layers.arena import dequantize_rows, quantize_rows
from elasticdl_tpu_torch.layers.embedding import shard_of
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import MODEL_AXIS
from elasticdl_tpu_torch.worker import graphs as graphs_lib
from elasticdl_tpu_torch.worker.trainer import run_device_serialized


def _pad_bucket(n: int) -> int:
    """Smallest power of four >= n, at least 64."""
    size = 64
    while size < n:
        size <<= 2
    return size


def _pad_indices(idx: np.ndarray) -> np.ndarray:
    """Pad an index vector to its bucket by repeating index 0."""
    padded = np.full(_pad_bucket(idx.size), idx[0], idx.dtype)
    padded[: idx.size] = idx
    return padded


def _pad_values(vals: np.ndarray, size: int) -> np.ndarray:
    """Pad rows to `size` by repeating row 0: every duplicate write
    carries the same value as the first."""
    padded = np.repeat(vals[:1], size, axis=0)
    padded[: vals.shape[0]] = vals
    return padded


def _arena(model: torch.nn.Module, path: str):
    return model.get_submodule(path)


def _device(state) -> torch.device:
    return next(state.model.parameters()).device


def _check_int8(arena, path: str) -> None:
    if getattr(arena, "cache_dtype", "float32") != "int8":
        raise ValueError(
            f'cache_dtype="int8" but {path} has no quantized planes; build '
            "the zoo model with cache_dtype='int8' (TieredArena) so the "
            "planes exist")


def _rows_of(arena, idx: torch.Tensor, cache_dtype: str) -> torch.Tensor:
    if cache_dtype == "int8":
        return dequantize_rows(arena.q8.index_select(0, idx),
                               arena.scale.index_select(0, idx)) \
            + arena.embedding.index_select(0, idx)
    return arena.embedding.index_select(0, idx)


def _shard(state, param_paths: Dict[str, str]):
    """(mesh, first slot, block rows) when `state`'s cache tables are its
    rank's row block over `model`, else None."""
    mesh = getattr(state, "mesh", None)
    if mesh is None:
        return None
    arena = _arena(state.model, next(iter(param_paths.values())))
    shard = shard_of(arena.embedding.shape[0], arena.rows, mesh)
    if shard is None:
        return None
    return shard + (arena.embedding.shape[0],)


def cache_block(state, param_paths: Dict[str, str]):
    """(index, count) of the block of the slot arena `state`'s cache
    tables hold over `model`, or None for whole tables."""
    shard = _shard(state, param_paths)
    if shard is None:
        return None
    mesh, first, rows = shard
    return first // rows, mesh.shape[MODEL_AXIS]


def graph_ok(state, shard=None) -> bool:
    """Whether the seam's gather and admit on `state` run as captured
    CUDA graphs: a CUDA device outside `graphs_lib.eager_loop`, whole
    cache tables (`shard` None: a row block over `model` reads and
    writes through gloo collectives on the host), a state that keeps
    graphs, real tensors, and no capture already under way."""
    return (_device(state).type == "cuda" and shard is None
            and not graphs_lib.in_eager_loop()
            and isinstance(getattr(state, "graphs", None), dict)
            and not programs.is_abstract(next(state.model.parameters()))
            and not torch.cuda.is_current_stream_capturing())


_GRAPHS_LOCK = threading.Lock()
_GRAPHS: Dict[tuple, graphs_lib.ProgramGraphs] = {}


def _graphs(device: torch.device, program: str) -> graphs_lib.ProgramGraphs:
    """The seam's graph runner of `program` on `device`: one memory pool,
    and one lock, for its graphs over every state there (the graphs
    themselves live on each state, `TrainState.graphs`).  The gather and
    the admit have a pool each, so an admission on the training thread
    does not wait for an eviction read's copy to the host."""
    with _GRAPHS_LOCK:
        key = (device, program)
        if key not in _GRAPHS:
            _GRAPHS[key] = graphs_lib.ProgramGraphs(device)
        return _GRAPHS[key]


def _layout(param_paths: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    """Hashable, order-stable (name, path) pairs: the key of the program
    caches below."""
    return tuple(sorted(param_paths.items()))


@functools.lru_cache(maxsize=None)
def _gather_program(layout, cache_dtype: str):
    def gather(model, idx):
        with torch.no_grad():
            return tuple(_rows_of(_arena(model, path), idx, cache_dtype)
                         for _, path in layout)

    return programs.registered_jit("store_gather", gather)


def read_rows(state, param_paths: Dict[str, str], slots: np.ndarray,
              cache_dtype: str = "float32") -> Dict[str, np.ndarray]:
    """Owning fp32 host copies of cache rows `slots`, per plane: the
    eviction write-back read."""
    n = int(np.asarray(slots).size)
    device = _device(state)
    idx_host = _pad_indices(np.asarray(slots, np.int64).reshape(-1))
    layout = _layout(param_paths)
    if cache_dtype == "int8":
        for _, path in layout:
            _check_int8(_arena(state.model, path), path)
    gather = _gather_program(layout, cache_dtype)
    shard = _shard(state, param_paths)

    def host_rows(rows):
        return {name: plane.float().cpu().numpy()[:n].copy()
                for (name, _), plane in zip(layout, rows)}

    def _read():
        idx = torch.from_numpy(idx_host)
        if graph_ok(state, shard):
            # the copy out runs under the pool's lock, before another
            # replay can rewrite the static rows
            return _graphs(device, "store_gather").run(
                state, ("store_gather", layout, cache_dtype,
                        graphs_lib.batch_shapes(idx)), idx,
                lambda i: gather(state.model, i), finish=host_rows,
                fingerprint=graphs_lib.model_fingerprint)
        idx = idx.to(device)
        if shard is None:
            rows = gather(state.model, idx)
        else:
            mesh, first, block = shard
            local = idx - first
            inside = ((local >= 0) & (local < block))[:, None]
            rows = tuple(collectives.axis_reduce(
                torch.where(inside, plane, torch.zeros_like(plane)), mesh,
                MODEL_AXIS) for plane in gather(
                    state.model, torch.where(inside[:, 0], local, 0)))
        return host_rows(rows)

    return run_device_serialized(_read, device=device)


def read_full_tables(state, param_paths: Dict[str, str],
                     cache_dtype: str = "float32") -> Dict[str, np.ndarray]:
    """Owning fp32 host copies of each plane's whole cache table (int8:
    the dequantized view plus the carrier)."""
    device = _device(state)
    whole = _whole(state, param_paths)

    def _read():
        out = {}
        with torch.no_grad():
            for name, path in param_paths.items():
                arena = _arena(state.model, path)
                if cache_dtype == "int8":
                    _check_int8(arena, path)
                    table = dequantize_rows(arena.q8, arena.scale) \
                        + arena.embedding
                else:
                    table = arena.embedding
                out[name] = whole(table.detach()).float().cpu().numpy(
                ).copy()
        return out

    return run_device_serialized(_read, device=device)


def read_full_planes(state, param_paths: Dict[str, str]
                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """Owning copies of an int8 cache's raw planes {name: {"q8",
    "scale"}}: the sidecar stores them as they are, so an int8 -> int8
    restore is exact."""
    device = _device(state)
    whole = _whole(state, param_paths)

    def _read():
        out = {}
        for name, path in param_paths.items():
            arena = _arena(state.model, path)
            _check_int8(arena, path)
            out[name] = {
                "q8": whole(arena.q8.detach()).cpu().numpy().copy(),
                "scale": whole(arena.scale.detach()).float().cpu().numpy(
                ).copy(),
            }
        return out

    return run_device_serialized(_read, device=device)


def _whole(state, param_paths: Dict[str, str]):
    """table -> the whole table: the identity, or on a row block the
    gather of every block over `model`."""
    shard = _shard(state, param_paths)
    if shard is None:
        return lambda table: table
    mesh = shard[0]
    return lambda table: collectives.all_gather(table.contiguous(), mesh,
                                                MODEL_AXIS)


def _zero_moments(optimizer, param: torch.nn.Parameter,
                  idx: torch.Tensor) -> int:
    """Zero rows `idx` of every optimizer-state tensor shaped like
    `param` (Adam's exp_avg and exp_avg_sq); returns how many it zeroed.
    Scalars (Adam's `step`) stay as they are; a parameter without state
    (no step taken yet) has nothing to zero."""
    if optimizer is None:
        return 0
    n = 0
    for value in optimizer.state.get(param, {}).values():
        if isinstance(value, torch.Tensor) and value.shape == param.shape:
            value.index_fill_(0, idx, 0.0)
            n += 1
    return n


def apply_admissions(state, param_paths: Dict[str, str], slots: np.ndarray,
                     values: Dict[str, np.ndarray],
                     cache_dtype: str = "float32"):
    """Write fp32 host values into cache rows `slots` of every plane, in
    place, and zero those rows' optimizer moments (int8: quantize into
    the planes and zero the carrier rows too).  On a row block over
    `model` only the slots of the block are written, at their offsets
    in it.  Returns `state`."""
    slots = np.asarray(slots, np.int64).reshape(-1)
    if slots.size == 0:
        return state
    values = {name: np.asarray(values[name], np.float32).reshape(
        slots.size, -1) for name in param_paths}
    shard = _shard(state, param_paths)
    if shard is not None:
        _, first, block = shard
        mine = (slots >= first) & (slots < first + block)
        slots = slots[mine] - first
        values = {name: v[mine] for name, v in values.items()}
        if slots.size == 0:
            return state
    device = _device(state)
    idx_host = _pad_indices(slots)
    vals_host = {name: _pad_values(values[name], idx_host.size)
                 for name in param_paths}

    layout = _layout(param_paths)
    if cache_dtype == "int8":
        for _, path in layout:
            _check_int8(_arena(state.model, path), path)
    admit = _admit_program(layout, cache_dtype)

    def _apply():
        idx = torch.from_numpy(idx_host)
        vals = tuple(torch.from_numpy(vals_host[name]) for name, _ in layout)
        if graph_ok(state, shard):
            _graphs(device, "store_admit").run(
                state, ("store_admit", layout, cache_dtype,
                        graphs_lib.batch_shapes((idx, vals))), (idx, vals),
                lambda inputs: admit(state, *inputs),
                finish=lambda out: None)
        else:
            admit(state, idx.to(device), tuple(v.to(device) for v in vals))
        return state

    return run_device_serialized(_apply, device=device)


@functools.lru_cache(maxsize=None)
def _admit_program(layout, cache_dtype: str):
    def admit(state, idx, vals):
        with torch.no_grad():
            for (_, path), v in zip(layout, vals):
                arena = _arena(state.model, path)
                if cache_dtype == "int8":
                    codes, scales = quantize_rows(v)
                    arena.q8.index_copy_(0, idx, codes)
                    arena.scale.index_copy_(0, idx, scales)
                    # an admission is the row's new state: a carrier
                    # delta left in the slot is stale
                    arena.embedding.index_fill_(0, idx, 0.0)
                else:
                    arena.embedding.index_copy_(
                        0, idx, v.to(arena.embedding.dtype))
                _zero_moments(state.optimizer, arena.embedding, idx)

    return programs.registered_jit("store_admit", admit)


def zero_cache_slots(state, param_paths: Dict[str, str], slots: np.ndarray,
                     cache_dtype: str = "float32"):
    """Zero cache rows `slots` in every plane and their moments (an int8
    cache quantizes zeros to code 0, scale 1.0)."""
    slots = np.asarray(slots, np.int64).reshape(-1)
    if slots.size == 0:
        return state
    values = {
        name: np.zeros((slots.size,
                        _arena(state.model, path).embedding.shape[1]),
                       np.float32)
        for name, path in param_paths.items()}
    return apply_admissions(state, param_paths, slots, values,
                            cache_dtype=cache_dtype)
