"""Fused embedding arena: every same-`dim` feature table as one tensor
(the port of the JAX package's layers/arena.py).

Feature i owns rows [offset_i, offset_i + capacity_i) of the one table;
its ids are hashed mod its own capacity and shifted by its offset, so
collisions are those of an isolated table of that capacity.  All
features' rows are concatenated and looked up with one `lookup_rows`
(layers/embedding.py's `_lookup`, on this rank's row shard where the
table is sharded over `model`): one gather forward and one scatter-add
backward (the Hopper kernel on the card) per arena, whatever the
feature count.  The parameter is named
`embedding`, as in the JAX arena.

Quantized storage (`arena_dtype="int8"`): rows live as int8 codes with a
per-row fp32 scale, the buffers `q8` (R, D) and `scale` (R, 1), and are
dequantized inside the gather.  The gradient and optimizer path stays
fp32: the trainable `embedding` is a zero fp32 carrier with the table's
name and shape (so optimizer state and checkpoint names do not change
with the mode), `_GradTap` routes the scatter-add gradient into it (the
same Hopper kernel as `_lookup`'s backward), and `fold_quantized_updates`
folds the optimizer's per-step delta back into the codes with
stochastic rounding, then zeroes the carrier.  The rounding's uniforms
are a counter-based draw computed on the device (`uniform_draw`): a hash
of (0x51A7, the step, the plane path, the element's global row and
column), with the step a device tensor, so a captured CUDA graph draws
anew as its step counter advances.  All int8 plane arithmetic lives in this module.  The int8
gather and the fold run inside the named profiler ranges `int8_lookup`
and `int8_fold`, so a torch.profiler trace attributes their device
time.

`TieredArena` is the tiered store's device cache (store/): the same
table, gather, scatter-add backward and int8 planes over `cache_rows`
cache slots instead of the whole vocabulary, plus the serving overlay
for cold rows.

Row-sharded over `model` (the trainer's `shard_state`): `q8` and `scale`
are sliced with their carrier, as the JAX trainer shards the
"quantized" collection by the params' rule.  The gather dequantizes
this rank's rows through `lookup_rows` (zeros off the shard, a sum over
`model`), the tap's scatter-add runs at the shard's row count, and the
fold draws only the shard's rows, keyed on their global row, so the
codes are those of the unsharded fold (the JAX draw does not depend on
the sharding either).
"""

from __future__ import annotations

import zlib
from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.layers.embedding import (
    hash_ids,
    hash_ids_host,
    lookup_rows,
    shard_of,
)
from elasticdl_tpu_torch.ops.scatter_add import scatter_add_forward

ARENA_DTYPES = ("float32", "int8")

# int8 code range is symmetric [-127, 127]: -128 is unused so negation
# round-trips and scale = max|row| / 127 covers the row exactly.
_Q_MAX = 127.0

# RNG namespace for the training write-back rounding, combined with the
# step and the plane path so every run rounds the same step alike
_FOLD_SEED = 0x51A7

# the counter-based draw works on 32-bit values held in int64 tensors
_MASK32 = 0xFFFFFFFF
_GOLDEN32 = 0x9E3779B9

# the state-dict names of an int8 arena's planes, beside its `embedding`
PLANE_KEYS = ("q8", "scale")

# ---- quantization numerics (all int8 plane math lives here) -------------


def quantize_rows(table: torch.Tensor):
    """fp32 (R, D) -> (int8 codes (R, D), fp32 scales (R, 1)).  Per-row
    symmetric: scale = max|row| / 127 (an all-zero row gets scale 1.0
    and round-trips exactly), codes round to nearest even.  The training
    write-back uses `stochastic_round` instead."""
    table = table.to(torch.float32)
    max_abs = table.abs().amax(dim=1, keepdim=True)
    scale = torch.where(max_abs > 0, max_abs / _Q_MAX,
                        torch.ones_like(max_abs))
    q8 = torch.clamp(torch.round(table / scale), -_Q_MAX, _Q_MAX)
    return q8.to(torch.int8), scale


def dequantize_rows(q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes + per-row scales -> the fp32 view the math runs on."""
    return q8.to(torch.float32) * scale


def quantize_rows_host(table: np.ndarray):
    """numpy mirror of `quantize_rows`, bit for bit."""
    table = np.asarray(table, np.float32)
    max_abs = np.max(np.abs(table), axis=1, keepdims=True) \
        if table.size else np.zeros((table.shape[0], 1), np.float32)
    scale = np.where(max_abs > 0, max_abs / _Q_MAX, 1.0).astype(np.float32)
    q8 = np.clip(
        np.round(table / scale), -_Q_MAX, _Q_MAX
    ).astype(np.int8)
    return q8, scale


def dequantize_rows_host(q8: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """numpy mirror of `dequantize_rows`."""
    return q8.astype(np.float32) * np.asarray(scale, np.float32)


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64 (or a Python
    int) and a 32-bit constant c: c's 16-bit halves keep every product
    below 2**48, so no int64 overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A bijection of [0, 2**32) in which every output bit depends on
    every input bit (the xor-shift-multiply finaliser "lowbias32"), on
    int64 tensors or Python ints alike.  Inputs are non-negative, so the
    right shifts are logical."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


_SEED_MIX = _mix32(_FOLD_SEED)


def fold_key(step, path: Tuple[str, ...]) -> torch.Tensor:
    """The fold's key for one step and plane: a 0-d int64 tensor of 32
    bits mixed from (_FOLD_SEED, step, the path's crc).  `step` is an int
    or a 0-d integer tensor (a device step counter: no host read)."""
    step = torch.as_tensor(step, dtype=torch.int64)
    key = _mix32((step & _MASK32) ^ _SEED_MIX)
    key = _mix32(key ^ ((step >> 32) & _MASK32))
    return _mix32(key ^ _path_seed(path))


def uniform_draw(key: torch.Tensor, rows: int, cols: int,
                 first_row: int = 0) -> torch.Tensor:
    """(rows, cols) f32 uniforms in [0, 1), element (i, j) a hash of
    (key, global row first_row + i, column j) in the manner of
    splitmix: a mixed row value plus a Weyl step per column, mixed
    again.  A block of rows draws what the whole plane draws there, and
    nothing is drawn for other rows.  24 bits per draw, so each value is
    exact in f32."""
    device = key.device
    row = torch.arange(first_row, first_row + rows, dtype=torch.int64,
                       device=device)
    row_hash = _mix32((row & _MASK32) ^ key)
    col = torch.arange(cols, dtype=torch.int64, device=device)
    weyl = (col * _GOLDEN32) & _MASK32
    bits = _mix32((row_hash[:, None] + weyl[None, :]) & _MASK32)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def stochastic_round(x: torch.Tensor, key, first_row: int = 0):
    """Unbiased integer rounding: floor(x + U[0,1)), so E[result] == x
    and exact integers return exactly (floor(k + u) == k for u < 1).
    The uniforms are `uniform_draw(key, ...)` at x's rows, which are
    rows [first_row, first_row + len(x)) of their plane, so a shard
    rounds as the whole plane does.  `key` is a 0-d int64 tensor (see
    `fold_key`) or an int."""
    key = torch.as_tensor(key, dtype=torch.int64).to(x.device)
    flat = x.reshape(x.shape[0], -1)
    u = uniform_draw(key, flat.shape[0], flat.shape[1], first_row)
    out = torch.clamp(torch.floor(flat + u.to(x.dtype)), -_Q_MAX, _Q_MAX)
    return out.reshape(x.shape).to(torch.int8)


class _GradTap(torch.autograd.Function):
    """Gradient collector for the quantized arena.  Forward returns exact
    zeros shaped like the gather output, made from the carrier's shape
    and dtype only (it never reads the carrier).  Backward scatter-adds
    the output gradient into the carrier's shape, the same scatter-add
    (the Hopper kernel on the card) as `_lookup`'s backward, so the
    optimizer sees an ordinary fp32 embedding gradient on the carrier."""

    @staticmethod
    def forward(ctx, carrier, flat_rows):
        ctx.save_for_backward(flat_rows)
        ctx.carrier_shape = carrier.shape
        ctx.carrier_dtype = carrier.dtype
        return torch.zeros(flat_rows.shape + (carrier.shape[1],),
                           dtype=carrier.dtype, device=carrier.device)

    @staticmethod
    def backward(ctx, g):
        (flat_rows,) = ctx.saved_tensors
        dcarrier = torch.zeros(ctx.carrier_shape, dtype=g.dtype,
                               device=g.device)
        scatter_add_forward(dcarrier, flat_rows, g.contiguous(),
                            inplace=True)
        return dcarrier.to(ctx.carrier_dtype), None


def _grad_tap(carrier: torch.Tensor, flat_rows: torch.Tensor):
    return _GradTap.apply(carrier, flat_rows)


def arena_offsets(features: Tuple[Tuple[str, int], ...]) -> Dict[str, int]:
    """{feature name: first arena row} for a (name, capacity) tuple."""
    offsets, total = {}, 0
    for name, capacity in features:
        offsets[name] = total
        total += int(capacity)
    return offsets


def arena_rows(features: Tuple[Tuple[str, int], ...]) -> int:
    return sum(int(capacity) for _, capacity in features)


class _ArenaTable(nn.Module):
    """The storage both arenas share: an (R, D) table named `embedding`,
    or in int8 mode the `q8`/`scale` planes beside a zero fp32 carrier of
    that name; its flax init, and the gather (the scatter-add kernel in
    the backward)."""

    def __init__(self, rows: int, dim: int, arena_dtype: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if arena_dtype not in ARENA_DTYPES:
            raise ValueError(
                f"arena_dtype must be one of {ARENA_DTYPES}, got "
                f"{arena_dtype!r}")
        self.arena_dtype = arena_dtype
        # the whole table's rows (a rank may hold a 'model' shard of them)
        self.rows = int(rows)
        shape = (int(rows), int(dim))
        if arena_dtype == "int8":
            # the trainable zero carrier; the planes are buffers
            self.embedding = nn.Parameter(torch.zeros(shape))
            self.register_buffer("q8", torch.zeros(shape, dtype=torch.int8))
            self.register_buffer("scale", torch.ones((shape[0], 1)))
        else:
            self.embedding = nn.Parameter(torch.empty(shape, dtype=dtype))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The flax init: normal(0.05) rows; in int8 mode drawn in fp32,
        quantized into the planes, with a zero carrier."""
        with torch.no_grad():
            if self.arena_dtype != "int8":
                nn.init.normal_(self.embedding, 0.0, 0.05,
                                generator=generator)
                return
            self.embedding.zero_()
            sample = torch.empty(self.embedding.shape,
                                 device=self.embedding.device)
            nn.init.normal_(sample, 0.0, 0.05, generator=generator)
            q8, scale = quantize_rows(sample)
            self.q8.copy_(q8)
            self.scale.copy_(scale)

    def _gather(self, flat_rows: torch.Tensor) -> torch.Tensor:
        if self.arena_dtype != "int8":
            return lookup_rows(self.embedding, flat_rows, self.rows)
        return lookup_rows(self.embedding, flat_rows, self.rows,
                           gather=self._int8_gather)

    def _int8_gather(self, carrier: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
        """Rows of this rank's planes: dequantize inside the gather (code
        gather, scale gather, one multiply); the tap adds exact zeros
        forward and collects the scatter-add backward."""
        with torch.profiler.record_function("int8_lookup"):
            deq = dequantize_rows(self.q8.index_select(0, rows),
                                  self.scale.index_select(0, rows))
        return deq + _grad_tap(carrier, rows)


class EmbeddingArena(_ArenaTable):
    """N per-feature embedding tables fused into one parameter.

    features:   ordered ((name, capacity), ...); order fixes the layout.
    output_dim: shared embedding dimension (one arena per dim).
    hash_input: multiplicative-mix ids before the per-feature mod.

    Call with a dict {name: int ids (B, ...)}; returns {name: (B, ...,
    output_dim)} vectors, zero where an id equals `pad_id`.  Call with
    `prehashed=True` and one int tensor of arena rows (from
    `arena_rows_host` or the dedup wire format) to skip the hashing.

    arena_dtype: "float32" (default) or "int8" (codes in the `q8` buffer,
    per-row scales in `scale`, a zero fp32 carrier as `embedding`; see
    the module docstring).
    """

    def __init__(self, features: Tuple[Tuple[str, int], ...],
                 output_dim: int, pad_id: int = -1, hash_input: bool = True,
                 dtype: torch.dtype = torch.float32,
                 arena_dtype: str = "float32"):
        features = tuple((str(n), int(c)) for n, c in features)
        super().__init__(arena_rows(features), output_dim, arena_dtype,
                         dtype)
        self.features = features
        self.output_dim = output_dim
        self.pad_id = pad_id
        self.hash_input = hash_input

    def forward(self, ids, prehashed: bool = False):
        if prehashed:
            rows = ids.to(torch.int32)
            return self._gather(rows.reshape(-1)).reshape(
                rows.shape + (self.output_dim,))
        names = [name for name, _ in self.features]
        if set(ids) != set(names):
            raise ValueError(
                f"arena expects ids for {names}, got {sorted(ids)}")
        parts, valids, shapes = [], [], []
        batch = ids[names[0]].shape[0]
        offset = 0
        for name, capacity in self.features:
            x = ids[name]
            valid = x != self.pad_id
            rows = hash_ids(torch.where(valid, x, torch.zeros_like(x)),
                            capacity, mix=self.hash_input) + offset
            parts.append(rows.reshape(batch, -1))
            valids.append(valid.reshape(batch, -1))
            shapes.append(tuple(x.shape))
            offset += capacity
        all_rows = torch.cat(parts, dim=1)                 # (B, sum k_i)
        all_valid = torch.cat(valids, dim=1)
        vecs = self._gather(all_rows.reshape(-1)).reshape(
            all_rows.shape + (self.output_dim,))
        vecs = torch.where(all_valid[..., None], vecs, torch.zeros_like(vecs))
        out, col = {}, 0
        for (name, _), shape in zip(self.features, shapes):
            k = int(np.prod(shape[1:], dtype=np.int64))
            out[name] = vecs[:, col: col + k].reshape(
                shape + (self.output_dim,))
            col += k
        return out

    def arena_rows_host(self, ids: Mapping[str, np.ndarray]) -> np.ndarray:
        """numpy replica of the row computation: {name: (B, k)} raw ids ->
        (B, sum k) int32 arena rows, bit-exact with the tensor path.
        Raises on a pad id, which the prehashed path cannot mask."""
        parts, offset = [], 0
        for name, capacity in self.features:
            x = np.asarray(ids[name])
            if np.any(x == self.pad_id):
                raise ValueError(
                    f"arena_rows_host: feature {name!r} contains pad ids "
                    f"({self.pad_id}); the prehashed fast path cannot "
                    "represent masked positions — use the per-feature path")
            rows = hash_ids_host(x, capacity, mix=self.hash_input) + offset
            parts.append(rows.reshape(x.shape[0], -1).astype(np.int32))
            offset += capacity
        return np.concatenate(parts, axis=1)


class TieredArena(_ArenaTable):
    """The device half of the tiered embedding store (store/): a
    `cache_rows`-row hot-row cache where `EmbeddingArena` holds the whole
    vocabulary.  The full, lazily grown vocabulary lives in the store's
    host tier, and the store admits every row a training batch touches
    before its step, so the cache table is the only trainable embedding
    storage and a step is the flat arena's: one gather forward and one
    scatter-add backward (the Hopper kernel on the card).

    Call with `slots` (..., F) int cache slots (TieredStore.prepare).
    Training passes resident slots (>= 0).  Serving may pass -1 for a
    cold or unknown id with `overlay`, a (..., F, dim) plane of host
    values for those positions; the overlay is detached (cold rows train
    on the host through the store's fold, never through the optimizer).

    cache_dtype: "float32", or "int8" (the flat arena's int8 planes,
    folded by `fold_quantized_updates` on the same plane path).  The
    table and the planes carry the flat arena's names, so optimizer
    state, checkpoints and `params_from_jax` see the same layout, and a
    never-admitted slot starts as a fresh flat row would."""

    def __init__(self, cache_rows: int, output_dim: int,
                 cache_dtype: str = "float32"):
        super().__init__(cache_rows, output_dim, cache_dtype)
        self.cache_rows = int(cache_rows)
        self.output_dim = int(output_dim)

    @property
    def cache_dtype(self) -> str:
        return self.arena_dtype

    def forward(self, slots: torch.Tensor, overlay=None) -> torch.Tensor:
        rows = slots.to(torch.int32)
        flat = torch.clamp_min(rows.reshape(-1), 0)
        hot = self._gather(flat).reshape(rows.shape + (self.output_dim,))
        if overlay is None:
            return hot
        cold = overlay.detach().to(hot.dtype)
        return torch.where((rows >= 0)[..., None], hot, cold)


# ---- quantized write-back + checkpoint migration ------------------------


def is_quantized_planes(node) -> bool:
    """True for a {"q8", "scale"} plane dict."""
    return isinstance(node, Mapping) and set(node) == set(PLANE_KEYS)


def _path_seed(path: Tuple[str, ...]) -> int:
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


def plane_path(prefix: str) -> Tuple[str, ...]:
    """The flax path of an arena's planes from its module name in the
    state dict ("fm_embedding" -> ("fm_embedding", "embedding"))."""
    return tuple(p for p in prefix.split(".") if p) + ("embedding",)


def _requantize_plane(q8: torch.Tensor, scale: torch.Tensor,
                      delta: torch.Tensor, key, first_row: int = 0):
    """(new q8, new scale) with `delta` folded in.  Rows whose delta is
    all zero (Adam's update is 0 while m = v = 0) keep their codes and
    scales bit for bit, so idle rows do not random-walk.  The planes may
    be rows [first_row, ...) of a larger plane (`stochastic_round`)."""
    touched = (delta != 0.0).any(dim=1, keepdim=True)
    table = dequantize_rows(q8, scale) + delta
    max_abs = table.abs().amax(dim=1, keepdim=True)
    new_scale = torch.where(max_abs > 0, max_abs / _Q_MAX,
                            torch.ones_like(max_abs))
    new_q8 = stochastic_round(table / new_scale, key, first_row)
    return (torch.where(touched, new_q8, q8),
            torch.where(touched, new_scale, scale))


def has_int8_arena(model: nn.Module) -> bool:
    """Whether `model` holds an int8 arena, whose planes a step folds."""
    return any(isinstance(m, _ArenaTable) and m.arena_dtype == "int8"
               for m in model.modules())


def fold_quantized_updates(model: nn.Module, step) -> int:
    """The write-back after `optimizer.step()`: in each int8 arena (flat
    or tiered, keyed on the same plane path) the carrier holds this
    step's fp32 delta; fold it into the codes (table = dequant + delta,
    new per-row scale, stochastic rounding keyed on (seed, step, plane
    path, element)) and zero the carrier.  `step` is an int or a 0-d
    integer tensor on the planes' device (the trainer's step counter,
    which a captured graph advances).  A rank holding a row shard over
    `model` folds its rows as the whole plane's fold does.  Returns the
    number of planes folded; with no int8 arena it changes nothing and
    returns 0."""
    arenas = [(name, m) for name, m in model.named_modules()
              if isinstance(m, _ArenaTable) and m.arena_dtype == "int8"]
    if not arenas:
        return 0
    with torch.no_grad(), torch.profiler.record_function("int8_fold"):
        for name, arena in arenas:
            key = fold_key(step, plane_path(name)).to(arena.q8.device)
            shard = shard_of(arena.embedding.shape[0], arena.rows)
            first = 0 if shard is None else shard[1]
            q8, scale = _requantize_plane(arena.q8, arena.scale,
                                          arena.embedding, key, first)
            arena.q8.copy_(q8)
            arena.scale.copy_(scale)
            arena.embedding.zero_()
    return len(arenas)


def plane_key(prefix: str, leaf: str) -> str:
    """The state-dict name of an arena's `leaf` ("embedding", "q8" or
    "scale") under its module name."""
    return f"{prefix}.{leaf}" if prefix else leaf


def plane_prefixes(state_dict: Mapping[str, torch.Tensor]) -> List[str]:
    """The module names that hold int8 planes in a state dict (both its
    `q8` and its `scale` present; "" for a top-level arena), sorted."""
    prefixes = (key[: -len("q8")].rstrip(".") for key in state_dict
                if key == "q8" or key.endswith(".q8"))
    return sorted(p for p in prefixes
                  if plane_key(p, "scale") in state_dict)


def quantize_arena_tree(state_dict: Mapping[str, torch.Tensor],
                        prefixes) -> Dict[str, torch.Tensor]:
    """fp32 -> int8 migration of a state dict: each table at a prefix
    of `prefixes` (the int8 model's `plane_prefixes`) is quantized
    deterministically into `q8`/`scale`, and its `embedding` becomes the
    zero carrier of the same name and shape, so Adam's moments carry
    over."""
    out = dict(state_dict)
    for prefix in prefixes:
        table = out[plane_key(prefix, "embedding")]
        q8, scale = quantize_rows(table)
        out[plane_key(prefix, "q8")] = q8
        out[plane_key(prefix, "scale")] = scale
        out[plane_key(prefix, "embedding")] = torch.zeros_like(table)
    return out


def dequantize_arena_tree(state_dict: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """int8 -> fp32 migration: each table = dequant(q8, scale) + carrier
    (the carrier is zero between steps; adding it keeps the conversion
    exact mid-step), and the planes are dropped."""
    out = dict(state_dict)
    for prefix in plane_prefixes(state_dict):
        q8 = out.pop(plane_key(prefix, "q8"))
        scale = out.pop(plane_key(prefix, "scale"))
        carrier = out[plane_key(prefix, "embedding")]
        out[plane_key(prefix, "embedding")] = dequantize_rows(q8, scale) \
            + carrier.to(torch.float32)
    return out
