"""Fused embedding arena: every same-`dim` feature table as one tensor
(the port of the JAX package's layers/arena.py, float32 mode).

Feature i owns rows [offset_i, offset_i + capacity_i) of the one table;
its ids are hashed mod its own capacity and shifted by its offset, so
collisions are those of an isolated table of that capacity.  All
features' rows are concatenated and looked up with one `_lookup`: one
gather forward and one scatter-add backward (the Hopper kernel on the
card) per arena, whatever the feature count.  The parameter is named
`embedding`, as in the JAX arena.

The quantized arena (`arena_dtype="int8"`) waits for its slice of the
port and raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.layers.embedding import (
    _lookup,
    hash_ids,
    hash_ids_host,
)

ARENA_DTYPES = ("float32", "int8")


def arena_offsets(features: Tuple[Tuple[str, int], ...]) -> Dict[str, int]:
    """{feature name: first arena row} for a (name, capacity) tuple."""
    offsets, total = {}, 0
    for name, capacity in features:
        offsets[name] = total
        total += int(capacity)
    return offsets


def arena_rows(features: Tuple[Tuple[str, int], ...]) -> int:
    return sum(int(capacity) for _, capacity in features)


class EmbeddingArena(nn.Module):
    """N per-feature embedding tables fused into one parameter.

    features:   ordered ((name, capacity), ...); order fixes the layout.
    output_dim: shared embedding dimension (one arena per dim).
    hash_input: multiplicative-mix ids before the per-feature mod.

    Call with a dict {name: int ids (B, ...)}; returns {name: (B, ...,
    output_dim)} vectors, zero where an id equals `pad_id`.  Call with
    `prehashed=True` and one int tensor of arena rows (from
    `arena_rows_host`) to skip the hashing.
    """

    def __init__(self, features: Tuple[Tuple[str, int], ...],
                 output_dim: int, pad_id: int = -1, hash_input: bool = True,
                 dtype: torch.dtype = torch.float32,
                 arena_dtype: str = "float32"):
        super().__init__()
        if arena_dtype not in ARENA_DTYPES:
            raise ValueError(
                f"arena_dtype must be one of {ARENA_DTYPES}, got "
                f"{arena_dtype!r}")
        if arena_dtype == "int8":
            raise NotImplementedError(
                "arena_dtype='int8' (int8 codes with per-row scales) comes "
                "with the int8 arena slice of the port")
        self.features = tuple((str(n), int(c)) for n, c in features)
        self.output_dim = output_dim
        self.pad_id = pad_id
        self.hash_input = hash_input
        self.embedding = nn.Parameter(torch.empty(
            (arena_rows(self.features), output_dim), dtype=dtype))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0, 0.05, generator=generator)

    def forward(self, ids, prehashed: bool = False):
        if prehashed:
            rows = ids.to(torch.int32)
            return _lookup(self.embedding, rows.reshape(-1)).reshape(
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
        vecs = _lookup(self.embedding, all_rows.reshape(-1)).reshape(
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
