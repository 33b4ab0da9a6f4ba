"""Embedding table with id hashing, pad masking and bag combiners (the
port of the JAX package's layers/embedding.py).

On one device the table is one tensor.  `_lookup` is the row gather
forward and the deterministic Hopper scatter-add backward
(ops/scatter_add.py), as the JAX `_lookup` pairs XLA's gather with its
scatter-add.  Ids map to rows by the same uint32 arithmetic as the JAX
`hash_ids`: the id reinterpreted as uint32, optionally times Knuth's
multiplicative constant mod 2^32, then mod the capacity.  The arithmetic
runs in int64 with explicit 32-bit masks, so negative ids wrap exactly
as they do there.

Row-sharded tables over the mesh `model` axis (the JAX package's
`embedding_param_sharding`, `P("model", None)`): the trainer gives each
`model` position the rows [r0, r1) of every table the zoo's
`param_sharding` names, and `lookup_rows` sees it from the table's row
count.  Ids outside the shard give zero rows, and a sum over `model`
(`axis_sum`) makes the output.  The backward reaches only the local
shard: the scatter-add (kernel 2 on the card) runs at the shard's own
row count, the ids of other shards carrying zero rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.ops.scatter_add import scatter_add_forward
from elasticdl_tpu_torch.parallel.collectives import axis_sum
from elasticdl_tpu_torch.parallel.mesh import MODEL_AXIS, get_current_mesh

# Knuth's multiplicative hash constant (2^32 / phi)
_MIX = 2654435761
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def hash_ids(ids: torch.Tensor, capacity: int, mix: bool = True
             ) -> torch.Tensor:
    """Rows in [0, capacity) for integer ids, bit-exact with the JAX
    `hash_ids`/`hash_ids_host`; returns int32."""
    u = ids.to(torch.int64) & _MASK32
    if mix:
        # (u * MIX) mod 2^32 from 16-bit halves, so no int64 product
        # overflows: u*MIX = lo*MIX + (hi*MIX mod 2^16) * 2^16 (mod 2^32)
        lo, hi = u & _MASK16, u >> 16
        u = (lo * _MIX + (((hi * _MIX) & _MASK16) << 16)) & _MASK32
    return (u % capacity).to(torch.int32)


def hash_ids_host(ids, capacity: int, mix: bool = True) -> np.ndarray:
    """numpy `hash_ids` for host-side packers, bit-exact with it: uint32
    wraparound arithmetic, negative ids reinterpreted as uint32."""
    ids = np.asarray(ids).astype(np.uint32)
    if mix:
        with np.errstate(over="ignore"):
            ids = ids * np.uint32(_MIX)
    return (ids % np.uint32(capacity)).astype(np.int32)


class _Lookup(torch.autograd.Function):
    """Gather rows of an (R, D) table at int32 rows in [0, R).  The
    backward scatter-adds the output gradient into a zero table of the
    table's shape in the gradient's dtype, in row order (the Hopper
    kernel on the card), then casts to the table's dtype, as the JAX
    `_lookup_bwd` does."""

    @staticmethod
    def forward(ctx, table, flat_rows):
        ctx.save_for_backward(flat_rows)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return torch.index_select(table, 0, flat_rows)

    @staticmethod
    def backward(ctx, g):
        (flat_rows,) = ctx.saved_tensors
        dtable = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        scatter_add_forward(dtable, flat_rows, g.contiguous(), inplace=True)
        return dtable.to(ctx.table_dtype), None


def _lookup(table: torch.Tensor, flat_rows: torch.Tensor) -> torch.Tensor:
    return _Lookup.apply(table, flat_rows)


def shard_of(table_rows: int, capacity: int, mesh=None):
    """(mesh, first row) when a table of `table_rows` rows is this
    rank's shard of a `capacity`-row table row-sharded over `model`,
    else None (a whole table)."""
    mesh = get_current_mesh() if mesh is None else mesh
    shards = mesh.shape[MODEL_AXIS]
    if shards == 1 or table_rows == capacity:
        return None
    if table_rows * shards != capacity:
        raise ValueError(
            f"a table of {table_rows} rows is neither the whole "
            f"{capacity}-row table nor its 1/{shards} shard over "
            f"'{MODEL_AXIS}'")
    return mesh, mesh.coords[MODEL_AXIS] * table_rows


def lookup_rows(table: torch.Tensor, flat_rows: torch.Tensor,
                capacity: int, gather=_lookup) -> torch.Tensor:
    """Rows `flat_rows` in [0, capacity) of a table that may be this
    rank's row shard (`shard_of`): the local rows, zeros for ids of
    other shards, summed over `model`.  `gather(table, rows)` is the
    one-shard gather."""
    shard = shard_of(table.shape[0], capacity)
    if shard is None:
        return gather(table, flat_rows)
    mesh, first = shard
    local = flat_rows - first
    inside = (local >= 0) & (local < table.shape[0])
    vecs = gather(table, torch.where(inside, local,
                                     torch.zeros_like(local)))
    vecs = torch.where(inside[:, None], vecs, torch.zeros_like(vecs))
    return axis_sum(vecs, mesh, MODEL_AXIS)


def embedding_param_sharding(name: str, value) -> Optional[tuple]:
    """`param_sharding` helper for zoo modules: every embedding table
    (a parameter named `embedding`, 2-D or more) row-sharded over the
    `model` axis, the rest replicated (None).  Specs are tuples of axis
    names or None, one per dim, as the JAX `PartitionSpec`s."""
    if "embedding" in name.split(".") and getattr(value, "ndim", 0) >= 2:
        return (MODEL_AXIS, None)
    return None


class DistributedEmbedding(nn.Module):
    """The port of `elasticdl_tpu.layers.embedding.DistributedEmbedding`.

    input_dim:  table capacity (vocab size after hashing).
    output_dim: embedding dimension.
    combiner:   None -> per-id vectors ((...,) int ids -> (..., output_dim));
                "sum" | "mean" | "sqrtn" -> bag reduction over the last
                input axis with `pad_id` masking.
    hash_input: apply the multiplicative mixer (False when ids are
                already uniform).

    `forward(ids, prehashed=True)` takes table rows hashed on the host
    and skips the hash and the pad mask.
    """

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: Optional[str] = None, pad_id: int = -1,
                 hash_input: bool = True, dtype=torch.float32):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.pad_id = pad_id
        self.hash_input = hash_input
        self.embedding = nn.Parameter(
            torch.empty((input_dim, output_dim), dtype=dtype)
        )
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0, 0.05, generator=generator)

    def forward(self, ids: torch.Tensor, prehashed: bool = False
                ) -> torch.Tensor:
        if prehashed:
            # ids are already table rows in [0, input_dim) (hashed on the
            # host by `hash_ids_host`); no hash and no pad masking
            vecs = lookup_rows(self.embedding,
                               ids.reshape(-1).to(torch.int32),
                               self.input_dim)
            vecs = vecs.reshape(ids.shape + (self.output_dim,))
            if self.combiner is None:
                return vecs
            return self._combine(vecs, torch.ones_like(ids, dtype=torch.bool))
        valid = ids != self.pad_id
        rows = hash_ids(torch.where(valid, ids, torch.zeros_like(ids)),
                        self.input_dim, mix=self.hash_input)
        vecs = lookup_rows(self.embedding, rows.reshape(-1),
                           self.input_dim)
        vecs = vecs.reshape(rows.shape + (self.output_dim,))
        vecs = torch.where(valid[..., None], vecs, torch.zeros_like(vecs))
        if self.combiner is None:
            return vecs
        return self._combine(vecs, valid)

    def _combine(self, vecs, valid):
        count = torch.clamp_min(
            valid.sum(dim=-1, keepdim=True).to(vecs.dtype), 1.0
        )
        total = vecs.sum(dim=-2)
        if self.combiner == "sum":
            return total
        if self.combiner == "mean":
            return total / count
        if self.combiner == "sqrtn":
            return total / torch.sqrt(count)
        raise ValueError(f"unknown combiner {self.combiner!r}")
