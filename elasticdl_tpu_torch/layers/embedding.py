"""Embedding table with id hashing, pad masking and bag combiners (the
forward of the JAX package's layers/embedding.py).

On one device the table is one tensor and the lookup a row gather.  Ids
map to rows by the same uint32 arithmetic as the JAX `hash_ids`: the id
reinterpreted as uint32, optionally times Knuth's multiplicative
constant mod 2^32, then mod the capacity.  The arithmetic runs in int64
with explicit 32-bit masks, so negative ids wrap exactly as they do
there.  The backward's scatter-add waits for the training slice, where
it becomes a deterministic Hopper kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

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


class DistributedEmbedding(nn.Module):
    """The port of `elasticdl_tpu.layers.embedding.DistributedEmbedding`.

    input_dim:  table capacity (vocab size after hashing).
    output_dim: embedding dimension.
    combiner:   None -> per-id vectors ((...,) int ids -> (..., output_dim));
                "sum" | "mean" | "sqrtn" -> bag reduction over the last
                input axis with `pad_id` masking.
    hash_input: apply the multiplicative mixer (False when ids are
                already uniform).
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

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        valid = ids != self.pad_id
        rows = hash_ids(torch.where(valid, ids, torch.zeros_like(ids)),
                        self.input_dim, mix=self.hash_input)
        vecs = torch.index_select(self.embedding, 0, rows.reshape(-1))
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
