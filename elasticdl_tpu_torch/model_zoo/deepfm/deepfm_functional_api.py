"""DeepFM for Criteo-style CTR data: the port of the JAX zoo's
model_zoo/deepfm/deepfm_functional_api.py, with the same parameter
names, numerics and zoo contract.

- All 26 sparse fields share one table (a single-feature
  `EmbeddingArena`) addressed by field-offset ids: one gather and one
  scatter-add (the Hopper kernel on the card) per arena and step.  Two
  arenas: `fm_embedding` (dim embed_dim) and `fm_linear` (dim 1).
- FM second order by the square-of-sum trick, in f32.
- The deep tower is a plain MLP, in bf16 when `bf16=True` (parameters
  stay f32).

Submodules carry the flax names (`fm_embedding.embedding`,
`fm_linear.embedding`, `dense_linear`, `mlp_0`, `mlp_1`, `mlp_out`), so
`common/weights.py::params_from_jax` carries a flax tree across.

Three wire formats (data/wire.py), decoded on the device by
`sparse_field_rows`: plain (`feed_bulk`: f32 dense, int32 ids, 160
bytes/example), compact (`feed_bulk_compact`: bf16 dense, b22 ids, uint8
labels, 99 bytes/example; uint24 ids decode too) and dedup
(`feed_bulk_dedup`: the ids field-offset and hashed on the host, then
dedup'd per field, so the embeddings take the rows as they are,
`prehashed=True`).  The decode runs inside the named profiler range
`wire_decode`.  `arena_dtype="int8"` stores both arenas as int8 codes
with per-row scales (layers/arena.py).

Record format: 13 float32 dense | 26 int32 sparse ids | 1 uint8 label =
157 bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.wire import (
    DedupPacker,
    is_packed_b22,
    is_packed_dedup,
    is_packed_uint24,
    pack_f32_to_bf16,
    pack_int_to_b22,
    unpack_b22,
    unpack_rows_dedup,
    unpack_uint24,
)
from elasticdl_tpu_torch.layers.arena import EmbeddingArena
from elasticdl_tpu_torch.layers.embedding import (
    embedding_param_sharding,
    hash_ids_host,
)
from elasticdl_tpu_torch.layers.linen import Dense
from elasticdl_tpu_torch.model_zoo.common.metrics import auc, binary_accuracy

NUM_DENSE = 13
NUM_SPARSE = 26
# int32-safe odd mixing constant (2^32/phi >> 1) that separates fields
_FIELD_MIX = 0x61C88647
_MASK32 = 0xFFFFFFFF


def field_offset_ids(sparse: torch.Tensor) -> torch.Tensor:
    """(B, 26) raw ids -> field-offset int32 ids for the one shared
    table.  The JAX version adds field * 0x61C88647 in int32, wrapping;
    here the sum runs in int64 under a 32-bit mask and is reinterpreted
    as signed, which gives the same int32 values."""
    offsets = torch.arange(NUM_SPARSE, dtype=torch.int64,
                           device=sparse.device) * _FIELD_MIX
    u = (sparse.to(torch.int64) + offsets[None, :]) & _MASK32
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def sparse_ids(features) -> torch.Tensor:
    """(B, 26) int ids from `features["sparse"]`, whatever wire format it
    arrived in: plain ids, or the compact b22 / uint24 packings."""
    sparse = features["sparse"]
    if is_packed_b22(sparse):
        return unpack_b22(sparse)
    if is_packed_uint24(sparse):
        return unpack_uint24(sparse)
    return sparse


def sparse_field_rows(features, vocab_capacity: int):
    """(B, 26) rows into the shared table, plus whether they are already
    hashed.  The dedup'd wire format ships pre-hashed rows (decoded by
    `unpack_rows_dedup`; the embeddings then skip their hash); every
    other format goes through the field offsets and the device hash."""
    sparse = features["sparse"]
    with torch.profiler.record_function("wire_decode"):
        if is_packed_dedup(sparse):
            return unpack_rows_dedup(sparse), True
        return field_offset_ids(sparse_ids(features)), False


def hash_field_rows_host(sparse, vocab_capacity: int) -> np.ndarray:
    """numpy replica of `field_offset_ids` plus the arenas' hash
    (mix=True), bit-exact with the tensor path.  Raises if a field-offset
    id equals the pad sentinel (-1): the tensor path masks it, the
    prehashed path cannot."""
    sparse = np.asarray(sparse)
    offsets = np.arange(NUM_SPARSE, dtype=np.uint32) * np.uint32(_FIELD_MIX)
    with np.errstate(over="ignore"):
        field_ids = sparse.astype(np.uint32) + offsets[None, :]
    if np.any(field_ids == np.uint32(_MASK32)):
        raise ValueError(
            "dedup packing: a field-offset id equals the pad sentinel "
            "(-1); this batch must ship on the non-dedup wire format")
    return hash_ids_host(field_ids, vocab_capacity, mix=True)


def normalize_dense(dense: torch.Tensor) -> torch.Tensor:
    """Signed log1p squashing of the 13 dense counters, in f32."""
    dense = dense.float()
    return torch.log1p(dense.abs()) * torch.sign(dense)


def arena_field_lookup(arena: EmbeddingArena, field_ids, prehashed: bool):
    """A single-feature arena on DeepFM's (B, 26) shared-hash-space rows:
    prehashed rows go straight through; raw ids take the dict path under
    the one feature name."""
    if prehashed:
        return arena(field_ids, prehashed=True)
    return arena({"sparse": field_ids})["sparse"]


def deepfm_tail(layers: nn.Module, emb, first, dense, compute_dtype):
    """Everything after the embedding lookups: FM reduction, wide head,
    deep tower.  `layers` holds `dense_linear`, `mlp_0` ... and
    `mlp_out`; the additions run in the flax version's order."""
    # FM second order: 0.5 * sum_k [ (sum_f v)^2 - sum_f v^2 ]
    sum_f = emb.sum(dim=1)
    fm2 = 0.5 * (sum_f * sum_f - (emb * emb).sum(dim=1)).sum(dim=-1)

    dense_n = normalize_dense(dense)                   # (B, 13)
    wide = layers.dense_linear(dense_n)[..., 0]

    deep_in = torch.cat([dense_n, emb.reshape(emb.shape[0], -1)], dim=-1)
    h = deep_in.to(compute_dtype)
    for i in range(len(layers.mlp_dims)):
        h = F.relu(getattr(layers, f"mlp_{i}")(h))
    deep = layers.mlp_out(h)[..., 0].float()

    return wide + first[..., 0].sum(dim=1) + fm2 + deep  # logits


class DeepFM(nn.Module):
    def __init__(self, vocab_capacity: int = 1 << 18, embed_dim: int = 16,
                 mlp_dims: tuple = (256, 128),
                 compute_dtype: torch.dtype = torch.float32,
                 arena_dtype: str = "float32"):
        super().__init__()
        self.vocab_capacity = vocab_capacity
        self.mlp_dims = tuple(mlp_dims)
        self.compute_dtype = compute_dtype
        features = (("sparse", vocab_capacity),)
        self.fm_embedding = EmbeddingArena(features, embed_dim,
                                           arena_dtype=arena_dtype)
        self.fm_linear = EmbeddingArena(features, 1, arena_dtype=arena_dtype)
        self.dense_linear = Dense(NUM_DENSE, 1)
        width = NUM_DENSE + NUM_SPARSE * embed_dim
        for i, out in enumerate(self.mlp_dims):
            self.add_module(f"mlp_{i}", Dense(width, out, dtype=compute_dtype))
            width = out
        self.mlp_out = Dense(width, 1, dtype=compute_dtype)

    def forward(self, features):
        field_ids, prehashed = sparse_field_rows(features,
                                                 self.vocab_capacity)
        emb = arena_field_lookup(self.fm_embedding, field_ids, prehashed)
        first = arena_field_lookup(self.fm_linear, field_ids, prehashed)
        return deepfm_tail(self, emb, first, features["dense"],
                           self.compute_dtype)


def custom_model(vocab_capacity: int = 1 << 18, embed_dim: int = 16,
                 bf16: bool = False, arena_dtype: str = "float32"):
    global DEDUP_VOCAB_CAPACITY
    # the dedup feed hashes on the host, so it must use the capacity the
    # model in this process was built with (feeds get no model handle)
    DEDUP_VOCAB_CAPACITY = int(vocab_capacity)
    return DeepFM(
        vocab_capacity=vocab_capacity,
        embed_dim=embed_dim,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        arena_dtype=arena_dtype,
    )


def loss(labels, predictions):
    """Mean sigmoid binary cross-entropy on logits (optax's
    sigmoid_binary_cross_entropy, averaged)."""
    return F.binary_cross_entropy_with_logits(predictions.float(),
                                              labels.float())


def optimizer(lr: float = 1e-3):
    """optax.adam(lr) with its defaults (b1 0.9, b2 0.999, eps 1e-8), as
    a factory over the parameters.  Dense Adam, as optax's: every row of
    the tables has its moments decayed on every step."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


RECORD_BYTES = NUM_DENSE * 4 + NUM_SPARSE * 4 + 1


def feed(records, metadata=None):
    dense = np.empty((len(records), NUM_DENSE), np.float32)
    sparse = np.empty((len(records), NUM_SPARSE), np.int32)
    labels = np.empty((len(records),), np.int32)
    for i, record in enumerate(records):
        if isinstance(record, dict):
            dense[i] = record["dense"]
            sparse[i] = record["sparse"]
            labels[i] = record["label"]
        else:
            dense[i] = np.frombuffer(record, np.float32, NUM_DENSE, 0)
            sparse[i] = np.frombuffer(
                record, np.int32, NUM_SPARSE, NUM_DENSE * 4
            )
            labels[i] = record[RECORD_BYTES - 1]
    return {
        "features": {"dense": dense, "sparse": sparse},
        "labels": labels,
    }


def feed_bulk(buffer, sizes, metadata=None):
    """Vectorized parse of the fixed 157-byte record: one reshape over the
    reader's contiguous payload buffer."""
    n = len(sizes)
    if n == 0 or not (np.asarray(sizes) == RECORD_BYTES).all():
        raise ValueError(
            f"deepfm feed_bulk expects fixed {RECORD_BYTES}-byte records"
        )
    arr = np.frombuffer(buffer, np.uint8).reshape(n, RECORD_BYTES)
    dense = np.ascontiguousarray(arr[:, : NUM_DENSE * 4]).view("<f4")
    sparse = np.ascontiguousarray(
        arr[:, NUM_DENSE * 4: NUM_DENSE * 4 + NUM_SPARSE * 4]
    ).view("<i4")
    labels = arr[:, RECORD_BYTES - 1].astype(np.int32)
    return {
        "features": {"dense": dense, "sparse": sparse},
        "labels": labels,
    }


def feed_bulk_compact(buffer, sizes, metadata=None):
    """feed_bulk in the compact wire format: dense bf16, sparse b22
    (uint16 low halves + bit-packed high 6), labels uint8, 99 bytes per
    example on the link instead of 160.  The model decodes on the
    device; dense values round through bf16 (they feed a log1p squash in
    f32).  This record format keeps ids < 2^22, the b22 bound."""
    batch = feed_bulk(buffer, sizes, metadata)
    features = batch["features"]
    return {
        "features": {
            "dense": pack_f32_to_bf16(features["dense"]),
            "sparse": pack_int_to_b22(features["sparse"]),
        },
        "labels": batch["labels"].astype(np.uint8),
    }


DEDUP_VOCAB_CAPACITY = 1 << 18   # set by custom_model()
# one packer for the process: its sticky caps keep consecutive batches of
# every worker thread at one shape (DedupPacker is thread-safe)
_DEDUP_PACKER = DedupPacker()


def feed_bulk_dedup(buffer, sizes, metadata=None):
    """feed_bulk in the dedup'd wire format: ids are field-offset and
    hashed on the host into shared-table rows, dedup'd per field into a
    frequency-ranked unique list, a 1-byte inverse plane and escape-coded
    exceptions; dense bf16, labels uint8.  The device skips the hash (the
    embeddings take the rows as they are)."""
    batch = feed_bulk(buffer, sizes, metadata)
    features = batch["features"]
    rows = hash_field_rows_host(features["sparse"], DEDUP_VOCAB_CAPACITY)
    return {
        "features": {
            "dense": pack_f32_to_bf16(features["dense"]),
            "sparse": _DEDUP_PACKER.pack(rows),
        },
        "labels": batch["labels"].astype(np.uint8),
    }


def eval_metrics_fn():
    return {"auc": auc, "accuracy": binary_accuracy}


# every arena table row-sharded over the mesh `model` axis
param_sharding = embedding_param_sharding
