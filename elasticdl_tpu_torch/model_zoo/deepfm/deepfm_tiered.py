"""DeepFM over the tiered embedding store (store/): the port of the JAX
zoo's model_zoo/deepfm/deepfm_tiered.py.

The flat zoo's DeepFM but for the embedding storage: two `TieredArena`
hot-row caches on the device instead of two whole-vocabulary
`EmbeddingArena` tables; the whole, lazily grown vocabulary lives in the
store's host tier.  Everything after the lookups is the flat model's
`deepfm_tail`, with the same submodule names.

Features arrive translated by the store:
  slots        (B, 26) int32 cache slots (TieredStore.prepare)
  cold_fm      (B, 26, embed_dim) serving-only overlay for cold rows
  cold_linear  (B, 26, 1)         serving-only overlay for cold rows

Training never passes overlays (every row is admitted before its step);
serving passes them for slot -1 (store/serving.py).  On a mesh with
`model` > 1 the cache tables row-shard as the flat tables do
(`param_sharding`), and the store applies each rank's block of every
plan (store/tiered.py).  The Local runner
(client/api.py) finds `build_tiered_store` here, wraps the feeds with
the store's id -> slot translation and starts the store's threads.  The
feeds rank each batch's field-encoded ids with the dedup packer (its
per-call ranking, data/wire.py) for the store's admission plan.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.data.wire import DedupPacker, field_disjoint_ids
from elasticdl_tpu_torch.layers.arena import TieredArena
from elasticdl_tpu_torch.layers.embedding import hash_ids_host
from elasticdl_tpu_torch.layers.linen import Dense
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (  # noqa: F401,E501
    NUM_DENSE,
    NUM_SPARSE,
    _FIELD_MIX,
    deepfm_tail,
    eval_metrics_fn,
    feed as _base_feed,
    feed_bulk as _base_feed_bulk,
    loss,
    optimizer,
    # the cache tables row-shard over `model` by the flat tables' rule
    param_sharding,
)
from elasticdl_tpu_torch.store.tiered import TieredStore
from elasticdl_tpu_torch.worker.trainer import RANKING_KEY

# Set by custom_model(), read by build_tiered_store(): the feeds get no
# model handle, so the store is built from the configuration the model
# of this process was built with.
CACHE_ROWS = 1 << 12
EMBED_DIM = 16
HOST_DTYPE = "fp32"
CACHE_DTYPE = "float32"
STORE_SEED = 0x5EED

# the store the Local runner built last (its checks read it)
_LAST_STORE = None

# one packer for the process (thread-safe); only its per-call ranking is
# used
_RANK_PACKER = DedupPacker()


def _attach_ranking(batch):
    """The batch with the frequency ranking of its field-encoded ids
    (`wire.field_disjoint_ids`: the store's vocabulary keys (field, id),
    so equal raw ids of two fields stay apart) under
    `__dedup_ranking__`, for `TieredStore.attach`."""
    _, ranking = _RANK_PACKER.pack(
        field_disjoint_ids(batch["features"]["sparse"]),
        return_ranking=True)
    out = dict(batch)
    out[RANKING_KEY] = ranking
    return out


def feed(records, metadata=None):
    return _attach_ranking(_base_feed(records, metadata))


def feed_bulk(buffer, sizes, metadata=None):
    return _attach_ranking(_base_feed_bulk(buffer, sizes, metadata))


def flat_rows_host(fields, ids, vocab_capacity: int) -> np.ndarray:
    """The flat DeepFM's row of each (field, id) pair: the field-offset
    id and the arenas' hash, as `hash_field_rows_host` computes them for
    a (B, 26) batch.  The tiered <-> flat migration's `hash_fn`."""
    with np.errstate(over="ignore"):
        field_ids = np.asarray(ids).astype(np.uint32) \
            + np.asarray(fields).astype(np.uint32) * np.uint32(_FIELD_MIX)
    return hash_ids_host(field_ids, vocab_capacity, mix=True)


class TieredDeepFM(nn.Module):
    def __init__(self, cache_rows: int = 1 << 12, embed_dim: int = 16,
                 mlp_dims: tuple = (256, 128),
                 compute_dtype: torch.dtype = torch.float32,
                 cache_dtype: str = "float32"):
        super().__init__()
        self.cache_rows = int(cache_rows)
        self.mlp_dims = tuple(mlp_dims)
        self.compute_dtype = compute_dtype
        self.fm_embedding = TieredArena(cache_rows, embed_dim,
                                        cache_dtype=cache_dtype)
        self.fm_linear = TieredArena(cache_rows, 1, cache_dtype=cache_dtype)
        self.dense_linear = Dense(NUM_DENSE, 1)
        width = NUM_DENSE + NUM_SPARSE * embed_dim
        for i, out in enumerate(self.mlp_dims):
            self.add_module(f"mlp_{i}", Dense(width, out, dtype=compute_dtype))
            width = out
        self.mlp_out = Dense(width, 1, dtype=compute_dtype)

    def forward(self, features):
        slots = features["slots"]
        emb = self.fm_embedding(slots, overlay=features.get("cold_fm"))
        first = self.fm_linear(slots, overlay=features.get("cold_linear"))
        return deepfm_tail(self, emb, first, features["dense"],
                           self.compute_dtype)


def custom_model(cache_rows: int = 1 << 12, embed_dim: int = 16,
                 bf16: bool = False, host_dtype: str = "fp32",
                 store_seed: int = 0x5EED, cache_dtype: str = "float32"):
    global CACHE_ROWS, EMBED_DIM, HOST_DTYPE, CACHE_DTYPE, STORE_SEED
    CACHE_ROWS = int(cache_rows)
    EMBED_DIM = int(embed_dim)
    HOST_DTYPE = host_dtype
    CACHE_DTYPE = cache_dtype
    STORE_SEED = int(store_seed)
    return TieredDeepFM(
        cache_rows=CACHE_ROWS,
        embed_dim=EMBED_DIM,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        cache_dtype=CACHE_DTYPE,
    )


def store_planes(embed_dim: int = None):
    """Plane name -> dim, TieredDeepFM's two arenas."""
    return {"fm_embedding": int(embed_dim or EMBED_DIM), "fm_linear": 1}


# serving: the feature each plane's cold values travel under
OVERLAY_FEATURES = {"fm_embedding": "cold_fm", "fm_linear": "cold_linear"}


def build_tiered_store(registry=None, phase_timer=None) -> TieredStore:
    """A store matching the last custom_model() configuration; the
    Local runner builds one per job and it stays here as `_LAST_STORE`."""
    global _LAST_STORE
    store = TieredStore(
        planes=store_planes(),
        num_fields=NUM_SPARSE,
        cache_rows=CACHE_ROWS,
        host_dtype=HOST_DTYPE,
        seed=STORE_SEED,
        registry=registry,
        phase_timer=phase_timer,
        cache_dtype=CACHE_DTYPE,
    )
    _LAST_STORE = store
    return store
