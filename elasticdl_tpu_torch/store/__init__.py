"""Tiered embedding store: a host-RAM bulk tier and a device hot-row
cache (the port of the JAX package's elasticdl_tpu/store).

The flat `EmbeddingArena` keeps the whole vocabulary on the device.  The
store keeps the whole, lazily grown vocabulary in host RAM (fp32, or
int8 codes with per-row scales) and only a hot-row cache on the device.
The cache table is the model's only trainable embedding storage: every
row a batch touches is admitted before its step, so the step is the flat
arena's and equal to it bit for bit on an all-hot working set.  Cold
rows are gathered from the host tier on a prefetch thread and written
back on eviction by a fold thread.

  host_tier.py   host planes and the lazy vocabulary (numpy)
  cache.py       the cache's bookkeeping and admission plans (numpy)
  device.py      the one device seam (admit, read)
  tiered.py      TieredStore: the orchestrator and its threads
  checkpoint.py  the sidecar and the tiered <-> flat migration
  serving.py     TieredServingEngine: cold rows on Predict, hot swap
  sharding.py    ShardedTieredStore: row-space shards over one host
                 tier, shard handoff (the online loop's store)
"""

from elasticdl_tpu_torch.store.cache import CachePlan, HotRowCache
from elasticdl_tpu_torch.store.host_tier import HostTier, LazyVocabulary
from elasticdl_tpu_torch.store.tiered import TieredStore

__all__ = [
    "CachePlan",
    "HotRowCache",
    "HostTier",
    "LazyVocabulary",
    "TieredStore",
]
