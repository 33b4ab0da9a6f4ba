"""Synthetic Criteo-like CTR data with planted structure (the port's copy
of the JAX zoo's model_zoo/deepfm/data.py, byte for byte in its output):
the label depends on dense features, on individual sparse ids and on one
pairwise id interaction, so DeepFM's linear, FM and deep parts all have
signal to find.  Writing TFRecord shards waits for the reader slice."""

from __future__ import annotations

import numpy as np

from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (
    NUM_DENSE,
    NUM_SPARSE,
)


def synthetic_criteo(n: int, seed: int = 0, ids_per_field: int = 1000):
    rng = np.random.RandomState(seed)
    dense = rng.exponential(1.0, size=(n, NUM_DENSE)).astype(np.float32)
    # zipf-ish id popularity, like real CTR traffic
    sparse = (
        rng.zipf(1.5, size=(n, NUM_SPARSE)).astype(np.int64) % ids_per_field
    ).astype(np.int32)

    planted = np.random.RandomState(7)
    id_weights = planted.randn(NUM_SPARSE, ids_per_field) * 0.6
    dense_w = planted.randn(NUM_DENSE) * 0.25
    logits = 2.0 * (
        np.log1p(dense) @ dense_w
        + id_weights[np.arange(NUM_SPARSE)[None, :], sparse].sum(axis=1) * 0.3
        # planted pairwise interaction between fields 0 and 1
        + 0.8 * ((sparse[:, 0] % 7) == (sparse[:, 1] % 7)).astype(np.float32)
        - 0.5
    )
    prob = 1.0 / (1.0 + np.exp(-logits))
    labels = (rng.rand(n) < prob).astype(np.uint8)
    return dense, sparse, labels


def records(dense, sparse, labels):
    """157-byte records: 13 float32 dense | 26 int32 ids | 1 uint8 label."""
    for d, s, y in zip(dense, sparse, labels):
        yield d.tobytes() + s.tobytes() + bytes([int(y)])
