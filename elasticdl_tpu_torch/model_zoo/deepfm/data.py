"""Synthetic Criteo-like CTR data with planted structure (the port's copy
of the JAX zoo's model_zoo/deepfm/data.py, byte for byte in its output):
the label depends on dense features, on individual sparse ids and on one
pairwise id interaction, so DeepFM's linear, FM and deep parts all have
signal to find.  `write_dataset` writes the same TFRecord shards as the
JAX zoo's, through the port's record_io and its vectorised CRC."""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data.record_io import write_tfrecords_bulk
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (
    NUM_DENSE,
    NUM_SPARSE,
    RECORD_BYTES,
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


def record_rows(dense, sparse, labels) -> np.ndarray:
    """The records of `records` as one (n, 157) uint8 array."""
    n = len(labels)
    rows = np.empty((n, RECORD_BYTES), np.uint8)
    rows[:, :NUM_DENSE * 4] = np.ascontiguousarray(
        dense, np.float32).view(np.uint8).reshape(n, -1)
    rows[:, NUM_DENSE * 4: RECORD_BYTES - 1] = np.ascontiguousarray(
        sparse, np.int32).view(np.uint8).reshape(n, -1)
    rows[:, RECORD_BYTES - 1] = labels
    return rows


def _write_shard(path: str, dense, sparse, labels) -> None:
    rows = record_rows(dense, sparse, labels)
    write_tfrecords_bulk(path, rows.reshape(-1),
                         np.full(len(rows), RECORD_BYTES, np.int64))


def write_dataset(directory: str, n_train: int = 8192, n_val: int = 2048,
                  seed: int = 0, shards: int = 2):
    """`shards` training files of n_train // shards records and one
    validation file, as the JAX zoo's write_dataset names and fills
    them; returns (train_dir, val_dir)."""
    train_dir = os.path.join(directory, "train")
    val_dir = os.path.join(directory, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    per_shard = n_train // shards
    for i in range(shards):
        _write_shard(os.path.join(train_dir, f"criteo-{i:05d}.tfrecord"),
                     *synthetic_criteo(per_shard, seed=seed + i))
    _write_shard(os.path.join(val_dir, "criteo-val.tfrecord"),
                 *synthetic_criteo(n_val, seed=seed + 1000))
    return train_dir, val_dir
