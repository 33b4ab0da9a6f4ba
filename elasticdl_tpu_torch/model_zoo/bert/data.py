"""Synthetic sequence-classification data with a long-range planted
dependency (the port's copy of the JAX zoo's model_zoo/bert/data.py,
byte for byte in its output): label == 1 iff the first and last tokens
match, so a model learns it only by attending across the whole
sequence.  `write_dataset` writes the same TFRecord files as the JAX
zoo's, through the port's record_io and its vectorised CRC."""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data.record_io import write_tfrecords_bulk


def synthetic_pairs(n: int, max_len: int = 128, vocab: int = 8192,
                    seed: int = 0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, vocab, size=(n, max_len)).astype(np.int32)
    labels = rng.randint(0, 2, size=n).astype(np.uint8)
    match = labels == 1
    ids[match, -1] = ids[match, 0]
    # non-match rows must actually differ
    clash = (~match) & (ids[:, -1] == ids[:, 0])
    ids[clash, -1] = (ids[clash, 0] + 1) % vocab
    return ids, labels


def _write(path: str, ids: np.ndarray, labels: np.ndarray) -> None:
    """The zoo's records, max_len int32 token ids | 1 uint8 label, as
    one fixed-width TFRecord file."""
    n, max_len = ids.shape
    rows = np.empty((n, 4 * max_len + 1), np.uint8)
    rows[:, :-1] = np.ascontiguousarray(ids, "<i4").view(np.uint8)
    rows[:, -1] = labels
    write_tfrecords_bulk(path, rows, np.full(n, rows.shape[1]))


def write_dataset(directory: str, n_train: int = 2048, n_val: int = 512,
                  max_len: int = 128, vocab: int = 8192, seed: int = 0):
    train_dir = os.path.join(directory, "train")
    val_dir = os.path.join(directory, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    _write(os.path.join(train_dir, "pairs-00000.tfrecord"),
           *synthetic_pairs(n_train, max_len, vocab, seed))
    _write(os.path.join(val_dir, "pairs-val.tfrecord"),
           *synthetic_pairs(n_val, max_len, vocab, seed + 1))
    return train_dir, val_dir
