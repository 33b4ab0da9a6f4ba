"""Synthetic CIFAR-10-like data (the port's copy of the JAX zoo's
model_zoo/cifar10/data.py, byte for byte in its output):
class-conditional coloured patterns over 32x32x3, one record = 3072
image bytes + 1 label byte."""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data.record_io import write_tfrecords_bulk

IMG_BYTES = 32 * 32 * 3


def synthetic_cifar(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    proto = np.random.RandomState(77).rand(10, IMG_BYTES) * 255
    images = proto[labels] + rng.randn(n, IMG_BYTES) * 40
    return (
        np.clip(images, 0, 255).astype(np.uint8),
        labels.astype(np.uint8),
    )


def write_records(path: str, images, labels) -> None:
    rows = np.concatenate([images, labels[:, None]], axis=1)
    write_tfrecords_bulk(path, rows.reshape(-1),
                         np.full(len(rows), IMG_BYTES + 1, np.int64))


def write_dataset(directory: str, n_train: int = 1024, n_val: int = 256,
                  seed: int = 0, val_seed: int = None):
    """One training and one validation file, named as the JAX zoo's
    write_dataset names them; the validation records come from
    `val_seed` (default seed + 1, the JAX zoo's choice).  Returns
    (train_dir, val_dir)."""
    train_dir = os.path.join(directory, "train")
    val_dir = os.path.join(directory, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    write_records(os.path.join(train_dir, "cifar-00000.tfrecord"),
                  *synthetic_cifar(n_train, seed))
    write_records(os.path.join(val_dir, "cifar-val.tfrecord"),
                  *synthetic_cifar(n_val, seed + 1 if val_seed is None
                                   else val_seed))
    return train_dir, val_dir
