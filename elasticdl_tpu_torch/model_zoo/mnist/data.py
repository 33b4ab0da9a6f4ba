"""Synthetic MNIST-like data (the port's copy of the JAX zoo's
model_zoo/mnist/data.py, byte for byte in its output): class-conditional
blobs over 784 pixels, written as the real record format, 784 image
bytes and 1 label byte per TFRecord.  `grain_dataset` serves the same
records to a `grain://` origin as a plain random-access list, with no
grain package (data/reader/grain_reader.py)."""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data.record_io import write_tfrecords_bulk


def synthetic_mnist(n: int, seed: int = 0):
    """Class-conditional blobs over 784 dims: learnable, not trivial."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    proto = np.random.RandomState(1234).rand(10, 784) * 255
    images = proto[labels] + rng.randn(n, 784) * 32
    images = np.clip(images, 0, 255).astype(np.uint8)
    return images, labels.astype(np.uint8)


def grain_dataset(n: int = 2048, seed: int = 0):
    """The `grain://` factory (data/reader/grain_reader.py): the JAX
    zoo's records, each image's 784 bytes then its label byte, as a
    random-access list (`len` and `[i]`, grain's contract) in place of a
    grain MapDataset --
    --training_data 'grain://mnist.data:grain_dataset?n=2048'."""
    images, labels = synthetic_mnist(n, seed)
    return [row.tobytes() for row in record_rows(images, labels)]


def record_rows(images, labels) -> np.ndarray:
    """(n, 785) uint8: each image's bytes, then its label."""
    return np.concatenate(
        [np.asarray(images, np.uint8),
         np.asarray(labels, np.uint8)[:, None]], axis=1)


def write_records(path: str, images, labels) -> None:
    rows = record_rows(images, labels)
    write_tfrecords_bulk(path, rows.reshape(-1),
                         np.full(len(rows), rows.shape[1], np.int64))


def write_dataset(directory: str, n_train: int = 2048, n_val: int = 512,
                  seed: int = 0):
    """One training and one validation file, as the JAX zoo's
    write_dataset names and fills them; returns (train_dir, val_dir)."""
    train_dir = os.path.join(directory, "train")
    val_dir = os.path.join(directory, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    write_records(os.path.join(train_dir, "mnist-00000.tfrecord"),
                  *synthetic_mnist(n_train, seed))
    write_records(os.path.join(val_dir, "mnist-00000.tfrecord"),
                  *synthetic_mnist(n_val, seed + 1))
    return train_dir, val_dir
