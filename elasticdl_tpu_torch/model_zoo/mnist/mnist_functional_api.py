"""MNIST CNN (the port of the JAX zoo's model_zoo/mnist/
mnist_functional_api.py, with its parameter names, numerics and zoo
contract): two 3x3 "SAME" convs (32, 64), a 2x2 max pool, Dense 128,
Dense 10.

The port runs NCHW and flax runs NHWC, so the pooled maps are permuted
to (B, H, W, C) before the flatten: `Dense_0`'s carried kernel expects
its 12,544 inputs in H, W, C order.

Records are dicts {"image": (784,) values, "label": int} (the memory
reader) or 785-byte blobs, 784 image bytes and 1 label byte (TFRecord
files written by mnist/data.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.linen import Conv, Dense, max_pool

IMAGE_BYTES = 28 * 28
RECORD_BYTES = IMAGE_BYTES + 1
POOLED = 14 * 14 * 64


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C), flax's row-major NHWC flatten."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def conv_tower(x, conv1, conv2):
    """(B, 784) pixels -> the pooled maps, flattened as flax's."""
    x = x.reshape(x.shape[0], 1, 28, 28)
    x = F.relu(conv1(x))
    x = F.relu(conv2(x))
    return flatten_nhwc(max_pool(x, (2, 2), (2, 2)))


class MnistCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(1, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        self.Dense_0 = Dense(POOLED, 128)
        self.Dense_1 = Dense(128, 10)

    def forward(self, x):
        x = conv_tower(x, self.Conv_0, self.Conv_1)
        return self.Dense_1(F.relu(self.Dense_0(x)))  # logits


def custom_model():
    return MnistCNN()


def loss(labels, predictions):
    """Mean softmax cross-entropy on logits against integer labels."""
    return F.cross_entropy(predictions.float(), labels.long())


def optimizer(lr: float = 1e-3):
    """optax.adam(lr) with its defaults, as a factory over the
    parameters."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def feed(records, metadata=None):
    images, labels = [], []
    for record in records:
        if isinstance(record, dict):
            images.append(np.asarray(record["image"], np.float32))
            labels.append(int(record["label"]))
        else:
            arr = np.frombuffer(record, dtype=np.uint8)
            images.append(arr[:IMAGE_BYTES].astype(np.float32))
            labels.append(int(arr[IMAGE_BYTES]))
    features = np.stack(images) / 255.0
    return {
        "features": features.astype(np.float32),
        "labels": np.asarray(labels, np.int32),
    }


def feed_bulk(buffer, sizes, metadata=None):
    """Vectorized parse of the fixed 785-byte record: one reshape over
    the reader's contiguous buffer."""
    n = len(sizes)
    if n == 0 or not (np.asarray(sizes) == RECORD_BYTES).all():
        raise ValueError("mnist feed_bulk expects fixed 785-byte records")
    arr = np.frombuffer(buffer, np.uint8).reshape(n, RECORD_BYTES)
    return {
        "features": (arr[:, :IMAGE_BYTES].astype(np.float32) / 255.0),
        "labels": arr[:, IMAGE_BYTES].astype(np.int32),
    }


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: float(
            np.mean(np.argmax(predictions, axis=-1) == labels)
        ),
    }


class PredictionOutputsProcessor:
    """The `--prediction_outputs_processor` surface: called with every
    prediction batch.  This one keeps them in memory; a production
    processor would stream rows to a sink."""

    def __init__(self):
        self.batches = []

    def process(self, predictions, worker_id):
        self.batches.append((worker_id, np.asarray(predictions)))
