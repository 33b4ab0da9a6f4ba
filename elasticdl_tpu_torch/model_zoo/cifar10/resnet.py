"""ResNet-50 for CIFAR-10 (the port of the JAX zoo's model_zoo/cifar10/
resnet.py, with its module names, numerics and zoo contract):
bottleneck-block ResNet-v1.5, stages (3, 4, 6, 3), with the CIFAR stem
(a 3x3 conv, no initial max-pool).

Module names follow flax's auto-naming, so `common/weights.py::
params_from_jax` carries a flax tree (params and `batch_stats`) across:
`Conv_0`, `BatchNorm_0`, `BottleneckBlock_k` (inside: `Conv_0..2`,
`BatchNorm_0..2`, and the projection `Conv_3` / `BatchNorm_3` where the
shape changes), `Dense_0`.  The last BatchNorm of each block starts at
scale 0.  Convs pad as flax's "SAME" (layers/linen.py: the strided 3x3
of each stage's first block pads (0, 1)).

BatchNorm is the model's mutable state: the forward takes the zoo
contract's `train` kwarg (worker/trainer.py passes it); training steps
normalise by the batch and move the running statistics, evaluation and
serving read them, and checkpoints carry them as buffers.

Record format: 32 * 32 * 3 image bytes (H, W, C) + 1 label byte.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.linen import BatchNorm, Conv, Dense

IMG_BYTES = 32 * 32 * 3
RECORD_BYTES = IMG_BYTES + 1


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), use_bias=False)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), (strides, strides),
                           use_bias=False)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False)
        self.BatchNorm_2 = BatchNorm(out, scale_init_zero=True)
        self.project = in_features != out or strides != 1
        if self.project:
            self.Conv_3 = Conv(in_features, out, (1, 1), (strides, strides),
                               use_bias=False)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x, train: bool = False):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.project:
            residual = self.BatchNorm_3(self.Conv_3(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 10):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.Conv_0 = Conv(3, 64, (3, 3), use_bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        width, k = 64, 0
        for stage, size in enumerate(self.stage_sizes):
            for block in range(size):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = 64 * 2 ** stage
                self.add_module(f"BottleneckBlock_{k}", BottleneckBlock(
                    width, filters, strides))
                width, k = filters * 4, k + 1
        self.num_blocks = k
        self.Dense_0 = Dense(width, num_classes)

    def forward(self, x, train: bool = False):
        # flat H, W, C bytes -> NCHW
        x = x.reshape(x.shape[0], 32, 32, 3).permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        for k in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{k}")(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def custom_model(stage_sizes=(3, 4, 6, 3)):
    return ResNet(stage_sizes=tuple(stage_sizes))


def loss(labels, predictions):
    """Mean softmax cross-entropy on logits against integer labels."""
    return F.cross_entropy(predictions.float(), labels.long())


def optimizer(lr: float = 0.1):
    """optax.sgd(lr, momentum=0.9): trace = g + 0.9 * trace, param -=
    lr * trace; torch's SGD with dampening 0 keeps the same buffer."""
    return functools.partial(torch.optim.SGD, lr=lr, momentum=0.9,
                             dampening=0.0, nesterov=False)


def feed(records, metadata=None):
    images, labels = [], []
    for record in records:
        if isinstance(record, dict):
            images.append(np.asarray(record["image"], np.float32))
            labels.append(int(record["label"]))
        else:
            arr = np.frombuffer(record, dtype=np.uint8)
            images.append(arr[:IMG_BYTES].astype(np.float32))
            labels.append(int(arr[IMG_BYTES]))
    features = (np.stack(images) / 255.0 - 0.5).astype(np.float32)
    return {
        "features": features,
        "labels": np.asarray(labels, np.int32),
    }


def feed_bulk(buffer, sizes, metadata=None):
    """Vectorized parse of the fixed 3073-byte record."""
    n = len(sizes)
    if n == 0 or not (np.asarray(sizes) == RECORD_BYTES).all():
        raise ValueError(
            f"cifar10 feed_bulk expects fixed {RECORD_BYTES}-byte records"
        )
    arr = np.frombuffer(buffer, np.uint8).reshape(n, RECORD_BYTES)
    features = (arr[:, :IMG_BYTES].astype(np.float32) / 255.0 - 0.5)
    return {
        "features": features,
        "labels": arr[:, IMG_BYTES].astype(np.int32),
    }


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: float(
            np.mean(np.argmax(predictions, axis=-1) == labels)
        ),
    }
