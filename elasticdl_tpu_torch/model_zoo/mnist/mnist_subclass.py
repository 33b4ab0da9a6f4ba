"""MNIST CNN, subclass style (the port of the JAX zoo's model_zoo/mnist/
mnist_subclass.py): the layers are named attributes (`conv1`, `conv2`,
`fc1`, `fc2`), as the flax `setup()` declares them; the forward, record
format and the rest of the zoo contract are mnist_functional_api's."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.linen import Conv, Dense
from elasticdl_tpu_torch.model_zoo.mnist.mnist_functional_api import (  # noqa: F401,E501
    POOLED,
    conv_tower,
    eval_metrics_fn,
    feed,
    feed_bulk,
    loss,
    optimizer,
)

__all__ = ["custom_model", "loss", "optimizer", "feed", "feed_bulk",
           "eval_metrics_fn"]


class MnistSubclassCNN(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.conv1 = Conv(1, 32, (3, 3))
        self.conv2 = Conv(32, 64, (3, 3))
        self.fc1 = Dense(POOLED, hidden)
        self.fc2 = Dense(hidden, 10)

    def forward(self, x):
        x = conv_tower(x, self.conv1, self.conv2)
        return self.fc2(F.relu(self.fc1(x)))  # logits


def custom_model(hidden: int = 128):
    return MnistSubclassCNN(hidden=hidden)
