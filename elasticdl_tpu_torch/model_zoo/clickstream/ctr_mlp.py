"""Click-through-rate MLP (the port of the JAX zoo's model_zoo/
clickstream/ctr_mlp.py, with its parameter names, numerics and zoo
contract), the model of the online loop (ROADMAP.md item 10).

Records are click dicts {user, item, clicked, ...}.  Features are hashed
one-hots, the user into the first HASH_USER buckets and the item into
the next HASH_ITEM, so the serving input stays a fixed (B, DIM) matrix
however the id spaces grow.  Two logits, [no-click, click].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.linen import Dense

HASH_USER = 64
HASH_ITEM = 64
DIM = HASH_USER + HASH_ITEM


class CtrMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(DIM, 32)
        self.Dense_1 = Dense(32, 2)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))  # logits


def custom_model():
    return CtrMLP()


def loss(labels, predictions):
    """Mean softmax cross-entropy over the 2 logits."""
    return F.cross_entropy(predictions.float(), labels.long())


def optimizer(lr: float = 1e-2):
    """optax.adam(lr) with its defaults, as a factory over the
    parameters."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def encode(users: np.ndarray, items: np.ndarray) -> np.ndarray:
    """(B,) user ids + (B,) item ids -> (B, DIM) hashed one-hots, shared
    by feed() and serving clients so both see one feature space."""
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    out = np.zeros((users.shape[0], DIM), np.float32)
    out[np.arange(users.shape[0]), users % HASH_USER] = 1.0
    out[np.arange(items.shape[0]), HASH_USER + items % HASH_ITEM] = 1.0
    return out


def feed(records, metadata=None):
    users, items, labels = [], [], []
    for record in records:
        users.append(int(record["user"]))
        items.append(int(record["item"]))
        labels.append(int(record["clicked"]))
    return {
        "features": encode(np.asarray(users), np.asarray(items)),
        "labels": np.asarray(labels, np.int32),
    }


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: float(
            np.mean(np.argmax(predictions, axis=-1) == labels)
        ),
    }
