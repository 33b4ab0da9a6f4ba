"""Wide & Deep on Census-income-style data (the port of the JAX zoo's
model_zoo/census/wide_and_deep.py, with its parameter names, numerics
and zoo contract).

Records are CSV rows of strings (data/reader/csv_reader.py, or tuples
from the sqlite table reader); `feed` finds each column through the
reader's `columns` metadata and hashes the categoricals on the host with
FNV-1a (preprocessing/layers.py), bit for bit with the JAX feed.

Two embedding arenas (layers/arena.py), each one gather and one
scatter-add (the Hopper kernel on the card) a step:
- `deep_embedding`: the 8 categorical features at D = embed_dim, each
  owning vocab_capacity / 8 rows, into an MLP (`mlp_0`, `mlp_1`,
  `deep_out`) beside log1p(|numeric|);
- `wide_linear`: the 8 categoricals and 2 hashed crosses at D = 1, summed
  with `wide_numeric`'s linear term.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.arena import EmbeddingArena
from elasticdl_tpu_torch.layers.linen import Dense
from elasticdl_tpu_torch.model_zoo.common.metrics import auc, binary_accuracy
from elasticdl_tpu_torch.preprocessing.layers import fnv1a_hash

NUMERIC_COLS = ["age", "capital_gain", "capital_loss", "hours_per_week"]
CATEGORICAL_COLS = [
    "workclass", "education", "marital_status", "occupation",
    "relationship", "race", "sex", "native_country",
]
LABEL_COL = "label"
COLUMNS = NUMERIC_COLS + CATEGORICAL_COLS + [LABEL_COL]

_CROSSES = [("education", "occupation"), ("marital_status", "relationship")]
_WIDE_COLS = CATEGORICAL_COLS + [f"{a}_x_{b}" for a, b in _CROSSES]


def deep_arena_features(vocab_capacity: int):
    """((name, capacity), ...) for the deep arena: the 8 categorical
    columns split the vocab budget evenly."""
    per = max(vocab_capacity // len(CATEGORICAL_COLS), 1)
    return tuple((name, per) for name in CATEGORICAL_COLS)


def wide_arena_features(vocab_capacity: int):
    """((name, capacity), ...) for the wide arena (8 raw + 2 crossed)."""
    per = max(vocab_capacity // len(CATEGORICAL_COLS), 1)
    return tuple((name, per) for name in _WIDE_COLS)


class WideAndDeep(nn.Module):
    def __init__(self, vocab_capacity: int = 4096, embed_dim: int = 8,
                 mlp_dims: tuple = (64, 32), arena_dtype: str = "float32"):
        super().__init__()
        self.mlp_dims = tuple(mlp_dims)
        self.deep_embedding = EmbeddingArena(
            deep_arena_features(vocab_capacity), embed_dim,
            arena_dtype=arena_dtype)
        width = len(NUMERIC_COLS) + len(CATEGORICAL_COLS) * embed_dim
        for i, out in enumerate(self.mlp_dims):
            self.add_module(f"mlp_{i}", Dense(width, out))
            width = out
        self.deep_out = Dense(width, 1)
        self.wide_linear = EmbeddingArena(
            wide_arena_features(vocab_capacity), 1, arena_dtype=arena_dtype)
        self.wide_numeric = Dense(len(NUMERIC_COLS), 1)

    def forward(self, features):
        numeric = features["numeric"].float()              # (B, 4)
        cat = features["categorical"].to(torch.int32)      # (B, 8)
        cross = features["cross"].to(torch.int32)          # (B, 2)

        numeric = torch.log1p(numeric.abs())

        deep_vecs = self.deep_embedding(
            {name: cat[:, j] for j, name in enumerate(CATEGORICAL_COLS)})
        emb = torch.stack([deep_vecs[name] for name in CATEGORICAL_COLS],
                          dim=1)                            # (B, 8, k)
        h = torch.cat([numeric, emb.reshape(emb.shape[0], -1)], dim=-1)
        for i in range(len(self.mlp_dims)):
            h = F.relu(getattr(self, f"mlp_{i}")(h))
        deep = self.deep_out(h)[..., 0]

        wide_ids = torch.cat([cat, cross], dim=1)           # (B, 10)
        wide_vecs = self.wide_linear(
            {name: wide_ids[:, j] for j, name in enumerate(_WIDE_COLS)})
        # Python's sum, from 0, in column order: the flax model's order
        wide = sum(wide_vecs[name][..., 0] for name in _WIDE_COLS)
        wide = wide + self.wide_numeric(numeric)[..., 0]

        return wide + deep  # logits


def custom_model(vocab_capacity: int = 4096, embed_dim: int = 8,
                 arena_dtype: str = "float32"):
    return WideAndDeep(vocab_capacity=vocab_capacity, embed_dim=embed_dim,
                       arena_dtype=arena_dtype)


def loss(labels, predictions):
    """Mean sigmoid binary cross-entropy on logits."""
    return F.binary_cross_entropy_with_logits(predictions.float(),
                                              labels.float())


def optimizer(lr: float = 1e-3):
    """optax.adam(lr) with its defaults, as a factory over the
    parameters."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def feed(records, metadata=None):
    """records: CSV rows (strings) or table rows, their columns named by
    the reader's `columns` metadata (COLUMNS when it names none)."""
    columns = (metadata or {}).get("columns") or COLUMNS
    idx = {c: i for i, c in enumerate(columns)}
    n = len(records)
    numeric = np.empty((n, len(NUMERIC_COLS)), np.float32)
    cat = np.empty((n, len(CATEGORICAL_COLS)), np.int32)
    cross = np.empty((n, len(_CROSSES)), np.int32)
    labels = np.empty((n,), np.int32)
    for i, row in enumerate(records):
        for j, col in enumerate(NUMERIC_COLS):
            numeric[i, j] = float(row[idx[col]])
        for j, col in enumerate(CATEGORICAL_COLS):
            cat[i, j] = fnv1a_hash(f"{col}={row[idx[col]]}")
        for j, (a, b) in enumerate(_CROSSES):
            cross[i, j] = fnv1a_hash(f"{a}x{b}={row[idx[a]]}|{row[idx[b]]}")
        labels[i] = int(row[idx[LABEL_COL]])
    return {
        "features": {"numeric": numeric, "categorical": cat, "cross": cross},
        "labels": labels,
    }


def eval_metrics_fn():
    return {"auc": auc, "accuracy": binary_accuracy}
