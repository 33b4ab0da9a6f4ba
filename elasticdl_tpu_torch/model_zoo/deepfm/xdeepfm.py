"""xDeepFM for Criteo-style CTR data (the port of the JAX zoo's
model_zoo/deepfm/xdeepfm.py, with its parameter names, numerics and zoo
contract).  It shares DeepFM's record format, feeds (plain, compact and
dedup wire formats) and embedding helpers.

The Compressed Interaction Network (CIN) replaces DeepFM's FM term with
explicit vector-wise interactions; each layer computes

    X^k[b,h,d] = sum_{i,j} W^k[h,i,j] * X^{k-1}[b,i,d] * X0[b,j,d]

The reference writes it as one einsum that XLA contracts without
building the outer product.  Here it runs as the conv formulation, by
choice: the outer product Z[b,(i,j),d] = X^{k-1}[b,i,d] * X0[b,j,d] is
built (B * H_{k-1} * m * D * 4 bytes: 436 MB for layer 2 at batch 4096,
H 64, m 26, D 16), then one batched matmul W^k (H, H_{k-1} * m) @ Z
contracts it on cuBLAS.  Contracting j first instead would build
(B, H, H_{k-1}, D), 2.5x larger at these widths.  Sum-pooling over d of
each layer's maps feeds `cin_out`, beside the linear term, the dense
linear head and the MLP tower.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.arena import EmbeddingArena
from elasticdl_tpu_torch.layers.embedding import embedding_param_sharding
from elasticdl_tpu_torch.layers.linen import Dense
from elasticdl_tpu_torch.model_zoo.common.metrics import auc, binary_accuracy
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_functional_api as _fm
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (  # noqa: F401,E501
    NUM_DENSE,
    NUM_SPARSE,
    RECORD_BYTES,
    arena_field_lookup,
    feed,
    feed_bulk,
    feed_bulk_compact,
    feed_bulk_dedup,
    loss,
    normalize_dense,
    optimizer,
    sparse_field_rows,
)

__all__ = [
    "custom_model", "loss", "optimizer", "feed", "feed_bulk",
    "feed_bulk_compact", "feed_bulk_dedup", "eval_metrics_fn",
    "param_sharding", "RECORD_BYTES", "NUM_DENSE", "NUM_SPARSE",
]


class CIN(nn.Module):
    """Compressed Interaction Network over field embeddings (B, m, D);
    parameters `w_0`, `w_1`, ... of shape (H_k, H_{k-1}, m), as flax's."""

    def __init__(self, fields: int, layer_widths: tuple = (64, 64)):
        super().__init__()
        self.layer_widths = tuple(layer_widths)
        prev = fields
        for li, width in enumerate(self.layer_widths):
            self.register_parameter(
                f"w_{li}", nn.Parameter(torch.empty(width, prev, fields)))
            prev = width
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """flax glorot_uniform on (H, H_prev, m): fan_in = H_prev * H,
        fan_out = m * H (the leading axis is the receptive field)."""
        with torch.no_grad():
            for li in range(len(self.layer_widths)):
                w = getattr(self, f"w_{li}")
                width, prev, fields = w.shape
                limit = math.sqrt(6.0 / (prev * width + fields * width))
                nn.init.uniform_(w, -limit, limit, generator=generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        batch, fields, dim = x0.shape
        pooled = []
        xk = x0
        for li, width in enumerate(self.layer_widths):
            w = getattr(self, f"w_{li}")
            with torch.profiler.record_function("cin_layer"):
                z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(
                    batch, xk.shape[1] * fields, dim)
                xk = F.relu(torch.matmul(w.reshape(width, -1), z))
            pooled.append(xk.sum(dim=-1))                 # (B, width)
        return torch.cat(pooled, dim=-1)


class XDeepFM(nn.Module):
    def __init__(self, vocab_capacity: int = 1 << 18, embed_dim: int = 16,
                 cin_widths: tuple = (64, 64), mlp_dims: tuple = (256, 128),
                 compute_dtype: torch.dtype = torch.float32,
                 arena_dtype: str = "float32"):
        super().__init__()
        self.vocab_capacity = vocab_capacity
        self.mlp_dims = tuple(mlp_dims)
        self.compute_dtype = compute_dtype
        features = (("sparse", vocab_capacity),)
        self.fm_embedding = EmbeddingArena(features, embed_dim,
                                           arena_dtype=arena_dtype)
        self.fm_linear = EmbeddingArena(features, 1, arena_dtype=arena_dtype)
        self.cin = CIN(NUM_SPARSE, cin_widths)
        self.cin_out = Dense(sum(cin_widths), 1)
        self.dense_linear = Dense(NUM_DENSE, 1)
        width = NUM_DENSE + NUM_SPARSE * embed_dim
        for i, out in enumerate(self.mlp_dims):
            self.add_module(f"mlp_{i}", Dense(width, out, dtype=compute_dtype))
            width = out
        self.mlp_out = Dense(width, 1, dtype=compute_dtype)

    def forward(self, features):
        field_ids, prehashed = sparse_field_rows(features,
                                                 self.vocab_capacity)
        emb = arena_field_lookup(self.fm_embedding, field_ids, prehashed)
        first = arena_field_lookup(self.fm_linear, field_ids, prehashed)

        cin_logit = self.cin_out(self.cin(emb))[..., 0]

        dense_n = normalize_dense(features["dense"])       # (B, 13)
        wide = self.dense_linear(dense_n)[..., 0]

        deep_in = torch.cat([dense_n, emb.reshape(emb.shape[0], -1)], dim=-1)
        h = deep_in.to(self.compute_dtype)
        for i in range(len(self.mlp_dims)):
            h = F.relu(getattr(self, f"mlp_{i}")(h))
        deep = self.mlp_out(h)[..., 0].float()

        return wide + first[..., 0].sum(dim=1) + cin_logit + deep


def custom_model(vocab_capacity: int = 1 << 18, embed_dim: int = 16,
                 bf16: bool = False, cin_widths: tuple = (64, 64),
                 arena_dtype: str = "float32"):
    # the shared dedup feed hashes on the host with this capacity
    _fm.DEDUP_VOCAB_CAPACITY = int(vocab_capacity)
    return XDeepFM(
        vocab_capacity=vocab_capacity,
        embed_dim=embed_dim,
        cin_widths=tuple(cin_widths),
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        arena_dtype=arena_dtype,
    )


def eval_metrics_fn():
    return {"auc": auc, "accuracy": binary_accuracy}


# every arena table row-sharded over the mesh `model` axis
param_sharding = embedding_param_sharding
