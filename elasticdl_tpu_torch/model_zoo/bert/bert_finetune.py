"""BERT sequence classification — the port of the JAX zoo's
model_zoo/bert/bert_finetune.py, with the same parameter names, numerics
and zoo contract.

- Attention goes through `ring_self_attention`, which on one device is
  the Hopper flash kernel (ops/flash_attention.py).  It runs over all L
  positions, padding included, with no mask, as the JAX model does.
- The token table is a `DistributedEmbedding` (ids taken mod the vocab,
  no mixing; pad id -1 rows zeroed).
- Pooling is a max over the sequence, not a CLS token.
- bf16=True: parameters stay f32; the encoder's Dense layers and block
  LayerNorms compute in bf16 (the LayerNorm statistics in f32); the
  embedding LayerNorm and the classifier stay f32.

Only the dense single-device encoder is ported: moe_experts,
pipeline_microbatches and remat wait for the parallel-layer slice.

Record format: max_len int32 token ids | 1 uint8 label.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding
from elasticdl_tpu_torch.layers.linen import Dense, LayerNorm, gelu
from elasticdl_tpu_torch.ops.ring_attention import ring_self_attention

MAX_LEN = 128
VOCAB_SIZE = 8192


class RingSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.heads = heads
        self.qkv = Dense(hidden, 3 * hidden, dtype=dtype)
        self.out = Dense(hidden, hidden, dtype=dtype)

    def forward(self, x):
        batch, length, _ = x.shape
        head_dim = self.hidden // self.heads
        qkv = self.qkv(x)
        # q is columns [0, hidden), head h its [h*D, (h+1)*D): views into
        # qkv, read in place by the kernel through their row stride
        q, k, v = qkv.split(self.hidden, dim=-1)
        shape = (self.heads, head_dim)
        out = ring_self_attention(
            q.unflatten(-1, shape), k.unflatten(-1, shape),
            v.unflatten(-1, shape), mesh=None, causal=False,
        )
        return self.out(out.reshape(batch, length, self.hidden))


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 moe_experts: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError(
                "moe_experts > 0 (the Switch MoE FFN over the expert "
                "axis) comes with the parallel-layer slice of the port"
            )
        self.attention = RingSelfAttention(hidden, heads, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hidden, dtype=dtype)
        self.Dense_0 = Dense(hidden, mlp_dim, dtype=dtype)
        self.Dense_1 = Dense(mlp_dim, hidden, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(hidden, dtype=dtype)

    def forward(self, x):
        y = self.attention(x)
        x = self.LayerNorm_0(x + y)
        y = self.Dense_1(gelu(self.Dense_0(x)))
        return self.LayerNorm_1(x + y)


class BertClassifier(nn.Module):
    def __init__(self, vocab_size: int = VOCAB_SIZE, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = MAX_LEN, num_classes: int = 2,
                 moe_experts: int = 0, pipeline_microbatches: int = 0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pipeline_microbatches > 0:
            raise NotImplementedError(
                "pipeline_microbatches > 0 (the GPipe schedule over the "
                "pipe axis) comes with the parallel-layer slice of the port"
            )
        if remat:
            raise NotImplementedError(
                "remat=True (recompute each block in the backward) comes "
                "with the BERT training slice of the port"
            )
        self.num_layers = num_layers
        self.token_embedding = DistributedEmbedding(
            vocab_size, hidden, hash_input=False
        )
        self.position_embedding = nn.Parameter(torch.empty(max_len, hidden))
        self.LayerNorm_0 = LayerNorm(hidden)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(
                hidden, heads, mlp_dim, moe_experts=moe_experts, dtype=dtype
            ))
        self.classifier = Dense(hidden, num_classes)
        # the submodules drew their own parameters; only this one is left
        with torch.no_grad():
            nn.init.normal_(self.position_embedding, 0.0, 0.02)

    def forward(self, features):
        ids = features["input_ids"].to(torch.int32)         # (B, L)
        tok = self.token_embedding(ids)
        x = tok + self.position_embedding[None, : ids.shape[1]]
        x = self.LayerNorm_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        # max-pool over the sequence
        pooled = x.amax(dim=1)
        return self.classifier(pooled)


def init_parameters(model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter from flax's initialiser distributions: Dense
    lecun_normal kernels and zero biases, LayerNorm ones and zeros, the
    token table N(0, 0.05), the position table N(0, 0.02).  Pass a
    generator on the parameters' device for a seeded draw."""
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    if isinstance(model, BertClassifier):
        with torch.no_grad():
            nn.init.normal_(model.position_embedding, 0.0, 0.02,
                            generator=generator)


def custom_model(hidden: int = 768, num_layers: int = 12, heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = MAX_LEN,
                 vocab_size: int = VOCAB_SIZE, moe_experts: int = 0,
                 pipeline_microbatches: int = 0, bf16: bool = False,
                 remat: bool = False):
    return BertClassifier(
        vocab_size=vocab_size, hidden=hidden, num_layers=num_layers,
        heads=heads, mlp_dim=mlp_dim, max_len=max_len,
        dtype=torch.bfloat16 if bf16 else torch.float32,
        moe_experts=moe_experts,
        pipeline_microbatches=pipeline_microbatches,
        remat=remat,
    )


def loss(labels, predictions):
    """Mean softmax cross-entropy on integer labels (optax's
    softmax_cross_entropy_with_integer_labels, averaged)."""
    return F.cross_entropy(predictions.float(), labels.to(torch.int64))


def optimizer(lr: float = 2e-5):
    """optax.adamw(lr, weight_decay=0.01) with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8), as a factory over the parameters."""
    return functools.partial(
        torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.01,
    )


def feed(records, metadata=None, max_len: int = MAX_LEN):
    ids = np.empty((len(records), max_len), np.int32)
    labels = np.empty((len(records),), np.int32)
    for i, record in enumerate(records):
        if isinstance(record, dict):
            ids[i] = record["input_ids"]
            labels[i] = record["label"]
        else:
            ids[i] = np.frombuffer(record, np.int32, max_len, 0)
            labels[i] = record[max_len * 4]
    return {"features": {"input_ids": ids}, "labels": labels}


def feed_bulk(buffer, sizes, metadata=None):
    """Vectorized parse of the fixed-width record (max_len int32 ids + 1
    label byte); max_len is derived from the record size, so one parser
    serves every dataset length."""
    sizes = np.asarray(sizes)
    n = len(sizes)
    if n == 0 or not (sizes == sizes[0]).all() or sizes[0] % 4 != 1:
        raise ValueError(
            "bert feed_bulk expects fixed-width 4*max_len+1 byte records"
        )
    rec = int(sizes[0])
    arr = np.frombuffer(buffer, np.uint8).reshape(n, rec)
    ids = np.ascontiguousarray(arr[:, : rec - 1]).view("<i4")
    return {
        "features": {"input_ids": ids},
        "labels": arr[:, rec - 1].astype(np.int32),
    }


def feed_bulk_compact(buffer, sizes, metadata=None):
    """feed_bulk with the compact wire format: token ids as uint16 (any
    vocab <= 65536 fits), labels uint8.  The serving engine widens
    unsigned ids in numpy before they become tensors, and the model casts
    ids to int32 at entry."""
    batch = feed_bulk(buffer, sizes, metadata)
    ids = batch["features"]["input_ids"]
    if ids.size and (ids.min() < 0 or ids.max() >= 1 << 16):
        raise ValueError(
            "bert feed_bulk_compact needs token ids in [0, 65536); this "
            "dataset's don't fit uint16 — use the standard feed"
        )
    return {
        "features": {"input_ids": ids.astype(np.uint16)},
        "labels": batch["labels"].astype(np.uint8),
    }
