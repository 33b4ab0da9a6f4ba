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
- remat=True recomputes each encoder block in the backward
  (`torch.utils.checkpoint`, non-reentrant), as flax's nn.remat does:
  the same parameter names, the same numbers, less activation memory;
  the flash forward then runs twice per block per step.

On a mesh (parallel/mesh.py, set by the trainer) the variants of the
JAX zoo run over its axes:

- `seq`: each position embeds its chunk of the sequence with the
  position offset, attention is the ring (ops/ring_attention.py), and
  the pool is `axis_max` over `seq`;
- `model`: the token table is row-sharded (`param_sharding`);
- moe_experts > 0: the FFN is a Switch `MoEMLP` (layers/moe.py), its
  expert stacks sharded over `expert`;
- pipeline_microbatches > 0: the encoder is `GPipeBlocks` of
  `PipelinedBlock`s (layers/pipeline.py) over `pipe`; their attention is
  the ring of one (no `seq` axis), so the flash kernel where
  `flash_shapes_ok` holds (the JAX code uses flash on its TPU backend).

In export mode each runs its one-device form on the gathered tree.

Record format: max_len int32 token ids | 1 uint8 label.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.layers.embedding import (
    DistributedEmbedding,
    embedding_param_sharding,
)
from elasticdl_tpu_torch.layers.linen import Dense, LayerNorm, gelu
from elasticdl_tpu_torch.layers.moe import MoEMLP, moe_param_sharding
from elasticdl_tpu_torch.layers.pipeline import (
    GPipeBlocks,
    pipeline_param_sharding,
)
from elasticdl_tpu_torch.model_zoo.common.metrics import auc
from elasticdl_tpu_torch.ops.ring_attention import ring_self_attention
from elasticdl_tpu_torch.parallel.collectives import axis_max
from elasticdl_tpu_torch.parallel.mesh import SEQ_AXIS, get_current_mesh

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
            v.unflatten(-1, shape), mesh=get_current_mesh(), causal=False,
        )
        return self.out(out.reshape(batch, length, self.hidden))


class PipelinedBlock(nn.Module):
    """Shape-preserving block of the GPipe stack: local attention and a
    dense FFN."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
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


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 moe_experts: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = RingSelfAttention(hidden, heads, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hidden, dtype=dtype)
        if moe_experts > 0:
            # the Switch FFN, experts sharded over `expert` (f32, as the
            # JAX block builds it)
            self.moe_mlp = MoEMLP(hidden, num_experts=moe_experts,
                                  ffn_dim=mlp_dim)
        else:
            self.Dense_0 = Dense(hidden, mlp_dim, dtype=dtype)
            self.Dense_1 = Dense(mlp_dim, hidden, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(hidden, dtype=dtype)

    def forward(self, x):
        y = self.attention(x)
        x = self.LayerNorm_0(x + y)
        if hasattr(self, "moe_mlp"):
            y = self.moe_mlp(x)
        else:
            y = self.Dense_1(gelu(self.Dense_0(x)))
        return self.LayerNorm_1(x + y)


class BertClassifier(nn.Module):
    def __init__(self, vocab_size: int = VOCAB_SIZE, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = MAX_LEN, num_classes: int = 2,
                 moe_experts: int = 0, pipeline_microbatches: int = 0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pipeline_microbatches > 0 and moe_experts > 0:
            raise ValueError(
                "pipeline_microbatches and moe_experts are mutually "
                "exclusive")
        self.num_layers = num_layers
        self.pipelined = pipeline_microbatches > 0
        # recompute each block in the backward; the parameters, and so
        # the checkpoints, are the same either way
        self.remat = remat
        self.token_embedding = DistributedEmbedding(
            vocab_size, hidden, hash_input=False
        )
        self.position_embedding = nn.Parameter(torch.empty(max_len, hidden))
        self.LayerNorm_0 = LayerNorm(hidden)
        if self.pipelined:
            self.encoder_pipeline = GPipeBlocks(
                functools.partial(PipelinedBlock, hidden, heads, mlp_dim,
                                  dtype=dtype),
                num_layers=num_layers,
                num_microbatches=pipeline_microbatches, remat=remat)
        else:
            for i in range(num_layers):
                self.add_module(f"layer_{i}", TransformerBlock(
                    hidden, heads, mlp_dim, moe_experts=moe_experts,
                    dtype=dtype))
        self.classifier = Dense(hidden, num_classes)
        # the submodules drew their own parameters; only this one is left
        self.reset_own_parameters()

    def reset_own_parameters(self,
                             generator: Optional[torch.Generator] = None):
        """The position table, N(0, 0.02): the one parameter of no
        submodule, drawn last by `linen.init_parameters`."""
        with torch.no_grad():
            nn.init.normal_(self.position_embedding, 0.0, 0.02,
                            generator=generator)

    def forward(self, features):
        ids = features["input_ids"].to(torch.int32)         # (B, L)
        mesh = get_current_mesh()
        chunks = mesh.shape[SEQ_AXIS]
        start = 0
        if chunks > 1:
            # this position's chunk of the sequence
            if self.pipelined:
                raise ValueError(
                    "the pipelined encoder attends locally: it cannot "
                    f"run on a '{SEQ_AXIS}' axis of {chunks}")
            if ids.shape[1] % chunks:
                raise ValueError(
                    f"sequence length {ids.shape[1]} does not split over "
                    f"'{SEQ_AXIS}' of size {chunks}")
            width = ids.shape[1] // chunks
            start = mesh.coords[SEQ_AXIS] * width
            ids = ids[:, start:start + width]
        tok = self.token_embedding(ids)
        x = tok + self.position_embedding[None, start:start + ids.shape[1]]
        x = self.LayerNorm_0(x)
        if self.pipelined:
            x = self.encoder_pipeline(x)
        for i in range(0 if self.pipelined else self.num_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                # the block draws no random numbers, so the recompute
                # needs no saved RNG state (a CUDA graph capture cannot
                # read the generator's)
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x)
        # max-pool over the sequence (and over its chunks)
        pooled = axis_max(x, mesh, SEQ_AXIS, dim=1) if chunks > 1 \
            else x.amax(dim=1)
        return self.classifier(pooled)


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


def eval_metrics_fn():
    """Accuracy of the argmax, and AUC on logit1 - logit0, over (B, 2)
    logits."""
    return {
        "accuracy": lambda labels, predictions: float(
            np.mean(np.argmax(predictions, -1) == labels)
        ),
        "auc": lambda labels, predictions: auc(
            labels, predictions[:, 1] - predictions[:, 0]
        ),
    }


def param_sharding(name: str, value):
    """The token table row-sharded over `model`, expert stacks over
    `expert`, the pipelined layer stack over `pipe`; everything else
    replicated (the JAX zoo's `param_sharding`)."""
    for rule in (pipeline_param_sharding, moe_param_sharding,
                 embedding_param_sharding):
        spec = rule(name, value)
        if spec is not None:
            return spec
    return None
