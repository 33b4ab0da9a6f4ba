"""BERT-base sequence classification, written out plainly in PyTorch.

This is the harness's own statement of the model the port's zoo
`bert.bert_finetune.custom_model` trains and serves (Devlin et al.,
arXiv:1810.04805, at the widths of a configuration file), with the zoo's
departures from the published model, which a configuration lists under
`assumed`:

- token ids index the table directly (taken mod the vocabulary as
  unsigned 32-bit numbers; id -1 is padding and embeds to zero); no
  segment embeddings; learned positions;
- LayerNorm with eps 1e-6, statistics as E[x^2] - E[x]^2 clipped at 0;
- post-norm blocks: x = LN(x + Attn(x)); x = LN(x + FFN(x)), the FFN's
  GELU in its tanh form;
- attention over all positions with no mask, scaled by D^-0.5, the
  query, key and value from one fused projection (columns q | k | v,
  head h at columns [h*D, (h+1)*D) of each);
- a max over the sequence in place of the [CLS] pooler, then a linear
  classifier; mean softmax cross-entropy.

It imports nothing of the program.  Parameters are a flat dict whose
names are the program's `state_dict` names, so the harness can hand the
same tensors to both.  Everything runs in float32; a `Precision`
(precision.py) may round each tensor that the configuration computes
in a lower type: the encoder's products, their outputs, the residual
sums and the blocks' LayerNorm outputs (`low`, bfloat16 in the
configuration), the embedding LayerNorm and the classifier's inputs
(`high`, float32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

_MASK32 = 0xFFFFFFFF


def widths(cfg: dict) -> dict:
    return {"hidden": cfg["hidden_size"], "layers": cfg["num_hidden_layers"],
            "heads": cfg["num_attention_heads"],
            "ffn": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "positions": cfg["max_position_embeddings"],
            "classes": cfg["num_labels"]}


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter, in a fixed order.
    init: "normal" (scale is the std), "fan_in" (std 1/sqrt(in) of an
    (out, in) weight) or "one_plus" (1 + scale * N(0, 1))."""
    w = widths(cfg)
    h, f = w["hidden"], w["ffn"]
    spec = [("token_embedding.embedding", (w["vocab"], h), "normal", 0.05),
            ("position_embedding", (w["positions"], h), "normal", 0.02),
            ("LayerNorm_0.weight", (h,), "one_plus", 0.05),
            ("LayerNorm_0.bias", (h,), "normal", 0.05)]
    for i in range(w["layers"]):
        p = f"layer_{i}."
        spec += [(p + "attention.qkv.weight", (3 * h, h), "fan_in", 1.0),
                 (p + "attention.qkv.bias", (3 * h,), "normal", 0.02),
                 (p + "attention.out.weight", (h, h), "fan_in", 1.0),
                 (p + "attention.out.bias", (h,), "normal", 0.02),
                 (p + "LayerNorm_0.weight", (h,), "one_plus", 0.05),
                 (p + "LayerNorm_0.bias", (h,), "normal", 0.05),
                 (p + "Dense_0.weight", (f, h), "fan_in", 1.0),
                 (p + "Dense_0.bias", (f,), "normal", 0.02),
                 (p + "Dense_1.weight", (h, f), "fan_in", 1.0),
                 (p + "Dense_1.bias", (h,), "normal", 0.02),
                 (p + "LayerNorm_1.weight", (h,), "one_plus", 0.05),
                 (p + "LayerNorm_1.bias", (h,), "normal", 0.05)]
    # a fresh classification head: its logits start near 0, as a
    # fine-tune's do on a pretrained encoder (pooled features here are
    # the max of LayerNorm outputs over the sequence, ~3 each)
    spec += [("classifier.weight", (w["classes"], h), "normal", 0.002),
             ("classifier.bias", (w["classes"],), "normal", 0.0)]
    return spec


def _layer_norm(x, weight, bias, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          0.0)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def _dense(x, weight, bias, rnd):
    return rnd(x) @ rnd(weight).t() + bias


def forward(P: Dict[str, torch.Tensor], features: dict, cfg: dict,
            prec: Precision) -> torch.Tensor:
    """(B, classes) float32 logits for (B, L) token ids."""
    w = widths(cfg)
    ids = features["input_ids"].long()
    batch, length = ids.shape
    heads = w["heads"]
    dim = w["hidden"] // heads
    valid = ids != -1
    rows = (torch.where(valid, ids, torch.zeros_like(ids)) & _MASK32) \
        % w["vocab"]
    x = P["token_embedding.embedding"][rows] * valid[..., None]
    x = x + P["position_embedding"][:length]
    x = prec.high(_layer_norm(x, P["LayerNorm_0.weight"],
                              P["LayerNorm_0.bias"]))
    # where the program computes or holds a tensor in bfloat16, `low`
    # rounds it (the identity for the reference)
    low = prec.low
    for i in range(w["layers"]):
        p = f"layer_{i}."
        qkv = low(_dense(x, P[p + "attention.qkv.weight"],
                         P[p + "attention.qkv.bias"], low))
        q, k, v = (t.reshape(batch, length, heads, dim).transpose(1, 2)
                   for t in qkv.split(w["hidden"], dim=-1))
        scores = (q @ k.transpose(-1, -2)) * dim ** -0.5
        probs = torch.softmax(scores, dim=-1)
        att = low((low(probs) @ v).transpose(1, 2).reshape(
            batch, length, w["hidden"]))
        y = low(_dense(att, P[p + "attention.out.weight"],
                       P[p + "attention.out.bias"], low))
        x = low(_layer_norm(low(x + y), P[p + "LayerNorm_0.weight"],
                            P[p + "LayerNorm_0.bias"]))
        h = low(_gelu_tanh(low(_dense(x, P[p + "Dense_0.weight"],
                                      P[p + "Dense_0.bias"], low))))
        y = low(_dense(h, P[p + "Dense_1.weight"], P[p + "Dense_1.bias"],
                       low))
        x = low(_layer_norm(low(x + y), P[p + "LayerNorm_1.weight"],
                            P[p + "LayerNorm_1.bias"]))
    pooled = x.amax(dim=1)
    return _dense(pooled, P["classifier.weight"], P["classifier.bias"],
                  prec.high)


def block_rows(features: dict) -> int:
    """Rows a block of the reference takes at once: 8192 tokens, which
    holds the float32 activations of a full-width block in ~10 GB."""
    length = features["input_ids"].shape[1]
    return max(1, 8192 // length)


def loss_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed softmax cross-entropy over a block's rows (the mean is
    this over the batch's rows)."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="sum")
