"""DeepFM for Criteo-style CTR data, written out plainly in PyTorch.

This is the harness's own statement of the model the port's zoo
`deepfm.deepfm_functional_api.custom_model` trains (Guo et al.,
IJCAI 2017, arXiv:1703.04247, at the widths of a configuration file),
with the zoo's layout:

- the 26 categorical fields share one hashed table: field f's raw id
  becomes the unsigned 32-bit number id + f * 0x61C88647 (mod 2^32),
  which is multiplied by Knuth's 2654435761 (mod 2^32) and taken mod the
  table's rows; an offset id equal to 2^32 - 1 (the program's pad id -1)
  embeds to zero;
- two tables: the factors (embed_dim) and the first-order weights (1);
- FM second order by the square of the sum; a linear "wide" term on the
  13 dense counters after a signed log1p; an MLP (ReLU) on the dense
  counters and the flattened factors;
- logits = wide + first order + FM + deep; mean sigmoid cross-entropy.

It imports nothing of the program; parameter names are the program's
`state_dict` names.  A `Precision` (precision.py) may round what the
configuration computes in bfloat16 (`low`: the dense features, the
MLP's inputs, products and outputs) and in float32 (`high`: the
embedding rows and the wide term's inputs).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

FIELD_MIX = 0x61C88647
KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def widths(cfg: dict) -> dict:
    return {"rows": cfg["vocab_capacity"], "dim": cfg["embed_dim"],
            "mlp": list(cfg["mlp_dims"]), "dense": cfg["num_dense"],
            "fields": cfg["num_sparse"]}


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter (see bert.py)."""
    w = widths(cfg)
    spec = [("fm_embedding.embedding", (w["rows"], w["dim"]), "normal", 0.05),
            ("fm_linear.embedding", (w["rows"], 1), "normal", 0.05),
            ("dense_linear.weight", (1, w["dense"]), "fan_in", 1.0),
            ("dense_linear.bias", (1,), "normal", 0.02)]
    width = w["dense"] + w["fields"] * w["dim"]
    for i, out in enumerate(w["mlp"]):
        spec += [(f"mlp_{i}.weight", (out, width), "fan_in", 1.0),
                 (f"mlp_{i}.bias", (out,), "normal", 0.02)]
        width = out
    spec += [("mlp_out.weight", (1, width), "fan_in", 1.0),
             ("mlp_out.bias", (1,), "normal", 0.02)]
    return spec


def table_rows(sparse: torch.Tensor, rows: int):
    """(B, F) raw ids -> (table rows int64, valid mask)."""
    fields = sparse.shape[1]
    offsets = torch.arange(fields, dtype=torch.int64,
                           device=sparse.device) * FIELD_MIX
    u = (sparse.long() + offsets) & _MASK32
    valid = u != _MASK32
    u = torch.where(valid, u, torch.zeros_like(u))
    lo, hi = u & _MASK16, u >> 16
    # (u * KNUTH) mod 2^32 from 16-bit halves: no int64 product overflows
    mixed = (lo * KNUTH + (((hi * KNUTH) & _MASK16) << 16)) & _MASK32
    return mixed % rows, valid


def forward(P: Dict[str, torch.Tensor], features: dict, cfg: dict,
            prec: Precision) -> torch.Tensor:
    """(B,) float32 logits."""
    w = widths(cfg)
    rows, valid = table_rows(features["sparse"], w["rows"])
    mask = valid[..., None].float()
    emb = prec.high(P["fm_embedding.embedding"][rows] * mask)
    first = prec.high(P["fm_linear.embedding"][rows] * mask)
    sum_f = emb.sum(dim=1)
    fm2 = 0.5 * (sum_f * sum_f - (emb * emb).sum(dim=1)).sum(dim=-1)
    dense = prec.low(features["dense"].float())
    dense_n = torch.log1p(dense.abs()) * torch.sign(dense)
    wide = (prec.high(dense_n) @ prec.high(P["dense_linear.weight"]).t()
            + P["dense_linear.bias"])[:, 0]
    h = torch.cat([dense_n, emb.reshape(emb.shape[0], -1)], dim=-1)
    for i in range(len(w["mlp"])):
        h = F.relu(prec.low(prec.low(h) @ prec.low(P[f"mlp_{i}.weight"]).t()
                            + P[f"mlp_{i}.bias"]))
    deep = prec.low(prec.low(h) @ prec.low(P["mlp_out.weight"]).t()
                    + P["mlp_out.bias"])[:, 0]
    return wide + first[..., 0].sum(dim=1) + fm2 + deep


def block_rows(features: dict) -> int:
    return int(features["sparse"].shape[0])


def loss_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(
        logits.float(), labels.float(), reduction="sum")
