"""BERT-base classification's count of model operations, and the kernel
calls of its training step and of a served forward, from a
configuration's widths and the batch's shapes.  Model operations are
the products the forward and backward need (twice the multiply-adds of
every product, the backward twice the forward), with no recompute."""

import torch

from benchmark.reference import bert as model


def forward_flops_per_row(cfg: dict, seq_len: int) -> float:
    w = model.widths(cfg)
    h, f = w["hidden"], w["ffn"]
    per_token_layer = 2.0 * h * (3 * h + h + 2 * f) + 4.0 * seq_len * h
    return seq_len * w["layers"] * per_token_layer + 2.0 * h * w["classes"]


def train_flops_per_example(cfg: dict, features: dict) -> float:
    return 3.0 * forward_flops_per_row(cfg, features["input_ids"].shape[1])


def serve_flops_per_row(cfg: dict, features: dict) -> float:
    return forward_flops_per_row(cfg, features["input_ids"].shape[1])


def _attention(cfg, batch: int, seq_len: int) -> dict:
    w = model.widths(cfg)
    return dict(batch=batch, q_len=seq_len, k_len=seq_len, heads=w["heads"],
                dim=w["hidden"] // w["heads"],
                elem_bytes=2 if cfg["compute_dtype"] == "bf16" else 4)


def train_kernel_calls(cfg: dict, features: dict) -> dict:
    """{kernel: [call kwargs, ...]} of one training step on `features`
    (tensors): the flash forward and backward in every layer, and the
    token table's scatter-add over the rows the batch touches."""
    ids = features["input_ids"]
    batch, seq_len = ids.shape
    w = model.widths(cfg)
    att = _attention(cfg, batch, seq_len)
    touched = int(torch.unique(ids.long() % w["vocab"]).numel())
    return {"flash_fwd": [att] * w["layers"],
            "flash_bwd": [att] * w["layers"],
            "scatter_add": [dict(n=batch * seq_len, dim=w["hidden"],
                                 touched=touched)]}


def serve_kernel_calls(cfg: dict, rows: int, seq_len: int) -> dict:
    """{kernel: [call kwargs, ...]} of one served forward at `rows`
    (the bucket) rows."""
    w = model.widths(cfg)
    return {"flash_fwd": [_attention(cfg, rows, seq_len)] * w["layers"]}


def param_count(cfg: dict) -> int:
    return sum(int(torch.Size(shape).numel())
               for _, shape, _, _ in model.param_spec(cfg))
