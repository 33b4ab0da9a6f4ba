"""DeepFM's count of model operations, and the kernel calls of its
training step, from a configuration's widths and the batch."""

import torch

from benchmark.reference import deepfm as model


def forward_flops_per_row(cfg: dict) -> float:
    w = model.widths(cfg)
    fields, dim = w["fields"], w["dim"]
    width = w["dense"] + fields * dim
    mlp = 0.0
    for out in w["mlp"] + [1]:
        mlp += 2.0 * width * out
        width = out
    fm = 3.0 * fields * dim + 3.0 * dim
    return mlp + fm + 2.0 * w["dense"] + fields


def train_flops_per_example(cfg: dict, features: dict) -> float:
    return 3.0 * forward_flops_per_row(cfg)


def train_kernel_calls(cfg: dict, features: dict) -> dict:
    """Both tables' scatter-adds over the rows the batch touches."""
    w = model.widths(cfg)
    rows, _ = model.table_rows(features["sparse"], w["rows"])
    touched = int(torch.unique(rows).numel())
    n = int(rows.numel())
    return {"scatter_add": [dict(n=n, dim=w["dim"], touched=touched),
                            dict(n=n, dim=1, touched=touched)]}


def param_count(cfg: dict) -> int:
    return sum(int(torch.Size(shape).numel())
               for _, shape, _, _ in model.param_spec(cfg))
