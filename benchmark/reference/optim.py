"""Adam and AdamW written out in plain float32 tensor operations.

The update is Kingma and Ba's, with AdamW's decoupled weight decay
(Loshchilov and Hutter) applied to the parameter before the moment
step, and the bias corrections computed as Python floats:

    p <- p * (1 - lr * wd)                       (AdamW only)
    m <- b1 m + (1 - b1) g
    v <- b2 v + (1 - b2) g^2
    p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = params
        self.lr = float(lr)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.wd = float(weight_decay)
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for name, p in self.params.items():
            g = grads[name]
            if self.wd:
                p.mul_(1.0 - self.lr * self.wd)
            m, v = self.m[name], self.v[name]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt().div_(c2).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def from_config(params: Dict[str, torch.Tensor], spec: dict) -> Adam:
    """The optimizer a configuration states: {"kind": "adam"|"adamw",
    "lr", "betas", "eps", "weight_decay"}."""
    kind = spec["kind"]
    if kind not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {kind!r}")
    return Adam(params, lr=spec["lr"], betas=tuple(spec["betas"]),
                eps=spec["eps"],
                weight_decay=spec.get("weight_decay", 0.0)
                if kind == "adamw" else 0.0)
