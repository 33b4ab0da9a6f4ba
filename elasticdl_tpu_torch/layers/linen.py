"""PyTorch counterparts of the flax.linen layers the zoo models use, with
flax's numerics and initialisers rather than PyTorch's defaults.

- `Dense`: an nn.Linear (weight (out, in), flax's kernel transposed)
  that casts input, weight and bias to `dtype` before the product, as
  flax's promote_dtype does; dtype None promotes input and weight.
  Initialised with flax's lecun_normal and zero bias.
- `LayerNorm`: eps 1e-6, statistics in f32 from E[x^2] - E[x]^2 clipped
  at 0, normalisation in f32, output cast to `dtype` (default: the
  promotion of the input with f32).
- `gelu`: the tanh approximation, flax's default.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a unit normal truncated to [-2, 2]: flax's variance_scaling
# divides by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """flax lecun_normal for a (out, in) weight: truncated normal on
    [-2, 2] standard deviations, variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        self.dtype = dtype
        super().__init__(in_features, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


class LayerNorm(nn.Module):
    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(
            (xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0
        )
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(out_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
