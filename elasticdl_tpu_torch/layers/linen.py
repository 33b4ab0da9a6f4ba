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
- `Conv`: a 2-D convolution on NCHW tensors with an (out, in, kh, kw)
  weight (flax's HWIO kernel carried by `common/weights.py`), the input
  promoted with the weight's dtype as flax promotes it, flax's
  lecun_normal init over fan_in = in * kh * kw, zero bias, and flax's
  padding: "SAME" pads each spatial side as `lax.padtype_to_pads` does,
  which is asymmetric for a strided 3x3 (32 -> 16 pads (0, 1), where
  `Conv2d(padding=1)` pads (1, 1) and gives other numbers at the same
  shape); "VALID" pads nothing.
- `BatchNorm`: flax's BatchNorm over the channel axis of NCHW.  With
  `train=True` it normalises by the batch statistics, computed in f32
  as E[x] and E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), and
  updates the running statistics with the biased variance: running =
  momentum * running + (1 - momentum) * batch (flax's momentum 0.9 is
  torch's 0.1); with `train=False` it reads the running statistics.
  The statistics live in the buffers `running_mean` / `running_var`
  (flax's `batch_stats` collection).
- `max_pool`: flax's max_pool with "VALID" padding.
- `init_parameters`: every submodule's `reset_parameters(generator)`,
  then the model's own `reset_own_parameters(generator)` if it has one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis for flax's "SAME", as
    `lax.padtype_to_pads` computes it: the output has ceil(size / stride)
    positions and the extra pad goes on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: str = "SAME", use_bias: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got "
                             f"{padding!r}")
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features) + self.kernel_size))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax lecun_normal over fan_in = in * kh * kw; zero bias."""
        fan_in = self.weight.shape[1] * math.prod(self.kernel_size)
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's promote_dtype: bf16 input and f32 kernel run in f32
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if self.padding == "SAME":
            (h_lo, h_hi), (w_lo, w_hi) = (
                _same_pads(size, k, s) for size, k, s in
                zip(x.shape[2:], self.kernel_size, self.strides))
            if h_lo or h_hi or w_lo or w_hi:
                x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(x, self.weight, self.bias, stride=self.strides)


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, scale_init_zero: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale_init_zero = scale_init_zero
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: scale ones (zeros with `scale_init_zero`), bias
        zeros, running mean 0 and variance 1."""
        with torch.no_grad():
            self.weight.fill_(0.0 if self.scale_init_zero else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = (0, 2, 3)
            mean = xf.mean(dim=axes)
            var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean,
                                  0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


def max_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int]) -> torch.Tensor:
    """flax max_pool with "VALID" padding on NCHW."""
    return F.max_pool2d(x, tuple(window), tuple(strides))


def init_parameters(model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Draw every submodule's parameters from its flax initialiser
    distribution (`reset_parameters(generator)`), in module order, then
    the model's own (`reset_own_parameters(generator)`).  Pass a
    generator on the parameters' device for a seeded draw."""
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    # the model's own parameters (those of no submodule) are drawn last
    reset_own = getattr(model, "reset_own_parameters", None)
    if reset_own is not None:
        reset_own(generator)
