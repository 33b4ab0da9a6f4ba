"""How a reference computes: the plain float32 path, and the lower
precision that the correctness control puts in the program's place.

A configuration states two precisions: the one its products run in where
the program computes in bfloat16 (`low`) and where it computes in
float32 (`high`).  The plain reference computes everything in float32
and rounds nothing.  The control is the same reference with every
tensor that the program computes or holds in a stated type (the inputs
and outputs of products, the residual stream, the normalised
activations), and every gradient that flows back through one, rounded
to the next precision below: bfloat16 parts to float8 e4m3 (with a
per-tensor scale, as an fp8 recipe would use) and float32 parts to
bfloat16.  The arithmetic between the rounding points stays float32,
so the control differs from the reference by the rounding alone.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    q = (x.float() * scale).to(torch.float8_e4m3fn).float()
    return (q / scale).to(x.dtype)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


_ROUNDERS = {"fp8": _fp8, "bf16": _bf16}


class _Round(torch.autograd.Function):
    """Round the value forward and the incoming gradient backward."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _ROUNDERS[kind](x)

    @staticmethod
    def backward(ctx, g):
        return _ROUNDERS[ctx.kind](g), None


class Precision:
    """`low(x)` and `high(x)` round a product's input where the program
    computes in bfloat16 and in float32; identity for the reference."""

    def __init__(self, low=None, high=None):
        self._low = low
        self._high = high
        self.name = f"low={low or 'f32'},high={high or 'f32'}"

    def low(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._low is None else _Round.apply(x, self._low)

    def high(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._high is None else _Round.apply(x, self._high)


REFERENCE = Precision()
# the step below the stated precisions: bf16 -> fp8, f32 -> bf16
CONTROL = Precision(low="fp8", high="bf16")


def no_tf32():
    """float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
