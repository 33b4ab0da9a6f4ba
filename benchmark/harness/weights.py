"""Model weights from the seed, made on the device in one draw.

One float32 normal draw covers every parameter of a reference's
`param_spec`; each parameter is a view of its slice, scaled in place by
its init: `normal` (std = scale), `fan_in` (std = scale / sqrt(in) of an
(out, in) weight) or `one_plus` (1 + scale * N(0, 1)).  The program and
the reference are given the same tensors; neither draws its own."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness.inputs import generator


def make_weights(param_spec, seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _, _ in param_spec)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, offset = {}, 0
    with torch.no_grad():
        for name, shape, init, scale in param_spec:
            n = math.prod(shape)
            leaf = flat[offset:offset + n].view(shape)
            offset += n
            if init == "normal":
                leaf.mul_(scale)
            elif init == "fan_in":
                leaf.mul_(scale / math.sqrt(shape[1]))
            elif init == "one_plus":
                leaf.mul_(scale).add_(1.0)
            else:
                raise ValueError(f"unknown init {init!r} for {name}")
            out[name] = leaf
    return out
