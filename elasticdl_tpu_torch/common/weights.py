"""Carry a flax parameter tree into a port module.

The port names its submodules after the flax paths (`layer_0.attention.
qkv`, `LayerNorm_0`, ...), so one rule maps every leaf:

- `kernel` (in, out) -> `weight`, transposed to torch's (out, in);
- `scale`            -> `weight`;
- every other leaf keeps its name (`bias`, `embedding`, ...).

The tree arrives as numpy, flattened to '/'-joined paths such as
`layer_0/attention/qkv/kernel` (`flatten_params` does that for a nested
dict).  Every leaf must land on a parameter and every parameter must get
a leaf, with matching shapes; anything else raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a/b': np.asarray(x)}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def torch_name(flax_path: str) -> str:
    *scope, leaf = flax_path.split("/")
    if leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join([*scope, leaf])


def params_from_jax(module: nn.Module,
                    flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} for `module` from a flattened flax tree,
    each tensor on its parameter's device and in its dtype.  Load it with
    `module.load_state_dict(..., strict=True)` or serve it as variables."""
    params = dict(module.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in flat.items():
        name = torch_name(path)
        target = params.get(name)
        if target is None:
            unused.append(path)
            continue
        value = np.asarray(value)
        if path.rsplit("/", 1)[-1] == "kernel":
            value = value.T
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"flax leaf {path} has shape {value.shape}; port parameter "
                f"{name} has {tuple(target.shape)}"
            )
        out[name] = torch.from_numpy(np.array(value, copy=True)).to(
            device=target.device, dtype=target.dtype
        )
    missing = sorted(set(params) - set(out))
    if unused or missing:
        raise ValueError(
            f"flax tree does not match the port module: unused leaves "
            f"{sorted(unused)}, parameters without a leaf {missing}"
        )
    return out
