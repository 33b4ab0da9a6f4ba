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

An int8 arena's planes live in flax's `quantized` collection
(`fm_embedding/embedding/q8`, `.../scale`); passed as `quantized`, they
land on the arena's `q8` and `scale` buffers (`fm_embedding.q8`, ...).
The tiered DeepFM's `TieredArena` caches keep the flat arena's names, so
their tables, int8 planes and zero carriers map by the same rules.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.layers.arena import (
    PLANE_KEYS,
    plane_key,
    plane_prefixes,
)


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


def _plane_name(flax_path: str) -> str:
    """`a/b/embedding/q8` (a plane of the quantized collection) ->
    `a.b.q8` (the arena's buffer)."""
    *scope, table, leaf = flax_path.split("/")
    if table != "embedding" or leaf not in ("q8", "scale"):
        raise ValueError(f"{flax_path} is not an int8 arena plane "
                         "(<module>/embedding/q8 or .../scale)")
    return ".".join([*scope, leaf])


def _quantized_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The int8 arenas' `q8` and `scale` buffers, by state-dict name."""
    named = dict(module.named_buffers())
    return {plane_key(prefix, leaf): named[plane_key(prefix, leaf)]
            for prefix in plane_prefixes(named) for leaf in PLANE_KEYS}


def params_from_jax(module: nn.Module, flat: Mapping[str, np.ndarray],
                    quantized: Optional[Mapping[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} for `module` from a flattened flax tree,
    each tensor on its parameter's device and in its dtype, plus the int8
    arenas' `q8`/`scale` buffers from the flattened `quantized`
    collection.  Load it with `module.load_state_dict(..., strict=True)`
    or serve it as variables."""
    params = dict(module.named_parameters())
    buffers = _quantized_buffers(module)
    if buffers and quantized is None:
        raise ValueError(
            f"the module has int8 arena planes {sorted(buffers)}: pass the "
            "flax 'quantized' collection as `quantized`")
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in (quantized or {}).items():
        name = _plane_name(path)
        target = buffers.get(name)
        if target is None:
            unused.append(path)
            continue
        out[name] = _leaf_tensor(path, name, np.asarray(value), target)
    for path, value in flat.items():
        name = torch_name(path)
        target = params.get(name)
        if target is None:
            unused.append(path)
            continue
        value = np.asarray(value)
        if path.rsplit("/", 1)[-1] == "kernel":
            value = value.T
        out[name] = _leaf_tensor(path, name, value, target)
    missing = sorted((set(params) | set(buffers)) - set(out))
    if unused or missing:
        raise ValueError(
            f"flax tree does not match the port module: unused leaves "
            f"{sorted(unused)}, parameters without a leaf {missing}"
        )
    return out


def _leaf_tensor(path: str, name: str, value: np.ndarray,
                 target: torch.Tensor) -> torch.Tensor:
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(
            f"flax leaf {path} has shape {value.shape}; port tensor "
            f"{name} has {tuple(target.shape)}"
        )
    return torch.from_numpy(np.array(value, copy=True)).to(
        device=target.device, dtype=target.dtype
    )
