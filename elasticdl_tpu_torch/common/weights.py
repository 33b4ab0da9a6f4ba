"""Carry a flax parameter tree into a port module.

The port names its submodules after the flax paths (`layer_0.attention.
qkv`, `LayerNorm_0`, ...), so one rule maps every leaf:

- `kernel` (in, out) -> `weight`, transposed to torch's (out, in);
- a 4-D conv `kernel` (kh, kw, in, out), flax's HWIO -> `weight` as
  torch's (out, in, kh, kw), axis by axis: `.T` would give (out, in, kw,
  kh), spatially transposed, and a 3x3 kernel would pass the shape check
  with its taps in the wrong places;
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

BatchNorm statistics live in flax's `batch_stats` collection
(`BatchNorm_0/mean`, `.../var`); passed as `batch_stats`, they land on
the port BatchNorm's `running_mean` and `running_var` buffers.
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


_STAT_BUFFERS = {"mean": "running_mean", "var": "running_var"}


def _stat_name(flax_path: str) -> str:
    """`a/BatchNorm_0/mean` -> `a.BatchNorm_0.running_mean`."""
    *scope, leaf = flax_path.split("/")
    if leaf not in _STAT_BUFFERS:
        raise ValueError(f"{flax_path} is not a batch statistic "
                         "(<module>/mean or .../var)")
    return ".".join([*scope, _STAT_BUFFERS[leaf]])


def _stat_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics, by state-dict name."""
    return {name: buf for name, buf in module.named_buffers()
            if name.rsplit(".", 1)[-1] in _STAT_BUFFERS.values()}


def _kernel_to_torch(value: np.ndarray) -> np.ndarray:
    """A flax kernel in torch's layout: (in, out) -> (out, in); HWIO ->
    OIHW."""
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value.T


def _quantized_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The int8 arenas' `q8` and `scale` buffers, by state-dict name."""
    named = dict(module.named_buffers())
    return {plane_key(prefix, leaf): named[plane_key(prefix, leaf)]
            for prefix in plane_prefixes(named) for leaf in PLANE_KEYS}


def params_from_jax(module: nn.Module, flat: Mapping[str, np.ndarray],
                    quantized: Optional[Mapping[str, np.ndarray]] = None,
                    batch_stats: Optional[Mapping[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} for `module` from a flattened flax tree,
    each tensor on its parameter's device and in its dtype, plus the int8
    arenas' `q8`/`scale` buffers from the flattened `quantized`
    collection and the BatchNorm statistics from the flattened
    `batch_stats` collection.  Load it with `module.load_state_dict(...,
    strict=True)` or serve it as variables."""
    params = dict(module.named_parameters())
    buffers = _quantized_buffers(module)
    stats = _stat_buffers(module)
    if buffers and quantized is None:
        raise ValueError(
            f"the module has int8 arena planes {sorted(buffers)}: pass the "
            "flax 'quantized' collection as `quantized`")
    if stats and batch_stats is None:
        raise ValueError(
            f"the module has BatchNorm statistics {sorted(stats)}: pass "
            "the flax 'batch_stats' collection as `batch_stats`")
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for paths, to_name, targets in (
            (quantized or {}, _plane_name, buffers),
            (batch_stats or {}, _stat_name, stats)):
        for path, value in paths.items():
            name = to_name(path)
            target = targets.get(name)
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
            value = _kernel_to_torch(value)
        out[name] = _leaf_tensor(path, name, value, target)
    missing = sorted((set(params) | set(buffers) | set(stats)) - set(out))
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
