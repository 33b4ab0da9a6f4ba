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

Stacked leaves: a GPipe stack's kernels (`.../gpipe_stack/.../kernel`,
(L, in, out) from flax's vmapped init) go to (L, out, in), the layer
axis kept; the MoE expert stacks (`expert_w_in` (E, H, F), ...) keep
their names and layouts.

Sharding (`shard_tensor`, `shard_tree`): a spec is a tuple of mesh axis
names or None, one per leading dim, as the JAX `PartitionSpec`s the zoo's
`param_sharding` returns; dim i of a leaf split `shape[axis]` ways gives
the rank at `coords[axis]` its slice.  `gather_tensor` is the inverse
over a live mesh (parallel/collectives.py `all_gather`).
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
    """{'a': {'b': x}} -> {'a/b': np.asarray(x)} (a tensor leaf, an orbax
    bfloat16 one, stays a tensor)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = value if isinstance(value, torch.Tensor) \
                else np.asarray(value)
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


def _kernel_to_torch(value, stacked: bool = False):
    """A flax kernel (a numpy array or a tensor) in torch's layout: (in,
    out) -> (out, in); HWIO -> OIHW; a stacked (L, in, out) -> (L, out,
    in)."""
    if stacked:
        return value.swapaxes(-1, -2)
    if value.ndim == 4:
        return value.permute(3, 2, 0, 1) if isinstance(
            value, torch.Tensor) else value.transpose(3, 2, 0, 1)
    return value.T


def _flax_leaves(flat: Mapping[str, object],
                 quantized: Optional[Mapping[str, object]],
                 batch_stats: Optional[Mapping[str, object]]):
    """(collection, flax path, state-dict name, value in torch's layout)
    of every leaf of a flattened flax tree and its `quantized` and
    `batch_stats` collections: the naming rules, in one place."""
    for path, value in (quantized or {}).items():
        yield "quantized", path, _plane_name(path), value
    for path, value in (batch_stats or {}).items():
        yield "batch_stats", path, _stat_name(path), value
    for path, value in flat.items():
        if path.rsplit("/", 1)[-1] == "kernel":
            if not isinstance(value, torch.Tensor):
                value = np.asarray(value)
            value = _kernel_to_torch(
                value, stacked="gpipe_stack" in path.split("/"))
        yield "params", path, torch_name(path), value


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
    targets = {"params": params, "quantized": buffers, "batch_stats": stats}
    for kind, path, name, value in _flax_leaves(flat, quantized,
                                                batch_stats):
        target = targets[kind].get(name)
        if target is None:
            unused.append(path)
            continue
        out[name] = _leaf_tensor(path, name, value, target)
    missing = sorted((set(params) | set(buffers) | set(stats)) - set(out))
    if unused or missing:
        raise ValueError(
            f"flax tree does not match the port module: unused leaves "
            f"{sorted(unused)}, parameters without a leaf {missing}"
        )
    return out


def _as_tensor(value) -> torch.Tensor:
    """An owning, contiguous CPU tensor of a numpy array or a tensor (an
    orbax bfloat16 leaf arrives as a torch.bfloat16 tensor)."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone(memory_format=torch.contiguous_format)
    return torch.from_numpy(np.array(value, copy=True))


def state_dict_from_flax(flat: Mapping[str, object],
                         quantized: Optional[Mapping[str, object]] = None,
                         batch_stats: Optional[Mapping[str, object]] = None
                         ) -> Dict[str, torch.Tensor]:
    """{state-dict name: CPU tensor} of a flattened flax tree by the
    naming rules alone, with no module: what `params_from_jax` gives,
    before the shapes are checked against a module and the tensors cast
    to its dtypes.  A checkpoint's tree keeps its own layout this way
    (its arena dtype may differ from the model's, common/save_utils.py
    `_arena_compat`); `load_state_dict(strict=True)` then checks every
    name and shape."""
    return {name: _as_tensor(value) for _, _, name, value in
            _flax_leaves(flat, quantized, batch_stats)}


def _leaf_tensor(path: str, name: str, value,
                 target: torch.Tensor) -> torch.Tensor:
    value = _as_tensor(value)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(
            f"flax leaf {path} has shape {tuple(value.shape)}; port tensor "
            f"{name} has {tuple(target.shape)}"
        )
    return value.to(device=target.device, dtype=target.dtype)


def shard_tensor(value, spec, mesh):
    """This rank's slice of `value` (a tensor or array) under `spec`."""
    for dim, axis in enumerate(spec or ()):
        if axis is None or mesh.shape[axis] == 1:
            continue
        parts, index = mesh.shape[axis], mesh.coords[axis]
        size = value.shape[dim]
        if size % parts:
            raise ValueError(
                f"dim {dim} of size {size} does not split over "
                f"'{axis}' of size {parts}")
        width = size // parts
        value = value[(slice(None),) * dim
                      + (slice(index * width, (index + 1) * width),)]
    return value


def shard_tree(tree: Mapping[str, object], shardings: Mapping[str, tuple],
               mesh) -> Dict[str, object]:
    """{name: this rank's slice} of a full {name: tensor or array} tree
    under {name: spec} (names without a spec are whole)."""
    return {name: shard_tensor(value, shardings.get(name), mesh)
            for name, value in tree.items()}


def gather_tensor(value: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's `shard_tensor` slice: a
    gather over each sharded axis (a collective: every rank calls it)."""
    from elasticdl_tpu_torch.parallel.collectives import all_gather

    for dim in reversed(range(len(spec or ()))):
        axis = spec[dim]
        if axis is None or mesh.shape[axis] == 1:
            continue
        value = all_gather(value.contiguous(), mesh, axis, dim=dim)
    return value
