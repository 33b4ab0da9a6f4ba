"""Read a checkpoint step that the JAX package's orbax `CheckpointSaver`
wrote, with no orbax, tensorstore or zstd package.

A step directory `<checkpoint_dir>/<step>/` is orbax's when it holds
`_CHECKPOINT_METADATA` (the file orbax writes as it finalizes a step).
Its item lives in `default/`:

- `_METADATA` (JSON): under `tree_metadata`, one entry per leaf, keyed
  by the leaf's path, with each key's kind (1 a sequence index, 2 a
  dict key) and the leaf's value type: `jax.Array`, `np.ndarray` and
  `scalar` are stored arrays, `None`, `Dict` and `List` are an empty
  leaf, dict or list that stores nothing;
- an OCDBT database (common/ocdbt.py) whose keys are `<leaf path joined
  by '.'>/...`, one zarr array per stored leaf (common/zarr_array.py).

`read_tree(step_dir)` returns the stored tree as nested dicts and lists
with numpy leaves (Python scalars for `scalar` leaves, `torch.bfloat16`
tensors for bfloat16 ones): the tree the JAX `CheckpointSaver.
restore_raw` returns, leaf for leaf, bit for bit.  `swap_tree_keys` is
the JAX restore's legacy-key shim (a checkpoint whose GPipe stack is
still named `stack` restores as `gpipe_stack`; common/orbax_state.py
applies it).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from elasticdl_tpu_torch.common.ocdbt import OcdbtStore
from elasticdl_tpu_torch.common.zarr_array import read_array

MARKER = "_CHECKPOINT_METADATA"
ITEM = "default"
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}
_STORED = ("jax.Array", "np.ndarray", "scalar")


class OrbaxFormatError(ValueError):
    """An orbax step this reader cannot read."""


def is_orbax_step(step_dir: str) -> bool:
    return os.path.isfile(os.path.join(step_dir, MARKER))


def read_metadata(step_dir: str) -> Dict[str, Any]:
    """The step's `default/_METADATA`."""
    path = os.path.join(step_dir, ITEM, "_METADATA")
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as exc:
        raise OrbaxFormatError(f"cannot read {path}: {exc}") from exc
    if not meta.get("use_ocdbt", True):
        raise OrbaxFormatError(f"{path}: the step was saved without OCDBT")
    return meta


def _leaves(meta) -> List[Tuple[List[Tuple[str, int]], dict]]:
    out = []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
        out.append((keys, entry["value_metadata"]))
    return out


def _insert(root: dict, keys, value) -> None:
    """Put `value` at the path `keys` of `root`, making dicts for dict
    keys and {index: child} placeholders for sequence indices."""
    node = root
    for (key, kind), (next_key, next_kind) in zip(keys, keys[1:]):
        child = node.get(key)
        if child is None:
            child = node[key] = {} if next_kind == 2 else _Seq()
        node = child
    node[keys[-1][0]] = value


class _Seq(dict):
    """A sequence under construction: index (str) -> child."""


def _finish(node):
    if isinstance(node, _Seq):
        n = max(int(k) for k in node) + 1 if node else 0
        if sorted(int(k) for k in node) != list(range(n)):
            raise OrbaxFormatError("a sequence of the tree misses an index")
        return [_finish(node[str(i)]) for i in range(n)]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


def read_tree(step_dir: str) -> Any:
    """The stored tree of the orbax step at `step_dir`."""
    meta = read_metadata(step_dir)
    store = OcdbtStore(os.path.join(step_dir, ITEM))
    root: dict = {}
    for keys, value in _leaves(meta):
        kind = value.get("value_type")
        if kind in _EMPTY:
            leaf = _EMPTY[kind]()
        elif kind in _STORED:
            leaf = read_array(store, ".".join(k for k, _ in keys))
            if kind == "scalar":
                leaf = leaf.item()
        else:
            raise OrbaxFormatError(f"leaf {[k for k, _ in keys]} has value "
                                   f"type {kind!r}, which is not read")
        if not keys:
            return leaf
        _insert(root, keys, leaf)
    return _finish(root)


def tree_has_key(node, key: str) -> bool:
    if isinstance(node, dict):
        return key in node or any(tree_has_key(v, key)
                                  for v in node.values())
    if isinstance(node, list):
        return any(tree_has_key(v, key) for v in node)
    return False


def swap_tree_keys(node, old: str, new: str):
    """Every dict key `old` renamed `new` (a subtree holding both
    raises), as the JAX save_utils' `_swap_tree_keys`."""
    if isinstance(node, dict):
        if old in node and new in node:
            raise ValueError(f"cannot rename {old!r} -> {new!r}: both keys "
                             "present")
        return {(new if k == old else k): swap_tree_keys(v, old, new)
                for k, v in node.items()}
    if isinstance(node, list):
        return [swap_tree_keys(v, old, new) for v in node]
    return node


def as_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array (bfloat16 as its uint16 bits)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)
