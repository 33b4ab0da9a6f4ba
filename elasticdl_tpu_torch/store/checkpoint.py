"""The tiered store's checkpoint sidecar and the tiered <-> flat
migration (the port of the JAX package's store/checkpoint.py).

The TrainState (`<dir>/<step>/state.pt`) holds the device cache tables.
The rest the store needs to resume, the host planes, the lazy
vocabulary and the cache map, rides in a sidecar at
`<dir>/.tiered/<step>/`: `store.npz`, then `meta.json` last (its
presence marks a whole sidecar).  The sidecar also carries the cache
values at save time, so serving and migration rebuild every vocabulary
row's latest value from it alone.  Keys and meta are the JAX package's,
so each package reads the other's sidecar.

Saving splits in two: `capture_sidecar` takes owning host copies (under
the checkpoint saver's lock; the cache values come from the state's host
copy, so the device is read once) and
`write_sidecar` writes them (on the saver's writer thread).  Two things
differ from the JAX package's `save_sidecar`, which copies the host tier
and the cache map as they stand:
- the capture first joins the store's fold queue: a row evicted just
  before the save has its trained value on that queue and nowhere else,
  since its slot already holds another row;
- the cache map is the applied one (`TieredStore.checkpoint_state`):
  with eager planning the producer commits the maps of batches that have
  not stepped yet, whose admissions are not in the saved values.

Migration:
- tiered -> flat: `flat_tables_from_sidecar` fills (capacity, dim) flat
  tables by hashing every vocabulary id with the flat model's hash and
  writing its latest value; on a collision the earliest-assigned row
  wins, and unmapped rows keep the template's init.
- flat -> tiered: `fill_matching` copies every same-name, same-shape
  leaf (the dense layers) into a tiered template; the host tier then
  backfills grown rows from the flat tables (`flat_backfill`).

The sharded store (`sharding.py`) has a sidecar of its own at
`<dir>/.sharded/<step>/`: the shared host tier, every shard's cache
residency and the shard -> worker map, with the JAX package's keys and
meta.json written last.  `prune_sidecars` sweeps both roots.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.layers.arena import dequantize_rows_host

SIDECAR_ROOT = ".tiered"
NPZ_FILE = "store.npz"
META_FILE = "meta.json"


def sidecar_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), SIDECAR_ROOT,
                        str(int(step)))


def has_sidecar(checkpoint_dir: str, step: int) -> bool:
    return os.path.isfile(
        os.path.join(sidecar_dir(checkpoint_dir, step), META_FILE))


def sidecar_meta(store, step: int) -> dict:
    """The sidecar's meta.json (the manifest's `tiered` entry has the
    same fields but `step`)."""
    return {
        "step": int(step),
        "cache_rows": int(store.cache_rows),
        "num_fields": int(store.num_fields),
        "host_dtype": store.host.host_dtype,
        "planes": {name: int(dim) for name, dim in store.planes.items()},
        "vocab_rows": int(store.host.size),
        "cache_dtype": store.cache_dtype,
    }


def _cache_values(store, model_state, cache_dtype: str
                  ) -> Dict[str, np.ndarray]:
    """The sidecar's `values__*` arrays from host tensors of the model's
    state dict: each plane's fp32 table, or an int8 cache's raw `q8` and
    `scale` planes (an int8 -> int8 restore is then exact)."""
    arrays: Dict[str, np.ndarray] = {}
    for name, path in store.param_paths.items():
        if cache_dtype == "int8":
            if f"{path}.q8" not in model_state:
                raise ValueError(
                    f'cache_dtype="int8" but {path} has no quantized '
                    "planes; build the zoo model with cache_dtype='int8' "
                    "(TieredArena) so the planes exist")
            arrays[f"values__{name}__q8"] = model_state[f"{path}.q8"].numpy()
            arrays[f"values__{name}__scale"] = \
                model_state[f"{path}.scale"].float().numpy()
        else:
            arrays[f"values__{name}"] = \
                model_state[f"{path}.embedding"].float().numpy()
    return arrays


def capture_sidecar(store, model_state, step: int
                    ) -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays, meta): owning host copies of everything the sidecar
    holds (`TieredStore.checkpoint_state`: the fold queue joined, the
    applied cache map).  `model_state` is an owning host copy of the
    model's state dict taken at the same point (the checkpoint saver's
    own), so the cache values are not read off the device twice.  Call
    it where no step runs (under the owner's lock)."""
    host_state, row_of, score, cache_dtype = store.checkpoint_state()
    arrays: Dict[str, np.ndarray] = {
        f"host__{key}": value for key, value in host_state.items()}
    arrays["cache__row_of"] = row_of
    arrays["cache__score"] = score
    arrays.update(_cache_values(store, model_state, cache_dtype))
    meta = sidecar_meta(store, step)
    meta["vocab_rows"] = int(host_state["vocab_rows"].size)
    return arrays, meta


def _write_replace(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_sidecar(checkpoint_dir: str, step: int,
                  arrays: Dict[str, np.ndarray], meta: dict) -> str:
    """Write a captured sidecar: store.npz, then meta.json, each through
    a temporary name and `os.replace`, so a reader never sees a torn
    one."""
    d = sidecar_dir(checkpoint_dir, step)
    os.makedirs(d, exist_ok=True)
    _write_replace(os.path.join(d, NPZ_FILE),
                   lambda f: np.savez(f, **arrays))
    _write_replace(os.path.join(d, META_FILE),
                   lambda f: f.write(json.dumps(meta).encode()))
    return d


def save_sidecar(checkpoint_dir: str, step: int, store, state) -> str:
    """capture_sidecar and write_sidecar in one call, from a live
    state (its model state copied to the host here)."""
    model_state = {key: value.detach().to("cpu", copy=True)
                   for key, value in state.model.state_dict().items()}
    arrays, meta = capture_sidecar(store, model_state, step)
    return write_sidecar(checkpoint_dir, step, arrays, meta)


@dataclass
class TieredSidecar:
    meta: dict
    host_state: Dict[str, np.ndarray]
    row_of: np.ndarray                     # (cache_rows,) row per slot
    score: np.ndarray
    cache_values: Dict[str, np.ndarray]    # plane -> (cache_rows, dim)
    # int8 sidecars also carry the raw planes; cache_values is then
    # their dequantized view
    cache_planes: Dict[str, Dict[str, np.ndarray]] = field(
        default_factory=dict)

    @property
    def cache_dtype(self) -> str:
        """The dtype the cache values were saved in (sidecars from
        before int8 caches carry none and were fp32)."""
        return self.meta.get("cache_dtype", "float32")

    def host_plane(self, name: str) -> np.ndarray:
        """A (vocab_rows, dim) fp32 view of a host plane."""
        if self.meta["host_dtype"] == "fp32":
            return np.asarray(self.host_state[f"plane_{name}_fp32"],
                              np.float32)
        return dequantize_rows_host(
            self.host_state[f"plane_{name}_codes"],
            self.host_state[f"plane_{name}_scales"])

    def vocab_arrays(self):
        return (
            np.asarray(self.host_state["vocab_fields"], np.int64),
            np.asarray(self.host_state["vocab_ids"], np.int64),
            np.asarray(self.host_state["vocab_rows"], np.int64),
        )

    def latest_row_values(self, name: str) -> np.ndarray:
        """(vocab_rows, dim) fp32: the host value of every row, and the
        cache value of every resident one: each row's latest state at
        save time."""
        values = self.host_plane(name).copy()
        slots = np.nonzero(self.row_of >= 0)[0]
        rows = self.row_of[slots]
        in_range = rows < values.shape[0]
        values[rows[in_range]] = self.cache_values[name][slots[in_range]]
        return values


def load_sidecar(checkpoint_dir: str, step: int) -> TieredSidecar:
    d = sidecar_dir(checkpoint_dir, step)
    with open(os.path.join(d, META_FILE)) as f:
        meta = json.load(f)
    host_state: Dict[str, np.ndarray] = {}
    row_of = score = None
    cache_values: Dict[str, np.ndarray] = {}
    cache_planes: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(os.path.join(d, NPZ_FILE)) as npz:
        for key in npz.files:
            if key.startswith("host__"):
                host_state[key[len("host__"):]] = npz[key]
            elif key == "cache__row_of":
                row_of = npz[key]
            elif key == "cache__score":
                score = npz[key]
            elif key.startswith("values__"):
                name = key[len("values__"):]
                for plane_key in ("q8", "scale"):
                    suffix = f"__{plane_key}"
                    if name.endswith(suffix):
                        cache_planes.setdefault(
                            name[: -len(suffix)], {})[plane_key] = npz[key]
                        break
                else:
                    cache_values[name] = npz[key]
    for name, planes in cache_planes.items():
        cache_values[name] = dequantize_rows_host(planes["q8"],
                                                  planes["scale"])
    if row_of is None:
        raise ValueError(f"tiered sidecar {d} has no cache map")
    return TieredSidecar(meta, host_state, row_of, score, cache_values,
                         cache_planes)


SHARDED_ROOT = ".sharded"


def sharded_sidecar_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(
        os.path.abspath(checkpoint_dir), SHARDED_ROOT, str(int(step))
    )


def save_sharded_sidecar(checkpoint_dir: str, step: int, store) -> str:
    """The sidecar of a `ShardedTieredStore`: the shared host tier,
    every shard's cache residency and the shard -> worker map.
    meta.json lands last, so its presence marks a whole sidecar."""
    d = sharded_sidecar_dir(checkpoint_dir, step)
    os.makedirs(d, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for key, value in store.host.state_dict().items():
        arrays[f"host__{key}"] = value
    for key, value in store.cache_state().items():
        arrays[f"cache__{key}"] = value

    npz_path = os.path.join(d, NPZ_FILE)
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, npz_path)

    meta = {
        "step": int(step),
        "num_shards": int(store.num_shards),
        "per_shard_rows": int(store.per_shard_rows),
        "num_fields": int(store.num_fields),
        "host_dtype": store.host.host_dtype,
        "planes": {name: int(dim) for name, dim in store.planes.items()},
        "vocab_rows": int(store.host.size),
        "shard_owners": {
            str(s): int(w) for s, w in store.map.as_dict().items()
        },
    }
    meta_path = os.path.join(d, META_FILE)
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, meta_path)
    return d


def has_sharded_sidecar(checkpoint_dir: str, step: int) -> bool:
    return os.path.isfile(
        os.path.join(sharded_sidecar_dir(checkpoint_dir, step), META_FILE)
    )


@dataclass
class ShardedSidecar:
    """Loaded sharded sidecar.  `host_state` feeds
    `HostTier.load_state_dict`; `cache_arrays` feeds
    `ShardedTieredStore.load_cache_state`; `latest_row_values` is the
    interface `ShardedTieredStore.rebuild_shard` consumes."""

    meta: dict
    host_state: Dict[str, np.ndarray]
    cache_arrays: Dict[str, np.ndarray]

    def host_plane(self, name: str) -> np.ndarray:
        if self.meta["host_dtype"] == "fp32":
            return np.asarray(self.host_state[f"plane_{name}_fp32"],
                              np.float32)
        return dequantize_rows_host(
            self.host_state[f"plane_{name}_codes"],
            self.host_state[f"plane_{name}_scales"],
        )

    def latest_row_values(self, name: str) -> np.ndarray:
        """(vocab_rows, dim) fp32.  The sharded store's values live on
        the host (its caches hold bookkeeping only), so the host plane
        is the newest state at save time."""
        return self.host_plane(name).copy()


def load_sharded_sidecar(checkpoint_dir: str, step: int) -> ShardedSidecar:
    d = sharded_sidecar_dir(checkpoint_dir, step)
    with open(os.path.join(d, META_FILE)) as f:
        meta = json.load(f)
    host_state: Dict[str, np.ndarray] = {}
    cache_arrays: Dict[str, np.ndarray] = {}
    with np.load(os.path.join(d, NPZ_FILE)) as npz:
        for key in npz.files:
            if key.startswith("host__"):
                host_state[key[len("host__"):]] = npz[key]
            elif key.startswith("cache__"):
                cache_arrays[key[len("cache__"):]] = npz[key]
    return ShardedSidecar(meta, host_state, cache_arrays)


def prune_sidecars(checkpoint_dir: str, keep_steps: Iterable[int]) -> None:
    """Remove the sidecars of steps not in `keep_steps`, under both the
    tiered and the sharded root."""
    keep = {str(int(s)) for s in keep_steps}
    for root_name in (SIDECAR_ROOT, SHARDED_ROOT):
        root = os.path.join(os.path.abspath(checkpoint_dir), root_name)
        if not os.path.isdir(root):
            continue
        for name in os.listdir(root):
            if name.isdigit() and name not in keep:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)


# ---- migration: tiered -> flat ----------------------------------------


def flat_tables_from_sidecar(
    sidecar: TieredSidecar,
    templates: Dict[str, np.ndarray],
    hash_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
) -> Dict[str, np.ndarray]:
    """Flat-arena tables from a tiered sidecar.  `templates`: per plane,
    a fresh (capacity, dim) table whose unmapped rows stay as they are;
    `hash_fn(fields, ids) -> flat rows` is the flat model's hashing."""
    fields, ids, rows = sidecar.vocab_arrays()
    flat_rows = np.asarray(hash_fn(fields, ids), np.int64)
    # a descending-row scatter: the last write wins, so the earliest
    # vocabulary row claims a collided flat row
    order = np.argsort(-rows, kind="stable")
    out = {}
    for name, template in templates.items():
        table = np.array(template, np.float32, copy=True)
        values = sidecar.latest_row_values(name)[rows]
        table[flat_rows[order]] = values[order]
        out[name] = table
    return out


def flat_backfill(
    flat_tables: Dict[str, np.ndarray],
    hash_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
):
    """A HostTier backfill that pulls grown rows out of flat tables: the
    lazy half of the flat -> tiered migration."""

    def backfill(plane: str, fields: np.ndarray,
                 ids: np.ndarray) -> np.ndarray:
        table = flat_tables.get(plane)
        if table is None:
            return None
        flat_rows = np.asarray(
            hash_fn(np.asarray(fields, np.int64),
                    np.asarray(ids, np.int64)), np.int64)
        return np.asarray(table, np.float32)[flat_rows]

    return backfill


# ---- migration: name-matched fill -------------------------------------


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, tree


def fill_matching(template, raw):
    """A copy of `template` where every leaf of `raw` with the same path
    and shape replaces the template's (dict keys and sequence indices
    compare as strings).  Other leaves keep the template's value, which
    lets a flat table (capacity, dim) and a tiered cache table
    (cache_rows, dim) share a name across a migration.  Works on nested
    dicts of numpy arrays (the JAX package's trees) and on state dicts
    of tensors; a filled leaf takes the template leaf's type, dtype and
    device."""
    raw_map = {path: leaf for path, leaf in _walk(raw)}

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, prefix + (str(k),))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        leaf = raw_map.get(prefix)
        if (leaf is None or not hasattr(leaf, "shape")
                or not hasattr(node, "shape")
                or tuple(leaf.shape) != tuple(node.shape)):
            return node
        if isinstance(node, torch.Tensor):
            value = leaf if isinstance(leaf, torch.Tensor) \
                else torch.from_numpy(np.array(leaf))
            return value.detach().to(device=node.device, dtype=node.dtype,
                                     copy=True)
        out = leaf.detach().cpu().numpy() \
            if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if hasattr(node, "dtype") and out.dtype != node.dtype:
            out = out.astype(node.dtype)
        return out

    return rebuild(template, ())
