"""The port's reader of the JAX package's orbax checkpoints, part by part,
on the CPU at small sizes:

- common/ocdbt.py lists and reads every key as tensorstore's OCDBT
  driver does, on orbax's own databases and on databases tensorstore
  writes with small nodes (interior B+tree nodes), inline and indirect
  values, many versions (version-tree nodes) and uncompressed nodes; a
  corrupt node raises;
- common/zarr_array.py reads zarr v2 and v3 arrays as tensorstore does:
  edge chunks, missing chunks at the fill value, Fortran order, the
  transpose codec, big-endian bytes, bfloat16;
- common/orbax_read.py returns the tree that the JAX
  `CheckpointSaver.restore_raw` returns, leaf for leaf and bit for bit,
  for each kind of checkpoint in tests/_torch_orbax.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from _torch_orbax import (
    assert_trees_bitwise_equal,
    step_dir,
    write_jax_checkpoint,
)
from elasticdl_tpu.common.save_utils import CheckpointSaver as JaxSaver
from elasticdl_tpu_torch.common import ocdbt, orbax_read, zarr_array

KINDS = ("deepfm_f32", "deepfm_int8", "deepfm_tiered", "resnet",
         "bert_bf16", "legacy_stack")


def _ts_store(path: str):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": "file://" + path}).result()


def _assert_store_equal(path: str) -> int:
    want = _ts_store(path)
    keys = want.list().result()
    got = ocdbt.OcdbtStore(path)
    assert got.list() == sorted(keys)
    for key in keys:
        assert got.read(key) == want.read(key).result().value, key
    assert got.read(b"no such key") is None
    return len(keys)


def _write_db(path: str, config: dict, commits: int, per_commit: int):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path,
                          "config": config}).result()
    rng = np.random.RandomState(len(path))
    for c in range(commits):
        txn = ts.Transaction()
        for j in range(per_commit):
            key = f"param.{c:02d}/{j}.{rng.randint(100)}".encode()
            kv.with_transaction(txn).write(
                key, rng.bytes(int(rng.choice([0, 3, 40, 3000])))).result()
        txn.commit_async().result()


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 160, "max_inline_value_bytes": 16,
     "version_tree_arity_log2": 1},
    {"max_inline_value_bytes": 1024},
    {"max_decoded_node_bytes": 400, "compression": None},
], ids=["small_nodes", "orbax_like", "uncompressed"])
def test_ocdbt_lists_and_reads_as_tensorstore(tmp_path, config):
    path = str(tmp_path / "db")
    _write_db(path, config, commits=6, per_commit=9)
    assert _assert_store_equal(path) == 54
    store = ocdbt.OcdbtStore(path)
    assert store.manifest.latest["num_keys"] == 54
    if config.get("version_tree_arity_log2") == 1:
        # older generations live in version-tree nodes
        assert store.manifest.version_tree_nodes
    assert store.list(b"param.03/") == [
        k for k in store.list() if k.startswith(b"param.03/")]


def test_a_corrupt_ocdbt_node_or_manifest_raises(tmp_path):
    path = str(tmp_path / "db")
    _write_db(path, {"max_decoded_node_bytes": 160}, commits=2,
              per_commit=6)
    manifest = os.path.join(path, "manifest.ocdbt")
    good = open(manifest, "rb").read()
    for flip in (0, 9, len(good) // 2, len(good) - 1):
        bad = bytearray(good)
        bad[flip] ^= 0x10
        with open(manifest, "wb") as f:
            f.write(bytes(bad))
        with pytest.raises(ocdbt.OcdbtError):
            ocdbt.OcdbtStore(path)
    with open(manifest, "wb") as f:
        f.write(good)
    root = ocdbt.OcdbtStore(path).manifest.latest["root"]
    data_file = os.path.join(path, root[0])
    blob = bytearray(open(data_file, "rb").read())
    blob[root[1] + root[2] // 2] ^= 0x01
    with open(data_file, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ocdbt.OcdbtError, match="CRC32C"):
        ocdbt.OcdbtStore(path)
    os.remove(data_file)
    with pytest.raises(ocdbt.OcdbtError, match="cannot read"):
        ocdbt.OcdbtStore(path)


class _Kv:
    """A key-value store over tensorstore's OCDBT kvstore (the reader's
    `read` contract)."""

    def __init__(self, path):
        self._kv = _ts_store(path)

    def read(self, key):
        got = self._kv.read(key).result()
        return got.value if got.state == "value" else None


def _ts_array(path, name, spec):
    return ts.open({**spec, "kvstore": {
        "driver": "ocdbt", "base": "file://" + path, "path": name + "/"}},
        create=True, open=True).result()


@pytest.mark.parametrize("case", [
    ("zarr", "<f4", [10, 7], [4, 3], {"order": "C"}),
    ("zarr", "<i8", [9, 4], [4, 3], {"order": "F", "fill_value": 5}),
    ("zarr", "|i1", [6, 5], [6, 5], {}),
    ("zarr", "bfloat16", [5, 3], [2, 2], {}),
    ("zarr3", "float32", [10, 7], [4, 3],
     {"codecs": [{"name": "transpose", "configuration": {"order": [1, 0]}},
                 {"name": "bytes", "configuration": {"endian": "big"}},
                 {"name": "zstd", "configuration": {"level": 3}}]}),
    ("zarr3", "int32", [], [], {"fill_value": 7}),
    ("zarr3", "bfloat16", [4, 6], [3, 4], {}),
], ids=["v2_f32_edges", "v2_i8_fortran_fill", "v2_int8", "v2_bf16",
        "v3_transpose_big_endian", "v3_scalar_fill", "v3_bf16"])
def test_zarr_arrays_read_as_tensorstore_reads_them(tmp_path, case):
    driver, dtype, shape, chunks, extra = case
    path = str(tmp_path / "db")
    if driver == "zarr":
        metadata = {"dtype": dtype, "shape": shape, "chunks": chunks,
                    "compressor": {"id": "zstd", "level": 1},
                    **{k: v for k, v in extra.items() if k == "order"}}
        if "fill_value" in extra:
            metadata["fill_value"] = extra["fill_value"]
    else:
        metadata = {"data_type": dtype, "shape": shape,
                    "chunk_grid": {"name": "regular", "configuration": {
                        "chunk_shape": chunks}},
                    **extra}
    arr = _ts_array(path, "leaf", {"driver": driver, "metadata": metadata})
    rng = np.random.RandomState(0)
    values = rng.randn(*shape) * 100
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else \
        np.dtype(dtype.lstrip("<|")) if driver == "zarr" else \
        np.dtype(dtype)
    values = np.asarray(values).astype(np_dtype)
    if shape and shape[0] > 4:
        # the first chunk row stays unwritten: it reads as the fill value
        arr[4:].write(values[4:]).result()
    else:
        arr.write(values).result()
    want = np.asarray(arr.read().result())
    got = zarr_array.read_array(_Kv(path), "leaf")
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        got = got.view(torch.int16).numpy().view(np.uint16)
        want = want.view(np.uint16)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_kinds")
    return {kind: (str(root / kind), write_jax_checkpoint(
        kind, str(root / kind))) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_orbax_read_returns_the_jax_restore_raw_tree(checkpoints, kind):
    ckpt, _ = checkpoints[kind]
    saver = JaxSaver(ckpt, async_save=False)
    try:
        (step,) = saver.all_steps()
        want = saver.restore_raw(step)
    finally:
        saver.close()
    got = orbax_read.read_tree(step_dir(ckpt, step))
    assert assert_trees_bitwise_equal(want, got) > 3
    assert orbax_read.is_orbax_step(step_dir(ckpt, step))
    if kind == "bert_bf16":
        kernel = got["params"]["params"]["classifier"]["kernel"]
        assert isinstance(kernel, torch.Tensor) and \
            kernel.dtype == torch.bfloat16
    if kind == "legacy_stack":
        assert orbax_read.tree_has_key(got, "stack") and \
            not orbax_read.tree_has_key(got, "gpipe_stack")
        renamed = orbax_read.swap_tree_keys(got, "stack", "gpipe_stack")
        assert orbax_read.tree_has_key(renamed["opt_state"], "gpipe_stack")
    meta = orbax_read.read_metadata(step_dir(ckpt, step))
    assert meta["use_ocdbt"] and not meta["use_zarr3"]


def test_orbax_steps_of_one_directory_read_as_their_own_trees(tmp_path):
    """Steps 1 and 3 of one directory: each step's databases read its own
    values (their data files share the names `d/<hex>` per step)."""
    ckpt = str(tmp_path / "ckpt")
    write_jax_checkpoint("deepfm_f32", ckpt, steps=(1, 3))
    saver = JaxSaver(ckpt, async_save=False)
    try:
        for step in (1, 3):
            assert_trees_bitwise_equal(
                saver.restore_raw(step),
                orbax_read.read_tree(step_dir(ckpt, step)))
    finally:
        saver.close()
    with open(os.path.join(ckpt, ".manifests", "3.json")) as f:
        assert "default/manifest.ocdbt" in json.load(f)["files"]
